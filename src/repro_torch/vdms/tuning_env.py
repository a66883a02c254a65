"""The VDMS tuning environment of the port: the expensive black-box objective
the tuners optimize over the Milvus-like search space (index type +
per-family index parameters + 7 system parameters, paper §V-A). This slice
carries the static workload of the JAX package's ``vdms/tuning_env.py``;
streaming replays, fault injection and batch evaluation come later.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.objectives import TuningFailure
from ..device import resolve_device
from .datasets import VectorDataset
from .engine import VDMSInstance
from .registry import make_space  # noqa: F401  (registry-derived; re-exported)


def classify_eval_error(e: BaseException) -> Optional[TuningFailure]:
    """Map an evaluation-time exception to the failure taxonomy:
    ``TuningFailure`` passes through; config-dependent numeric/shape crashes
    (``ValueError``, ``ZeroDivisionError``, ``FloatingPointError``) and a
    configuration that exhausts device memory become config failures;
    anything else returns ``None`` and must be re-raised by the caller."""
    if isinstance(e, TuningFailure):
        return e
    if isinstance(e, (ValueError, ZeroDivisionError, FloatingPointError,
                      torch.cuda.OutOfMemoryError)):
        return TuningFailure(str(e))
    return None


class VDMSTuningEnv:
    """Callable black-box: config -> {'speed', 'recall', 'mem_gib', ...}.

    ``mode="wall"`` measures real QPS on the device; ``mode="analytic"`` uses
    the engine's deterministic cost model (recall is always real). Results
    are cached by canonical config, so repeated samples are free. A build
    slower than ``build_timeout`` seconds is a :class:`TuningFailure`; each
    failed configuration is kept with its message in ``failures``.
    ``device`` defaults to the GPU and raises without one. ``draws`` is
    handed to every ``VDMSInstance`` (the build's random draws; default the
    port's own).
    """

    def __init__(
        self,
        dataset: VectorDataset,
        mode: str = "wall",
        seed: int = 0,
        build_timeout: float = 120.0,
        repeats: int = 3,
        device=None,
        draws=None,
    ):
        if dataset is None:
            raise ValueError("static workload requires dataset=")
        self.dataset = dataset
        self.mode = mode
        self.seed = seed
        self.build_timeout = build_timeout
        self.repeats = repeats
        self.device = resolve_device(device)
        self.draws = draws
        self.cache: Dict[Tuple, Dict[str, float]] = {}
        self.failures: Dict[Tuple, Dict[str, Any]] = {}
        self.n_evals = 0
        self.total_replay_time = 0.0

    def workload_stats(self) -> Dict[str, float]:
        """Scalar statistics of the workload: dimensionality, corpus size,
        top-k, and the operation mix (static: searches only)."""
        w = self.dataset
        return {
            "dim": float(w.dim),
            "k": float(w.k),
            "corpus": float(w.n),
            "n_queries": float(w.queries.shape[0]),
            "insert_frac": 0.0,
            "search_frac": 1.0,
            "delete_frac": 0.0,
        }

    @staticmethod
    def _canon(cfg: Dict[str, Any]) -> Tuple:
        items = []
        for k in sorted(cfg):
            v = cfg[k]
            if isinstance(v, float):
                v = round(v, 4)
            items.append((k, v))
        return tuple(items)

    def _measure_one(self, cfg: Dict[str, Any]) -> Dict[str, float]:
        inst = VDMSInstance(self.dataset, cfg, seed=self.seed, device=self.device,
                            draws=self.draws)
        if inst.build_time > self.build_timeout:
            raise TuningFailure(f"index build exceeded {self.build_timeout}s")
        result = inst.measure(repeats=self.repeats, mode=self.mode)
        del inst
        return result

    def __call__(self, cfg: Dict[str, Any]) -> Dict[str, float]:
        key = self._canon(cfg)
        if key in self.cache:
            return dict(self.cache[key])
        t0 = time.perf_counter()
        try:
            result = self._measure_one(cfg)
        except Exception as e:
            # config-dependent crashes become TuningFailure; anything else is
            # a programmer error and propagates instead of poisoning the GP
            tf = classify_eval_error(e)
            if tf is None:
                raise
            self.failures[key] = {"config": dict(cfg), "error": str(tf)}
            if tf is e:
                raise
            raise tf from e
        finally:
            self.total_replay_time += time.perf_counter() - t0
            self.n_evals += 1
        self.cache[key] = dict(result)
        return result
