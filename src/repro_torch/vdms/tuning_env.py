"""The VDMS tuning environment of the port: the expensive black-box objective
the tuners optimize over the Milvus-like search space (index type +
per-family index parameters + 7 system parameters, paper §V-A); the
counterpart of the JAX package's ``vdms/tuning_env.py``.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.objectives import TuningFailure
from ..device import resolve_device
from .datasets import VectorDataset
from .engine import VDMSInstance, batch_signature, measure_batch
from .faults import FaultInjector, FaultPlan, classify_eval_error
from .registry import make_space  # noqa: F401  (registry-derived; re-exported)
from .workload import (
    OP_DELETE,
    OP_INSERT,
    OP_SEARCH,
    WorkloadTrace,
    replay_trace,
    time_aware_ground_truth,
)


class VDMSTuningEnv:
    """Callable black-box: config -> {'speed', 'recall', 'mem_gib', ...},
    with a vectorized ``evaluate_batch`` (the full ``EvalBackend``
    protocol).

    ``mode="wall"`` measures real QPS on the device; ``mode="analytic"`` uses
    the engine's deterministic cost model (recall is always real). Results
    are cached by canonical config, so repeated samples are free. A build
    slower than ``build_timeout`` seconds is a :class:`TuningFailure`; each
    failed configuration is kept with its message in ``failures``.
    ``device`` defaults to the GPU and raises without one. ``draws`` is
    handed to every build (the class of the build's random draws; default
    the port's own).

    The ``workload`` axis selects the evaluation regime:

    * ``"static"`` (default): one ``VDMSInstance`` per config over
      ``dataset``;
    * ``"streaming"``: each config replays a :class:`WorkloadTrace` through a
      live instance (``LiveVDMS``): growing-tail ingestion, incremental
      seal-and-index builds, tombstone deletes with compaction, time-aware
      recall. ``n_phases`` splits the trace into equal-op windows and
      :meth:`set_phase` moves the drifting workload forward; the cache is
      phase-keyed.

    ``faults`` (streaming only) is a :class:`~.faults.FaultPlan` or a
    :class:`~.faults.FaultInjector` armed on every replay's live instance;
    an injected fault surfaces as a *transient* :class:`TuningFailure`.
    """

    def __init__(
        self,
        dataset: Optional[VectorDataset] = None,
        mode: str = "wall",
        seed: int = 0,
        build_timeout: float = 120.0,
        repeats: int = 3,
        batch_workers: Optional[int] = None,
        workload: str = "static",
        trace: Optional[WorkloadTrace] = None,
        n_phases: int = 1,
        compact_threshold: float = 0.3,
        faults: Union[FaultPlan, FaultInjector, None] = None,
        device=None,
        draws=None,
    ):
        if workload not in ("static", "streaming"):
            raise ValueError(f"workload must be 'static' or 'streaming', got {workload!r}")
        if workload == "static" and dataset is None:
            raise ValueError("static workload requires dataset=")
        if workload == "streaming" and trace is None:
            raise ValueError("streaming workload requires trace=")
        if faults is not None and workload != "streaming":
            raise ValueError("fault injection requires the streaming workload")
        self.dataset = dataset
        self.mode = mode
        self.seed = seed
        self.build_timeout = build_timeout
        self.repeats = repeats
        self.batch_workers = batch_workers  # thread pool size for evaluate_batch
        self.workload = workload
        self.trace = trace
        self.compact_threshold = compact_threshold
        self.device = resolve_device(device)
        self.draws = draws
        self._phases = trace.split(n_phases) if workload == "streaming" else []
        self._phase_gt: List[Optional[np.ndarray]] = [None] * len(self._phases)
        self._phase = 0
        # one persistent injector across evaluations: a fail-count schedule
        # ("the next 2 builds crash") runs out across session retries, so a
        # transiently faulted configuration recovers on re-evaluation.
        # Faulted evaluations raise before caching, so a retry re-runs the
        # replay.
        self._fault_injector: Optional[FaultInjector] = (
            faults
            if faults is None or isinstance(faults, FaultInjector)
            else FaultInjector(faults, scope="primary")
        )
        self.cache: Dict[Tuple, Dict[str, float]] = {}
        self.failures: Dict[Tuple, Dict[str, Any]] = {}
        self.n_evals = 0
        self.total_replay_time = 0.0

    # ------------------------------------------------------------------
    # streaming phases (the drifting workload's time axis)
    # ------------------------------------------------------------------
    @property
    def n_phases(self) -> int:
        return len(self._phases)

    @property
    def phase(self) -> int:
        return self._phase

    def set_phase(self, phase: int) -> None:
        """Advance the streaming workload to phase ``phase`` (a window of the
        trace whose base corpus is the visible state at the window start)."""
        if self.workload != "streaming":
            raise ValueError("set_phase is only meaningful for streaming workloads")
        if not 0 <= phase < len(self._phases):
            raise ValueError(f"phase must be in [0, {len(self._phases)}), got {phase}")
        self._phase = int(phase)

    def current_workload(self) -> Tuple[str, Union[WorkloadTrace, VectorDataset]]:
        """``("streaming", active-phase trace)`` or ``("static", dataset)``:
        what an evaluation right now would measure."""
        if self.workload == "streaming":
            return "streaming", self._phases[self._phase]
        return "static", self.dataset

    def workload_stats(self) -> Dict[str, float]:
        """Scalar statistics of the current workload view: dimensionality,
        corpus size, top-k, and the operation arrival mix."""
        kind, w = self.current_workload()
        if kind == "streaming":
            n_ops = max(w.n_ops, 1)
            return {
                "dim": float(w.dim),
                "k": float(w.k),
                "corpus": float(w.capacity),
                "n_queries": float(w.n_searches),
                "insert_frac": float(np.sum(w.kinds == OP_INSERT)) / n_ops,
                "search_frac": float(np.sum(w.kinds == OP_SEARCH)) / n_ops,
                "delete_frac": float(np.sum(w.kinds == OP_DELETE)) / n_ops,
            }
        return {
            "dim": float(w.dim),
            "k": float(w.k),
            "corpus": float(w.n),
            "n_queries": float(w.queries.shape[0]),
            "insert_frac": 0.0,
            "search_frac": 1.0,
            "delete_frac": 0.0,
        }

    def _cache_key(self, cfg: Dict[str, Any]) -> Tuple:
        key = self._canon(cfg)
        if self.workload == "streaming":
            key = (("__phase__", self._phase),) + key
        return key

    @staticmethod
    def _canon(cfg: Dict[str, Any]) -> Tuple:
        items = []
        for k in sorted(cfg):
            v = cfg[k]
            if isinstance(v, float):
                v = round(v, 4)
            items.append((k, v))
        return tuple(items)

    def _build(self, cfg: Dict[str, Any]) -> VDMSInstance:
        inst = VDMSInstance(self.dataset, cfg, seed=self.seed, device=self.device,
                            draws=self.draws)
        if inst.build_time > self.build_timeout:
            raise TuningFailure(f"index build exceeded {self.build_timeout}s")
        return inst

    def _measure_one(self, cfg: Dict[str, Any]) -> Dict[str, float]:
        """Build + measure one config in the active workload regime (raises
        :class:`TuningFailure` for crashed / timed-out configurations)."""
        if self.workload == "streaming":
            phase = self._phases[self._phase]
            if self._phase_gt[self._phase] is None:
                self._phase_gt[self._phase] = time_aware_ground_truth(phase, device=self.device)
            result = replay_trace(
                phase, cfg, seed=self.seed, mode=self.mode,
                ground_truth=self._phase_gt[self._phase],
                compact_threshold=self.compact_threshold, device=self.device, draws=self.draws,
                fault_injector=self._fault_injector,
            )
            if result["build_time"] + result["seal_build_s"] > self.build_timeout:
                raise TuningFailure(f"index builds exceeded {self.build_timeout}s")
            return result
        inst = self._build(cfg)
        result = inst.measure(repeats=self.repeats, mode=self.mode)
        del inst
        return result

    def _classify(self, key: Tuple, cfg: Dict[str, Any], e: BaseException) -> TuningFailure:
        """The failure of one configuration, kept in ``failures``; re-raises
        anything that is not a configuration's failure (a programmer error is
        never laundered into tuning feedback)."""
        tf = classify_eval_error(e)
        if tf is None:
            raise e
        self.failures[key] = {"config": dict(cfg), "error": str(tf)}
        return tf

    def __call__(self, cfg: Dict[str, Any]) -> Dict[str, float]:
        key = self._cache_key(cfg)
        if key in self.cache:
            return dict(self.cache[key])
        t0 = time.perf_counter()
        try:
            result = self._measure_one(cfg)
        except Exception as e:
            tf = self._classify(key, cfg, e)
            if tf is e:
                raise
            raise tf from e
        finally:
            self.total_replay_time += time.perf_counter() - t0
            self.n_evals += 1
        self.cache[key] = dict(result)
        return result

    # ------------------------------------------------------------------
    # batch evaluation
    # ------------------------------------------------------------------
    def evaluate_batch(
        self, cfgs: Sequence[Dict[str, Any]], max_workers: Optional[int] = None
    ) -> List[Union[Dict[str, float], TuningFailure]]:
        """Evaluate a batch of configurations, exploiting batch structure.

        Cache hits and in-batch duplicates are deduplicated; the misses'
        index builds run in a thread pool in analytic mode (each build with
        its own draws; ``build_timeout`` is then checked against contended
        wall-clock build time) and sequentially in wall mode; shape-identical
        instances (same :func:`batch_signature`) are measured together by
        :func:`measure_batch` in analytic mode, where the amortised path is
        exact, and the rest one by one (threaded in analytic mode,
        sequential in wall mode so wall-clock timings stay honest). Streaming
        replays run sequentially.

        Returns one entry per input config, aligned with ``cfgs``: the raw
        result dict, or the ``TuningFailure`` of a config that crashed or
        timed out (never raised per config).
        """
        results: List[Any] = [None] * len(cfgs)
        pending: Dict[Tuple, List[int]] = {}
        for i, cfg in enumerate(cfgs):
            key = self._cache_key(cfg)
            if key in self.cache:
                results[i] = dict(self.cache[key])
            else:
                pending.setdefault(key, []).append(i)
        if not pending:
            return results
        keys = list(pending)
        miss_cfgs = [cfgs[pending[k][0]] for k in keys]
        t0 = time.perf_counter()
        try:
            outs = self._evaluate_misses(keys, miss_cfgs, max_workers)
        finally:
            self.total_replay_time += time.perf_counter() - t0
            self.n_evals += len(miss_cfgs)
        for key, out in zip(keys, outs):
            if not isinstance(out, Exception):
                self.cache[key] = dict(out)
            for pos in pending[key]:
                results[pos] = out if isinstance(out, Exception) else dict(out)
        return results

    def _evaluate_misses(
        self, keys: Sequence[Tuple], cfgs: Sequence[Dict[str, Any]], max_workers: Optional[int]
    ) -> List[Union[Dict[str, float], TuningFailure]]:
        def guarded(i: int, fn):
            try:
                return fn()
            except Exception as e:
                return self._classify(keys[i], cfgs[i], e)

        if self.workload == "streaming":
            # replays are stateful trace walks: evaluated one by one
            return [guarded(i, lambda c=c: self._measure_one(c)) for i, c in enumerate(cfgs)]

        def build(i: int):
            return guarded(i, lambda: self._build(cfgs[i]))

        def measure_one(i: int):
            return guarded(i, lambda: built[i].measure(repeats=self.repeats, mode=self.mode))

        analytic = self.mode == "analytic"
        workers = max_workers or self.batch_workers or min(len(cfgs), os.cpu_count() or 4)
        # wall mode builds sequentially: concurrent builds inflate each
        # build_time under contention and would fail configurations on the
        # timeout that a sequential run accepts
        if len(cfgs) == 1 or workers == 1 or not analytic:
            built = [build(i) for i in range(len(cfgs))]
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                built = list(ex.map(build, range(len(cfgs))))

        outs: List[Any] = [None] * len(cfgs)
        groups: Dict[Tuple, List[int]] = {}
        singles: List[int] = []
        for i, inst in enumerate(built):
            if isinstance(inst, Exception):
                outs[i] = inst
            elif analytic:
                groups.setdefault(batch_signature(inst), []).append(i)
            else:
                singles.append(i)
        for idxs in groups.values():
            if len(idxs) == 1:
                singles.append(idxs[0])
                continue
            try:
                rs = measure_batch([built[i] for i in idxs], repeats=self.repeats,
                                   mode=self.mode)
            except (ValueError, ZeroDivisionError, torch.cuda.OutOfMemoryError):
                # the batched dispatch failed as a whole: measure one by one,
                # where each configuration gets (or raises) its own error
                singles.extend(idxs)
                continue
            for i, r in zip(idxs, rs):
                outs[i] = r
        if analytic and len(singles) > 1 and workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                for i, r in zip(singles, ex.map(measure_one, singles)):
                    outs[i] = r
        else:
            for i in singles:
                outs[i] = measure_one(i)
        return outs
