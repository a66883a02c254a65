"""VDTuner's MOBO applied to the port's own training and serving stack: the
port of ``repro/tuning/serve_tuner.py``.

The mapping mirrors the VDMS problem:

* "index type"      -> remat strategy (categorical; each changes the
                       compute/memory trade-off the way an index type
                       changes speed/recall),
* index parameters  -> none (the non-fixed space's empty per-type sets),
* system parameters -> flash-attention block sizes (``flash_bq``,
                       ``flash_bk``) and sequence-parallel residuals,
* objectives        -> (steps/s at the roofline bound, memory headroom),
                       from the dry-run of the step (``launch/dryrun.py``):
                       an expensive, black-box, conflicting pair.

As in the JAX package, where the knobs set ``flash_xla``'s blocks and not
the Pallas kernel's, ``flash_bq`` / ``flash_bk`` set the blocks of the
blocked plain version (``kernels/flash_xla.py``), which the dry-run counts.
They do not set the CUDA kernels' tiles: a configuration run on the card
runs the same kernels whatever its blocks. ``seq_parallel`` has no effect
on a 1 x 1 mesh, as in the reference on such a mesh.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import SHAPES, ArchConfig
from ..core.objectives import SequentialBatchMixin, TuningFailure
from ..core.space import Param, SearchSpace
from ..distributed.sharding import ShardingRules
from ..kernels import flash_xla
from ..launch import hlo_analysis
from ..launch.dryrun import _compile_step, _costs_of, model_flops_for

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 at a 700 W power limit (chip_smoke.py phase 14 checks it on the card)
HBM_PER_DEV = 85_017_493_504


def make_serving_space() -> SearchSpace:
    return SearchSpace(
        index_types={
            "remat_nothing": [],
            "remat_dots": [],
            "remat_dots_no_batch": [],
        },
        system_params=[
            Param("flash_bq", "grid", choices=(128, 256, 512, 1024), default=512),
            Param("flash_bk", "grid", choices=(256, 512, 1024, 2048), default=1024),
            Param("seq_parallel", "cat", choices=(False, True), default=True),
        ],
    )


_REMAT = {
    "remat_nothing": "nothing",
    "remat_dots": "dots",
    "remat_dots_no_batch": "dots_no_batch",
}


class ServeTuningEnv(SequentialBatchMixin):
    """config -> {'speed': steps/s at the roofline bound, 'recall': memory
    headroom fraction, 'mem_gib'} for one (arch, shape, mesh).

    A full ``EvalBackend``: ``SequentialBatchMixin`` supplies
    ``evaluate_batch`` (the flash blocks are process-wide, so a batch
    evaluates one configuration at a time). Results are cached by
    configuration."""

    def __init__(self, cfg: ArchConfig, shape_name: str, mesh):
        self.cfg = cfg
        self.shape = SHAPES[shape_name]
        self.mesh = mesh
        self.cache: Dict = {}

    def __call__(self, config) -> Dict[str, float]:
        key = tuple(sorted((k, str(v)) for k, v in config.items()))
        if key in self.cache:
            return dict(self.cache[key])
        remat = _REMAT[config["index_type"]]
        # save the blocks in effect: restoring fixed defaults would clobber
        # a caller's own set_default_blocks
        prev_blocks = flash_xla.get_default_blocks()
        flash_xla.set_default_blocks(config["flash_bq"], config["flash_bk"])
        try:
            rules = ShardingRules(self.mesh, seq_parallel=bool(config["seq_parallel"]))
            traced = _compile_step(self.cfg, self.shape, self.mesh, rules, remat)
            costs = _costs_of(traced)
            chips = self.mesh.size
            roof = hlo_analysis.Roofline(
                arch=self.cfg.name, shape=self.shape.name, mesh="tune", chips=chips,
                hlo_flops=costs["flops"] * chips, hlo_bytes=costs["bytes"] * chips,
                coll_bytes=0.0, coll_breakdown={}, coll_counts={},
                model_flops=model_flops_for(self.cfg, self.shape),
                peak_mem_per_dev=float(traced["temp"]),
            )
            headroom = 1.0 - roof.peak_mem_per_dev / HBM_PER_DEV
            if headroom <= 0:
                raise TuningFailure("exceeds HBM")
            result = {
                "speed": 1.0 / max(roof.bound_s, 1e-12),
                "recall": headroom,
                "mem_gib": roof.peak_mem_per_dev / 2**30,
            }
        except TuningFailure:
            raise
        except Exception as e:  # noqa: BLE001 -- a step that cannot be traced is a crashed configuration
            raise TuningFailure(f"{type(e).__name__}: {e}") from e
        finally:
            flash_xla.set_default_blocks(*prev_blocks)
        self.cache[key] = dict(result)
        return result
