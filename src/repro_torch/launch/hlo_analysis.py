"""Roofline terms of a dry-run's counts on NVIDIA H100 constants.

The port of ``repro/launch/hlo_analysis.py``, under its name so that a
reader finds the counterpart. The port has no HLO: its dry-run
(``launch/dryrun.py``) counts a traced step on the ``meta`` device, and
:class:`Roofline` turns those counts into terms:

    compute term    = FLOPs / (chips * PEAK_FLOPS)
    memory term     = bytes / (chips * HBM_BW)
    collective term = collective bytes / (chips * NVLINK_BW)

The dry-run counts each rank's collectives by kind (``all-gather``,
``reduce-scatter``, ``all-reduce``, ``all-to-all``; the bytes of their
results, as the reference reads them from the HLO), and the ``Roofline``
takes them times the chips, as the reference scales its per-device HLO. On
one device there is no collective: 0 bytes and an empty breakdown. The
reference's ``collective_bytes`` and ``count_collectives`` parse XLA HLO
text and have no counterpart here.

The collective term prices every byte at one GPU's NVLink rate
(``NVLINK_BW``, 450 GB/s one way), whichever mesh axis it crosses. A
16-wide axis of the production mesh spans two 8-GPU NVLink domains, so part
of its traffic would cross the slower network between nodes: the term is a
lower bound on the time of the collectives, and no second term prices that
share.

Hardware constants: NVIDIA H100 80GB HBM3 (SXM), 700 W, as ``nvidia-smi``
names the card; NVIDIA's data-sheet peaks, dense.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12  # bf16 dense on the tensor cores, NVIDIA H100 80GB HBM3, 700 W
HBM_BW = 3.35e12  # bytes/s of HBM3, NVIDIA H100 80GB HBM3, 700 W
NVLINK_BW = 450e9  # bytes/s one way (900 GB/s both ways, 18 NVLink 4 links), NVIDIA H100 80GB HBM3, 700 W


@dataclasses.dataclass
class Roofline:
    """All quantities are global: the counts of the step on ``chips``
    devices (1 on the port). The fields keep the reference's names
    (``hlo_flops``, ``hlo_bytes``) though the counts come from a traced
    PyTorch step."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    coll_counts: Dict[str, int]
    model_flops: float
    peak_mem_per_dev: float

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=lambda k: terms[k])

    @property
    def bound_s(self) -> float:
        """The least time the step could take: the largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the binding roofline the useful work achieves:
        model_flops-time / max(term)."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        dominant = self.bound_s
        return ideal / dominant if dominant > 0 else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes, "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown, "coll_counts": self.coll_counts,
            "model_flops": self.model_flops,
            "peak_mem_per_dev": self.peak_mem_per_dev,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
