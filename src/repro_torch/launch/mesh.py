"""Meshes: the port of ``repro/launch/mesh.py``. Functions, not
module constants, so importing this module touches no device."""
from __future__ import annotations

from ..distributed.sharding import ShardMesh
from ..device import resolve_device


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 x 16 (256 chips) or 2 x 16 x 16 (512 chips) mesh:
    not ported. The multi-card layout is ROADMAP Queue 1 item 10."""
    raise NotImplementedError(
        f"make_production_mesh(multi_pod={multi_pod}): the port runs on one device; the "
        "multi-card layout is ROADMAP Queue 1 item 10")


def make_host_mesh(device=None) -> ShardMesh:
    """A 1 x 1 ``("data", "model")`` mesh over one device (the GPU when
    ``device`` is None)."""
    return ShardMesh((resolve_device(device),), axis_names=("data", "model"), axis_sizes=(1, 1))
