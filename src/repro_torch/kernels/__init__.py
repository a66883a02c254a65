"""Kernel layer of the port: plain PyTorch versions and hand-written CUDA
kernels for Hopper (``csrc/``), dispatched by :mod:`.ops`."""
from . import ops

__all__ = ["ops"]
