"""PyTorch/CUDA port of the VDTuner reproduction.

Same subpackage layout and public names as the JAX package ``repro``:
``kernels`` (plain PyTorch versions plus hand-written CUDA kernels for
Hopper), ``vdms`` (the vector data management system under tune), ``core``
(the tuning side), ``configs``, ``models`` and ``launch`` (the LM serving
path). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no ``device`` they raise.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
