"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU.

    Never falls back to the CPU quietly: with no GPU present and no
    ``device`` given, this raises, so a measurement that was meant for the
    card cannot silently run on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the host"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        pin_matmul_precision()
    return device


def pin_matmul_precision() -> None:
    """Matrix products on the card as the JAX package contracts them: f32
    in full f32 (no TF32; ``preferred_element_type=float32``), and bf16
    products summed in f32 (no reduced-precision reduction), as XLA does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def sync(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
