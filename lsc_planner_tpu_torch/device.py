"""Device handling and the float32 matmul settings the port relies on.

The JAX package forces exact-f32 contractions wherever world coordinates
or KKT matrices meet (``Precision.HIGHEST``, qp.py:396-399): the TPU's
default bf16 passes broke the positive definiteness of H = P + A'DA and
collapsed audited positions.  On Hopper the same hazard is TF32, so both
TF32 switches are set off explicitly, and the float32 matmul precision is
left at "highest".
"""
from __future__ import annotations

import torch


def exact_float32() -> None:
    """Turn TF32 off for matmuls and cuDNN (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device a simulator's tensors live on: the CUDA device unless the
    caller names another (``device="cpu"`` for the plain versions).  Raises
    when CUDA is asked for, or left as the default, and there is no card:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but "
                           "torch.cuda.is_available() is False")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on `device` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

