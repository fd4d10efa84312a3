"""Device handling of the reference (frozen copy of the port's
``device.py``; it leaves the TF32 switches as the caller set them).
"""
from __future__ import annotations

import torch


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

