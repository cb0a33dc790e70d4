"""Device selection and float32 precision for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_float32():
    """Float32 convolutions and matmuls in IEEE float32, not TF32, inside the
    block (or the decorated function); the caller's settings come back on
    exit. The float32 layers (the box-regression tower, FPN, heads, and the
    transformer when it is not run in bf16) are held to the JAX package's
    float32 numerics, which TF32's 10-bit mantissa would not meet."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent.
    The port's entry points default to "cuda" and never fall back to the CPU:
    the CPU is used only when the caller names it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available; "
                           "pass device='cpu' to run the plain PyTorch versions")
    return device
