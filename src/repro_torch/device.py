"""Device resolution shared by every entry point of the port, and the
float32 product precision its plain products run at."""
from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "full_f32_matmul"]


def full_f32_matmul(fn):
    """Decorate ``fn`` to run its float32 matrix products in full float32
    (TF32 off), restoring the caller's setting on return.  A TF32 product
    keeps about three decimal digits, and the objective trace is compared
    with the reference to float32 rounding.  With TF32 already off (the
    PyTorch default) the wrapper only reads the setting: it sits on the
    step loop's host path."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        matmul = torch.backends.cuda.matmul
        if not matmul.allow_tf32:
            return fn(*args, **kwargs)
        matmul.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            matmul.allow_tf32 = True
    return run


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA: the port is built for the card, so a missing card
    is an error, never a silent CPU run.  Pass ``device="cpu"`` (as the
    tests do) to run the plain PyTorch versions of the kernels on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the host")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device
