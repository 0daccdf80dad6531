"""repro_torch: the PyTorch / CUDA port of ``repro`` (encoded distributed
optimization, Karakus et al., 2018) for NVIDIA Hopper.

The package keeps the reference's module layout and names.  It imports
``torch`` and numpy only: it never imports ``jax`` nor anything of the
``repro`` package.  Host simulation (encoders, delay models, the cluster
engine, fault injection, tracing) is numpy and matches the reference bit
for bit; device math runs on PyTorch tensors, and each TPU kernel of the
reference is a hand-written CUDA C++ kernel under ``kernels/csrc``.

Entry points take an explicit ``device``; left unset they run on CUDA and
raise when no card is present (see :func:`repro_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
