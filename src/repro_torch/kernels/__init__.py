"""The port's hand-written CUDA kernels (``csrc/``), their wrappers and
their plain PyTorch versions.  Importing this package builds nothing: the
library is compiled on the first launch on the card."""
from ._build import launches
from .ops import (coded_combine, fused_masked_gradient, fwht,
                  hadamard_encode, srht_encode)

__all__ = ["launches", "fwht", "srht_encode", "hadamard_encode",
           "fused_masked_gradient", "coded_combine"]
