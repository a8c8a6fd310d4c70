"""PyTorch/CUDA port of ``dominantsparseeigenad_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX one, with the same module layout.  It
imports ``torch`` and ``numpy`` only.  So far it covers the sparse tier's
eigensolver path: ``dominant_eigh`` (one extremal eigenpair, first-order
reverse-mode gradients through the implicit-function-theorem rule) on a
``BellOperator`` whose every SpMV runs the hand-written CUDA kernel of
``csrc/bell_spmv.cu``, plus the dense and matrix-free operators.

Entry points run on CUDA unless called with ``device="cpu"``; without a
card they raise rather than fall back.
"""

from .convert import bell_operator_from_numpy, dense_operator_from_numpy
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all

__all__ = ["bell_operator_from_numpy", "dense_operator_from_numpy",
           *_ops_all]
