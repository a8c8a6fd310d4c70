"""PyTorch/CUDA port of ``dominantsparseeigenad_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX one, with the same module layout.  It
imports ``torch`` and ``numpy`` only.  So far it covers the sparse tier's
eigensolver paths, with first-order reverse-mode gradients through the
implicit-function-theorem rule: ``dominant_eigh`` (one extremal
eigenpair) on a ``BellOperator`` whose every SpMV runs the hand-written
CUDA kernel of ``csrc/bell_spmv.cu``, and the block solver
``dominant_eigh_multi`` (the r extremal pairs, by Lanczos or
``lobpcg_eigh``) whose every SpMM runs the one of ``csrc/bell_spmm.cu``;
plus the dense and matrix-free operators.

Entry points run on CUDA unless called with ``device="cpu"``; without a
card they raise rather than fall back.
"""

from .convert import bell_operator_from_numpy, dense_operator_from_numpy
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all

__all__ = ["bell_operator_from_numpy", "dense_operator_from_numpy",
           *_ops_all]
