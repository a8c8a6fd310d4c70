"""PyTorch/CUDA port of ``dominantsparseeigenad_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX one, with the same module layout.  It
imports ``torch`` and ``numpy`` only.  So far it covers the sparse tier's
eigensolver paths, with derivatives to any order through the
implicit-function-theorem rule, in reverse mode, in forward mode
(``torch.func.jvp`` nested to any order) and in the ``torch.func``
transforms that mix them (``hessian``, ``jacfwd``, ``grad∘jacfwd``),
whose deflated solve is itself differentiable so that no derivative is
taken through an iteration; ``torch.func.vmap`` batches every solver
(a Bell matvec becomes one SpMM, a deflated solve one block CG, the
rest lane by lane): ``dominant_eigh`` (one extremal
eigenpair) on a ``BellOperator`` whose every SpMV runs the hand-written
CUDA kernel of ``csrc/bell_spmv.cu``, and the block solver
``dominant_eigh_multi`` (the r extremal pairs, by Lanczos or
``lobpcg_eigh``) whose every SpMM runs the one of ``csrc/bell_spmm.cu``;
plus the dense and matrix-free operators.  The row-sharded tier
(``parallel/``, on ``torch.distributed``) splits a blocked-ELL or dense
operator's rows over ranks, one process each, and both solvers run
through it unchanged; each rank's row panel runs the same kernels.  An
operator whose slots are ring bands (config #5's all are) binds the
banded slot plan, and its products run the kernels' banded mode (K4b).
``energy_curvature`` gives an eigenvalue's first and second derivative
in a coupling, and ``models/`` holds the matrix-free TFIM flagship with
its Jordan-Wigner and ED oracles and the 2D classical Ising model
(BASELINE config #4): TRG and CTMRG free energies, energy and specific
heat differentiated through the renormalization flow, by the
degeneracy-safe decompositions ``eigh_safe``, ``eigh_safe_truncated``,
``svd_safe`` and ``svd_safe_truncated`` or by the block solver
(``dominant_svd`` on the symmetric embedding, ``dominant_eigh_multi``),
against Onsager's solution.  The row-sharded tier is first order in
reverse mode (its collectives carry forward mode to any order).
The Krylov engine has the JAX package's options: chunked
reorthogonalization, a bfloat16 basis polished by a Newton step
(``refine_eigenpair``), a carried restart direction that needs no host
read, early exit (``lanczos_adaptive``), MINRES and preconditioned
deflated solves (``ops/precond.py``), and the TFIM χ_F(g) sweep.  The
non-symmetric dominant eigensolver (``dominant_eig``,
``dominant_eig_multi``: a two-sided power iteration, Arnoldi-seeded on
request, whose IFT rule solves bordered systems by BiCGStab, GMRES or
CGNR) gives config #4's transfer observables, ``transfer_spectral_gap``
and ``correlation_length``.  Complex operators run through every solver
and derivative rule above but the blocked-ELL kernels and the row-sharded
tier: complex Hermitian ones through the symmetric solvers (real
eigenvalues, the eigenvectors' pivot phase gauge carried into the
rules), complex non-symmetric ones through ``dominant_eig``; and the
complex half of the non-symmetric solver (``dominant_eig_pair``,
``dominant_eig_spectrum``, ``spectrum_structure``) gives a real
operator's complex-conjugate eigenvalue pairs and their derivatives.
Thick-restart Lanczos (``lanczos_restarted``, ``restart_init``,
``restart_cycle``, ``restart_extract``; ``dominant_eigh(restart_cycles=
...)``) bounds the Krylov memory by a (k+1, N) window, and its state is
checkpointed by ``utils.save_pytree`` in the JAX package's file format;
``dominant_eigh_gen`` solves the generalized pencil A x = λ B x by
B-metric LOBPCG (``lobpcg_eigh_general``), differentiable in both
operators through ``solve_deflated_pencil``.

Entry points run on CUDA unless called with ``device="cpu"``; without a
card they raise rather than fall back.
"""

from .convert import (bcoo_operator_from_numpy, bell_operator_from_numpy,
                      coo_operator_from_numpy, csr_operator_from_numpy,
                      dense_operator_from_numpy, restart_state_from_numpy,
                      row_sharded_bell_operator_from_numpy)
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .parallel import *  # noqa: F401,F403
from .parallel import __all__ as _parallel_all

__all__ = ["bcoo_operator_from_numpy", "bell_operator_from_numpy",
           "coo_operator_from_numpy", "csr_operator_from_numpy",
           "dense_operator_from_numpy", "restart_state_from_numpy",
           "row_sharded_bell_operator_from_numpy", *_ops_all,
           *_parallel_all]
