"""Truncated differentiable SVD: the dominant singular triplets.

Counterpart of ``dominantsparseeigenad_tpu/ops/svd.py``.  The top-r
singular triplets of a (possibly rectangular, possibly matrix-free)
operator come from the block eigensolver run on the Hermitian embedding

    H = [[0, A], [Aᴴ, 0]],   H (u; v) = (A v; Aᴴ u),

whose top-r eigenpairs are (σ_i, (u_i; v_i)/√2).  For a complex A the
embedding must be Hermitian, with the adjoint ``Aᴴ u = conj(Aᵀ conj(u))``
built from the operator's bilinear ``rmatvec``: with the plain transpose
it is complex-symmetric and the singular values come out wrong.  The
embedding is a :class:`~.operators.MatrixFreeOperator` whose parameters
are the inner operator's, so every derivative, to any order and in either
mode, is the block IFT rule of :func:`~.eigh.dominant_eigh_multi`; this
module only builds the embedding and unpacks the halves.  TRG's
``split_method="lanczos"`` (``models/ising2d.py``) differentiates the free
energy through it.

Over a square operator whose vectors are sharded, a rank holds its rows
of u and its rows of v: the embedding's vectors are laid out by
``layout.stacked()`` (two segments of the whole (2N,) vector, the draws
and the pivot those of the whole vector), and u and v are the rank's
rows.
"""

from __future__ import annotations

import torch

from .eigh import dominant_eigh_multi
from .operators import (LinearOperator, MatrixFreeOperator, as_operator,
                        hmatmul, layout_norm, local_dim, vector_layout)


class _RectOperator(LinearOperator):
    """A rectangular dense (m, n) matrix behind the operator protocol's
    ``matvec`` (n,) -> (m,) and ``rmatvec`` (m,) -> (n,), for the
    embedding only."""

    def __init__(self, a: torch.Tensor):
        self.a = a

    def matvec(self, x):
        return hmatmul(self.a, x)

    def rmatvec(self, x):
        return hmatmul(self.a.T, x)

    matmat = matvec
    rmatmat = rmatvec

    def parameters(self):
        return [self.a]

    def with_parameters(self, tensors):
        (a,) = tensors
        return _RectOperator(a)

    @property
    def dim(self):
        return max(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device


class _Embedding(MatrixFreeOperator):
    """The Hermitian embedding of ``inner`` (m, n); its block products
    apply ``inner.matmat``/``rmatmat`` once instead of column by column."""

    def matmat(self, X):
        return self.matvec_fn(self.params, X)

    rmatmat = matmat


def _embed(op: LinearOperator, m: int, n: int) -> MatrixFreeOperator:
    """The embedding of ``op`` (m, n); over sharded vectors (a square
    ``op``) on the stacked layout, ``w[:m]`` the rank's rows of u."""
    layout = vector_layout(op)
    split = local_dim(op) if layout is not None else m

    def apply(params, w):
        inner = op.with_parameters(params)
        u, v = w[:split], w[split:]
        if w.ndim == 1:
            return torch.cat([inner.matvec(v), inner.rmatvec(u.conj()).conj()])
        return torch.cat([inner.matmat(v), inner.rmatmat(u.conj()).conj()])

    emb = _Embedding(apply, list(op.parameters()), dim=m + n,
                     dtype=op.dtype, device=op.device)
    if layout is not None:
        emb.vector_layout = layout.stacked()
    return emb


def _colunit(b, layout=None):
    nrm = layout_norm(layout, b, dim=0)
    return b / torch.clamp(nrm, min=torch.finfo(b.dtype).tiny)[None, :]


def dominant_svd(a, r: int = 4, k: int = 128, *, tol: float = 1e-8,
                 maxiter: int | None = None, seed: int = 0,
                 reorth_passes: int = 2, gap_eps: float = 1e-12,
                 method: str = "lanczos", with_info: bool = False,
                 v0: torch.Tensor | None = None,
                 x0: torch.Tensor | None = None,
                 generator: torch.Generator | None = None, device=None):
    """Top-r singular triplets ``(u (m, r), s (r,) descending, v (n, r))``
    of a matrix or a square LinearOperator, ``A v_i = s_i u_i``,
    differentiable to any order in the matrix (or the operator's
    parameters) through :func:`~.eigh.dominant_eigh_multi`.

    ``method`` ("lanczos" or "lobpcg"), ``k``, ``tol``, ``maxiter``,
    ``seed``, ``reorth_passes``, ``gap_eps``, ``generator`` and
    ``device`` are those of the embedding's solve; ``v0`` ((m + n,),
    Lanczos) or ``x0`` ((m + n, r), LOBPCG) gives its start.
    ``with_info=True`` appends the block's :class:`~.lanczos.LanczosInfo`.
    Triplets past rank(A) (``s_i ~ 0``) are unit null-space vectors, not
    singular triplets; ``s`` is clamped at 0.  Over a square operator
    whose vectors are sharded, u and v are the rank's rows (``v0`` and
    ``x0``: the rank's rows of u's part, then of v's, ``stacked().rows``
    of the whole start).
    """
    if isinstance(a, LinearOperator):
        op = as_operator(a)
        m = n = op.dim
    else:
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"expected a LinearOperator or a tensor, got "
                            f"{type(a).__name__}")
        if a.ndim != 2:
            raise ValueError(f"expected a matrix, got shape {tuple(a.shape)}")
        m, n = a.shape
        op = as_operator(a) if m == n else _RectOperator(a)
    out = dominant_eigh_multi(_embed(op, m, n), r=r, k=k, extreme="max",
                              tol=tol, maxiter=maxiter, seed=seed,
                              reorth_passes=reorth_passes, gap_eps=gap_eps,
                              method=method, with_info=with_info, v0=v0,
                              x0=x0, generator=generator, device=device)
    lams, w = out[0], out[1]
    # For σ_i > 0 the halves of w_i = (u_i; v_i)/√2 have norm 1/√2 each;
    # normalizing each half also keeps null-space columns unit.
    layout = vector_layout(op)
    split = m if layout is None else local_dim(op)
    u, v = _colunit(w[:split], layout), _colunit(w[split:], layout)
    lams = torch.maximum(lams, torch.zeros_like(lams))
    if with_info:
        return u, lams, v, out[2]
    return u, lams, v
