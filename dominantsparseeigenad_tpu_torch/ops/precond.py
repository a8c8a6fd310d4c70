"""Preconditioner constructors for the port's operator formats.

Counterpart of ``dominantsparseeigenad_tpu/ops/precond.py``:

* :func:`operator_diagonal`: ``diag(A)`` of a dense, COO, CSR, BCOO or
  blocked-ELL operator (gather or banded slot plan alike: the diagonal
  blocks are the slots whose column is their own block-row), and of the
  shift, scale and sum composites over them;
* :func:`jacobi_precond`: ``z = r / max(|diag(A) - shift|, floor)``, one
  elementwise product per apply;
* :func:`block_jacobi_precond`: the (bs, bs) diagonal blocks inverted by
  one batched ``eigh`` with floored eigenvalue magnitudes, so the result
  is SPD even where ``A - shift`` is indefinite (the CG contract).

Every returned preconditioner takes an (N,) vector or an (N, m) block
(:func:`_apply_columns`).

Over sharded vectors (``operators.vector_layout``) an apply is row-local:
the constructors take the whole ``diag=`` (N,) or ``blocks=`` (nb, bs,
bs), build the preconditioner from it as the replicated layout does (the
floor reads the largest magnitude of the whole), and keep the rank's
rows, so each rank scales its own rows with no collective.  A row-sharded
operator has no structural diagonal here, as in the JAX package: pass
``diag=`` or ``blocks=``.
"""

from __future__ import annotations

import torch

from .operators import (DenseOperator, ScaledOperator, ShiftedOperator,
                        SumOperator, as_operator, vector_layout)
from .sparse import BellOperator, _TripletOperator


def operator_diagonal(op) -> torch.Tensor:
    """``diag(A)`` read from the structure of a :class:`DenseOperator`, a
    COO, CSR or BCOO operator (the segment sum of the entries on the
    diagonal), a :class:`BellOperator` (in its compute dtype), or a
    shift, scale or sum composite over them.  A matrix-free operator has
    none: pass ``diag=`` to the constructors instead (for a physics
    operator it is usually known, e.g. ``tfim_zz_diagonal``), and
    neither has a row-sharded operator (TypeError, as the JAX function
    raises for a type it does not know)."""
    op = as_operator(op)
    if isinstance(op, DenseOperator):
        return torch.diagonal(op.a)
    if isinstance(op, _TripletOperator):
        rows, cols, vals = op._triplets()
        on_diag = torch.where(rows == cols, vals, torch.zeros_like(vals))
        return vals.new_zeros(op.n).index_add(0, rows, on_diag)
    if isinstance(op, BellOperator):
        return torch.diagonal(_bell_diag_blocks(op), dim1=1,
                              dim2=2).reshape(-1)
    if isinstance(op, ShiftedOperator):
        # A - shift I, not A + shift I.
        return operator_diagonal(op.op) - op.shift
    if isinstance(op, ScaledOperator):
        return op.c * operator_diagonal(op.op)
    if isinstance(op, SumOperator):
        return operator_diagonal(op.a) + operator_diagonal(op.b)
    raise TypeError(
        f"no structural diagonal for {type(op).__name__}; pass an explicit "
        "diag= tensor to the preconditioner constructor")


def _bell_diag_blocks(op: BellOperator) -> torch.Tensor:
    """(nb, bs, bs) diagonal blocks of a blocked-ELL operator, in its
    compute dtype: the sum of the slots with ``cols[i, j] == i`` (padding
    slots point at column 0 with zero blocks, so block-row 0's add
    nothing).  Only those slots are upcast; the values are not copied."""
    nb = op.vals.shape[0]
    rows, slots = torch.nonzero(
        op.cols == torch.arange(nb, dtype=op.cols.dtype,
                                device=op.cols.device)[:, None],
        as_tuple=True)
    blocks = torch.zeros((nb, *op.vals.shape[2:]), dtype=op.compute_dtype,
                         device=op.vals.device)
    return blocks.index_add_(0, rows,
                             op.vals[rows, slots].to(op.compute_dtype))


def _apply_columns(f):
    """Lift a vector apply ``(N,) -> (N,)`` to also take (N, m) blocks,
    column by column (LOBPCG and the batched CG hand a preconditioner a
    block)."""
    def apply(r):
        if r.ndim == 2:
            return torch.vmap(f, in_dims=1, out_dims=1)(r)
        return f(r)

    return apply


def _constant(t):
    """``t`` (a float or a tensor) without a graph: a preconditioner is
    a constant of the solves it serves."""
    return t.detach() if isinstance(t, torch.Tensor) else t


def _inverse_magnitudes(w, floor_rel):
    """``1 / max(|w|, floor_rel max|w| + tiny)``, or ones where every
    ``w`` is zero (nothing to precondition with: the identity, not
    1/tiny = inf)."""
    aw = torch.abs(w)
    if floor_rel is None:
        floor_rel = float(torch.finfo(aw.dtype).eps) ** 0.5
    scale = torch.max(aw)
    return torch.where(
        scale > 0,
        1.0 / torch.clamp(aw, min=floor_rel * scale
                          + torch.finfo(aw.dtype).tiny),
        torch.ones_like(aw))


def _rank_rows(op, t, what):
    """The rows of the whole ``t`` that this rank's vectors hold, for an
    ``op`` whose vectors are sharded (``t`` itself otherwise)."""
    layout = vector_layout(op)
    if layout is None:
        return t
    if t.shape[0] != layout.dim:
        raise ValueError(f"{what} has {t.shape[0]} rows; over vectors "
                         f"sharded over ranks pass the whole {layout.dim} "
                         f"(each rank keeps its own rows)")
    return layout.rows(t)


def jacobi_precond(op=None, *, diag=None, shift=0.0, floor_rel=None):
    """Diagonal (Jacobi) preconditioner ``z = r / max(|d - shift|,
    floor)``.

    ``d`` is read from ``op`` (:func:`operator_diagonal`) or given as
    ``diag``.  ``shift`` targets a shifted system: pass (an estimate of)
    the eigenvalue for the eigensolver's deflated ``(A - λ)`` solves.
    The magnitude and the relative floor (default ``sqrt(eps)`` of the
    diagonal's dtype, times its largest entry) keep it SPD where
    ``A - shift`` is indefinite; an all-zero shifted diagonal gives the
    identity.  Useful where the diagonal carries the conditioning.
    Over sharded vectors pass the whole ``diag``; each rank applies its
    own rows of the result.
    """
    if diag is None:
        if op is None:
            raise ValueError("need an operator or an explicit diag=")
        diag = operator_diagonal(op)
    inv = _inverse_magnitudes(_constant(torch.as_tensor(diag))
                              - _constant(shift), floor_rel)
    inv = _rank_rows(op, inv, "diag")
    return _apply_columns(lambda r: inv.to(r.dtype) * r)


def block_jacobi_precond(op=None, *, blocks=None, bs: int | None = None,
                         shift=0.0, floor_rel=None):
    """Block-Jacobi preconditioner ``z_i = |D_i - shift|^{-1} r_i`` per
    block-row ``i``, from the (bs, bs) diagonal blocks of a
    :class:`BellOperator`, of a :class:`DenseOperator` cut at ``bs``, or
    an explicit (nb, bs, bs) ``blocks``.

    SPD by construction: the shifted blocks are symmetrized,
    eigendecomposed in one batched ``eigh`` and rebuilt as
    ``V |w|^{-1} V^T`` with the magnitudes floored as in
    :func:`jacobi_precond`.  Each apply is one batched (bs, bs) product.
    Over sharded vectors pass the whole ``blocks``; each rank applies its
    own block-rows, which must be whole blocks (ValueError otherwise).
    """
    if blocks is None:
        if op is None:
            raise ValueError("need an operator or explicit blocks=")
        op = as_operator(op)
        if isinstance(op, BellOperator):
            blocks = _bell_diag_blocks(op)
        elif isinstance(op, DenseOperator):
            if bs is None:
                raise ValueError("dense block-Jacobi needs bs=")
            n = op.dim
            if n % bs:
                raise ValueError(f"dim {n} not divisible by bs={bs}")
            nb = n // bs
            idx = torch.arange(nb, device=op.device)
            blocks = op.a.reshape(nb, bs, nb, bs)[idx, :, idx, :]
        else:
            raise TypeError(
                f"no structural diagonal blocks for {type(op).__name__}; "
                "pass explicit blocks=")
    blocks = _constant(torch.as_tensor(blocks))
    nb, bsz, _ = blocks.shape
    d = blocks - _constant(shift) * torch.eye(bsz, dtype=blocks.dtype,
                                              device=blocks.device)
    w, v = torch.linalg.eigh((d + d.transpose(1, 2)) / 2)
    inv_w = _inverse_magnitudes(w, floor_rel)
    minv = torch.einsum("nij,nj,nkj->nik", v, inv_w, v)
    layout = vector_layout(op)
    if layout is not None:
        if layout.local_dim % bsz or layout.offset % bsz:
            raise ValueError(
                f"the rank's {layout.local_dim} rows are not a whole number "
                f"of {bsz}-row blocks")
        if nb * bsz != layout.dim:
            raise ValueError(f"blocks cover {nb * bsz} rows; over vectors "
                             f"sharded over ranks pass the whole "
                             f"{layout.dim}")
        nb = layout.local_dim // bsz
        minv = minv.narrow(0, layout.offset // bsz, nb)

    def apply_vec(r):
        z = torch.einsum("nij,nj->ni", minv.to(r.dtype), r.reshape(nb, bsz))
        return z.reshape(r.shape)

    return _apply_columns(apply_vec)
