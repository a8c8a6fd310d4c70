"""Row-sharded blocked-ELL sparse operator (BASELINE config #5 as written).

Counterpart of ``RowShardedBellOperator`` in
``dominantsparseeigenad_tpu/parallel/sharded_sparse.py``, its
``mode="all_gather"``.  The global blocked-ELL matrix

    vals : (nb, max_blk, bs, bs)   cols : (nb, max_blk) global block-columns

is split by block-rows over the ranks of a :class:`~.mesh.ShardGroup`:
rank d keeps block-rows ``[d*nb_l, (d+1)*nb_l)``, a rectangular panel of
nb_l block-rows against all nb block-columns.

Layout: values are sharded, Krylov vectors are replicated.  Every rank
holds the whole x; ``matvec`` runs the rank's panel on it (on the card,
the hand-written SpMV kernel on a row panel, K4a) and all-gathers the
panel outputs into the whole y.  That moves the same N·4 bytes per
product as the JAX package's ``all_gather`` of x, and it leaves the
solvers (``ops/lanczos.py``, ``ops/cg.py``, ``ops/lobpcg.py``,
``ops/eigh.py``) as they are: their dots and norms need no reduction
over ranks.  What bounds the size is the values (4.57 GB in float32 at
config #5, against 2 MB for a vector), and those are split.  ``matmat``
does the same over an (N, r) block, on the SpMM kernel.

Lockstep.  The solvers read scalars on the host (β in Lanczos, the CG
residual every 10 iterations, the LOBPCG residual) and branch on them;
every rank must take the same branch.  They do, because every rank
starts from the same vectors (the default generators are seeded alike)
and the gathered y is bitwise the same on every rank, so every rank
computes bitwise the same numbers.

Gradients.  ``parameters()`` is the rank's panel.  The gather's backward
returns the rank's own rows of the gradient (``collectives.py``), so the
IFT rule of ``ops/eigh.py`` gives each rank ∂L/∂(its panel); the panels,
concatenated in rank order, are the gradient with respect to the global
``vals``.

Forward mode: the tangent products run the same panel kernels on the
tangent of the panel.  The collectives' backwards are differentiable, so
derivatives of any order go through the operator.

Complex values run as on a square ``BellOperator``: a complex64 panel
on the card runs the complex kernels (K5, K6) on the rank's rows, the
gather and the all-reduce carry complex tensors, a real vector meeting a
complex operator is promoted, and ``rmatvec`` stays the bilinear A^T (a
complex Hermitian operator is built with ``symmetric=False``).

The ``ring`` mode (the vector hops rank to rank, never whole on one
rank) needs sharded vectors and is not ported (``ROADMAP.md``).
"""

from __future__ import annotations

import math

import torch

from ..ops.bell_spmv import _bell_rmatmat_torch, bell_spmm, bell_spmv
from ..ops.operators import LinearOperator, promote_to
from .collectives import gather_rows, replicate, sum_over_ranks
from .mesh import make_mesh


def _check_mode(mode):
    if mode == "ring":
        raise NotImplementedError(
            "mode='ring' needs vectors sharded over the ranks and is not "
            "ported yet (ROADMAP.md, queue 1 item 14); use 'all_gather'")
    if mode != "all_gather":
        raise ValueError(f"unknown mode {mode!r}")


class RowShardedBellOperator(LinearOperator):
    """Blocked-ELL operator whose block-rows are split over ranks.

    vals, cols : the GLOBAL (nb, max_blk, bs, bs) values and (nb, max_blk)
        block-column indices, as every rank holds them; the rank keeps a
        copy of its block-rows (gradients flow back into ``vals`` where
        it requires them).
    n     : global dimension, nb * bs.
    group : the :class:`~.mesh.ShardGroup` (default :func:`~.mesh.make_mesh`).
    mode  : "all_gather" ("ring" raises NotImplementedError).
    symmetric : ``rmatvec``/``rmatmat`` alias ``matvec``/``matmat``.
    compute_dtype : dtype of the vectors (float32 for bfloat16 values).

    The panels bind no slot plan: band offsets are defined on the square
    ring, and JAX drops the plan on a row panel, so they run the gather
    kernels.
    """

    def __init__(self, vals, cols, n: int, group=None, *,
                 mode: str = "all_gather", symmetric: bool = False,
                 compute_dtype=None):
        _check_mode(mode)
        if vals.ndim != 4:
            raise ValueError(f"vals must be (nb, max_blk, bs, bs), got "
                             f"{tuple(vals.shape)}")
        nb, max_blk, bs, bs2 = vals.shape
        if bs != bs2:
            raise ValueError(f"blocks must be square, got ({bs}, {bs2})")
        if nb * bs != int(n):
            raise ValueError(f"nb*bs = {nb * bs} != n = {n}")
        if tuple(cols.shape) != (nb, max_blk):
            raise ValueError(f"cols must be {(nb, max_blk)}, got "
                             f"{tuple(cols.shape)}")
        if cols.device != vals.device:
            raise ValueError(f"cols on {cols.device}, vals on {vals.device}")
        sg = make_mesh() if group is None else group
        if nb % sg.size:
            raise ValueError(f"{nb} block-rows not divisible by {sg.size} "
                             f"shards")
        # The kernels trust the indices: check the range once, here.
        if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= nb):
            raise ValueError(f"cols must lie in [0, {nb})")
        nb_l = nb // sg.size
        rows = slice(sg.rank * nb_l, (sg.rank + 1) * nb_l)
        if compute_dtype is None:
            compute_dtype = (torch.float32 if vals.dtype == torch.bfloat16
                             else vals.dtype)
        self._init_panel(vals[rows].clone(),
                         cols[rows].to(torch.int32).contiguous(), int(n), sg,
                         bool(symmetric), compute_dtype)

    def _init_panel(self, vals, cols, n, group, symmetric, compute_dtype):
        self.vals = vals            # (nb_l, max_blk, bs, bs), this rank's
        self.cols = cols            # (nb_l, max_blk), global block-columns
        self.n = n
        self.group = group
        self.symmetric = symmetric
        self.compute_dtype = compute_dtype

    @classmethod
    def from_bell(cls, op, group=None, **kw):
        """Shard a single-device :class:`~..ops.sparse.BellOperator`."""
        kw.setdefault("symmetric", op.symmetric)
        kw.setdefault("compute_dtype", op.compute_dtype)
        return cls(op.vals, op.cols, op.n, group, **kw)

    def with_vals(self, vals):
        """Copy with this rank's panel replaced by ``vals`` (same shape,
        same pattern), e.g. a leaf tensor to differentiate into."""
        if tuple(vals.shape) != tuple(self.vals.shape):
            raise ValueError(f"panel must be {tuple(self.vals.shape)}, got "
                             f"{tuple(vals.shape)}")
        new = type(self).__new__(type(self))
        new._init_panel(vals, self.cols, self.n, self.group, self.symmetric,
                        self.compute_dtype)
        return new

    def astype_vals(self, dtype):
        """Copy with the panel cast to ``dtype`` (e.g. bfloat16)."""
        return self.with_vals(self.vals.to(dtype))

    # -- products ----------------------------------------------------------

    def _rows(self, x):
        """This rank's rows of a replicated vector or block."""
        nb_l, _, bs, _ = self.vals.shape
        return x.narrow(0, self.group.rank * nb_l * bs, nb_l * bs)

    def _apply(self, vals, X):
        """``A(vals) X`` for X (N,) or (N, r): the panel product of the
        rank's rows (on the card the panel SpMV or SpMM kernel, K4a, or
        the complex ones on a complex panel), then the gather of the row
        blocks."""
        product = bell_spmv if X.ndim == 1 else bell_spmm
        X = promote_to(X, self.compute_dtype)
        return gather_rows(product(vals, self.cols, replicate(X, self.group)),
                           self.group)

    def _apply_t(self, vals, X):
        """``A(vals)^T X``: the alias of :meth:`_apply` when symmetric;
        else the panel's transpose scattered onto all nb block-columns,
        summed over ranks (the JAX package's psum_scatter, replicated)."""
        if self.symmetric:
            return self._apply(vals, X)
        X = promote_to(X, self.compute_dtype)
        block = X if X.ndim == 2 else X[:, None]
        part = _bell_rmatmat_torch(vals, self.cols,
                                   self._rows(replicate(block, self.group)),
                                   self.n // self.block_size)
        out = sum_over_ranks(part, self.group)
        return out if X.ndim == 2 else out[:, 0]

    def matvec(self, x):
        return self._apply(self.vals, x)

    def rmatvec(self, x):
        return self._apply_t(self.vals, x)

    matmat, rmatmat = matvec, rmatvec

    def tangent_matvec(self, x, dparams):
        """``(dA) x``: the same panel product on the tangent of the panel."""
        (dvals,) = dparams
        return self._apply(dvals.contiguous(), x)

    def tangent_rmatvec(self, x, dparams):
        (dvals,) = dparams
        return self._apply_t(dvals.contiguous(), x)

    tangent_matmat, tangent_rmatmat = tangent_matvec, tangent_rmatvec

    def parameters(self):
        return [self.vals]

    def with_parameters(self, tensors):
        (vals,) = tensors
        return self.with_vals(vals)

    @property
    def dim(self):
        return self.n

    @property
    def dtype(self):
        # The compute dtype, which Krylov vectors and reductions use.
        return self.compute_dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def block_size(self):
        return self.vals.shape[-1]

    @property
    def nnz(self):
        """Stored entries of the whole operator, padding blocks included."""
        return math.prod(self.vals.shape) * self.group.size
