"""Row-sharded blocked-ELL sparse operator (BASELINE config #5 as written).

Counterpart of ``RowShardedBellOperator`` in
``dominantsparseeigenad_tpu/parallel/sharded_sparse.py``, both modes.
The global blocked-ELL matrix

    vals : (nb, max_blk, bs, bs)   cols : (nb, max_blk) global block-columns

is split by block-rows over the ranks of a :class:`~.mesh.ShardGroup`:
rank d keeps block-rows ``[d*nb_l, (d+1)*nb_l)``, a rectangular panel of
nb_l block-rows against all nb block-columns.

Two layouts of the Krylov vectors (``vectors=``):

* ``"replicated"`` (the default): every rank holds the whole x;
  ``matvec`` runs the rank's panel on it (on the card, the hand-written
  SpMV kernel on a row panel, K4a) and all-gathers the panel outputs
  into the whole y.  That moves the same N·4 bytes per product as the
  JAX package's ``all_gather`` of x, and it leaves the solvers as they
  are: their dots and norms need no reduction over ranks.
* ``"sharded"`` (the JAX package's ``P(axis)``): every rank holds its
  rows of x and of y, and the solvers reduce their dots over the ranks
  (``vector_layout``, ``collectives.ShardedVectors``).  In ``all_gather``
  mode a product gathers x (:func:`~.collectives.all_gather_sharded`) and
  runs the same panel kernel, with no gather of y.

``mode="ring"`` (sharded vectors only; over replicated vectors every rank
already holds the segment a ring step would send): the slots are
bucketed at construction by the offset ``o`` of the rank whose segment
their block-column lies in (JAX's ``_bucket_by_offset``, every stored
slot kept, zero blocks too); the offsets are visited in ascending
order, and between two the segment jumps ``o - prev`` ranks with one
:func:`~.collectives.ppermute`, so a rank never holds more than its own
N/p rows and the one segment in hand.  Each offset's bucket is gathered
from the panel by its slot index (plain, differentiable PyTorch),
multiplied by its padding mask, and multiplied by the segment in hand on
the same hand-written gather kernels (the SpMV for ``matvec``, the SpMM
for ``matmat``, gathering each bucket once for all r columns), counted
apart in ``ops/bell_spmv.ring_launch_counts``.  It is the memory niche,
not the throughput default: the bucket gather copies the panel's values
once per offset and product (the JAX package measured ring at 0.62–0.91x
the all_gather rate).

Lockstep.  The solvers read scalars on the host (β in Lanczos, the CG
residual every 10 iterations, the LOBPCG residual) and branch on them;
every rank must take the same branch.  They do: with replicated vectors
every rank holds bitwise the same vectors; with sharded ones every
scalar the host reads comes out of an all-reduce, the same on every
rank.

Gradients.  ``parameters()`` is the rank's panel; the IFT rule of
``ops/eigh.py`` gives each rank ∂L/∂(its panel), and the panels,
concatenated in rank order, are the gradient with respect to the global
``vals``.  Forward mode: the tangent products run the same panel (or
bucket) kernels on the tangent of the panel.  The collectives' backwards
are differentiable, so derivatives of any order go through the operator.

Complex values run as on a square ``BellOperator``: a complex64 panel
(or bucket) on the card runs the complex kernels (K5, K6), the
collectives carry complex tensors, a real vector meeting a complex
operator is promoted, and ``rmatvec`` stays the bilinear A^T (a complex
Hermitian operator is built with ``symmetric=False``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.bell_spmv import (_bell_rmatmat_torch, bell_spmm, bell_spmv,
                             ring_launches)
from ..ops.operators import LinearOperator, promote_to
from .collectives import (ShardedVectors, all_gather_sharded, gather_rows,
                          ppermute, reduce_scatter_rows, replicate,
                          sum_over_ranks)
from .mesh import make_mesh

VECTOR_LAYOUTS = ("replicated", "sharded")


def _check_mode(mode, vectors="replicated"):
    if vectors not in VECTOR_LAYOUTS:
        raise ValueError(f"vectors must be 'replicated' or 'sharded', got "
                         f"{vectors!r}")
    if mode not in ("all_gather", "ring"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "ring" and vectors != "sharded":
        raise ValueError(
            "mode='ring' needs vectors='sharded': over replicated vectors "
            "every rank already holds the segment a ring step would send")


def _bucket_by_offset(cols: np.ndarray, p: int) -> dict:
    """JAX's ``_bucket_by_offset``: ``{offset: (slot_idx, local_col,
    mask)}``, each (nb, m_o), for the offsets that occur.  Slot (i, j)
    reads the segment of rank ``cols[i, j] // nb_l``, ``o = (that - i //
    nb_l) % p`` ranks on from row i's owner; ``slot_idx`` is its slot,
    ``local_col`` its block-column within that segment, ``mask`` 0 on a
    row's padding up to m_o, the most any row of that offset holds.
    Every stored slot takes part: the format cannot tell its pad
    convention (block-column 0, a zero block) from a stored block that
    is zero now and moves later (``with_vals``, a tangent)."""
    nb, _ = cols.shape
    nb_l = nb // p
    offset = (cols // nb_l - np.arange(nb)[:, None] // nb_l) % p
    buckets = {}
    for o in range(p):
        sel = offset == o
        m_o = int(sel.sum(axis=1).max()) if nb else 0
        if m_o == 0:
            continue
        slot_idx = np.zeros((nb, m_o), np.int32)
        local_col = np.zeros((nb, m_o), np.int32)
        mask = np.zeros((nb, m_o), np.float32)
        for i in range(nb):
            js = np.nonzero(sel[i])[0]
            slot_idx[i, :len(js)] = js
            local_col[i, :len(js)] = cols[i, js] % nb_l
            mask[i, :len(js)] = 1.0
        buckets[o] = (slot_idx, local_col, mask)
    return buckets


class RowShardedBellOperator(LinearOperator):
    """Blocked-ELL operator whose block-rows are split over ranks.

    vals, cols : the GLOBAL (nb, max_blk, bs, bs) values and (nb, max_blk)
        block-column indices, as every rank holds them; the rank keeps a
        copy of its block-rows (gradients flow back into ``vals`` where
        it requires them).
    n     : global dimension, nb * bs.
    group : the :class:`~.mesh.ShardGroup` (default :func:`~.mesh.make_mesh`).
    mode  : "all_gather" or "ring" (``vectors="sharded"`` only).
    vectors : "replicated" (every rank holds whole vectors) or "sharded"
        (the rank's rows, :func:`~.sharded.shard_vector`; the solvers then
        reduce over the ranks through :attr:`vector_layout`).
    symmetric : ``rmatvec``/``rmatmat`` alias ``matvec``/``matmat``.
    compute_dtype : dtype of the vectors (float32 for bfloat16 values).

    The panels and the ring buckets bind no slot plan: band offsets are
    defined on the square ring, and JAX drops the plan on a row panel, so
    they run the gather kernels.
    """

    def __init__(self, vals, cols, n: int, group=None, *,
                 mode: str = "all_gather", symmetric: bool = False,
                 compute_dtype=None, vectors: str = "replicated"):
        _check_mode(mode, vectors)
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
        buckets = ()
        if mode == "ring":
            # Host-side, once, from the global cols (the offsets and each
            # m_o are the whole operator's, the same on every rank).
            found = _bucket_by_offset(cols.cpu().numpy(), sg.size)
            buckets = tuple(
                (o, *(torch.from_numpy(a[rows]).to(vals.device)
                      for a in found[o])) for o in sorted(found))
        self._init_panel(vals[rows].clone(),
                         cols[rows].to(torch.int32).contiguous(), int(n), sg,
                         bool(symmetric), compute_dtype, mode, vectors,
                         buckets)

    def _init_panel(self, vals, cols, n, group, symmetric, compute_dtype,
                    mode, vectors, buckets):
        self.vals = vals            # (nb_l, max_blk, bs, bs), this rank's
        self.cols = cols            # (nb_l, max_blk), global block-columns
        self.n = n
        self.group = group
        self.symmetric = symmetric
        self.compute_dtype = compute_dtype
        self.mode = mode
        self.vectors = vectors
        # Ring mode: (offset, slot_idx, local_col, mask) per active offset,
        # ascending; the rank's rows, on the device.
        self._buckets = buckets
        self.vector_layout = (ShardedVectors(group, n)
                              if vectors == "sharded" else None)

    @classmethod
    def from_bell(cls, op, group=None, **kw):
        """Shard a single-device :class:`~..ops.sparse.BellOperator`."""
        kw.setdefault("symmetric", op.symmetric)
        kw.setdefault("compute_dtype", op.compute_dtype)
        return cls(op.vals, op.cols, op.n, group, **kw)

    def with_vals(self, vals):
        """Copy with this rank's panel replaced by ``vals`` (same shape,
        same pattern, the same mode, layout and ring buckets), e.g. a leaf
        tensor to differentiate into."""
        if tuple(vals.shape) != tuple(self.vals.shape):
            raise ValueError(f"panel must be {tuple(self.vals.shape)}, got "
                             f"{tuple(vals.shape)}")
        new = type(self).__new__(type(self))
        new._init_panel(vals, self.cols, self.n, self.group, self.symmetric,
                        self.compute_dtype, self.mode, self.vectors,
                        self._buckets)
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
        """``A(vals) X`` for X (N,) or (N, r), or the rank's rows of them
        with sharded vectors: the rank's rows of the product."""
        X = promote_to(X, self.compute_dtype)
        if self.mode == "ring":
            return self._ring(vals, X)
        product = bell_spmv if X.ndim == 1 else bell_spmm
        if self.vectors == "sharded":
            # The panel product (K4a) on the gathered x; y stays the
            # rank's rows.
            return product(vals, self.cols,
                           all_gather_sharded(X, self.group))
        # The panel product (K4a) of the rank's rows, then the gather of
        # the row blocks.
        return gather_rows(product(vals, self.cols, replicate(X, self.group)),
                           self.group)

    def _ring(self, vals, X):
        """Ring mode over the rank's rows ``X``: for each active offset o,
        ascending, the segment of rank ``(me + o) % p`` in hand after one
        ``ppermute`` of ``o - prev`` ranks (shard s's segment goes to
        ``(s - delta) % p``), and the offset's bucket (its slots gathered
        from the panel, the padding masked) multiplied by it on the gather
        kernel, one launch per offset, counted as a ring launch."""
        p = self.group.size
        product = bell_spmv if X.ndim == 1 else bell_spmm
        rows = torch.arange(vals.shape[0], device=vals.device)[:, None]
        acc, seg, prev = None, X, 0
        for o, slot_idx, local_col, mask in self._buckets:
            delta = o - prev
            if delta:
                seg = ppermute(seg, self.group,
                               [(s, (s - delta) % p) for s in range(p)])
            prev = o
            bucket = vals[rows, slot_idx.long()] \
                * mask.to(vals.dtype)[:, :, None, None]
            with ring_launches():
                y = product(bucket, local_col, seg)
            acc = y if acc is None else acc + y
        return acc

    def _apply_t(self, vals, X):
        """``A(vals)^T X``: the alias of :meth:`_apply` when symmetric;
        else the panel's transpose scattered onto all nb block-columns,
        summed over ranks (the JAX package's psum_scatter, its rows for
        sharded vectors, replicated otherwise)."""
        if self.symmetric:
            return self._apply(vals, X)
        X = promote_to(X, self.compute_dtype)
        block = X if X.ndim == 2 else X[:, None]
        nb = self.n // self.block_size
        if self.vectors == "sharded":
            out = reduce_scatter_rows(
                _bell_rmatmat_torch(vals, self.cols, block, nb), self.group)
        else:
            part = _bell_rmatmat_torch(
                vals, self.cols, self._rows(replicate(block, self.group)), nb)
            out = sum_over_ranks(part, self.group)
        return out if X.ndim == 2 else out[:, 0]

    def matvec(self, x):
        return self._apply(self.vals, x)

    def rmatvec(self, x):
        return self._apply_t(self.vals, x)

    matmat, rmatmat = matvec, rmatvec

    def tangent_matvec(self, x, dparams):
        """``(dA) x``: the same panel (or bucket) products on the tangent
        of the panel."""
        (dvals,) = dparams
        return self._apply(dvals.contiguous(), x)

    def tangent_rmatvec(self, x, dparams):
        (dvals,) = dparams
        return self._apply_t(dvals.contiguous(), x)

    tangent_matmat, tangent_rmatmat = tangent_matvec, tangent_rmatvec

    @property
    def ring_offsets(self) -> tuple:
        """The active offsets of ``mode="ring"``, ascending: offset o
        means some stored block reads the segment of rank ``(me + o) %
        p``; () in ``all_gather`` mode."""
        return tuple(b[0] for b in self._buckets)

    @property
    def ring_hops(self) -> int:
        """``ppermute`` hops per ring product: one per active offset other
        than 0 (the rank's own segment needs none)."""
        return sum(1 for o in self.ring_offsets if o != 0)

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
