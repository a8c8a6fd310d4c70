"""Sparse operators: COO, CSR and BCOO triplets, and blocked-ELL.

Counterpart of ``dominantsparseeigenad_tpu/ops/sparse.py``.

* :class:`COOOperator`, :class:`CSROperator` and :class:`BCOOOperator`
  store (row, column, value) triplets (CSR derives its row of each entry
  from ``indptr`` once, at construction) and share one product, a gather
  and a segment sum, ``zeros(n).index_add(0, rows, vals * x[cols])``, as
  the JAX operators' ``segment_sum`` and ``BCOO @ x`` are.  No Pallas
  kernel is on these paths in the JAX package, so none is owed here; on
  CUDA, ``index_add`` adds with atomics, so the order of a row's sum (and
  its last bits) may change from one call to the next.  The index arrays
  are int32 constants; the values are the operator's one parameter, and
  the product is plain differentiable PyTorch (both AD modes, any order,
  ``torch.func.vmap``).  ``BCOOOperator`` builds no sparse tensor on its
  products (a sparse COO tensor has no forward-mode AD): ``.mat`` is made
  when it is read, for interop.
* :class:`BellOperator`: the device decides the product's path: on a
  CUDA tensor every matvec launches the hand-written kernel of
  ``bell_spmv`` and every matmat the one of ``bell_spmm``, on a CPU
  tensor they take the plain versions.  An operator whose slots are ring
  bands (``random_bell_operator``'s all are) binds the banded slot plan,
  so its products run the kernels' banded mode, as the JAX operator's
  run the banded Pallas kernel.  Complex values (complex64 on the card:
  K5 and K6) go through the same paths.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from .bell_spmv import (_band_offsets, _bell_product, _bell_rmatmat_torch,
                        _slot_plan_matches, detect_slot_plan)
from .operators import (LinearOperator, outside_transforms, promote_to,
                        resolve_device)


def _segment_product(vals, src, dst, x, n):
    """``y[dst[j]] += vals[j] x[src[j]]`` over the entries j, for ``x`` of
    shape (N,) or (N, m): the triplet formats' product (``A x`` with
    ``(src, dst) = (cols, rows)``, ``A^T x`` with them swapped).  Out of
    place, so it differentiates in both modes and batches under
    ``torch.func.vmap``."""
    prod = (vals[:, None] if x.ndim == 2 else vals) * x[src]
    return prod.new_zeros((n, *x.shape[1:])).index_add(0, dst, prod)


def _plain_index(t):
    """An index tensor as a plain int32 tensor.  One made under a
    ``torch.func`` grad or jvp level (even by ``arange``) is that level's
    wrapper, which the derivative rules, run one level down, cannot read
    from the operator; converted with the levels popped it is the plain
    tensor beneath (an integer tensor carries no tangent)."""
    with outside_transforms():
        return t.to(torch.int32)


def _index_tensor(a, dev):
    return torch.as_tensor(np.asarray(a, np.int32), device=dev)


def _nonzero_triplets(a, tol):
    """``(rows, cols, vals)`` of the entries of the dense square ``a`` (a
    tensor or an array) with ``|a_ij| > tol``, row-major."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected square matrix, got shape {a.shape}")
    rows, cols = np.nonzero(np.abs(a) > tol)
    return rows, cols, a[rows, cols]


class _TripletOperator(LinearOperator):
    """Products of a sparse operator stored as (row, column, value)
    triplets; a subclass gives :meth:`_triplets` ``(rows, cols, vals)``,
    the size ``n``, :meth:`parameters` (the values) and
    :meth:`with_parameters`."""

    def _triplets(self):
        raise NotImplementedError

    def matvec(self, x):
        rows, cols, vals = self._triplets()
        return _segment_product(vals, cols, rows, x, self.n)

    def rmatvec(self, x):
        rows, cols, vals = self._triplets()
        return _segment_product(vals, rows, cols, x, self.n)

    matmat = matvec
    rmatmat = rmatvec

    def tangent_matvec(self, x, dparams):
        """``(dA) x``: the same product on the tangent values."""
        rows, cols, _ = self._triplets()
        (dvals,) = dparams
        return _segment_product(dvals, cols, rows, x, self.n)

    tangent_matmat = tangent_matvec

    def tangent_rmatvec(self, x, dparams):
        rows, cols, _ = self._triplets()
        (dvals,) = dparams
        return _segment_product(dvals, rows, cols, x, self.n)

    tangent_rmatmat = tangent_rmatvec

    def to_dense(self):
        rows, cols, vals = self._triplets()
        return vals.new_zeros((self.n, self.n)).index_put(
            (rows.long(), cols.long()), vals, accumulate=True)

    @property
    def dim(self):
        return self.n

    @property
    def dtype(self):
        return self._triplets()[2].dtype

    @property
    def device(self):
        return self._triplets()[2].device

    @property
    def nnz(self):
        return self._triplets()[2].shape[0]


class COOOperator(_TripletOperator):
    """COO sparse operator: entry j is ``vals[j]`` at ``(rows[j],
    cols[j])``; duplicates add.  The product is a gather and a segment
    sum (``index_add``)."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, n: int):
        self.rows = _plain_index(rows)
        self.cols = _plain_index(cols)
        self.vals = vals
        self.n = int(n)

    def _triplets(self):
        return self.rows, self.cols, self.vals

    def parameters(self):
        return [self.vals]

    def with_parameters(self, tensors):
        (vals,) = tensors
        op = copy.copy(self)
        op.vals = vals
        return op

    @classmethod
    def from_dense(cls, a, *, tol: float = 0.0, device=None):
        """The entries of the dense (N, N) ``a`` with ``|a_ij| > tol``,
        read on the host and moved to ``device``."""
        dev = resolve_device(device)
        rows, cols, vals = _nonzero_triplets(a, tol)
        return cls(_index_tensor(rows, dev), _index_tensor(cols, dev),
                   torch.from_numpy(vals).to(dev), a.shape[0])


class CSROperator(_TripletOperator):
    """CSR sparse operator (``indptr``, ``indices``, ``data``).  The row
    of each entry is derived from ``indptr`` once, here, by
    ``torch.searchsorted`` (no host read, so an operator may be built
    under a transform), unless given as ``rows``; the products are COO's
    on ``(rows, indices, data)``."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, n: int, rows: torch.Tensor | None = None):
        self.indptr = _plain_index(indptr)
        self.indices = _plain_index(indices)
        self.data = data
        self.n = int(n)
        if rows is None:
            # The row of entry j: the row boundaries at or before j.
            rows = torch.searchsorted(
                self.indptr, torch.arange(self.indices.shape[0],
                                          dtype=torch.int32,
                                          device=self.indptr.device),
                right=True, out_int32=True) - 1
        self._rows = _plain_index(rows)

    def _triplets(self):
        return self._rows, self.indices, self.data

    def parameters(self):
        return [self.data]

    def with_parameters(self, tensors):
        (data,) = tensors
        op = copy.copy(self)
        op.data = data
        return op

    def to_coo(self) -> COOOperator:
        return COOOperator(self._rows, self.indices, self.data, self.n)

    @classmethod
    def from_dense(cls, a, *, tol: float = 0.0, device=None):
        """The entries of the dense (N, N) ``a`` with ``|a_ij| > tol``, in
        row-major order, read on the host and moved to ``device``."""
        dev = resolve_device(device)
        rows, cols, vals = _nonzero_triplets(a, tol)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        n = len(a)
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        return cls(_index_tensor(np.cumsum(indptr), dev),
                   _index_tensor(cols, dev), torch.from_numpy(vals).to(dev),
                   n, _index_tensor(rows, dev))

    @classmethod
    def from_scipy(cls, m, *, device=None):
        """From any scipy.sparse matrix, as canonical CSR (duplicates
        summed)."""
        if m.shape[0] != m.shape[1]:
            # Square only: a rectangular one would index out of range.
            raise ValueError(f"CSROperator is square-only, got {m.shape}")
        dev = resolve_device(device)
        m = m.tocsr()
        m.sum_duplicates()
        return cls(_index_tensor(m.indptr, dev), _index_tensor(m.indices, dev),
                   torch.from_numpy(np.array(m.data)).to(dev), m.shape[0])


class BCOOOperator(_TripletOperator):
    """Operator on a sparse COO tensor (the counterpart of the JAX
    operator on ``jax.experimental.sparse.BCOO``).  ``mat`` is a dense
    square tensor or a ``torch.sparse_coo_tensor``; its coalesced
    indices (as int32) and values are kept, the values its parameter.
    The products run on them as COO's do, not through ``torch.sparse``
    (no forward-mode AD, and a loop per lane under ``vmap``)."""

    def __init__(self, mat: torch.Tensor):
        if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
            raise ValueError(f"expected square matrix, got shape "
                             f"{tuple(mat.shape)}")
        if not mat.is_sparse:
            mat = mat.to_sparse()
        mat = mat.coalesce()
        self.indices = _plain_index(mat.indices())        # (2, nnz)
        self.values = mat.values()
        self.n = int(mat.shape[0])

    @property
    def mat(self) -> torch.Tensor:
        """The coalesced sparse COO tensor (for interop; no product uses
        it)."""
        return torch.sparse_coo_tensor(
            self.indices.long(), self.values, (self.n, self.n),
            is_coalesced=True, check_invariants=False)

    def _triplets(self):
        return self.indices[0], self.indices[1], self.values

    def parameters(self):
        return [self.values]

    def with_parameters(self, tensors):
        (values,) = tensors
        op = copy.copy(self)
        op.values = values
        return op


class BellOperator(LinearOperator):
    """Blocked-ELLPACK sparse operator.

    ``vals[i, j]`` is the dense (bs, bs) block at block-row ``i``,
    block-column ``cols[i, j]``; slots past a row's real block count are
    zero blocks pointing at column 0.

    Narrow-values tier: ``vals`` may be stored in bfloat16.  Vectors stay
    in ``compute_dtype`` (float32 by default for bf16 storage) and the
    blocks are upcast at the product, so the only rounding is storage,
    ``||δA|| <= 2^-8 ||A||`` once at write time.

    Complex values (complex64 on the card, where the products run the
    kernels K5 and K6; complex128 on the CPU): ``compute_dtype`` defaults
    to ``vals.dtype``, and real values with a complex ``compute_dtype``
    multiply complex vectors (on the card, the real kernels on the
    vectors' real and imaginary parts).  A real vector given to a complex
    operator is promoted to ``compute_dtype``.  ``symmetric=True`` means
    A^T = A (``rmatvec`` is ``matvec``), as in the JAX package; ``rmatvec``
    is the bilinear A^T x.  A complex Hermitian operator is not symmetric
    in that sense: build it with ``symmetric=False``.

    ``slot_plan`` (JAX's): "auto" detects the banded slot plan from
    ``cols`` (``bell_spmv.detect_slot_plan``), None forces the gather
    kernels, and an explicit tuple is checked against ``cols`` and
    dropped (None) if it does not match or has the wrong length.  The
    check reads ``cols`` to the host once, here, beside the range check;
    the products never read it back.
    """

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, n: int, *,
                 symmetric: bool = False, compute_dtype=None,
                 slot_plan="auto"):
        if vals.ndim != 4 or vals.shape[2] != vals.shape[3]:
            raise ValueError(f"vals must be (nb, max_blk, bs, bs), got "
                             f"{tuple(vals.shape)}")
        nb, max_blk, bs, _ = vals.shape
        if nb * bs != int(n):
            raise ValueError(f"n={n} is not nb*bs={nb * bs}")
        if tuple(cols.shape) != (nb, max_blk):
            raise ValueError(f"cols must be {(nb, max_blk)}, got "
                             f"{tuple(cols.shape)}")
        if cols.device != vals.device:
            raise ValueError(f"cols on {cols.device}, vals on {vals.device}")
        cols = cols.to(torch.int32)
        # The kernel trusts the indices: check the range once, here, on
        # one host copy, which also gives the slot plan.
        host = cols.cpu().numpy()
        if host.size and (host.min() < 0 or host.max() >= nb):
            raise ValueError(f"cols must lie in [0, {nb})")
        if isinstance(slot_plan, str):
            if slot_plan != "auto":
                raise ValueError(f"slot_plan must be 'auto', None or a "
                                 f"tuple, got {slot_plan!r}")
            slot_plan = detect_slot_plan(host, nb)
        elif slot_plan is not None:
            slot_plan = tuple((str(kind), int(o)) for kind, o in slot_plan)
            if len(slot_plan) != max_blk or not _slot_plan_matches(
                    host, nb, slot_plan):
                slot_plan = None
        if compute_dtype is None:
            compute_dtype = (torch.float32 if vals.dtype == torch.bfloat16
                             else vals.dtype)
        self.vals = vals
        self.cols = cols
        self.n = int(n)
        self.symmetric = bool(symmetric)
        self.compute_dtype = compute_dtype
        self.slot_plan = slot_plan
        if slot_plan is not None and vals.device.type == "cuda":
            _band_offsets(slot_plan, nb, vals.device)   # built once, here

    @classmethod
    def from_dense(cls, a, bs: int = 128, *, symmetric: bool = False,
                   device=None):
        """The nonzero (bs, bs) blocks of the dense (N, N) ``a``; built on
        the host, then moved to ``device``."""
        dev = resolve_device(device)
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
        n = a.shape[0]
        if n % bs:
            raise ValueError(f"dim {n} not divisible by block size {bs}")
        nb = n // bs
        blocks = a.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
        keep = np.abs(blocks).max(axis=(2, 3)) > 0         # (nb, nb)
        max_blk = max(int(keep.sum(axis=1).max()), 1)
        vals = np.zeros((nb, max_blk, bs, bs), a.dtype)
        cols = np.zeros((nb, max_blk), np.int32)
        for i in range(nb):
            js = np.nonzero(keep[i])[0]
            vals[i, : len(js)] = blocks[i, js]
            cols[i, : len(js)] = js
        return cls(torch.from_numpy(vals).to(dev),
                   torch.from_numpy(cols).to(dev), n, symmetric=symmetric)

    def _apply(self, vals, X):
        """``A(vals) X`` for X (N,) or (N, r), a real X promoted to a
        complex compute dtype (on a CUDA tensor the kernel, banded under
        the plan)."""
        return _bell_product(vals, self.cols,
                             promote_to(X, self.compute_dtype),
                             self.slot_plan)

    def _apply_t(self, vals, X):
        """``A(vals)^T X``, the bilinear transpose: the alias of
        :meth:`_apply` when symmetric, else a scatter-transpose in plain
        PyTorch (off the Lanczos loop)."""
        if self.symmetric:
            return self._apply(vals, X)
        X = promote_to(X, self.compute_dtype)
        block = X if X.ndim == 2 else X[:, None]
        out = _bell_rmatmat_torch(vals, self.cols, block, self.vals.shape[0])
        return out if X.ndim == 2 else out[:, 0]

    def matvec(self, x):
        if x.ndim != 1:
            raise ValueError(f"matvec takes x of shape (N,), got "
                             f"{tuple(x.shape)}")
        return self._apply(self.vals, x)

    def rmatvec(self, x):
        return self._apply_t(self.vals, x)

    def matmat(self, X):
        """``A @ X`` for an (N, r) block: one SpMM streams the values once
        for all r columns (what the block solvers call)."""
        if X.ndim != 2:
            raise ValueError(f"matmat takes X of shape (N, r), got "
                             f"{tuple(X.shape)}")
        return self._apply(self.vals, X)

    def tangent_matvec(self, x, dparams):
        """``(dA) x = A(dvals) x``: the same product on the tangent values
        (on a CUDA tensor the kernel, banded under the plan)."""
        (dvals,) = dparams
        return self._apply(dvals.contiguous(), x)

    def tangent_matmat(self, X, dparams):
        """``(dA) X = A(dvals) X``: one SpMM on the tangent values (on a
        CUDA tensor the kernel, banded under the plan)."""
        return self.tangent_matvec(X, dparams)

    def tangent_rmatvec(self, x, dparams):
        """``(dA)^T x = A(dvals)^T x`` (plain PyTorch, as :meth:`rmatvec`)."""
        (dvals,) = dparams
        return self._apply_t(dvals.contiguous(), x)

    def tangent_rmatmat(self, X, dparams):
        """``(dA)^T X`` (plain PyTorch, as :meth:`rmatmat`)."""
        return self.tangent_rmatvec(X, dparams)

    def rmatmat(self, X):
        return self._apply_t(self.vals, X)

    def parameters(self):
        return [self.vals]

    def with_parameters(self, tensors):
        (vals,) = tensors
        return self.with_vals(vals)

    def to_dense(self):
        """Dense (N, N) matrix in the compute dtype (test helper)."""
        nb, max_blk, bs, _ = self.vals.shape
        rows = torch.arange(nb, device=self.vals.device)[:, None].expand(
            nb, max_blk)
        dense = torch.zeros(nb, nb, bs, bs, dtype=self.compute_dtype,
                            device=self.vals.device)
        dense = dense.index_put((rows, self.cols.long()),
                                self.vals.to(self.compute_dtype),
                                accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(self.n, self.n)

    def astype_vals(self, dtype):
        """Copy with the block values cast to ``dtype`` (e.g. bfloat16);
        Krylov vectors keep ``compute_dtype``."""
        return self.with_vals(self.vals.to(dtype))

    def with_vals(self, vals):
        """Copy with new block values on the same sparsity pattern,
        keeping every setting (compute dtype, slot plan); ``cols`` is not
        checked again."""
        if tuple(vals.shape) != tuple(self.vals.shape):
            raise ValueError(f"vals must be {tuple(self.vals.shape)}, got "
                             f"{tuple(vals.shape)}")
        if vals.device != self.vals.device:
            raise ValueError(f"vals on {vals.device}, cols on "
                             f"{self.cols.device}")
        op = copy.copy(self)
        op.vals = vals
        return op

    @property
    def dim(self):
        return self.n

    @property
    def dtype(self):
        # The compute dtype, which Lanczos vectors and reductions use.
        return self.compute_dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def block_size(self):
        return self.vals.shape[-1]

    @property
    def nnz(self):
        """Stored entries, padding blocks included."""
        return math.prod(self.vals.shape)


def random_bell_operator(n: int, bs: int, blocks_per_row: int, *,
                         generator: torch.Generator | None = None,
                         dtype=torch.float32, vals_dtype=None,
                         device=None) -> BellOperator:
    """Synthetic symmetric block-banded operator (BASELINE config #5).

    The structure is the JAX ``random_bell_operator``'s exactly: the
    diagonal block (symmetrized) plus pairs of bands at offsets ±o drawn
    from ``np.random.default_rng(7)``, the -o band the transpose of the +o
    band, entries scaled by ``1/sqrt(blocks_per_row * bs)``.  A complex
    ``dtype`` gives a complex symmetric operator (A^T = A, not Hermitian),
    as JAX's does.  So ``cols``
    equals the JAX operator's, and every slot is a ring band: the
    operator binds an all-band slot plan.  The values come from ``generator`` (seeded
    0 on the device when None) and are made on the device, one band at a
    time.
    """
    if blocks_per_row % 2 == 0:
        raise ValueError("blocks_per_row must be odd (diag + ± band pairs)")
    nb = n // bs
    if nb * bs != n:
        raise ValueError(f"dim {n} not divisible by block size {bs}")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    n_off = (blocks_per_row - 1) // 2
    rng = np.random.default_rng(7)
    offs = (rng.permutation(np.arange(1, nb))[:n_off]
            if nb > 1 else np.zeros(0, np.int64))
    n_off = len(offs)

    scale = float(1.0 / np.sqrt((1 + 2 * n_off) * bs))
    i = np.arange(nb)
    cols = [i]
    vals = torch.empty((nb, 1 + 2 * n_off, bs, bs), dtype=dtype, device=dev)
    band = torch.empty((nb, bs, bs), dtype=dtype, device=dev)
    torch.randn(band.shape, generator=generator, out=band)
    band.mul_(scale)
    vals[:, 0] = (band + band.transpose(-1, -2)) / 2
    for o_idx, o in enumerate(offs):
        torch.randn(band.shape, generator=generator, out=band)
        band.mul_(scale)
        # +o band: block B_i at (i, (i+o) % nb)
        vals[:, 1 + 2 * o_idx] = band
        cols.append((i + o) % nb)
        # -o band: block at (i, (i-o) % nb) = B_{(i-o) % nb}^T
        src = (i - o) % nb
        vals[:, 2 + 2 * o_idx] = band[torch.from_numpy(src).to(dev)] \
            .transpose(-1, -2)
        cols.append(src)
    del band
    cols = torch.from_numpy(np.stack(cols, axis=1).astype(np.int32)).to(dev)
    op = BellOperator(vals, cols, n, symmetric=True)
    if vals_dtype is not None:
        op = op.astype_vals(vals_dtype)
    return op
