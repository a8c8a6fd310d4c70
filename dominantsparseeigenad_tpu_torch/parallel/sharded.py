"""Row-sharded dense and matrix-free operators.

Counterpart of ``dominantsparseeigenad_tpu/parallel/sharded.py``: the
operator's rows are split over the ranks of a :class:`~.mesh.ShardGroup`,
and its vectors are replicated (``vectors="replicated"``: each rank
computes its own rows of ``A x`` and the row blocks are all-gathered) or
sharded (``vectors="sharded"``, the JAX package's ``P(axis)``: each rank
holds its rows of x and of ``A x``, :func:`shard_vector`; the solvers
reduce their dots over the ranks through ``vector_layout``).

* :class:`RowShardedOperator`: a dense (N, N) matrix, real or complex,
  each rank's (N/p, N) rows multiplied in true fp32/fp64 (``hmatmul``;
  the JAX package leaves these products to XLA, so no kernel is owed).
  ``mode="all_gather"`` gathers x; ``mode="ring"`` (sharded vectors)
  walks the p column blocks with the segment in hand, passing it to the
  next rank with :func:`~.collectives.ppermute` (p - 1 hops: the last,
  whose segment no step reads, is skipped).
* :class:`ShardedMatrixFreeOperator`: a ``local_matvec`` written against
  the rank's segment of the vector, which may use the collectives of
  ``collectives.py`` (the sharded TFIM swaps segments between XOR
  partners with :func:`~.collectives.ppermute`).  It is the JAX contract
  exactly: over sharded vectors the segment is the rank's rows as they
  are, over replicated ones they are cut out and the results gathered.

Both carry forward mode and derivatives of any order: their tangent
products run the same collectives on the tangent, and the collectives'
backwards are differentiable.
"""

from __future__ import annotations

import copy

import torch

from ..ops.operators import LinearOperator, MatrixFreeOperator, hmatmul
from .collectives import (ShardedVectors, all_gather_sharded, gather_rows,
                          ppermute, reduce_scatter_rows, replicate,
                          sum_over_ranks)
from .mesh import SHARD_AXIS, make_mesh, row_sharding
from .sharded_sparse import _check_mode


def shard_vector(x: torch.Tensor, group=None) -> torch.Tensor:
    """The rank's rows of a global vector (or (N, r) block) that every
    rank holds, as an operator with ``vectors="sharded"`` takes it:
    ``row_sharding(group, x.ndim).place(x)`` (JAX ``shard_vector``)."""
    sg = make_mesh() if group is None else group
    return row_sharding(sg, x.ndim).place(x)


class RowShardedOperator(LinearOperator):
    """Dense square operator whose rows are split over ranks.

    a     : the GLOBAL (N, N) matrix, real or complex; the rank keeps a
            copy of its rows (gradients flow back into ``a`` where it
            requires them).
    group : the :class:`~.mesh.ShardGroup` (default :func:`~.mesh.make_mesh`).
    mode  : "all_gather" or "ring" (``vectors="sharded"`` only).
    vectors : "replicated" or "sharded" (see the module docstring).
    """

    def __init__(self, a, group=None, *, mode: str = "all_gather",
                 vectors: str = "replicated"):
        _check_mode(mode, vectors)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected square matrix, got shape "
                             f"{tuple(a.shape)}")
        n = a.shape[0]
        sg = make_mesh() if group is None else group
        if n % sg.size:
            raise ValueError(f"dim {n} not divisible by {sg.size} shards "
                             f"(pad the operator)")
        n_l = n // sg.size
        self.a = a[sg.rank * n_l:(sg.rank + 1) * n_l].clone()
        self.n = n
        self.group = sg
        self.mode = mode
        self.vectors = vectors
        self.vector_layout = (ShardedVectors(sg, n) if vectors == "sharded"
                              else None)

    def _rows(self, x):
        n_l = self.a.shape[0]
        return x.narrow(0, self.group.rank * n_l, n_l)

    def _mv(self, a, x):
        sg = self.group
        if self.vectors == "replicated":
            return gather_rows(hmatmul(a, replicate(x, sg)), sg)
        if self.mode == "all_gather":
            return hmatmul(a, all_gather_sharded(x, sg))
        # Ring: at step t the segment in hand is rank (me - t) % p's, the
        # matching (N/p, N/p) column block multiplies it, and it moves on
        # to the next rank (JAX parallel/sharded.py:92-115).
        p, n_l = sg.size, a.shape[0]
        perm = [(s, (s + 1) % p) for s in range(p)]
        acc, seg = None, x
        for t in range(p):
            src = (sg.rank - t) % p
            y = hmatmul(a.narrow(1, src * n_l, n_l), seg)
            acc = y if acc is None else acc + y
            if t < p - 1:
                seg = ppermute(seg, sg, perm)
        return acc

    def _rmv(self, a, x):
        # A^T x = sum over ranks of (rank rows)^T (x's rank rows).
        sg = self.group
        if self.vectors == "sharded":
            return reduce_scatter_rows(hmatmul(a.T, x), sg)
        return sum_over_ranks(hmatmul(a.T, self._rows(replicate(x, sg))),
                              sg)

    def matvec(self, x):
        return self._mv(self.a, x)

    def matmat(self, X):
        return self._mv(self.a, X)

    def rmatvec(self, x):
        return self._rmv(self.a, x)

    def rmatmat(self, X):
        return self._rmv(self.a, X)

    def tangent_matvec(self, x, dparams):
        """``(dA) x``: the same product on the tangent of the rank's
        rows."""
        (da,) = dparams
        return self._mv(da, x)

    def tangent_rmatvec(self, x, dparams):
        (da,) = dparams
        return self._rmv(da, x)

    tangent_matmat, tangent_rmatmat = tangent_matvec, tangent_rmatvec

    def parameters(self):
        return [self.a]

    def with_parameters(self, tensors):
        """The same sharding with this rank's rows replaced by the one
        tensor of ``tensors`` (same shape)."""
        (a,) = tensors
        if tuple(a.shape) != tuple(self.a.shape):
            raise ValueError(f"rows must be {tuple(self.a.shape)}, got "
                             f"{tuple(a.shape)}")
        op = copy.copy(self)
        op.a = a
        return op

    @property
    def dim(self):
        return self.n

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device


def _map_specs(fn, params, specs):
    """``params`` with every tensor leaf ``t`` replaced by ``fn(t, spec)``,
    ``spec`` the leaf of ``specs`` (same structure, None or SHARD_AXIS)
    at the same place; ``specs`` None means every leaf replicated."""
    if isinstance(params, torch.Tensor):
        if specs not in (None, SHARD_AXIS):
            raise ValueError(f"param spec {specs!r}: expected None "
                             f"(replicated) or {SHARD_AXIS!r}")
        return fn(params, specs)
    if isinstance(params, dict):
        return {k: _map_specs(fn, v, None if specs is None else specs[k])
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        if specs is not None and len(specs) != len(params):
            raise ValueError(f"param_specs has {len(specs)} entries for "
                             f"{len(params)} params")
        items = [_map_specs(fn, p, None if specs is None else s)
                 for p, s in zip(params, specs or [None] * len(params))]
        return type(params)(*items) if hasattr(params, "_fields") \
            else type(params)(items)
    return params


class ShardedMatrixFreeOperator(MatrixFreeOperator):
    """Matrix-free operator whose product runs on each rank's segment.

    ``local_matvec(params_local, x_local) -> y_local`` is written against
    the rank's segment of the vector (rows ``[rank*N/p, (rank+1)*N/p)``)
    and may use the collectives of ``collectives.py`` over ``group``,
    e.g. :func:`~.collectives.ppermute`.  Every rank calls it in step.

    params      : a tensor or a (nested) tuple/list/dict of them, GLOBAL
                  leaves as every rank holds them.
    param_specs : the same structure of None (the leaf is replicated:
                  the JAX ``P()``) or ``SHARD_AXIS`` (split along dim 0:
                  ``P(axis)``); default every leaf replicated.  The rank
                  keeps its rows of a sharded leaf.
    dim, dtype  : the global dimension and the vectors' dtype (complex
                  allowed).
    device      : where the operator runs when ``params`` holds no tensor.
    local_rmatvec : the transpose product on the segment (required when
                  ``symmetric`` is False).
    vectors     : "replicated" (each product cuts the rank's segment out
                  of the whole x and gathers the results) or "sharded"
                  (x and the product are the rank's segment).

    ``parameters()`` is the replicated leaves whole and the sharded
    leaves' rows.  Inside a product every replicated leaf goes through
    :func:`~.collectives.replicate`, so its gradient is summed over the
    ranks (each rank's rows add their share), and is the whole gradient
    on every rank.  Tangent products and derivatives of any order come
    from :class:`~..ops.operators.MatrixFreeOperator`; a block product is
    one product per column.
    """

    def __init__(self, local_matvec, params, dim: int, group=None, *,
                 dtype=torch.float32, param_specs=None, local_rmatvec=None,
                 symmetric: bool = True, device=None,
                 vectors: str = "replicated"):
        if local_rmatvec is None and not symmetric:
            raise ValueError("non-symmetric operator requires local_rmatvec")
        _check_mode("all_gather", vectors)
        sg = make_mesh() if group is None else group
        dim = int(dim)
        if dim % sg.size:
            raise ValueError(f"dim {dim} not divisible by {sg.size} shards")

        def local(t, spec):
            if spec is None:
                return t
            if t.ndim == 0 or t.shape[0] % sg.size:
                raise ValueError(f"a sharded leaf of shape {tuple(t.shape)} "
                                 f"does not split over {sg.size} shards")
            rows = t.shape[0] // sg.size
            return t[sg.rank * rows:(sg.rank + 1) * rows].clone()

        super().__init__(None, _map_specs(local, params, param_specs), dim,
                         dtype=dtype, symmetric=symmetric, device=device)
        self.local_matvec = local_matvec
        self.local_rmatvec = local_rmatvec
        self.param_specs = param_specs
        self.group = sg
        self.vectors = vectors
        self.vector_layout = (ShardedVectors(sg, dim) if vectors == "sharded"
                              else None)

    def _run(self, fn, x):
        sg = self.group
        params = _map_specs(
            lambda t, spec: replicate(t, sg) if spec is None else t,
            self.params, self.param_specs)
        if self.vectors == "sharded":
            return fn(params, x)
        n_l = self.dim // sg.size
        x_local = replicate(x, sg).narrow(0, sg.rank * n_l, n_l)
        return gather_rows(fn(params, x_local), sg)

    def matvec(self, x):
        return self._run(self.local_matvec, x)

    def rmatvec(self, x):
        return self._run(self.local_rmatvec or self.local_matvec, x)
