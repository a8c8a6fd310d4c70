"""Row-sharded dense and matrix-free operators.

Counterpart of ``dominantsparseeigenad_tpu/parallel/sharded.py``, with
the layout of :class:`~.sharded_sparse.RowShardedBellOperator`: the
operator's rows are split over the ranks of a :class:`~.mesh.ShardGroup`,
vectors are replicated, each rank computes its own rows of ``A x`` and
the row blocks are all-gathered.

* :class:`RowShardedOperator` (``mode="all_gather"``): a dense (N, N)
  matrix, real or complex; each rank multiplies its (N/p, N) rows by the
  whole x in true fp32/fp64.  It runs no kernel of its own.
* :class:`ShardedMatrixFreeOperator`: a ``local_matvec`` written against
  the rank's segment of the vector, which may use the collectives of
  ``collectives.py`` (the sharded TFIM swaps segments between XOR
  partners with :func:`~.collectives.ppermute`).  It is the JAX
  contract exactly, so that code written against it does not change
  when the vectors become sharded.

Both carry forward mode and derivatives of any order: their tangent
products run the same collectives on the tangent, and the collectives'
backwards are differentiable.

Not ported yet (``ROADMAP.md`` queue 1 item 14): ``mode="ring"`` and
``shard_vector``, which need vectors sharded over the ranks.
"""

from __future__ import annotations

import copy

import torch

from ..ops.operators import LinearOperator, MatrixFreeOperator, hmatmul
from .collectives import gather_rows, replicate, sum_over_ranks
from .mesh import SHARD_AXIS, make_mesh
from .sharded_sparse import _check_mode


class RowShardedOperator(LinearOperator):
    """Dense square operator whose rows are split over ranks.

    a     : the GLOBAL (N, N) matrix, real or complex; the rank keeps a
            copy of its rows (gradients flow back into ``a`` where it
            requires them).
    group : the :class:`~.mesh.ShardGroup` (default :func:`~.mesh.make_mesh`).
    mode  : "all_gather" ("ring" raises NotImplementedError).
    """

    def __init__(self, a, group=None, *, mode: str = "all_gather"):
        _check_mode(mode)
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

    def _rows(self, x):
        n_l = self.a.shape[0]
        return x.narrow(0, self.group.rank * n_l, n_l)

    def _mv(self, a, x):
        return gather_rows(hmatmul(a, replicate(x, self.group)), self.group)

    def _rmv(self, a, x):
        # A^T x = sum over ranks of (rank rows)^T (x's rank rows).
        return sum_over_ranks(hmatmul(a.T,
                                      self._rows(replicate(x, self.group))),
                              self.group)

    def matvec(self, x):
        return self._mv(self.a, x)

    def matmat(self, X):
        return self._mv(self.a, X)

    def rmatvec(self, x):
        return self._rmv(self.a, x)

    def rmatmat(self, X):
        return self._rmv(self.a, X)

    def tangent_matvec(self, x, dparams):
        """``(dA) x``: the same gather on the tangent of the rank's rows."""
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
                 symmetric: bool = True, device=None):
        if local_rmatvec is None and not symmetric:
            raise ValueError("non-symmetric operator requires local_rmatvec")
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

    def _run(self, fn, x):
        sg = self.group
        params = _map_specs(
            lambda t, spec: replicate(t, sg) if spec is None else t,
            self.params, self.param_specs)
        n_l = self.dim // sg.size
        x_local = replicate(x, sg).narrow(0, sg.rank * n_l, n_l)
        return gather_rows(fn(params, x_local), sg)

    def matvec(self, x):
        return self._run(self.local_matvec, x)

    def rmatvec(self, x):
        return self._run(self.local_rmatvec or self.local_matvec, x)
