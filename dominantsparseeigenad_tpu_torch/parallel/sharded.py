"""Row-sharded dense operator.

Counterpart of ``RowShardedOperator`` in
``dominantsparseeigenad_tpu/parallel/sharded.py``, its
``mode="all_gather"``: the rows of a dense (N, N) matrix are split over
the ranks of a :class:`~.mesh.ShardGroup`, with the layout of
:class:`~.sharded_sparse.RowShardedBellOperator`: the matrix is sharded,
vectors are replicated, each rank multiplies its (N/p, N) rows by the
whole x in true fp32/fp64 and the row blocks are all-gathered.  It runs
no kernel of its own.

Not ported yet (``ROADMAP.md``): ``mode="ring"``,
``ShardedMatrixFreeOperator`` and ``shard_vector``.
"""

from __future__ import annotations

import copy

from ..ops.operators import LinearOperator, hmatmul, refuse_complex
from .collectives import gather_rows, replicate, sum_over_ranks
from .mesh import make_mesh
from .sharded_sparse import SHARDED_COMPLEX, _check_mode


class RowShardedOperator(LinearOperator):
    """Dense square operator whose rows are split over ranks.

    a     : the GLOBAL (N, N) matrix; the rank keeps a copy of its rows
            (gradients flow back into ``a`` where it requires them).
    group : the :class:`~.mesh.ShardGroup` (default :func:`~.mesh.make_mesh`).
    mode  : "all_gather" ("ring" raises NotImplementedError).
    """

    def __init__(self, a, group=None, *, mode: str = "all_gather"):
        _check_mode(mode)
        refuse_complex(a.dtype, "the matrix", SHARDED_COMPLEX)
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

    def matvec(self, x):
        return gather_rows(hmatmul(self.a, replicate(x, self.group)),
                           self.group)

    def matmat(self, X):
        return self.matvec(X)

    def rmatvec(self, x):
        # A^T x = sum over ranks of (rank rows)^T (x's rank rows).
        return sum_over_ranks(hmatmul(self.a.T,
                                      self._rows(replicate(x, self.group))),
                              self.group)

    def rmatmat(self, X):
        return self.rmatvec(X)

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
