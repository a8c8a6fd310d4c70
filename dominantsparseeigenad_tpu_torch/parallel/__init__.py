"""The row-sharded tier on ``torch.distributed``.

Counterpart of ``dominantsparseeigenad_tpu/parallel``: one process per
rank; operator rows are split over the ranks, Krylov vectors are
replicated (see ``sharded_sparse.py``).  Ported: the ``all_gather``
mode of :class:`RowShardedBellOperator` (its panels on the hand-written
kernels) and of :class:`RowShardedOperator`, and the shard axis of the
mesh.  The ``ring`` mode, the batch axis and the sharded matrix-free
operator wait (``ROADMAP.md``).
"""

from .mesh import (SHARD_AXIS, ShardGroup, init_distributed, make_mesh,
                   rank_device)
from .sharded import RowShardedOperator
from .sharded_sparse import RowShardedBellOperator

__all__ = ["RowShardedBellOperator", "RowShardedOperator", "SHARD_AXIS",
           "ShardGroup", "init_distributed", "make_mesh", "rank_device"]
