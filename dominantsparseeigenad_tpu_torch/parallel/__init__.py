"""The row-sharded tier on ``torch.distributed``.

Counterpart of ``dominantsparseeigenad_tpu/parallel``: one process per
rank; operator rows are split over the ranks, Krylov vectors are
replicated (see ``sharded_sparse.py``).  Ported: the ``all_gather``
mode of :class:`RowShardedBellOperator` (its panels on the hand-written
kernels) and of :class:`RowShardedOperator` (real or complex),
:class:`ShardedMatrixFreeOperator` (a product written against the
rank's segment, with :func:`~.collectives.ppermute` among its
collectives), and the mesh with its batch and shard axes.  Every
operator carries forward mode and derivatives of any order.  The
``ring`` mode and ``shard_vector`` wait for a sharded-vector layout
(``ROADMAP.md`` queue 1 item 14).
"""

from .collectives import ppermute
from .mesh import (BATCH_AXIS, SHARD_AXIS, ShardGroup, init_distributed,
                   make_mesh, rank_device)
from .sharded import RowShardedOperator, ShardedMatrixFreeOperator
from .sharded_sparse import RowShardedBellOperator

__all__ = ["BATCH_AXIS", "RowShardedBellOperator", "RowShardedOperator",
           "SHARD_AXIS", "ShardGroup", "ShardedMatrixFreeOperator",
           "init_distributed", "make_mesh", "ppermute", "rank_device"]
