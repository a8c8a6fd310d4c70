"""The row-sharded tier on ``torch.distributed``.

Counterpart of ``dominantsparseeigenad_tpu/parallel``: one process per
rank; operator rows are split over the ranks.  The Krylov vectors are
replicated (``vectors="replicated"``, the default: every rank holds the
whole x) or sharded (``vectors="sharded"``, the JAX package's layout:
every rank holds its rows, ``shard_vector``, and the solvers reduce
their dots over the ranks).  Ported: both modes of
:class:`RowShardedBellOperator` (``all_gather``: its panels on the
hand-written kernels; ``ring``: each offset's bucket on them, over
sharded vectors) and of :class:`RowShardedOperator` (real or complex),
:class:`ShardedMatrixFreeOperator` (a product written against the rank's
segment, with :func:`~.collectives.ppermute` among its collectives), the
mesh with its batch and shard axes, and the placements
:func:`row_sharding` and :func:`replicated`.  Every operator carries
forward mode and derivatives of any order.
"""

from .collectives import ppermute
from .mesh import (BATCH_AXIS, SHARD_AXIS, ShardGroup, init_distributed,
                   make_mesh, rank_device, replicated, row_sharding)
from .sharded import (RowShardedOperator, ShardedMatrixFreeOperator,
                      shard_vector)
from .sharded_sparse import RowShardedBellOperator

__all__ = ["BATCH_AXIS", "RowShardedBellOperator", "RowShardedOperator",
           "SHARD_AXIS", "ShardGroup", "ShardedMatrixFreeOperator",
           "init_distributed", "make_mesh", "ppermute", "rank_device",
           "replicated", "row_sharding", "shard_vector"]
