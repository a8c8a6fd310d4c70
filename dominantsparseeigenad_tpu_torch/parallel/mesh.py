"""Process groups for the row-sharded operators.

Counterpart of ``dominantsparseeigenad_tpu/parallel/mesh.py``.  The JAX
package builds a ``jax.sharding.Mesh`` with a ``"batch"`` and a
``"shards"`` axis over the devices of a slice; here one process per rank
joins a ``torch.distributed`` group, and :func:`make_mesh` lays its ranks
out as JAX's ``(batch, shards)`` grid: rank r is in batch row
``r // n_shards`` at shard index ``r % n_shards``.  It returns the
:class:`ShardGroup` of the rank's own row, the ``"shards"`` axis that
the sharded operators split over; the rows are independent problems
(many couplings, many right-hand sides), each sharded over its own
group.

Each rank drives one card, ``cuda:(rank % device_count)``
(:func:`rank_device`), so several ranks on a machine with fewer cards
share them; :func:`init_distributed` makes it the rank's current device,
so that ``device=None`` (CUDA) in the entry points means the rank's own
card.

:func:`row_sharding` and :func:`replicated` are the port's counterparts
of the JAX ``NamedSharding`` objects of the same names: where a ``jax.Array``
carries its sharding, a torch tensor on a rank is its rows or the whole,
and these objects say which (``place`` a global tensor, ``gather`` the
whole one back); ``utils/checkpoint.py`` takes a tree of them.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from .collectives import gather_rows, replicate

SHARD_AXIS = "shards"
BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """The ranks one operator is sharded over.

    group   : the ``torch.distributed`` process group (None: the default
              group of every rank)
    rank    : this process's rank in it (its shard index)
    size    : the number of ranks (shards)
    backend : the group's backend ("gloo" or "nccl")
    batch_index : the batch row of the mesh this group is (0 without a
              batch axis)
    n_batch : the number of batch rows
    """

    group: object
    rank: int
    size: int
    backend: str
    batch_index: int = 0
    n_batch: int = 1


def rank_device(rank: int) -> torch.device:
    """The card a rank drives: ``cuda:(rank % device_count)``."""
    return torch.device("cuda", rank % torch.cuda.device_count())


# How long a collective may wait for the other ranks before it raises.
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def init_distributed(backend: str | None = None,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> None:
    """Join the default process group, once per process.

    Arguments that are None come from the ``torchrun`` environment:
    ``RANK`` and ``WORLD_SIZE``, and ``init_method="env://"``
    (``MASTER_ADDR``/``MASTER_PORT``).  ``init_method`` may also be
    ``"file:///path"`` (a file store, one machine) or
    ``"tcp://host:port"``.  ``backend`` defaults to ``"nccl"`` when a card
    is present, else ``"gloo"``.  NCCL refuses two ranks on one card:
    ranks that share a card need ``"gloo"``.

    With a card, the rank's current device becomes
    :func:`rank_device` of its rank.
    """
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if init_method is None:
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(rank_device(rank))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=COLLECTIVE_TIMEOUT)


def make_mesh(n_shards: int | None = None, n_batch: int = 1,
              group=None) -> ShardGroup:
    """The ``(batch, shards)`` grid over the ranks of ``group`` (default:
    every rank of the default group, which :func:`init_distributed`
    joined), as the JAX ``make_mesh`` lays its devices out:
    ``reshape(n_batch, n_shards)`` of the ranks in order.

    ``n_shards`` defaults to the group's size over ``n_batch``;
    ``n_shards * n_batch`` must equal the group's size.  With
    ``n_batch > 1`` every rank calls this with the same arguments: each
    row becomes a process group of its own (every rank creates every
    row's group, in the same order), and the call returns the rank's
    row.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    size = dist.get_world_size(group)
    if n_batch < 1:
        raise ValueError(f"make_mesh: n_batch={n_batch} must be >= 1")
    if n_shards is None:
        n_shards = size // n_batch
    if n_shards < 1 or n_shards * n_batch != size:
        raise ValueError(
            f"mesh {n_batch}x{n_shards} needs {n_batch * n_shards} ranks, "
            f"the group has {size}")
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    if n_batch == 1:
        return ShardGroup(group=group, rank=rank, size=size, backend=backend)
    ranks = [r if group is None else dist.get_global_rank(group, r)
             for r in range(size)]
    row = rank // n_shards
    mine = None
    for b in range(n_batch):
        sub = dist.new_group(ranks[b * n_shards:(b + 1) * n_shards],
                             backend=backend, timeout=COLLECTIVE_TIMEOUT)
        if b == row:
            mine = sub
    return ShardGroup(group=mine, rank=rank % n_shards, size=n_shards,
                      backend=backend, batch_index=row, n_batch=n_batch)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """A tensor's leading axis split over the ranks of ``group``: rank d
    holds rows ``[d*M/p, (d+1)*M/p)`` (the JAX ``P(axis, None, ...)``).

    ``place(x)``: the rank's rows of the global ``x`` (the same on every
    rank); its gradient is summed over the ranks, as each holds a share.
    ``gather(x)``: the global tensor on every rank from the ranks' rows,
    a replicated result (a loss every rank computes alike takes it; a
    panel's input is ``collectives.all_gather_sharded``)."""

    group: ShardGroup
    ndim: int = 1

    def _check(self, x, rows):
        if x.ndim != self.ndim:
            raise ValueError(f"row_sharding(ndim={self.ndim}) got a tensor "
                             f"of shape {tuple(x.shape)}")
        if rows % self.group.size:
            raise ValueError(f"{rows} rows do not split over "
                             f"{self.group.size} shards")

    def place(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, x.shape[0])
        rows = x.shape[0] // self.group.size
        return replicate(x, self.group).narrow(
            0, self.group.rank * rows, rows).clone()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, x.shape[0] * self.group.size)
        return gather_rows(x, self.group)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """A tensor held whole on every rank of ``group`` (the JAX ``P()``):
    ``place`` and ``gather`` return it as it is."""

    group: ShardGroup

    def place(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x


def row_sharding(group: ShardGroup, ndim: int = 1) -> RowSharding:
    """The sharding that splits the leading axis of an ``ndim``-dimensional
    tensor over ``group`` (JAX ``row_sharding(mesh, ndim)``)."""
    return RowSharding(group, int(ndim))


def replicated(group: ShardGroup) -> Replicated:
    """The sharding of a tensor every rank holds whole (JAX
    ``replicated(mesh)``)."""
    return Replicated(group)
