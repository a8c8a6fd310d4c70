"""Process groups for the row-sharded operators.

Counterpart of ``dominantsparseeigenad_tpu/parallel/mesh.py``.  The JAX
package builds a ``jax.sharding.Mesh`` with a ``"batch"`` and a
``"shards"`` axis over the devices of a slice; here one process per rank
joins a ``torch.distributed`` group, and :func:`make_mesh` returns that
group as the ``"shards"`` axis: a :class:`ShardGroup` with the rank and
the number of ranks.  Only the shard axis is ported (``n_batch=1``).

Each rank drives one card, ``cuda:(rank % device_count)``
(:func:`rank_device`), so several ranks on a machine with fewer cards
share them; :func:`init_distributed` makes it the rank's current device,
so that ``device=None`` (CUDA) in the entry points means the rank's own
card.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta

import torch
import torch.distributed as dist

SHARD_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """The ranks one operator is sharded over.

    group   : the ``torch.distributed`` process group (None: the default
              group of every rank)
    rank    : this process's rank in it
    size    : the number of ranks
    backend : the group's backend ("gloo" or "nccl")
    """

    group: object
    rank: int
    size: int
    backend: str


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
    """The shard axis over the ranks of ``group`` (default: every rank of
    the default group, which :func:`init_distributed` joined).

    ``n_shards`` defaults to the group's size and must equal it.  Only
    ``n_batch=1``: the batch axis is not ported yet (``ROADMAP.md``).
    """
    if n_batch != 1:
        raise NotImplementedError(
            "make_mesh: only n_batch=1; the batch axis waits (ROADMAP.md, "
            "queue 1 item 14)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    size = dist.get_world_size(group)
    if n_shards is not None and n_shards != size:
        raise ValueError(f"make_mesh: n_shards={n_shards}, but the group has "
                         f"{size} ranks")
    return ShardGroup(group=group, rank=dist.get_rank(group), size=size,
                      backend=str(dist.get_backend(group)))
