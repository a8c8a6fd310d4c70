"""Checkpoint and resume for long iterative runs.

Counterpart of ``dominantsparseeigenad_tpu/utils/checkpoint.py``, in its
on-disk format: ``<path>.npz`` holds the leaves as ``leaf_0``,
``leaf_1``, ... and ``<path>.tree.json`` their count and a description of
the structure.  A :class:`~..ops.restart.RestartState` saved by either
package therefore resumes in the other.

A tree is a tensor (or a numpy array or a number: a leaf), None (no
leaf), or a list, tuple, NamedTuple or dict of trees.  Leaves are taken in
the order ``jax.tree.flatten`` takes them: a NamedTuple's fields in field
order, a dict's values in sorted key order (``torch.utils._pytree``
keeps insertion order instead, which would permute a dict's leaves).
A bfloat16 tensor is written as float32 (numpy has no bfloat16;
the widening is exact) and restored to ``like``'s dtype.

``save_orbax`` and ``load_orbax`` take a tree of shardings (the port's
``row_sharding``/``replicated``): ranks that each hold their rows of a
sharded tensor write one file of the global tensors, which any number
of ranks, or the JAX package's ``load_pytree``, reads back.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as dist


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _rebuild(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        out = {key: _rebuild(like[key], it) for key in sorted(like)}
        return {key: out[key] for key in like}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(item, it) for item in like]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return type(like)(items)
    return next(it)


def _describe(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_describe(tree[key])}"
                               for key in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(item) for item in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Save a tree of tensors to ``<path>.npz`` + ``<path>.tree.json``."""
    leaves = _leaves(tree)
    np.savez(path + ".npz", **{f"leaf_{i}": _to_numpy(leaf)
                               for i, leaf in enumerate(leaves)})
    with open(path + ".tree.json", "w") as f:
        json.dump({"n_leaves": len(leaves), "treedef": _describe(tree)}, f)


def load_pytree(path: str, like):
    """Restore a tree saved by :func:`save_pytree` (by this package or the
    JAX one).  ``like`` gives the structure, and each tensor leaf of
    ``like`` the device and dtype its restored leaf goes to; a leaf that
    is not a tensor comes back as the stored numpy array."""
    refs = _leaves(like)
    with np.load(path + ".npz") as data:
        if len(data.files) != len(refs):
            raise ValueError(f"{path}.npz holds {len(data.files)} leaves, "
                             f"the structure given has {len(refs)}")
        arrays = [data[f"leaf_{i}"] for i in range(len(refs))]
    leaves = [torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
              if isinstance(ref, torch.Tensor) else arr
              for arr, ref in zip(arrays, refs)]
    return _rebuild(like, iter(leaves))


def _spec_leaves(like, shardings) -> list:
    """One sharding (or None) for each leaf of ``like``: ``shardings`` has
    the same structure, or is one sharding (or None) for all its leaves."""
    if shardings is None or hasattr(shardings, "place"):
        return [shardings] * len(_leaves(like))
    if like is None:
        return []
    if isinstance(like, dict):
        return [x for key in sorted(like)
                for x in _spec_leaves(like[key], shardings[key])]
    if isinstance(like, (list, tuple)):
        if len(like) != len(shardings):
            raise ValueError(f"shardings has {len(shardings)} entries for a "
                             f"node of {len(like)}")
        return [x for item, spec in zip(like, shardings)
                for x in _spec_leaves(item, spec)]
    return [shardings]


def _groups(specs) -> list:
    """The distinct process groups the shardings name, in order."""
    out = []
    for spec in specs:
        if spec is not None and all(spec.group != g for g in out):
            out.append(spec.group)
    return out


def save_orbax(path: str, tree, shardings=None) -> None:
    """:func:`save_pytree`, what the JAX package's ``save_orbax`` does
    where orbax is not installed, across processes: ``shardings`` (the
    torch counterpart of the ``.sharding`` a ``jax.Array`` carries) is a
    tree of the structure of ``tree`` (or one entry for every leaf) of
    :func:`~..parallel.row_sharding`, :func:`~..parallel.replicated` and
    None.  Every rank calls this with its own leaves: a row-sharded
    leaf's rows are gathered over its group, rank 0 of the group writes
    the global tree in the JAX package's npz format, and every rank waits
    at a barrier until the file is there.  Without ``shardings`` it is
    :func:`save_pytree`."""
    specs = _spec_leaves(tree, shardings)
    groups = _groups(specs)
    if not groups:
        save_pytree(path, tree)
        return
    if len(groups) > 1:
        raise ValueError("the shardings name more than one process group")
    (sg,) = groups
    whole = _rebuild(tree, iter(
        leaf if spec is None else spec.gather(leaf.detach())
        for leaf, spec in zip(_leaves(tree), specs)))
    if sg.rank == 0:
        save_pytree(path, whole)
    dist.barrier(group=sg.group)


def load_orbax(path: str, like, shardings=None):
    """Restore a :func:`save_orbax` checkpoint (or any :func:`save_pytree`
    file, the JAX package's too): each rank reads the global tree and
    keeps, for a row-sharded leaf, its rows (``shardings`` as in
    :func:`save_orbax`, ``like`` giving the rank's leaves, whose dtype
    and device the restored ones take).  The file may have been written
    at any number of ranks.  Without ``shardings`` it is
    :func:`load_pytree`."""
    specs = _spec_leaves(like, shardings)
    if not _groups(specs):
        return load_pytree(path, like)
    refs = _leaves(like)
    with np.load(path + ".npz") as data:
        if len(data.files) != len(refs):
            raise ValueError(f"{path}.npz holds {len(data.files)} leaves, "
                             f"the structure given has {len(refs)}")
        arrays = [data[f"leaf_{i}"] for i in range(len(refs))]
    leaves = []
    for arr, ref, spec in zip(arrays, refs, specs):
        if not isinstance(ref, torch.Tensor):
            leaves.append(arr)
            continue
        t = torch.from_numpy(arr)
        if spec is not None:
            t = spec.place(t)
        leaves.append(t.to(device=ref.device, dtype=ref.dtype))
    return _rebuild(like, iter(leaves))
