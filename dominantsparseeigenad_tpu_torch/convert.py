"""Carry operators of the JAX package across as numpy arrays.

The JAX package's ``BellOperator``, ``DenseOperator``, ``COOOperator``,
``CSROperator`` and ``BCOOOperator`` hold their data in JAX arrays;
``np.asarray`` turns them into numpy arrays (bfloat16 values come as
numpy's ``bfloat16`` extension dtype), and these functions build the
port's operator from them, so both packages compute the same
thing.  ``restart_state_from_numpy`` does the same for a thick-restart
``RestartState`` (``utils.load_pytree`` reads one from a checkpoint
file).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.operators import DenseOperator, resolve_device
from .ops.restart import RestartState
from .ops.sparse import BCOOOperator, BellOperator, COOOperator, CSROperator
from .parallel.sharded_sparse import RowShardedBellOperator


def _tensor_from_numpy(a) -> torch.Tensor:
    # A copy: arrays from JAX are read-only, and the tensor owns its data.
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        # Same 16 bits: reinterpret, no rounding.
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def bell_operator_from_numpy(vals, cols, n: int, *, symmetric: bool = False,
                             slot_plan="auto", device=None) -> BellOperator:
    """The port's ``BellOperator`` for a JAX ``BellOperator``'s
    ``np.asarray(op.vals)``, ``np.asarray(op.cols)`` and ``op.n``;
    ``slot_plan`` as in :class:`BellOperator` (JAX's ``op.slot_plan`` may
    be passed as it is)."""
    dev = resolve_device(device)
    return BellOperator(_tensor_from_numpy(vals).to(dev),
                        _tensor_from_numpy(np.asarray(cols, np.int32)).to(dev),
                        n, symmetric=symmetric, slot_plan=slot_plan)


def row_sharded_bell_operator_from_numpy(
        vals, cols, n: int, group=None, *, symmetric: bool = False,
        device=None) -> RowShardedBellOperator:
    """This rank's ``RowShardedBellOperator`` for a JAX
    ``RowShardedBellOperator``'s (or ``BellOperator``'s) global
    ``np.asarray(op.vals)``, ``np.asarray(op.cols)`` and ``op.n``;
    ``group`` as in :func:`~.parallel.make_mesh`."""
    dev = resolve_device(device)
    return RowShardedBellOperator(
        _tensor_from_numpy(vals).to(dev),
        _tensor_from_numpy(np.asarray(cols, np.int32)).to(dev), n, group,
        symmetric=symmetric)


def dense_operator_from_numpy(a, *, device=None) -> DenseOperator:
    """The port's ``DenseOperator`` for a JAX ``DenseOperator``'s
    ``np.asarray(op.a)``, in the same dtype (complex64 and complex128
    too)."""
    return DenseOperator(_tensor_from_numpy(a).to(resolve_device(device)))


def coo_operator_from_numpy(rows, cols, vals, n: int, *,
                            device=None) -> COOOperator:
    """The port's ``COOOperator`` for a JAX ``COOOperator``'s
    ``np.asarray(op.rows)``, ``np.asarray(op.cols)``,
    ``np.asarray(op.vals)`` and ``op.n``."""
    dev = resolve_device(device)
    return COOOperator(_tensor_from_numpy(np.asarray(rows, np.int32)).to(dev),
                       _tensor_from_numpy(np.asarray(cols, np.int32)).to(dev),
                       _tensor_from_numpy(vals).to(dev), n)


def csr_operator_from_numpy(indptr, indices, data, n: int, *,
                            device=None) -> CSROperator:
    """The port's ``CSROperator`` for a JAX ``CSROperator``'s
    ``np.asarray(op.indptr)``, ``np.asarray(op.indices)``,
    ``np.asarray(op.data)`` and ``op.n``."""
    dev = resolve_device(device)
    return CSROperator(
        _tensor_from_numpy(np.asarray(indptr, np.int32)).to(dev),
        _tensor_from_numpy(np.asarray(indices, np.int32)).to(dev),
        _tensor_from_numpy(data).to(dev), n)


def bcoo_operator_from_numpy(indices, data, n: int, *,
                             device=None) -> BCOOOperator:
    """The port's ``BCOOOperator`` for a JAX ``BCOOOperator``'s
    ``np.asarray(op.mat.indices)`` (shape (nnz, 2)),
    ``np.asarray(op.mat.data)`` and ``op.dim``."""
    dev = resolve_device(device)
    idx = _tensor_from_numpy(np.asarray(indices, np.int64)).T
    return BCOOOperator(torch.sparse_coo_tensor(
        idx.to(dev), _tensor_from_numpy(data).to(dev), (n, n),
        check_invariants=True))


def restart_state_from_numpy(theta, y, s, q, *, device=None) -> RestartState:
    """The port's ``RestartState`` for a JAX ``RestartState``'s
    ``np.asarray`` fields, in the same dtypes."""
    dev = resolve_device(device)
    return RestartState(*(_tensor_from_numpy(a).to(dev)
                          for a in (theta, y, s, q)))
