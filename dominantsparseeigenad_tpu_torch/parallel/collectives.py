"""The collectives of the row-sharded operators, and their gradients.

The sharded operators keep Krylov vectors replicated: every rank holds
the whole x and computes its own rows of ``A x``.  Three differentiable
steps carry that layout (``sg`` is a :class:`~.mesh.ShardGroup`):

* :func:`replicate` (identity forward): marks a replicated input.  Its
  backward sums the ranks' gradients with ``all_reduce``, because each
  rank's panel saw all of x but produced only its own rows.
* :func:`gather_rows` (``all_gather`` forward): the ranks' row blocks,
  concatenated in rank order, the same on every rank.  Its backward
  returns the rank's own rows of the incoming gradient, with no
  communication: every rank computes the same loss from the same
  replicated vectors, so the incoming gradient is the same on every rank.
  (``torch.distributed.nn.functional.all_gather`` sums the gradient over
  the ranks instead, which would multiply it by their number here.)
* :func:`sum_over_ranks` (``all_reduce`` forward, identity backward):
  the transpose product's partial sums.

Their backwards are first order: under ``create_graph`` they raise
NotImplementedError (second order through the sharded operators is
``ROADMAP.md`` queue 1 item 14).  Each is linear, so its ``jvp`` is the
same collective on the tangent (this Function again, so forward mode
nests); ``vmap`` runs one collective per lane, in the same order on every
rank.

Host staging on gloo.  Gloo takes CUDA tensors in few collectives (not
in ``all_gather``), so on a group whose backend is gloo every collective
here copies a CUDA tensor to host memory, runs there, and copies the
result back.  This is explicit, by the group's backend, never a switch
taken on failure; it is what lets several ranks share one card (NCCL
refuses that).  On NCCL the tensors stay on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.operators import nestable_jvp, per_lane_vmap


def _staged(sg, t) -> bool:
    """Whether a collective on ``t`` goes through host memory: a CUDA
    tensor on a gloo group."""
    return sg.backend == "gloo" and t.device.type == "cuda"


def all_gather_rows(t: torch.Tensor, sg) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated along
    dim 0 in rank order."""
    staged = _staged(sg, t)
    src = (t.cpu() if staged else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(sg.size)]
    dist.all_gather(parts, src, group=sg.group)
    out = torch.cat(parts)
    return out.to(t.device) if staged else out


def all_reduce_sum(t: torch.Tensor, sg) -> torch.Tensor:
    """The sum of every rank's ``t``, the same on every rank (a new
    tensor; ``t`` is left as it was)."""
    staged = _staged(sg, t)
    buf = t.to("cpu", copy=True) if staged else t.clone()
    dist.all_reduce(buf, group=sg.group)
    return buf.to(t.device) if staged else buf


def _first_order_only():
    """Refuse a backward that records a graph (``create_graph``): second
    order through the sharded operators would run collectives in a
    double backward whose lockstep across the ranks nothing checks."""
    if torch.is_grad_enabled():
        raise NotImplementedError(
            "second-order derivatives through the row-sharded operators "
            "are not ported yet (ROADMAP.md queue 1 item 14); use "
            "create_graph=False")


@per_lane_vmap
class _Replicate(torch.autograd.Function):

    @staticmethod
    def forward(x, sg):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sg = inputs[1]

    @staticmethod
    @nestable_jvp
    def jvp(ctx, dx, _):
        return _Replicate.apply(dx, ctx.sg)

    @staticmethod
    def backward(ctx, g):
        _first_order_only()
        # Through the Function, so a vmap over the backward batches it.
        return _SumOverRanks.apply(g, ctx.sg), None


@per_lane_vmap
class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(y, sg):
        return all_gather_rows(y, sg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y, sg = inputs
        ctx.sg, ctx.rank, ctx.rows = sg, sg.rank, y.shape[0]

    @staticmethod
    @nestable_jvp
    def jvp(ctx, dy, _):
        return _GatherRows.apply(dy, ctx.sg)

    @staticmethod
    def backward(ctx, g):
        _first_order_only()
        return g.narrow(0, ctx.rank * ctx.rows, ctx.rows), None


@per_lane_vmap
class _SumOverRanks(torch.autograd.Function):

    @staticmethod
    def forward(y, sg):
        return all_reduce_sum(y, sg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sg = inputs[1]

    @staticmethod
    @nestable_jvp
    def jvp(ctx, dy, _):
        return _SumOverRanks.apply(dy, ctx.sg)

    @staticmethod
    def backward(ctx, g):
        _first_order_only()
        return g, None


def replicate(x: torch.Tensor, sg) -> torch.Tensor:
    """``x``, replicated on every rank; gradients are summed over ranks."""
    return _Replicate.apply(x, sg)


def gather_rows(y: torch.Tensor, sg) -> torch.Tensor:
    """The ranks' row blocks ``y`` concatenated; the gradient of the
    rank's own rows comes back."""
    return _GatherRows.apply(y, sg)


def sum_over_ranks(y: torch.Tensor, sg) -> torch.Tensor:
    """The sum over ranks of ``y``; the gradient passes through."""
    return _SumOverRanks.apply(y, sg)
