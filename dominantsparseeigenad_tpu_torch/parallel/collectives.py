"""The collectives of the sharded operators, and their derivatives.

Two layouts of the Krylov vectors.  With replicated vectors every rank
holds the whole x and computes its own rows of ``A x``; with sharded
vectors (``vectors="sharded"``, the JAX package's ``P(axis)``) every rank
holds its rows of x only, and the solvers reduce their dots over the
ranks through :class:`ShardedVectors`.  Four differentiable steps carry
the replicated layout (``sg`` is a :class:`~.mesh.ShardGroup`):

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
* :func:`ppermute` (send to one rank, receive from another): the
  counterpart of ``lax.ppermute``, which the sharded matrix-free TFIM
  uses to swap whole segments between XOR partners.  Its backward is the
  inverse permutation (an XOR exchange is its own inverse).

Two more carry the sharded one:

* :func:`all_gather_sharded` (``all_gather`` forward): the whole vector
  from the ranks' rows, for a rank's panel to multiply.  Each rank's
  panel gives its own cotangent of the gathered vector, so the backward
  is the reduce-scatter, the JAX ``all_gather(tiled=True)`` transposed.
  (:func:`gather_rows` assumes one cotangent on every rank: it is the
  gather of a replicated result, not of a panel's input.)
* :func:`reduce_scatter_rows` (sum over ranks, then the rank's rows; the
  JAX ``psum_scatter``): the transpose products' partial sums.  Its
  backward is :func:`all_gather_sharded`.  On gloo it is an
  ``all_reduce`` and a narrow (gloo has no CUDA reduce-scatter), counted
  as the all_reduce it is.

Every derivative is again one of these steps, so derivatives of any
order go through them.  A backward that hands a replicated gradient to
the rank's own computation (``gather_rows``, ``sum_over_ranks``) marks
it with :func:`replicate`, so that a double backward sums the ranks'
shares of it, as the first backward sums those of x.  Each step is
linear: its ``jvp`` is the same step on the tangent (this Function
again, so forward mode nests), and ``vmap`` runs one collective per
lane.

Lockstep.  The solvers branch on scalars read on the host, and every
rank must run the same collectives in the same order.  They do: every
rank starts from the same vectors, every replicated result is bitwise
the same on every rank, and so every rank builds the same graph and runs
the same backward (and double backward) through it.
:data:`collective_counts` counts the collectives this process ran, by
kind, so that a run can check that every rank ran the same ones.

Complex tensors travel as their real view (``torch.view_as_real``), by
the dtype, never by how a backend treats a complex dtype.  Host staging
on gloo: gloo takes CUDA tensors in few collectives (not in
``all_gather``), so on a group whose backend is gloo every collective
here copies a CUDA tensor to host memory, runs there, and copies the
result back.  This is explicit, by the group's backend, never a switch
taken on failure; it is what lets several ranks share one card (NCCL
refuses that).  On NCCL the tensors stay on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.operators import hmatmul, nestable_jvp, per_lane_vmap

# Collectives run by this process, by kind (one per call of the three
# functions below, also on one rank).
collective_counts = dict.fromkeys(("all_gather", "all_reduce", "ppermute"),
                                  0)


def reset_collective_counts():
    for kind in collective_counts:
        collective_counts[kind] = 0


def _staged(sg, t) -> bool:
    """Whether a collective on ``t`` goes through host memory: a CUDA
    tensor on a gloo group."""
    return sg.backend == "gloo" and t.device.type == "cuda"


def _wire(t, sg, fresh=False):
    """``t`` as the collectives send it: a contiguous real tensor (the
    real view of a complex one), in host memory when staged; with
    ``fresh``, never ``t``'s own memory (a buffer to reduce into)."""
    if _staged(sg, t):
        src = t.cpu()
    else:
        src = t.clone() if fresh else t
    if src.is_complex():
        src = torch.view_as_real(src.resolve_conj())
    return src.contiguous()


def _unwire(buf, like):
    """A received ``buf`` back as ``like``'s dtype and device."""
    if like.is_complex():
        buf = torch.view_as_complex(buf)
    return buf.to(like.device)


def all_gather_rows(t: torch.Tensor, sg) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated along
    dim 0 in rank order."""
    collective_counts["all_gather"] += 1
    src = _wire(t, sg)
    parts = [torch.empty_like(src) for _ in range(sg.size)]
    dist.all_gather(parts, src, group=sg.group)
    return _unwire(torch.cat(parts), t)


def all_reduce_sum(t: torch.Tensor, sg) -> torch.Tensor:
    """The sum of every rank's ``t``, the same on every rank (a new
    tensor; ``t`` is left as it was)."""
    collective_counts["all_reduce"] += 1
    buf = _wire(t, sg, fresh=True)
    dist.all_reduce(buf, group=sg.group)
    return _unwire(buf, t)


def _peers(sg, perm):
    """(where this rank sends, where it receives from) under ``perm``, a
    sequence of (source, destination) pairs of shard indices; None where
    ``perm`` names no such rank.  Raises on a pair that is out of range
    or a rank that sends or receives twice."""
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if any(not 0 <= i < sg.size for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} names a rank outside "
                         f"[0, {sg.size})")
    to = dict(perm).get(sg.rank)
    frm = {d: s for s, d in perm}.get(sg.rank)
    return to, frm


def _global(sg, rank):
    return rank if sg.group is None else dist.get_global_rank(sg.group, rank)


def permute_exchange(t: torch.Tensor, sg, perm) -> torch.Tensor:
    """This rank's ``t`` sent to its destination under ``perm``, and the
    source's ``t`` received (zeros where no rank sends here, as
    ``lax.ppermute``).  Every send and receive of the call is in one
    ``batch_isend_irecv``, so a pair of ranks that swap cannot deadlock."""
    collective_counts["ppermute"] += 1
    to, frm = _peers(sg, perm)
    src = _wire(t, sg)
    if to == sg.rank and frm == sg.rank:
        return _unwire(src.clone(), t)
    buf = torch.zeros_like(src)
    ops = []
    if to is not None and to != sg.rank:
        ops.append(dist.P2POp(dist.isend, src, _global(sg, to), sg.group))
    if frm is not None and frm != sg.rank:
        ops.append(dist.P2POp(dist.irecv, buf, _global(sg, frm), sg.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _unwire(buf, t)


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
        # Through the Function, so a vmap over the backward batches it and
        # a double backward replicates the sum again.
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
        # The replicated g enters the rank's own rows: its double backward
        # sums the ranks' rows (an all_reduce of the padded shares).
        return _Replicate.apply(g, ctx.sg).narrow(0, ctx.rank * ctx.rows,
                                                  ctx.rows), None


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
        return _Replicate.apply(g, ctx.sg), None


@per_lane_vmap
class _Ppermute(torch.autograd.Function):

    @staticmethod
    def forward(x, sg, perm):
        return permute_exchange(x, sg, perm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.sg, ctx.perm = inputs

    @staticmethod
    @nestable_jvp
    def jvp(ctx, dx, *_):
        return _Ppermute.apply(dx, ctx.sg, ctx.perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _Ppermute.apply(g, ctx.sg, inverse), None, None


@per_lane_vmap
class _AllGatherSharded(torch.autograd.Function):

    @staticmethod
    def forward(x, sg):
        return all_gather_rows(x, sg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sg = inputs[1]

    @staticmethod
    @nestable_jvp
    def jvp(ctx, dx, _):
        return _AllGatherSharded.apply(dx, ctx.sg)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterRows.apply(g, ctx.sg), None


@per_lane_vmap
class _ReduceScatterRows(torch.autograd.Function):

    @staticmethod
    def forward(t, sg):
        rows = t.shape[0] // sg.size
        return all_reduce_sum(t, sg).narrow(0, sg.rank * rows, rows) \
            .contiguous()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sg = inputs[1]

    @staticmethod
    @nestable_jvp
    def jvp(ctx, dt, _):
        return _ReduceScatterRows.apply(dt, ctx.sg)

    @staticmethod
    def backward(ctx, g):
        return _AllGatherSharded.apply(g, ctx.sg), None


def all_gather_sharded(x: torch.Tensor, sg) -> torch.Tensor:
    """The whole vector (or block) from the ranks' rows ``x``, for the
    rank's own computation; the gradient is the reduce-scatter of the
    ranks' gradients."""
    return _AllGatherSharded.apply(x, sg)


def reduce_scatter_rows(t: torch.Tensor, sg) -> torch.Tensor:
    """The rank's rows of the sum over ranks of ``t`` (whose leading
    dimension the ranks split evenly); the gradient is the all-gather of
    the ranks' gradients."""
    if t.shape[0] % sg.size:
        raise ValueError(f"{t.shape[0]} rows do not split over {sg.size} "
                         f"ranks")
    return _ReduceScatterRows.apply(t, sg)


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


def ppermute(x: torch.Tensor, sg, perm) -> torch.Tensor:
    """``lax.ppermute`` over the ranks of ``sg``: ``perm`` is a sequence
    of (source, destination) shard indices; this rank's ``x`` goes to its
    destination and the result is what its source sent (zeros where no
    rank sends here).  Every rank passes the same ``perm`` and an ``x``
    of one shape and dtype.  Differentiable to any order: the gradient
    travels back by the inverse permutation."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    _peers(sg, perm)
    return _Ppermute.apply(x, sg, perm)


class ShardedVectors:
    """The layout of vectors sharded over the ranks of ``group``: a rank
    holds rows ``[offset, offset + local_dim)`` of every N-vector and
    every (N, r) block.  The solvers take their contractions over the
    vector axis through it (``ops/operators.py``, ``vector_layout``);
    every result is the same on every rank, so the ranks stay in step.
    Two layouts are equal when their kind, group and dimension are.

    The rank's rows are the global rows of :meth:`_segments`, in that
    order: one segment here; the Hermitian embedding's two
    (:class:`StackedVectors`)."""

    def __init__(self, group, dim: int):
        if dim % group.size:
            raise ValueError(f"dim {dim} not divisible by {group.size} "
                             f"shards")
        self.group = group
        self.dim = int(dim)
        self.local_dim = self.dim // group.size
        self.offset = group.rank * self.local_dim

    def _key(self):
        return self.group, self.dim

    def __eq__(self, other):
        return type(other) is type(self) and self._key() == other._key()

    def _segments(self):
        """``((start, length), ...)``: the global rows the rank holds, in
        the order it holds them (ascending)."""
        return ((self.offset, self.local_dim),)

    def sum(self, t):
        """The sum over ranks of the local contraction ``t``."""
        return sum_over_ranks(t, self.group)

    def bcast(self, t):
        """A replicated ``t`` entering the rank's rows: its gradient
        shares are summed over the ranks."""
        return replicate(t, self.group)

    def norm(self, x, dim=None):
        """The 2-norm of the whole vector (of each column with
        ``dim=0``)."""
        local = torch.linalg.vector_norm(x, dim=dim)
        return torch.sqrt(self.sum(local * local))

    def rows(self, t):
        """The rank's rows of a whole (N, ...) tensor."""
        parts = [t.narrow(0, s, n) for s, n in self._segments()]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def draw(self, shape, generator, dtype, device):
        """``torch.randn(shape)`` of the whole (N, ...) tensor from
        ``generator`` (as an unsharded run draws it), narrowed to the
        rank's rows.  The whole draw is transient: N numbers, next to the
        (k+1) N of a Krylov basis."""
        full = torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
        return self.rows(full).clone()

    def _global_rows(self, device):
        """The global index of each of the rank's rows."""
        return torch.cat([torch.arange(s, s + n, device=device)
                          for s, n in self._segments()])

    def pivot(self, v):
        """``(idx, entry)``: the global index of the first largest |v| (of
        each column of an (N/p, r) block) and the entry there, the same on
        every rank (``torch.argmax`` of the whole vector).  One
        all-gather of each rank's (max |v|, index, entry)."""
        block = v if v.ndim == 2 else v[:, None]
        mag = torch.abs(block)
        # The rank's rows ascend globally: its first largest is its lowest.
        local = torch.argmax(mag, dim=0)
        entry = torch.gather(block, 0, local[None])[0]
        parts = [torch.gather(mag, 0, local[None])[0].double(),
                 self._global_rows(v.device)[local].double()]
        parts += ([entry.real.double(), entry.imag.double()]
                  if entry.is_complex() else [entry.double()])
        got = all_gather_rows(torch.stack(parts)[None], self.group)
        # Among the ranks with the largest magnitude, the lowest index.
        top = got[:, 0].max(dim=0).values
        index = torch.where(got[:, 0] == top, got[:, 1],
                            torch.full_like(got[:, 1], float("inf")))
        best = torch.argmin(index, dim=0)
        pick = got[best, :, torch.arange(block.shape[1],
                                          device=best.device)]
        idx = pick[:, 1].long()
        entry = (torch.complex(pick[:, 2], pick[:, 3]) if entry.is_complex()
                 else pick[:, 2]).to(v.dtype)
        return (idx[0], entry[0]) if v.ndim == 1 else (idx, entry)

    def _owned(self, idx):
        """Whether the rank holds global ``idx``, and its local row
        there (0 where it does not)."""
        mine = torch.zeros_like(idx, dtype=torch.bool)
        local = torch.zeros_like(idx)
        first = 0
        for s, n in self._segments():
            inside = (idx >= s) & (idx < s + n)
            local = torch.where(inside, idx - s + first, local)
            mine = mine | inside
            first += n
        return mine, local

    def take(self, t, idx):
        """The entries of the whole ``t`` at global ``idx`` (a scalar
        index for an (N/p,) ``t``, one per column of an (N/p, r) block),
        the same on every rank; differentiable (a sum over ranks of the
        owner's entry)."""
        mine, local = self._owned(idx)
        if t.ndim == 1:
            got = t[local]
        else:
            got = torch.gather(t, 0, local[None])[0]
        return self.sum(torch.where(mine, got, torch.zeros_like(got)))

    def one_hot(self, idx, dtype):
        """The rank's rows of the unit vector e_idx (an (N/p,) vector), or
        of one per column (an (N/p, r) block)."""
        rows = self._global_rows(idx.device)
        hot = rows == idx if idx.ndim == 0 else rows[:, None] == idx[None, :]
        return hot.to(dtype)

    def tall_qr(self, z):
        """The thin QR of the whole (N, r) block whose rows ``z`` the rank
        holds: ``(the rank's rows of Q, R)``, R the same on every rank.
        A local QR, then the QR of the ranks' R factors stacked in rank
        order (one all-gather of r x r).  At one rank the second QR is of
        a triangular R, its Q the identity, and this is ``torch.linalg.qr``
        exactly.  Forward only (the block power iteration's)."""
        q, r = torch.linalg.qr(z)
        qs, r = torch.linalg.qr(all_gather_rows(r, self.group))
        k = z.shape[1]
        return hmatmul(q, qs[self.group.rank * k:(self.group.rank + 1) * k]), r

    def stacked(self):
        """The layout of the Hermitian embedding's vectors (u; v) of an
        operator on this layout (:class:`StackedVectors`)."""
        return StackedVectors(self)

    def bordered(self, k: int):
        """The layout of a bordered vector (x; ν) with x on this layout
        and a border of ``k`` entries (:class:`BorderedVectors`)."""
        return BorderedVectors(self, k)


class StackedVectors(ShardedVectors):
    """The layout of the (2N,) vectors ``(u; v)`` of the Hermitian
    embedding ``[[0, A], [A^H, 0]]`` of an operator A on ``inner``'s
    sharded N-vectors: a rank holds its rows of u and its rows of v,
    global rows ``[o, o + N/p)`` and ``[N + o, N + o + N/p)``, stacked in
    that order (``w[:N/p]`` is its u, ``w[N/p:]`` its v).  The draws are
    the rows of the whole (2N, ...) draw, and the pivot breaks a tie of
    magnitude by the lowest global index, as ``torch.argmax`` of the whole
    vector does (not by rank: rank 1's u rows come before rank 0's v
    rows)."""

    def __init__(self, inner: ShardedVectors):
        self.inner = inner
        self.group = inner.group
        self.dim = 2 * inner.dim
        self.local_dim = 2 * inner.local_dim

    def _key(self):
        return self.inner._key()

    def _segments(self):
        lay = self.inner
        return ((lay.offset, lay.local_dim),
                (lay.dim + lay.offset, lay.local_dim))


class BorderedVectors:
    """The layout of a bordered vector ``z = (x; ν)``: x the rank's rows
    of a vector on the sharded ``inner`` layout, ν a border of ``k``
    entries that the first rank holds after its rows and every other rank
    holds as zeros.  A local dot summed over the ranks then counts ν
    once, so the Krylov loops run on z with ``inner``'s sums and norms;
    a product on z reads ν with :meth:`exchange` and writes its border
    with :meth:`join`, which keeps the zeros.  (Summing a ν that every
    rank held would count it p times.)"""

    def __init__(self, inner: ShardedVectors, k: int):
        self.inner, self.k = inner, int(k)
        self.group = inner.group
        self.dim = inner.dim + self.k
        self.local_dim = inner.local_dim + self.k
        self.holds_border = inner.group.rank == 0

    def __eq__(self, other):
        return isinstance(other, BorderedVectors) and \
            (self.inner, self.k) == (other.inner, other.k)

    def sum(self, t):
        return self.inner.sum(t)

    def bcast(self, t):
        return self.inner.bcast(t)

    def norm(self, x, dim=None):
        return self.inner.norm(x, dim)

    def join(self, x, nu):
        """The bordered vector of the rank's rows ``x`` and the replicated
        border ``nu``: ``nu`` after the first rank's rows, zeros after the
        others' (kept in the graph: every rank runs the backward's
        collectives)."""
        return torch.cat([x, nu * (1.0 if self.holds_border else 0.0)])

    def exchange(self, tail, t):
        """``(ν, Σ t)`` in one all-reduce: ν, the border of a bordered
        vector whose local tail is ``tail``, and the local contraction
        ``t`` (k,) summed over the ranks, both replicated and marked as
        they enter the rank's rows (:meth:`ShardedVectors.bcast`)."""
        both = self.sum(torch.cat([tail, t]))
        return self.bcast(both[:self.k]), self.bcast(both[self.k:])
