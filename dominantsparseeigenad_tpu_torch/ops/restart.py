"""Thick-restart Lanczos (TRLan, Wu & Simon): bounded-memory eigensolving.

Counterpart of ``dominantsparseeigenad_tpu/ops/restart.py``.  The plain
k-step Lanczos of ``lanczos.py`` holds a (k+1, N) basis; thick restart
holds a (k+1, N) window whatever the number of cycles: after each cycle
the best ``l`` Ritz vectors are kept together with the next Lanczos
vector, the projected matrix restarts as an arrowhead (diag(θ) bordered
by the residual couplings s_i), and the recurrence goes on.

Each cycle writes its window into one preallocated (k+1, N) slab, row by
row in place.  The reorthogonalization of step j runs against the rows
written so far, ``slab[:j+1]``: one matrix-vector product for the
coefficients and one for the update, in true fp32/fp64 (``hmatmul``,
never TF32).  The Ritz recombination is one product ``sel^T @ slab[:k]``,
and the state keeps new tensors, never views of the slab, so a cycle
frees its window when it returns.

The state between cycles, :class:`RestartState`, is a plain NamedTuple of
tensors: ``utils.checkpoint.save_pytree`` writes it in the JAX package's
format, and a run resumed from it is bitwise the uninterrupted one.  The
random vector that continues a broken-down recurrence is a pure function
of (0x5452, step index), a fresh generator seeded ``0x5452 + j`` (the JAX
package folds the step index into ``PRNGKey(0x5452)``), so a resumed
process draws what an uninterrupted one draws.  The breakdown test is
read on the host every step (the JAX ``lax.cond``).  Each host read is
a ``host_read`` range of ``spans.py``, and each step's projections
against the window the range ``restart_reorth``, while a profiler
records.

Forward only: ``dominant_eigh(restart_cycles=...)`` differentiates the
converged pair by the implicit-function-theorem rule of ``eigh.py``.
Complex Hermitian operators run the same cycles (real arrowhead, real
Ritz values).

Over sharded vectors (``operators.vector_layout``) the window, the
retained vectors y and q are the rank's rows (a (k+1, N/p) slab): α, β,
the projections and the norms are summed over the ranks, and the restart
vector is the whole seeded draw narrowed to the rank's rows, so every
host branch (breakdown, exhaustion, a dead continuation) reads a value
that is the same on every rank, and the arrowhead, its eigenpairs and θ
and s are too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lanczos import _breakdown_rel_tol, _tridiagonal_eigh, lanczos
from .operators import (_reduced, as_operator, check_device, hdot, hmatmul,
                        layout_norm, layout_sum, local_dim, pivot_gauge,
                        real_dtype, vector_layout)
from .spans import host_read, span

# The JAX package's restart stream, PRNGKey(0x5452).
RESTART_SEED = 0x5452


class RestartState(NamedTuple):
    """State between thick-restart cycles (checkpointable).

    theta : (l,)    retained Ritz values
    y     : (l, N)  retained Ritz vectors (rows; the rank's N/p columns
                    over sharded vectors)
    s     : (l,)    residual couplings beta_k * (last eigvec components)
    q     : (N,)    next Lanczos vector (the rank's rows over sharded
                    vectors)
    """

    theta: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    q: torch.Tensor


def _project(rows, w, layout=None):
    """``w - rows^T (conj(rows) w)``: ``w`` projected off the rows (the
    coefficients summed over the ranks of a sharded ``layout``)."""
    return w - hmatmul(rows.T, _reduced(layout, hmatmul(rows.conj(), w)))


def _fresh_vector(n, j, dtype, dev, rows, layout=None):
    """The restart vector of step ``j``: a seeded draw of the whole N
    (the rank's rows of it under a sharded ``layout``), normalized and
    projected twice off ``rows``; returns ``(vector, exhausted)``, the
    second True when no direction orthogonal to the rows is left."""
    rdt = real_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(RESTART_SEED + j)
    if layout is None:
        r = torch.randn(n, generator=gen, dtype=dtype, device=dev)
    else:
        r = layout.draw((n,), gen, dtype, dev)
    r = _project(rows, _project(rows, r / layout_norm(layout, r), layout),
                 layout)
    rn = layout_norm(layout, r)
    exhausted = host_read("restart_fresh",
                          rn <= (float(n) ** 0.5) * _breakdown_rel_tol(rdt))
    return r / torch.clamp(rn, min=torch.finfo(rdt).tiny), exhausted


def _continuation(w, b, scale, dead_in, j, rows, n, layout=None):
    """``(q_next, beta_out, dead_out)`` after step ``j``.

    On a breakdown (β ~ 0 relative to ``scale``) the recurrence restarts
    from a fresh vector orthogonal to ``rows`` with a zero coupling: a
    normalized ~0 residual is not orthogonal to the basis, and projecting
    against a non-orthonormal window amplifies round-off from cycle to
    cycle.  If no orthogonal direction is left, or the run is dead
    already, the remaining steps are dead: zero vectors, zero
    couplings.  ``n`` is the whole dimension; ``b`` and ``scale`` are
    replicated under a sharded ``layout``."""
    broke = host_read("restart_breakdown",
                      b <= _breakdown_rel_tol(b.dtype) * scale)
    dead = dead_in
    if broke and not dead_in:
        q_next, dead = _fresh_vector(n, j, w.dtype, w.device, rows, layout)
    elif not broke:
        q_next = w / b
    if dead:
        return torch.zeros_like(w), torch.zeros_like(b), True
    return q_next, (torch.zeros_like(b) if broke else b), False


def _cycle(op, state: RestartState, k: int, extreme: str,
           reorth_passes: int):
    """One thick-restart cycle from ``state``: returns the state trimmed
    to its ``l`` retained pairs and the residual coupling ``|s_0|``.

    Steps l .. k-1 write rows l+1 .. k of the slab; step l is the
    arrowhead column (w = A q - Σ s_i y_i - α q), the others the plain
    recurrence with full reorthogonalization.  Dead rows (the space is
    exhausted) get their zero diagonal entries pushed past the requested
    spectral end, so the ordered Ritz selection never picks them."""
    l = state.theta.shape[0]
    dtype, dev = state.q.dtype, state.q.device
    rdt = real_dtype(dtype)
    layout = vector_layout(op)
    n = op.dim
    slab = torch.empty((k + 1, local_dim(op)), dtype=dtype, device=dev)
    slab[:l] = state.y
    slab[l] = state.q
    t = torch.zeros((k, k), dtype=rdt, device=dev)
    idx = torch.arange(l, device=dev)
    t[idx, idx] = state.theta
    t[l, :l] = state.s
    t[:l, l] = state.s
    dead_mask = [False] * k

    # A dead continuation vector from the previous cycle keeps the whole
    # cycle dead: a fresh vector there would re-derive eigenvalues that
    # theta already holds, and their duplicate Ritz vectors would break
    # the next cycle's orthonormality.
    dead = host_read("restart_dead", layout_norm(layout, state.q) < 0.5)
    q = slab[l]
    w = op.matvec(q)
    alpha = torch.zeros((), dtype=rdt, device=dev) if dead \
        else layout_sum(layout, hdot(q, w)).real
    w = w - alpha * q - hmatmul(state.s.to(dtype), slab[:l])
    with span("restart_reorth"):
        for _ in range(reorth_passes):
            w = _project(slab[:l + 1], w, layout)
    beta = layout_norm(layout, w)
    scale = alpha.abs() + torch.linalg.vector_norm(state.s) + 1.0
    dead_mask[l] = dead
    slab[l + 1], beta, dead = _continuation(w, beta, scale, dead, l,
                                            slab[:l + 1], n, layout)
    t[l, l] = alpha
    t[l + 1, l] = t[l, l + 1] = beta      # l + 2 <= k

    q_prev, beta_prev = q, beta
    for j in range(l + 1, k):
        q = slab[j]
        w = op.matvec(q)
        a = torch.zeros((), dtype=rdt, device=dev) if dead \
            else layout_sum(layout, hdot(q, w)).real
        w = w - a * q - beta_prev * q_prev
        with span("restart_reorth"):
            for _ in range(reorth_passes):
                w = _project(slab[:j + 1], w, layout)
        b = layout_norm(layout, w)
        scale = torch.sqrt(a * a + beta_prev * beta_prev) + 1.0
        dead_mask[j] = dead
        slab[j + 1], b, dead = _continuation(w, b, scale, dead, j,
                                             slab[:j + 1], n, layout)
        t[j, j] = a
        if j + 1 < k:
            t[j + 1, j] = t[j, j + 1] = b
        q_prev, beta_prev = q, b

    if any(dead_mask):
        # t is block-diagonal across the zeroed couplings: the shift is
        # exact (a Gershgorin bound of the genuine entries).
        bound = t.abs().sum() + 1.0
        mask = torch.tensor(dead_mask, device=dev)
        shift = bound if extreme == "min" else -bound
        t = t + torch.diag(torch.where(mask, shift, torch.zeros_like(bound)))
    with host_read("restart_arrowhead_eigh"):
        evals, evecs = torch.linalg.eigh(t.double())
    order = torch.arange(l, device=dev)
    if extreme == "max":
        order = k - 1 - order
    theta = evals[order].to(rdt)
    sel = evecs[:, order].to(rdt)                            # (k, l)
    y = hmatmul(sel.T.to(dtype), slab[:k])                   # (l, N)
    s = beta_prev * sel[k - 1]
    return RestartState(theta=theta, y=y, s=s, q=slab[k].clone()), \
        s[0].abs()


def _check_extreme(extreme):
    if extreme not in ("min", "max"):
        raise ValueError(f"extreme must be min|max, got {extreme!r}")


def restart_init(op, k: int = 64, *, num_kept: int | None = None,
                 extreme: str = "min", v0: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 reorth_passes: int = 2, device=None) -> RestartState:
    """Cycle 0 of thick-restart Lanczos: one plain k-step run compressed
    into a checkpointable :class:`RestartState`.

    Drive a long run cycle by cycle: ``state = restart_init(...)``, then
    ``state, resid = restart_cycle(op, state, k)`` again and again, with
    ``utils.save_pytree`` between cycles, and :func:`restart_extract` at
    the end; a killed run resumes from the last saved state, bit for bit.
    :func:`lanczos_restarted` is that loop in one call.

    ``k`` is clamped to ``op.dim``; ``num_kept`` (default ``max(1,
    k // 4)``) Ritz vectors are kept per restart; ``v0`` is the start
    vector, else drawn from ``generator`` (seeded 0 on the device when
    None).  One k-step Lanczos run plus one matvec, which rebuilds the
    continuation vector q_{k+1} the couplings refer to.
    """
    op = as_operator(op)
    _check_extreme(extreme)
    dev = check_device(device, op)
    layout = vector_layout(op)
    n, dtype = op.dim, op.dtype
    k = int(min(k, n))
    # At least one Ritz vector must be kept: l = 0 would give empty
    # arrays that restart_extract cannot read.
    l = int(max(1, k // 4) if num_kept is None else num_kept)
    if l < 1:
        raise ValueError(f"need num_kept >= 1, got {num_kept}")
    if l + 2 > k:
        raise ValueError(f"need k >= num_kept + 2, got k={k}, l={l}"
                         + (f" (k clamped to op.dim={n})" if k < 4 else ""))
    res = lanczos(op, k, v0=v0, generator=generator,
                  reorth_passes=reorth_passes, device=dev)
    rows = res.basis.T                                     # (k, N)
    evals, evecs = _tridiagonal_eigh(res.alphas, res.betas)
    order = torch.arange(l, device=dev)
    if extreme == "max":
        order = k - 1 - order
    theta = evals[order]
    sel = evecs[:, order]
    y = hmatmul(sel.T.to(dtype), rows)                     # (l, N)
    # q_{k+1} of the recurrence (the Lanczos result keeps k vectors):
    # w = A q_k - α_k q_k - β_{k-1} q_{k-1}, projected twice.
    qk = rows[-1]
    w = op.matvec(qk) - res.alphas[-1] * qk
    last_beta = torch.zeros((), dtype=theta.dtype, device=dev)
    if k > 1:
        last_beta = res.betas[-1]
        w = w - last_beta * rows[-2]
    w = _project(rows, _project(rows, w, layout), layout)
    beta_last = layout_norm(layout, w)
    q, beta, _ = _continuation(
        w, beta_last, res.alphas[-1].abs() + last_beta.abs() + 1.0, False,
        0, rows, n, layout)
    return RestartState(theta=theta, y=y, s=beta * sel[k - 1],
                        q=q)


def restart_cycle(op, state: RestartState, k: int, *, extreme: str = "min",
                  reorth_passes: int = 2):
    """One thick-restart cycle on a :class:`RestartState`.

    Returns ``(state, residual)``: the state with its ``l`` retained
    pairs (ready for the next cycle or a checkpoint) and the extremal
    pair's residual coupling ``|s_0|``.  ``k`` is clamped to ``op.dim``
    as :func:`restart_init` clamps its own (a window wider than the space
    would give spurious ~0 Ritz values).  Runs where the state lives.
    """
    op = as_operator(op)
    _check_extreme(extreme)
    check_device(state.q.device, op)
    l = state.theta.shape[0]
    k = int(min(k, op.dim))
    if l + 2 > k:
        raise ValueError(
            f"need k >= num_kept + 2, got k={k} (clamped to op.dim="
            f"{op.dim}) with {l} retained Ritz vectors")
    return _cycle(op, state, k, extreme, int(reorth_passes))


def restart_extract(state: RestartState, op=None):
    """Finalize a restart run: ``(lam, v, residual)`` of the extremal
    Ritz pair, ``v`` normalized and pivot-gauged like every forward
    here.  ``op``, the operator of the run, is needed only when its
    vectors are sharded over ranks (the norm and the pivot are then the
    whole vector's)."""
    layout = vector_layout(op)
    v = state.y[0]
    v = pivot_gauge(v / layout_norm(layout, v), layout=layout)
    return state.theta[0], v, state.s[0].abs()


def lanczos_restarted(op, k: int = 64, *, n_restarts: int = 8,
                      num_kept: int | None = None, extreme: str = "min",
                      v0: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      reorth_passes: int = 2, device=None):
    """Extremal eigenpair by thick-restart Lanczos with a (k+1, N)
    window.

    op         : symmetric/Hermitian LinearOperator (or dense tensor).
    k          : window size per cycle (clamped to ``op.dim``).
    n_restarts : restart cycles after the initial run.
    num_kept   : Ritz vectors kept per restart (default ``max(1, k//4)``).
    extreme    : "min" or "max".
    v0, generator : the start vector, or the generator it is drawn from.
    device     : where the run goes (CUDA when None).

    Returns ``(lam, v, residual)``: the extremal Ritz pair and its
    residual coupling ``|s_0|``.  ``k + n_restarts (k - num_kept) + 1``
    matvecs.  For checkpointed cycle-by-cycle driving use
    :func:`restart_init`, :func:`restart_cycle` and
    :func:`restart_extract`: this function is that loop.
    """
    op = as_operator(op)
    state = restart_init(op, k, num_kept=num_kept, extreme=extreme, v0=v0,
                         generator=generator, reorth_passes=reorth_passes,
                         device=device)
    for _ in range(int(n_restarts)):
        state, _ = restart_cycle(op, state, k, extreme=extreme,
                                 reorth_passes=reorth_passes)
    return restart_extract(state, op)
