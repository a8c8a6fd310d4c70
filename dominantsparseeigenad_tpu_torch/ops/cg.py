"""Conjugate gradient, MINRES and the deflated solves of the IFT rules.

Counterpart of ``cg``, ``cg_info``, ``minres``, ``solve_spd``,
``solve_symmetric``, ``solve_deflated`` and ``solve_deflated_info`` in
``dominantsparseeigenad_tpu/ops/cg.py``, with rank-1 (V of shape (N,))
and block (V of shape (N, r)) deflation.  A right-hand side of shape
(N, m) with one shift per column is solved by a batched CG over the
columns, the written-out counterpart of the ``jax.vmap(solve_deflated)``
in the block eigensolver's tangent rule (``eigh.py::_multi_pair_tangents``):
one operator ``matmat`` of width m per iteration.  ``solve_deflated`` is
differentiable to any order, the counterpart of the
``lax.custom_linear_solve`` the JAX solve wraps its solver in: its
backward is one more deflated solve, by the same method and with the
same preconditioner, and one deflated product (:class:`_DeflatedSolve`),
so the IFT rules of ``eigh.py`` that call it differentiate again under
``create_graph``.  ``solve_spd`` and ``solve_symmetric`` are the same
Function with nothing deflated.  BiCGSTAB, GMRES and ``solve_general``
come with the non-symmetric solver (``ROADMAP.md`` queue 1 item 8).
"""

from __future__ import annotations

from typing import Callable

import torch

from .operators import (LinearOperator, as_operator, check_device, hdot,
                        hmatmul, partial_vjp, refuse_complex, tol_floor)
from .precond import _apply_columns

# The JAX loops test the residual on the device every iteration inside a
# ``lax.while_loop``.  Eager PyTorch would have to read it on the host,
# which waits for the card each time; instead the host reads it once
# every CHECK_EVERY iterations, and in between the device freezes the
# state once the residual meets the tolerance (CG: alpha = 0, p and rz
# kept; MINRES: every quantity kept), so a solve may run up to
# CHECK_EVERY - 1 products past the one that met it without changing x.
# (An iteration past convergence is not harmless: on a deflated system,
# singular on span(V), the round-off residual's span(V) component makes
# p^T M p tiny, and one more step with alpha = rz / p^T M p throws x off.)
CHECK_EVERY = 10


def _project_out(V, x):
    """``x - V <V, x>`` for a unit vector V and x of shape (N,), or for
    an (N, r) V with orthonormal columns and x of shape (N,) or (N, m)."""
    if V.ndim == 1:
        return x - V * hdot(V, x)
    return x - hmatmul(V, hmatmul(V.T, x))


def _nonzero(t):
    """``t`` with its zeros replaced by ones (a safe divisor)."""
    return torch.where(t == 0, torch.ones_like(t), t)


def _cg_loop(matvec: Callable, b, tol: float, maxiter, x0=None,
             atol: float = 0.0, precond: Callable | None = None):
    """Preconditioned CG; returns ``(x, iterations run)``, the second
    counting the products made (frozen iterations included).  Stops once
    ``||r|| <= max(tol ||b||, atol)``, as the JAX loop does."""
    if maxiter is None:
        maxiter = 10 * b.shape[-1]
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.to(b.dtype).clone()
        r = b - matvec(x)
    z = r if precond is None else precond(r)
    p = z.clone()
    rr = hdot(r, r)
    rz = rr if precond is None else hdot(r, z)
    tol = tol_floor(tol, b.dtype)
    target2 = torch.clamp(tol * tol * hdot(b, b), min=float(atol) ** 2)
    zero = torch.zeros_like(rz)
    it = 0
    while it < maxiter:
        if not bool(rr > target2):
            break
        for _ in range(min(CHECK_EVERY, maxiter - it)):
            active = rr > target2
            ap = matvec(p)
            denom = hdot(p, ap)
            alpha = torch.where(active & (denom != 0), rz / _nonzero(denom),
                                zero)
            x = x + alpha * p
            r = r - alpha * ap
            z = r if precond is None else precond(r)
            rr_new = hdot(r, r)
            rz_new = rr_new if precond is None else hdot(r, z)
            beta = rz_new / _nonzero(rz)
            p = torch.where(active, z + beta * p, p)
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, rr_new, rr)
            it += 1
    return x, it


def cg(matvec: Callable, b: torch.Tensor, *, x0: torch.Tensor | None = None,
       tol: float = 1e-7, atol: float = 0.0, maxiter: int | None = None,
       precond: Callable | None = None, device=None) -> torch.Tensor:
    """(Preconditioned) conjugate gradient for an SPD ``matvec``.

    Stops once ``||r|| <= max(tol ||b||, atol)`` (``tol`` clamped to what
    the dtype can reach), tested every ``CHECK_EVERY`` iterations, or
    after ``maxiter`` iterations (default 10 N).  ``x0`` is the start
    (zero when None); ``precond`` an SPD approximate inverse
    ``z = M^{-1} r`` (see :mod:`~.precond`).
    """
    check_device(device, b)
    refuse_complex(b.dtype, "b")
    return _cg_loop(matvec, b, tol, maxiter, x0, atol, precond)[0]


def cg_info(matvec: Callable, b: torch.Tensor, *,
            x0: torch.Tensor | None = None, tol: float = 1e-7,
            atol: float = 0.0, maxiter: int | None = None,
            precond: Callable | None = None, device=None):
    """:func:`cg` that also returns ``(iterations, relative_residual)``:
    the products made (up to ``CHECK_EVERY - 1`` past the iteration that
    met the tolerance, whose steps are frozen) and ``||b - A x|| /
    ||b||`` from one extra matvec.  Forward-only."""
    check_device(device, b)
    refuse_complex(b.dtype, "b")
    with torch.no_grad():
        x, it = _cg_loop(matvec, b, tol, maxiter, x0, atol, precond)
        res = torch.linalg.vector_norm(b - matvec(x)) \
            / torch.linalg.vector_norm(b)
    return x, it, float(res)


def _minres_loop(matvec: Callable, b, tol: float, maxiter, x0=None,
                 precond: Callable | None = None):
    """Paige-Saunders MINRES (the JAX ``minres`` recurrence, line for
    line); returns ``(x, iterations run)``, products made, frozen ones
    included.  Once ``phibar`` meets the target every quantity of the
    state is kept, as the JAX ``while_loop`` would stop there."""
    if maxiter is None:
        maxiter = 10 * b.shape[-1]
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    r = b.clone() if x0 is None else b - matvec(x)
    yv = r if precond is None else precond(r)
    beta1 = torch.sqrt(torch.clamp(hdot(r, yv), min=0.0))
    tol = tol_floor(tol, b.dtype)
    # The M^{-1} norm phibar tracks; for M = I and x0 = 0, tol ||b||.
    target = tol * (torch.linalg.vector_norm(b) if precond is None
                    else beta1)
    zero = torch.zeros_like(beta1)
    tiny = torch.finfo(b.dtype).tiny
    # x, r1, r2, yv, w, w2, oldb, beta, dbar, epsln, cs, sn, phibar
    state = [x, r, r, yv, torch.zeros_like(b), torch.zeros_like(b), zero,
             beta1, zero, zero, -torch.ones_like(beta1), zero, beta1]
    it = 0
    while it < maxiter:
        if not bool(state[-1] > target):
            break
        for _ in range(min(CHECK_EVERY, maxiter - it)):
            (x, r1, r2, yv, w, w2, oldb, beta, dbar, epsln, cs, sn,
             phibar) = state
            active = phibar > target
            v = yv / _nonzero(beta)
            y = matvec(v)
            if it >= 1:
                y = y - (beta / _nonzero(oldb)) * r1
            alfa = hdot(v, y)
            y = y - (alfa / _nonzero(beta)) * r2
            r1, r2 = r2, y
            yv = y if precond is None else precond(y)
            oldb = beta
            beta_new = torch.sqrt(torch.clamp(hdot(y, yv), min=0.0))
            oldeps = epsln
            delta = cs * dbar + sn * alfa
            gbar = sn * dbar - cs * alfa
            epsln = sn * beta_new
            dbar = -cs * beta_new
            gamma = torch.clamp(torch.sqrt(gbar * gbar + beta_new * beta_new),
                                min=tiny)
            cs = gbar / gamma
            sn = beta_new / gamma
            phi = cs * phibar
            phibar = sn * phibar
            w1, w2_new = w2, w
            w_new = (v - oldeps * w1 - delta * w2_new) / gamma
            x = x + phi * w_new
            new = (x, r1, r2, yv, w_new, w2_new, oldb, beta_new, dbar,
                   epsln, cs, sn, phibar)
            state = [torch.where(active, a, o) for a, o in zip(new, state)]
            it += 1
    return state[0], it


def minres(matvec: Callable, b: torch.Tensor, *,
           x0: torch.Tensor | None = None, tol: float = 1e-7,
           maxiter: int | None = None, precond: Callable | None = None,
           device=None) -> torch.Tensor:
    """MINRES for a symmetric, possibly indefinite ``matvec``.

    Stops once the residual estimate ``phibar <= tol ||b||`` (in the
    ``M^{-1}`` norm with a preconditioner: ``tol sqrt(b^T M^{-1} b)``),
    tested every ``CHECK_EVERY`` iterations, or after ``maxiter``
    iterations (default 10 N).  ``precond`` is an SPD approximate inverse
    ``y = M^{-1} r`` (the operator may stay indefinite): the Lanczos
    recurrence runs on the preconditioned residuals with
    ``beta = sqrt(r^T M^{-1} r)``.  With ``precond=None`` this is exactly
    the unpreconditioned recurrence.
    """
    check_device(device, b)
    refuse_complex(b.dtype, "b")
    return _minres_loop(matvec, b, tol, maxiter, x0, precond)[0]


def _deflated_mv(op, lam, V, sign, batched):
    """``x -> sign * P (A - lam I) P x``, ``P = I - V V^T``: on (N,)
    vectors with a scalar ``lam``, or on (N, m) blocks with one shift per
    column in ``lam`` (m,)."""
    if batched:
        def mv(x):
            px = _project_out(V, x)
            return sign * _project_out(V, op.matmat(px) - px * lam[None, :])
    else:
        def mv(x):
            px = _project_out(V, x)
            return sign * _project_out(V, op.matvec(px) - lam * px)
    return mv


def _deflated_precond(precond, V, batched):
    """The preconditioner projected as ``P M P``, which maps V⊥ to V⊥
    (for CG and MINRES alike: PSD with null space span(V), which the
    deflated recurrences never touch); applied column by column to an
    (N, m) block.  The recurrences hand it residuals in V⊥ already, so
    only its output is projected, as in the JAX solve."""
    if precond is None:
        return None
    if batched:
        precond = _apply_columns(precond)
    return lambda r: _project_out(V, precond(r))


def _deflated_solve(op, lam, V, rhs, sign, tol, maxiter, method="cg",
                    precond=None):
    """``P solve(M, P rhs)``, the solver that the JAX package hands to
    ``custom_linear_solve``: the right-hand side is projected onto V⊥
    (a cotangent or tangent with a span(V) component would make the
    solver divide by round-off; M is singular there) and so is the
    result.  Returns ``(x, iterations)``, per column for an (N, m)
    ``rhs`` (which only CG solves)."""
    batched = rhs.ndim == 2
    mv = _deflated_mv(op, lam, V, sign, batched)
    m = _deflated_precond(precond, V, batched)
    if method == "minres":
        if batched:
            raise NotImplementedError(
                "method='minres' solves one right-hand side at a time")
        loop = _minres_loop
    else:
        loop = _cg_columns_loop if batched else _cg_loop
    args = (mv, _project_out(V, rhs), tol, maxiter)
    x, its = loop(*args) if m is None else loop(*args, precond=m)
    return _project_out(V, x), its


def _cg_columns_loop(matmat: Callable, B, tol: float, maxiter,
                     precond: Callable | None = None):
    """Batched (preconditioned) CG from X0 = 0 over the columns of ``B``
    (N, m), one ``matmat`` of width m per iteration; returns ``(X,
    iterations per column)``.

    Each column has its own alpha and beta, and is frozen once its own
    residual meets ``tol`` (state kept, as a lane of a vmapped
    ``while_loop`` is): whether a column is still active is decided on
    the device every iteration, and the host reads whether any is left
    every ``CHECK_EVERY`` iterations.  ``precond`` maps (N, m) blocks.
    """
    n, m = B.shape
    if maxiter is None:
        maxiter = 10 * n
    X = torch.zeros_like(B)
    R = B.clone()
    Z = R if precond is None else precond(R)
    P = Z.clone()
    rr = (R * R).sum(dim=0)
    rz = rr if precond is None else (R * Z).sum(dim=0)
    tol = tol_floor(tol, B.dtype)
    target2 = tol * tol * rr
    its = torch.zeros(m, dtype=torch.int64, device=B.device)
    zero = torch.zeros_like(rz)
    it = 0
    while it < maxiter:
        if not bool((rr > target2).any()):
            break
        for _ in range(min(CHECK_EVERY, maxiter - it)):
            active = rr > target2
            AP = matmat(P)
            denom = (P * AP).sum(dim=0)
            alpha = torch.where(active & (denom != 0), rz / _nonzero(denom),
                                zero)
            X = X + alpha * P
            R = R - alpha * AP
            Z = R if precond is None else precond(R)
            rr_new = (R * R).sum(dim=0)
            rz_new = rr_new if precond is None else (R * Z).sum(dim=0)
            beta = rz_new / _nonzero(rz)
            P = torch.where(active, Z + beta * P, P)
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, rr_new, rr)
            its += active
            it += 1
    return X, its


class _DeflatedSolve(torch.autograd.Function):
    """``x = M^+ rhs`` for ``M = sign P (A(θ) - λ) P``, differentiable in
    ``rhs``, ``λ``, ``V`` and the operator's parameters θ by the rule of
    ``lax.custom_linear_solve`` (M is symmetric, so its transpose solve
    is the same solve):

        w = M^+ x̄,   rhs̄ = w,   (λ̄, V̄, θ̄) = -∂/∂(λ, V, θ) <w, M x>,

    the last with x held constant: one more solve (the same ``method``
    and preconditioner) and one deflated product per backward.  The
    forward runs the solver with no graph (no iteration is ever
    recorded); the backward is built of this Function and differentiable
    operations only, so under ``create_graph`` it differentiates again,
    to any order.  An empty (N, 0) ``V`` deflates nothing: that is
    :func:`solve_spd` and :func:`solve_symmetric`."""

    @staticmethod
    def forward(ctx, op, sign, tol, maxiter, method, precond, rhs, lam, V,
                *params):
        x, _ = _deflated_solve(op, lam, V, rhs, sign, tol, maxiter, method,
                               precond)
        ctx.op, ctx.cfg = op, (sign, tol, maxiter, method, precond)
        ctx.save_for_backward(x, lam, V)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        op, cfg = ctx.op, ctx.cfg
        sign = cfg[0]
        x, lam, V = ctx.saved_tensors
        w = _DeflatedSolve.apply(op, *cfg, x_bar, lam, V, *op.parameters())
        grads = partial_vjp(
            op, lambda held, lam_, V_: _deflated_mv(held, lam_, V_, sign,
                                                    x.ndim == 2)(x),
            [lam, V], -w, ctx.needs_input_grad[7:])
        rhs_bar = w if ctx.needs_input_grad[6] else None
        return (None,) * 6 + (rhs_bar, *grads)


def _shifts(lam, b):
    """``lam`` as a tensor of ``b``'s dtype and device (a tensor that is
    one already stays itself, graph and all): a scalar for an (N,) ``b``,
    one shift per column for an (N, m) ``b``."""
    lam = torch.as_tensor(lam, dtype=b.dtype, device=b.device)
    want = (b.shape[1],) if b.ndim == 2 else ()
    if lam.shape != want:
        raise ValueError(f"a right-hand side of shape {tuple(b.shape)} "
                         f"needs shifts of shape {want}, got "
                         f"{tuple(lam.shape)}")
    return lam


def solve_deflated_info(op, lam, V, b, *, definite_sign: float = 1.0,
                        tol: float = 1e-7, maxiter: int | None = None,
                        precond: Callable | None = None, device=None):
    """Forward-only :func:`solve_deflated` (CG) that also returns
    ``(iterations, relative_residual)`` of its CG, the residual taken on
    the deflated system with one extra matvec (matmat).  For an (N, m)
    right-hand side both are lists with one entry per column."""
    op = as_operator(op)
    check_device(device, op, V, b)
    refuse_complex(b.dtype, "b")
    sign = float(definite_sign)
    with torch.no_grad():
        lam = _shifts(lam, b)
        rhs = sign * _project_out(V, b)
        x, its = _deflated_solve(op, lam, V, rhs, sign, tol, maxiter,
                                 "cg", precond)
        mv = _deflated_mv(op, lam, V, sign, b.ndim == 2)
        rhs = _project_out(V, rhs)
        bnorm = torch.linalg.vector_norm(rhs, dim=0)
        res = torch.linalg.vector_norm(rhs - mv(x), dim=0) / _nonzero(bnorm)
    if b.ndim == 2:
        return x, its.tolist(), res.tolist()
    return x, its, float(res)


def solve_deflated(op, lam, V, b, *, definite_sign: float = 1.0,
                   tol: float = 1e-7, maxiter: int | None = None,
                   method: str = "cg", precond: Callable | None = None,
                   device=None) -> torch.Tensor:
    """Solve ``P (A - lam I) P x = P b`` on ``span(V)⊥``,
    ``P = I - V V^T``, differentiably (see :class:`_DeflatedSolve`).

    ``V`` is the (N,) unit eigenvector being deflated, or an (N, r) block
    of orthonormal ones.  ``b`` is (N,) with a scalar ``lam``, or (N, m)
    with one shift per column in ``lam`` (m,), solved by the batched CG
    (each column stops at its own tolerance).  ``definite_sign`` makes the
    restricted operator positive definite for CG: +1 when ``lam`` is the
    algebraic minimum, -1 when it is the maximum (CG then runs on
    ``lam I - A``).  ``method="minres"`` solves the (possibly indefinite)
    restriction with MINRES instead, for an interior ``lam`` (an (N,)
    ``b`` only); ``definite_sign`` is then ignored.  ``precond`` is an SPD
    approximate inverse ``z = M^{-1} r`` in the vector convention, used
    projected (``P M P``) by either solver and, for an (N, m) ``b``,
    column by column.  The returned x solves the unsigned equation and is
    the solution orthogonal to V.  It is differentiable in ``b``,
    ``lam``, ``V`` and ``op.parameters()``, to any order, and no
    derivative is taken through the solver's iterations.
    """
    if method not in ("cg", "minres"):
        raise ValueError(f"method must be cg|minres, got {method!r}")
    op = as_operator(op)
    check_device(device, op, V, b)
    refuse_complex(b.dtype, "b")
    sign = 1.0 if method == "minres" else float(definite_sign)
    lam = _shifts(lam, b)
    # The two projections of the JAX solve: this one differentiable, the
    # second inside the solver (a right-hand side nearly parallel to V
    # leaves a round-off remainder whose own V component is large).
    rhs = sign * _project_out(V, b)
    x = _DeflatedSolve.apply(op, sign, tol, maxiter, method, precond, rhs,
                             lam, V, *op.parameters())
    # Keep x exactly in V⊥, differentiably: round-off would leak a
    # span(V) component into the gradients downstream.
    return _project_out(V, x)


def _undeflated(op, b, tol, maxiter, method, device):
    """``A^{-1} b`` through :class:`_DeflatedSolve` with nothing deflated
    (an empty (N, 0) V, λ = 0): gradients to ``b`` and
    ``op.parameters()``."""
    if callable(op) and not isinstance(op, (LinearOperator, torch.Tensor)):
        # The JAX solve differentiates into whatever its matvec closes
        # over; an autograd Function cannot see a closure's tensors and
        # would drop their gradients without a word.
        raise TypeError(
            "pass a LinearOperator or a dense tensor, not a bare callable: "
            "wrap the matvec in MatrixFreeOperator(fn, params, dim) so that "
            "the tensors it uses (params) get their gradients")
    op = as_operator(op)
    check_device(device, op, b)
    refuse_complex(b.dtype, "b")
    empty = torch.zeros((op.dim, 0), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    return _DeflatedSolve.apply(op, 1.0, tol, maxiter, method, None, b,
                                zero, empty, *op.parameters())


def solve_spd(op, b: torch.Tensor, *, tol: float = 1e-7,
              maxiter: int | None = None, device=None) -> torch.Tensor:
    """Differentiable SPD solve ``A x = b`` by CG, to any order in ``b``
    and ``op.parameters()`` (a :class:`~.operators.LinearOperator` or a
    dense tensor; a bare callable raises TypeError)."""
    return _undeflated(op, b, tol, maxiter, "cg", device)


def solve_symmetric(op, b: torch.Tensor, *, tol: float = 1e-7,
                    maxiter: int | None = None, device=None) -> torch.Tensor:
    """Differentiable symmetric (possibly indefinite) solve ``A x = b``
    by MINRES, to any order in ``b`` and ``op.parameters()`` (as
    :func:`solve_spd`)."""
    return _undeflated(op, b, tol, maxiter, "minres", device)
