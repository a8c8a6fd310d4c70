"""Conjugate gradient and the deflated solves of the IFT backwards.

Counterpart of ``cg``, ``solve_deflated`` (method "cg") and
``solve_deflated_info`` in ``dominantsparseeigenad_tpu/ops/cg.py``, with
rank-1 (V of shape (N,)) and block (V of shape (N, r)) deflation.  A
right-hand side of shape (N, m) with one shift per column is solved by a
batched CG over the columns, the written-out counterpart of the
``jax.vmap(solve_deflated)`` in the block eigensolver's tangent rule
(``eigh.py::_multi_pair_tangents``): one operator ``matmat`` of width m
per iteration.  ``solve_deflated`` is differentiable to any order, the
counterpart of the ``lax.custom_linear_solve`` the JAX solve wraps its CG
in: its backward is one more deflated solve and one deflated product
(:class:`_DeflatedSolve`), so the IFT rules of ``eigh.py`` that call it
differentiate again under ``create_graph``.  MINRES, preconditioning,
BiCGSTAB and GMRES wait for a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from .operators import (as_operator, check_device, hdot, hmatmul,
                        partial_vjp, refuse_complex, tol_floor)

# The JAX loop tests the residual on the device every iteration inside a
# ``lax.while_loop``.  Eager PyTorch would have to read it on the host,
# which waits for the card each time; instead the host reads it once
# every CHECK_EVERY iterations, and in between the device freezes the
# state once the residual meets the tolerance (alpha = 0, p and rz kept),
# so a solve may run up to CHECK_EVERY - 1 products past the one that
# met it without changing x.  (An iteration past convergence is not
# harmless: on a deflated system, singular on span(V), the round-off
# residual's span(V) component makes p^T M p tiny, and one more step
# with alpha = rz / p^T M p throws x off.)
CHECK_EVERY = 10


def _project_out(V, x):
    """``x - V <V, x>`` for a unit vector V and x of shape (N,), or for
    an (N, r) V with orthonormal columns and x of shape (N,) or (N, m)."""
    if V.ndim == 1:
        return x - V * hdot(V, x)
    return x - hmatmul(V, hmatmul(V.T, x))


def _cg_loop(matvec: Callable, b, tol: float, maxiter):
    """Plain CG from x0 = 0; returns ``(x, iterations run)``, the second
    counting the products made (frozen iterations included)."""
    if maxiter is None:
        maxiter = 10 * b.shape[-1]
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rz = hdot(r, r)
    tol = tol_floor(tol, b.dtype)
    target2 = tol * tol * rz
    zero = torch.zeros_like(rz)
    it = 0
    while it < maxiter:
        if not bool(rz > target2):
            break
        for _ in range(min(CHECK_EVERY, maxiter - it)):
            active = rz > target2
            ap = matvec(p)
            denom = hdot(p, ap)
            alpha = torch.where(active & (denom != 0),
                                rz / torch.where(denom == 0,
                                                 torch.ones_like(denom),
                                                 denom), zero)
            x = x + alpha * p
            r = r - alpha * ap
            rz_new = hdot(r, r)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            p = torch.where(active, r + beta * p, p)
            rz = torch.where(active, rz_new, rz)
            it += 1
    return x, it


def cg(matvec: Callable, b: torch.Tensor, *, tol: float = 1e-7,
       maxiter: int | None = None, device=None) -> torch.Tensor:
    """Conjugate gradient for an SPD ``matvec``, from x0 = 0.

    Stops once ``||r|| <= tol * ||b||`` (``tol`` clamped to
    what the dtype can reach), tested every ``CHECK_EVERY`` iterations,
    or after ``maxiter`` iterations (default 10 N).
    """
    check_device(device, b)
    refuse_complex(b.dtype, "b")
    return _cg_loop(matvec, b, tol, maxiter)[0]


def _cg_columns_loop(matmat: Callable, B, tol: float, maxiter):
    """Batched CG from X0 = 0 over the columns of ``B`` (N, m), one
    ``matmat`` of width m per iteration; returns ``(X, iterations per
    column)``.

    Each column has its own alpha and beta, and is frozen once its own
    residual meets ``tol`` (state kept, as a lane of a vmapped
    ``while_loop`` is): whether a column is still active is decided on
    the device every iteration, and the host reads whether any is left
    every ``CHECK_EVERY`` iterations.
    """
    n, m = B.shape
    if maxiter is None:
        maxiter = 10 * n
    X = torch.zeros_like(B)
    R = B.clone()
    P = R.clone()
    rz = (R * R).sum(dim=0)
    tol = tol_floor(tol, B.dtype)
    target2 = tol * tol * rz
    its = torch.zeros(m, dtype=torch.int64, device=B.device)
    zero = torch.zeros_like(rz)
    it = 0
    while it < maxiter:
        if not bool((rz > target2).any()):
            break
        for _ in range(min(CHECK_EVERY, maxiter - it)):
            active = rz > target2
            AP = matmat(P)
            denom = (P * AP).sum(dim=0)
            alpha = torch.where(active & (denom != 0),
                                rz / torch.where(denom == 0,
                                                 torch.ones_like(denom),
                                                 denom), zero)
            X = X + alpha * P
            R = R - alpha * AP
            rz_new = (R * R).sum(dim=0)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            P = torch.where(active, R + beta * P, P)
            rz = torch.where(active, rz_new, rz)
            its += active
            it += 1
    return X, its


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


def _cg_solve(op, lam, V, rhs, sign, tol, maxiter):
    """``P cg(M, P rhs)``, the solver that the JAX package hands to
    ``custom_linear_solve``: the right-hand side is projected onto V⊥
    (a cotangent or tangent with a span(V) component would make CG
    divide by round-off; M is singular there) and so is the result.
    Returns ``(x, iterations)``, per column for an (N, m) ``rhs``."""
    mv = _deflated_mv(op, lam, V, sign, rhs.ndim == 2)
    loop = _cg_columns_loop if rhs.ndim == 2 else _cg_loop
    x, its = loop(mv, _project_out(V, rhs), tol, maxiter)
    return _project_out(V, x), its


class _DeflatedSolve(torch.autograd.Function):
    """``x = M^+ rhs`` for ``M = sign P (A(θ) - λ) P``, differentiable in
    ``rhs``, ``λ``, ``V`` and the operator's parameters θ by the rule of
    ``lax.custom_linear_solve`` (M is symmetric, so its transpose solve
    is the same solve):

        w = M^+ x̄,   rhs̄ = w,   (λ̄, V̄, θ̄) = -∂/∂(λ, V, θ) <w, M x>,

    the last with x held constant: one more solve and one deflated
    product per backward.  The forward runs the CG with no graph (no
    iteration is ever recorded); the backward is built of this Function
    and differentiable operations only, so under ``create_graph`` it
    differentiates again, to any order."""

    @staticmethod
    def forward(ctx, op, sign, tol, maxiter, rhs, lam, V, *params):
        x, _ = _cg_solve(op, lam, V, rhs, sign, tol, maxiter)
        ctx.op, ctx.cfg = op, (sign, tol, maxiter)
        ctx.save_for_backward(x, lam, V)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        op, (sign, tol, maxiter) = ctx.op, ctx.cfg
        x, lam, V = ctx.saved_tensors
        w = _DeflatedSolve.apply(op, sign, tol, maxiter, x_bar, lam, V,
                                 *op.parameters())
        grads = partial_vjp(
            op, lambda held, lam_, V_: _deflated_mv(held, lam_, V_, sign,
                                                    x.ndim == 2)(x),
            [lam, V], -w, ctx.needs_input_grad[5:])
        rhs_bar = w if ctx.needs_input_grad[4] else None
        return (None, None, None, None, rhs_bar, *grads)


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
                        device=None):
    """Forward-only :func:`solve_deflated` that also returns
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
        x, its = _cg_solve(op, lam, V, rhs, sign, tol, maxiter)
        mv = _deflated_mv(op, lam, V, sign, b.ndim == 2)
        rhs = _project_out(V, rhs)
        bnorm = torch.linalg.vector_norm(rhs, dim=0)
        res = torch.linalg.vector_norm(rhs - mv(x), dim=0) / torch.where(
            bnorm == 0, torch.ones_like(bnorm), bnorm)
    if b.ndim == 2:
        return x, its.tolist(), res.tolist()
    return x, its, float(res)


def solve_deflated(op, lam, V, b, *, definite_sign: float = 1.0,
                   tol: float = 1e-7, maxiter: int | None = None,
                   device=None) -> torch.Tensor:
    """Solve ``P (A - lam I) P x = P b`` on ``span(V)⊥``,
    ``P = I - V V^T``, differentiably (see :class:`_DeflatedSolve`).

    ``V`` is the (N,) unit eigenvector being deflated, or an (N, r) block
    of orthonormal ones.  ``b`` is (N,) with a scalar ``lam``, or (N, m)
    with one shift per column in ``lam`` (m,), solved by the batched CG
    (each column stops at its own tolerance).  ``definite_sign`` makes the
    restricted operator positive definite for CG: +1 when ``lam`` is the
    algebraic minimum, -1 when it is the maximum (CG then runs on
    ``lam I - A``).  The returned x solves the unsigned equation and is
    the solution orthogonal to V.  It is differentiable in ``b``,
    ``lam``, ``V`` and ``op.parameters()``, to any order, and no
    derivative is taken through the CG's iterations.
    """
    op = as_operator(op)
    check_device(device, op, V, b)
    refuse_complex(b.dtype, "b")
    sign = float(definite_sign)
    lam = _shifts(lam, b)
    # The two projections of the JAX solve: this one differentiable, the
    # second inside the solver (a right-hand side nearly parallel to V
    # leaves a round-off remainder whose own V component is large).
    rhs = sign * _project_out(V, b)
    x = _DeflatedSolve.apply(op, sign, tol, maxiter, rhs, lam, V,
                             *op.parameters())
    # Keep x exactly in V⊥, differentiably: round-off would leak a
    # span(V) component into the gradients downstream.
    return _project_out(V, x)
