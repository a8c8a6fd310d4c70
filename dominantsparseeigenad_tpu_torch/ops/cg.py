"""Conjugate gradient and the rank-1 deflated solve of the IFT backward.

Counterpart of ``cg``, ``solve_deflated`` (method "cg", one deflation
vector) and ``solve_deflated_info`` in
``dominantsparseeigenad_tpu/ops/cg.py``.  The solve is not differentiable
itself: the first-order backward of ``eigh.py`` calls it once and needs
no derivative of it.  MINRES, preconditioning, block deflation,
BiCGSTAB, GMRES and the differentiable ``custom_linear_solve`` wrapper
wait for a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from .operators import as_operator, check_device, hdot, tol_floor

# The JAX loop tests the residual on the device every iteration inside a
# ``lax.while_loop``.  Eager PyTorch would have to read it on the host,
# which waits for the card each time; instead the residual is read once
# every CHECK_EVERY iterations, so a solve may run up to CHECK_EVERY - 1
# iterations past the one that met the tolerance (each of them only
# lowers the residual further).
CHECK_EVERY = 10


def _project_out(V, x):
    """``x - V <V, x>`` for a unit vector V of shape (N,)."""
    return x - V * hdot(V, x)


def _cg_loop(matvec: Callable, b, tol: float, maxiter):
    """Plain CG from x0 = 0; returns ``(x, iterations)``."""
    if maxiter is None:
        maxiter = 10 * b.shape[-1]
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rz = hdot(r, r)
    tol = tol_floor(tol, b.dtype)
    target2 = tol * tol * float(rz)
    it = 0
    while it < maxiter:
        if float(rz) <= target2:
            break
        for _ in range(min(CHECK_EVERY, maxiter - it)):
            ap = matvec(p)
            denom = hdot(p, ap)
            alpha = torch.where(denom == 0, torch.zeros_like(rz),
                                rz / torch.where(denom == 0,
                                                 torch.ones_like(denom),
                                                 denom))
            x = x + alpha * p
            r = r - alpha * ap
            rz_new = hdot(r, r)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            p = r + beta * p
            rz = rz_new
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
    return _cg_loop(matvec, b, tol, maxiter)[0]


def _deflated_system(op, lam, V, b, definite_sign):
    sign = float(definite_sign)

    def deflated_mv(x):
        px = _project_out(V, x)
        return sign * _project_out(V, op.matvec(px) - lam * px)

    # Project the right-hand side onto V⊥: the deflated operator is
    # singular on span(V), and a component along V (an eigenvector
    # cotangent parallel to v) would make CG divide by round-off.  Twice,
    # as the JAX solve does (once before its linear solve, once inside):
    # for b nearly parallel to V one pass leaves a round-off remainder
    # whose own component along V is still large, relative to itself.
    return deflated_mv, sign * _project_out(V, _project_out(V, b))


def solve_deflated_info(op, lam, V, b, *, definite_sign: float = 1.0,
                        tol: float = 1e-7, maxiter: int | None = None,
                        device=None):
    """:func:`solve_deflated` that also returns ``(iterations,
    relative_residual)`` of its CG, the residual taken on the deflated
    system with one extra matvec."""
    op = as_operator(op)
    check_device(device, op, V, b)
    mv, rhs = _deflated_system(op, lam, V, b, definite_sign)
    x, it = _cg_loop(mv, rhs, tol, maxiter)
    bnorm = torch.linalg.vector_norm(rhs)
    res = torch.linalg.vector_norm(rhs - mv(x)) / torch.where(
        bnorm == 0, torch.ones_like(bnorm), bnorm)
    return _project_out(V, x), it, float(res)


def solve_deflated(op, lam, V, b, *, definite_sign: float = 1.0,
                   tol: float = 1e-7, maxiter: int | None = None,
                   device=None) -> torch.Tensor:
    """Solve ``P (A - lam I) P x = P b`` on ``V⊥``, ``P = I - V V^T``.

    ``V`` is the (N,) unit eigenvector being deflated.  ``definite_sign``
    makes the restricted operator positive definite for CG: +1 when
    ``lam`` is the algebraic minimum, -1 when it is the maximum (CG then
    runs on ``lam I - A``).  The returned x solves the unsigned equation
    and is the solution orthogonal to V.
    """
    op = as_operator(op)
    check_device(device, op, V, b)
    mv, rhs = _deflated_system(op, lam, V, b, definite_sign)
    x, _ = _cg_loop(mv, rhs, tol, maxiter)
    # Keep x exactly in V⊥: round-off would leak a span(V) component into
    # the gradients downstream.
    return _project_out(V, x)
