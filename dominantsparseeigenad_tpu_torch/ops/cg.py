"""Conjugate gradient and the deflated solves of the IFT backwards.

Counterpart of ``cg``, ``solve_deflated`` (method "cg") and
``solve_deflated_info`` in ``dominantsparseeigenad_tpu/ops/cg.py``, with
rank-1 (V of shape (N,)) and block (V of shape (N, r)) deflation.  A
right-hand side of shape (N, m) with one shift per column is solved by a
batched CG over the columns, the written-out counterpart of the
``jax.vmap(solve_deflated)`` in the block eigensolver's tangent rule
(``eigh.py::_multi_pair_tangents``): one operator ``matmat`` of width m
per iteration.  The solve is not differentiable itself: the first-order
backwards of ``eigh.py`` call it once and need no derivative of it.
MINRES, preconditioning, BiCGSTAB, GMRES and the differentiable
``custom_linear_solve`` wrapper wait for a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from .operators import (as_operator, check_device, hdot, hmatmul,
                        refuse_complex, tol_floor)

# The JAX loop tests the residual on the device every iteration inside a
# ``lax.while_loop``.  Eager PyTorch would have to read it on the host,
# which waits for the card each time; instead the residual is read once
# every CHECK_EVERY iterations, so a solve may run up to CHECK_EVERY - 1
# iterations past the one that met the tolerance (each of them only
# lowers the residual further).
CHECK_EVERY = 10


def _project_out(V, x):
    """``x - V <V, x>`` for a unit vector V and x of shape (N,), or for
    an (N, r) V with orthonormal columns and x of shape (N,) or (N, m)."""
    if V.ndim == 1:
        return x - V * hdot(V, x)
    return x - hmatmul(V, hmatmul(V.T, x))


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


def _deflated_system(op, lam, V, b, definite_sign):
    """The signed deflated operator and right-hand side.  ``b`` (N,) with
    a scalar ``lam``, or (N, m) with one shift per column in ``lam``
    (m,)."""
    sign = float(definite_sign)
    if b.ndim == 2:
        lams = torch.as_tensor(lam, dtype=b.dtype, device=b.device)
        if lams.shape != (b.shape[1],):
            raise ValueError(f"a right-hand side of shape {tuple(b.shape)} "
                             f"needs {b.shape[1]} shifts, got "
                             f"{tuple(lams.shape)}")

        def deflated_mv(x):
            px = _project_out(V, x)
            return sign * _project_out(V, op.matmat(px) - px * lams[None, :])
    else:
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


def _solve(op, lam, V, b, definite_sign, tol, maxiter):
    mv, rhs = _deflated_system(op, lam, V, b, definite_sign)
    if rhs.ndim == 2:
        x, its = _cg_columns_loop(mv, rhs, tol, maxiter)
    else:
        x, its = _cg_loop(mv, rhs, tol, maxiter)
    return mv, rhs, x, its


def solve_deflated_info(op, lam, V, b, *, definite_sign: float = 1.0,
                        tol: float = 1e-7, maxiter: int | None = None,
                        device=None):
    """:func:`solve_deflated` that also returns ``(iterations,
    relative_residual)`` of its CG, the residual taken on the deflated
    system with one extra matvec (matmat).  For an (N, m) right-hand side
    both are lists with one entry per column."""
    op = as_operator(op)
    check_device(device, op, V, b)
    refuse_complex(b.dtype, "b")
    mv, rhs, x, its = _solve(op, lam, V, b, definite_sign, tol, maxiter)
    bnorm = torch.linalg.vector_norm(rhs, dim=0)
    res = torch.linalg.vector_norm(rhs - mv(x), dim=0) / torch.where(
        bnorm == 0, torch.ones_like(bnorm), bnorm)
    if rhs.ndim == 2:
        return _project_out(V, x), its.tolist(), res.tolist()
    return _project_out(V, x), its, float(res)


def solve_deflated(op, lam, V, b, *, definite_sign: float = 1.0,
                   tol: float = 1e-7, maxiter: int | None = None,
                   device=None) -> torch.Tensor:
    """Solve ``P (A - lam I) P x = P b`` on ``span(V)⊥``,
    ``P = I - V V^T``.

    ``V`` is the (N,) unit eigenvector being deflated, or an (N, r) block
    of orthonormal ones.  ``b`` is (N,) with a scalar ``lam``, or (N, m)
    with one shift per column in ``lam`` (m,), solved by the batched CG
    (each column stops at its own tolerance).  ``definite_sign`` makes the
    restricted operator positive definite for CG: +1 when ``lam`` is the
    algebraic minimum, -1 when it is the maximum (CG then runs on
    ``lam I - A``).  The returned x solves the unsigned equation and is
    the solution orthogonal to V.
    """
    op = as_operator(op)
    check_device(device, op, V, b)
    refuse_complex(b.dtype, "b")
    _, _, x, _ = _solve(op, lam, V, b, definite_sign, tol, maxiter)
    # Keep x exactly in V⊥: round-off would leak a span(V) component into
    # the gradients downstream.
    return _project_out(V, x)
