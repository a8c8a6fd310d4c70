"""Conjugate gradient, MINRES and the deflated solves of the IFT rules.

Counterpart of ``cg``, ``cg_info``, ``minres``, ``solve_spd``,
``solve_symmetric``, ``solve_deflated`` and ``solve_deflated_info`` in
``dominantsparseeigenad_tpu/ops/cg.py``, with rank-1 (V of shape (N,))
and block (V of shape (N, r)) deflation.  A right-hand side of shape
(N, m) with one shift per column is solved by a batched CG over the
columns, the written-out counterpart of the ``jax.vmap(solve_deflated)``
in the block eigensolver's tangent rule (``eigh.py::_multi_pair_tangents``):
one operator ``matmat`` of width m per iteration; with ``method="minres"``
by a batched MINRES over the columns, the counterpart of the vmapped
MINRES of the spectral slice's rule (``ops/slicing.py``).  ``solve_deflated`` is
differentiable to any order, the counterpart of the
``lax.custom_linear_solve`` the JAX solve wraps its solver in: its
backward is one more deflated solve, by the same method and with the
same preconditioner, and one deflated product (:class:`_DeflatedSolve`),
so the IFT rules of ``eigh.py`` that call it differentiate again under
``create_graph``; its ``jvp`` is one more solve too (forward mode to any
order), and under ``torch.func.vmap`` a batch of right-hand sides is
one batched CG (or MINRES) over the columns.  ``solve_spd`` and ``solve_symmetric``
are the same Function with nothing deflated.

The non-symmetric solvers: ``bicgstab``, ``gmres`` (restarted, its small
Hessenberg least squares solved on the device by a QR and a masked
triangular solve) and ``solve_general``, whose Function
(:class:`_GeneralSolve`) also solves the bordered systems of the
non-symmetric eigensolver's rule (``eig.py``): its backward is the same
solve on the transposed system, the counterpart of the JAX package's
``custom_linear_solve`` with ``transpose_solve``.

Sharded vectors (``operators.vector_layout``): the CG and MINRES loops,
single and batched, the deflated and undeflated solves with their
rules, and ``cg``/``cg_info``/``minres`` on a bound ``op.matvec`` (which
names its operator) run on the rank's rows, their inner products and
norms summed over the ranks (so every rank reads the same residual and
stops at the same iteration), λ marked where it enters the rank's rows;
the default iteration cap is 10 N of the whole N.  A preconditioner's
apply is row-local (``ops/precond.py``).  BiCGStab, GMRES (its Arnoldi
basis the rank's columns, its small Hessenberg problem the same on every
rank) and the general solve run there too, ``bicgstab``/``gmres`` on a
bound ``op.matvec``.  A bordered system's vector ``z = (x; ν)`` has its
own layout (``layout.bordered(k)``): the first rank holds the border ν
after its rows and the others hold zeros there, so that the loops' summed
dots count ν once; the bordered product reads ν and writes its border in
one all-reduce, and λ and ν enter the rank's rows marked (``bcast``).

Complex operators: every inner product conjugates (``hdot``), and CG's
and MINRES's step sizes are real for a Hermitian system.  PyTorch's
gradient of a complex tensor is the conjugate of JAX's cotangent, so a
backward solves with the adjoint, not the transpose: for a Hermitian
deflated system that is the same solve (where the JAX package needs
``conj(A^{-1} conj(b))``), and for a general one it is the transposed
solve between two conjugations.
"""

from __future__ import annotations

from typing import Callable

import torch

from .lanczos import arnoldi_step
from .operators import (LinearOperator, _add, _per_lane, _project_out,
                        _projector_tangent, _tangent_product, as_operator,
                        check_device, hdot, hmatmul, layout_bcast,
                        layout_norm, layout_sum, local_dim, matvec_layout,
                        nestable_jvp, partial_vjp, per_lane_vmap, rebind,
                        tol_floor, vector_layout)
from .precond import _apply_columns
from .spans import count, host_read, recording, span

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


def _coldot(a, b):
    """The real parts of the column inner products ``<a_j, b_j>`` of two
    (N, m) blocks (the real step sizes of a Hermitian system)."""
    return (a.conj() * b).real.sum(dim=0)


def _nonzero(t):
    """``t`` with its zeros replaced by ones (a safe divisor)."""
    return torch.where(t == 0, torch.ones_like(t), t)


def _cg_loop(matvec: Callable, b, tol: float, maxiter, x0=None,
             atol: float = 0.0, precond: Callable | None = None,
             layout=None):
    """Preconditioned CG; returns ``(x, iterations run)``, the second
    counting the products made (frozen iterations included).  Stops once
    ``||r|| <= max(tol ||b||, atol)``, as the JAX loop does.  Under a
    sharded ``layout`` b is the rank's rows and every dot is summed over
    the ranks.

    While a profiler records, the steps that ran unfrozen are summed on
    the device (one add a step) and come back in the test's own read
    every ``CHECK_EVERY`` steps: the counter ``cg_iterations``.  A solve
    that ``maxiter`` stops reads nothing after its last block, whose
    steps then count as unfrozen."""
    if maxiter is None:
        maxiter = 10 * (b.shape[-1] if layout is None else layout.dim)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.to(b.dtype).clone()
        r = b - matvec(x)
    z = r if precond is None else precond(r)
    p = z.clone()

    def dot(a, c):
        return layout_sum(layout, hdot(a, c)).real

    rr = dot(r, r)
    rz = rr if precond is None else dot(r, z)
    tol = tol_floor(tol, b.dtype)
    target2 = torch.clamp(tol * tol * dot(b, b), min=float(atol) ** 2)
    zero = torch.zeros_like(rz)
    useful = torch.zeros((), dtype=torch.int64, device=b.device) \
        if recording() else None
    ran = checked = it = 0
    while it < maxiter:
        if useful is None:
            go = host_read("cg_check", rr > target2)
        else:
            # The test and the count in one value: go on if it is >= 0,
            # and the unfrozen steps are it or its complement.
            state = host_read("cg_check",
                              torch.where(rr > target2, useful, ~useful))
            go, ran, checked = state >= 0, max(state, ~state), it
        if not go:
            break
        for _ in range(min(CHECK_EVERY, maxiter - it)):
            active = rr > target2
            if useful is not None:
                useful = useful + active
            with span("cg_matvec"):
                ap = matvec(p)
            denom = dot(p, ap)
            alpha = torch.where(active & (denom != 0), rz / _nonzero(denom),
                                zero)
            x = x + alpha * p
            r = r - alpha * ap
            z = r if precond is None else precond(r)
            rr_new = dot(r, r)
            rz_new = rr_new if precond is None else dot(r, z)
            beta = rz_new / _nonzero(rz)
            p = torch.where(active, z + beta * p, p)
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, rr_new, rr)
            it += 1
    if useful is not None:
        count("cg_iterations", ran + it - checked)
    return x, it


def _bicgstab_loop(matvec: Callable, b, tol: float, maxiter, x0=None,
                   atol: float = 0.0, layout=None):
    """BiCGStab (van der Vorst), the JAX ``bicgstab`` recurrence with its
    breakdown guards; returns ``(x, iterations)``, the second a device
    tensor counting the iterations that ran unfrozen (what the JAX
    ``while_loop`` counts).  The state freezes once the residual meets
    the target or the iteration stops (a near-zero ``rho`` or
    ``<rhat, v>``, ``omega = 0``, or a non-finite step, which is
    discarded); the host reads that every ``CHECK_EVERY`` iterations.
    Under a sharded ``layout`` b is the rank's rows and every dot and
    norm is summed over the ranks (the breakdown and finiteness tests
    read those, the same on every rank)."""
    if maxiter is None:
        maxiter = 10 * (b.shape[-1] if layout is None else layout.dim)

    def dot(a, c):
        return layout_sum(layout, hdot(a, c))

    def norm(a):
        return layout_norm(layout, a)

    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.to(b.dtype).clone()
        r = b - matvec(x)
    tol = tol_floor(tol, b.dtype)
    target2 = torch.clamp(tol * tol * dot(b, b).real, min=float(atol) ** 2)
    # scipy's near-breakdown test |rho| <= eps ||rhat|| ||r||: an exact
    # zero test lets |rho| ~ eps^2 through and beta ~ 1/rho overflows.
    eps = float(torch.finfo(b.dtype).eps)
    rhat = r.clone()
    rhat_norm = norm(rhat)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros_like(one)
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = one
    rr = dot(r, r).real
    stop = torch.zeros((), dtype=torch.bool, device=b.device)
    its = torch.zeros((), dtype=torch.int64, device=b.device)
    it = 0
    while it < maxiter:
        if not host_read("bicgstab_check", (rr > target2) & ~stop):
            break
        for _ in range(min(CHECK_EVERY, maxiter - it)):
            active = (rr > target2) & ~stop
            rho_new = dot(rhat, r)
            broke = rho_new.abs() <= eps * rhat_norm * norm(r)
            beta = torch.where(broke, zero,
                               (rho_new / torch.where(broke, one, rho))
                               * (alpha / torch.where(omega == 0, one,
                                                      omega)))
            p_new = r + beta * (p - omega * v)
            with span("bicgstab_matvec"):
                v_new = matvec(p_new)
            denom = dot(rhat, v_new)
            broke = broke | (denom.abs() <= eps * rhat_norm * norm(v_new))
            alpha_new = torch.where(broke, zero,
                                    rho_new / torch.where(broke, one, denom))
            s = r - alpha_new * v_new
            with span("bicgstab_matvec"):
                t = matvec(s)
            tt = dot(t, t)
            omega_new = torch.where(tt == 0, zero,
                                    dot(t, s) / torch.where(tt == 0, one,
                                                            tt))
            x_new = x + alpha_new * p_new + omega_new * s
            r_new = s - omega_new * t
            rr_new = dot(r_new, r_new).real
            # A non-finite step (an overflow past the guards) is
            # discarded: the loop stops on the last good iterate.
            bad = ~torch.isfinite(rr_new)
            x_new = torch.where(bad, x, x_new)
            r_new = torch.where(bad, r, r_new)
            rr_new = torch.where(bad, rr, rr_new)
            stop_new = broke | bad | (omega_new == 0)
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            v = torch.where(active, v_new, v)
            rho = torch.where(active, rho_new, rho)
            alpha = torch.where(active, alpha_new, alpha)
            omega = torch.where(active, omega_new, omega)
            rr = torch.where(active, rr_new, rr)
            stop = torch.where(active, stop_new, stop)
            its = its + active
            it += 1
    return x, its


def bicgstab(matvec: Callable, b: torch.Tensor, *,
             x0: torch.Tensor | None = None, tol: float = 1e-7,
             atol: float = 0.0, maxiter: int | None = None,
             device=None) -> torch.Tensor:
    """BiCGStab for a general square ``matvec``: two products per
    iteration, at κ(A) cost where CG on the normal equations pays κ².

    Stops once ``||r|| <= max(tol ||b||, atol)`` (``tol`` clamped to what
    the dtype can reach), on a breakdown (a near-zero ``rho`` or
    ``<rhat, v>``, scaled by eps, or ``omega = 0``; x stays the last
    finite iterate), or after ``maxiter`` iterations (default 10 N).  On
    a bound ``op.matvec`` of an operator whose vectors are sharded, ``b``
    is the rank's rows and the dots are summed over the ranks.
    """
    check_device(device, b)
    return _bicgstab_loop(matvec, b, tol, maxiter, x0, atol,
                          matvec_layout(matvec))[0]


def _hessenberg_lstsq(h, rhs):
    """``argmin ||h y - rhs||`` for the (m+1, m) Hessenberg ``h`` of a
    GMRES cycle, on the device: a QR, then the triangular solve with
    y = 0 for each column whose diagonal entry of R is at most
    ``(m+1) eps max|diag R|``.  After a happy breakdown every later
    column of ``h`` is zero, and this is the minimum-norm solution that
    the JAX ``lstsq`` gives (a CUDA ``lstsq`` has only the full-rank
    ``gels`` routine, which gives NaN there)."""
    q, rt = torch.linalg.qr(h)
    c = hmatmul(q.mH, rhs)
    d = torch.diagonal(rt).abs()
    floor = h.shape[0] * torch.finfo(h.dtype).eps \
        * torch.clamp(d.max(), min=torch.finfo(h.dtype).tiny)
    dead = d <= floor
    eye = torch.eye(rt.shape[0], dtype=rt.dtype, device=rt.device)
    rt = torch.where(dead[:, None], eye, rt)
    c = torch.where(dead, torch.zeros_like(c), c)
    return torch.linalg.solve_triangular(rt, c[:, None], upper=True)[:, 0]


def _gmres_loop(matvec: Callable, b, tol: float, maxiter, x0=None,
                atol: float = 0.0, restart: int = 32, layout=None):
    """Restarted GMRES(m), the JAX ``gmres`` cycle; returns ``(x, inner
    steps run)``.  The host reads the residual once a cycle (m products),
    which is the JAX loop's own test, so nothing runs past it.  Under a
    sharded ``layout`` b is the rank's rows, the basis holds the rank's
    columns, its Gram-Schmidt coefficients and norms are summed over the
    ranks, and the Hessenberg problem is the same on every rank."""
    n = b.shape[-1] if layout is None else layout.dim
    m = max(1, min(int(restart), n))
    if maxiter is None:
        maxiter = 10 * n
    max_cycles = -(-int(maxiter) // m)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.to(b.dtype).clone()
        r = b - matvec(x)
    tol = tol_floor(tol, b.dtype)

    def rr(a):
        return layout_sum(layout, hdot(a, a)).real

    target2 = torch.clamp(tol * tol * rr(b), min=float(atol) ** 2)
    tiny = torch.finfo(b.dtype).tiny
    cycles = 0
    while cycles < max_cycles and bool(rr(r) > target2):
        beta = layout_norm(layout, r)
        basis = torch.zeros((m + 1, b.shape[-1]), dtype=b.dtype,
                            device=b.device)
        basis[0] = r / torch.clamp(beta, min=tiny)
        h = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        for j in range(m):
            arnoldi_step(matvec, basis, h, j, layout)
        rhs = torch.zeros(m + 1, dtype=b.dtype, device=b.device)
        rhs[0] = beta
        y = _hessenberg_lstsq(h, rhs)
        x = x + hmatmul(basis[:m].T, y)
        # The Arnoldi relation A V_m y = V_{m+1} (H y): no extra product.
        r = r - hmatmul(basis.T, hmatmul(h, y))
        cycles += 1
    return x, cycles * m


def gmres(matvec: Callable, b: torch.Tensor, *,
          x0: torch.Tensor | None = None, tol: float = 1e-7,
          atol: float = 0.0, restart: int = 32, maxiter: int | None = None,
          device=None) -> torch.Tensor:
    """Restarted GMRES(``restart``) for a general square ``matvec``: a
    residual that never grows within a cycle (no BiCGStab breakdown), at
    the cost of an (m+1, N) basis.  ``maxiter`` bounds the inner
    (Arnoldi) steps, default 10 N; the test ``||r|| <= max(tol ||b||,
    atol)`` is made once a cycle, on the residual of the Arnoldi
    relation.  On a bound ``op.matvec`` of an operator whose vectors are
    sharded, ``b`` is the rank's rows and the basis the rank's columns."""
    check_device(device, b)
    return _gmres_loop(matvec, b, tol, maxiter, x0, atol, restart,
                       matvec_layout(matvec))[0]


def cg(matvec: Callable, b: torch.Tensor, *, x0: torch.Tensor | None = None,
       tol: float = 1e-7, atol: float = 0.0, maxiter: int | None = None,
       precond: Callable | None = None, device=None) -> torch.Tensor:
    """(Preconditioned) conjugate gradient for an SPD ``matvec``.

    Stops once ``||r|| <= max(tol ||b||, atol)`` (``tol`` clamped to what
    the dtype can reach), tested every ``CHECK_EVERY`` iterations, or
    after ``maxiter`` iterations (default 10 N).  ``x0`` is the start
    (zero when None); ``precond`` an SPD approximate inverse
    ``z = M^{-1} r`` (see :mod:`~.precond`).  On a bound ``op.matvec``
    of an operator whose vectors are sharded, ``b`` is the rank's rows
    and the dots are summed over the ranks.
    """
    check_device(device, b)
    return _cg_loop(matvec, b, tol, maxiter, x0, atol, precond,
                    matvec_layout(matvec))[0]


def cg_info(matvec: Callable, b: torch.Tensor, *,
            x0: torch.Tensor | None = None, tol: float = 1e-7,
            atol: float = 0.0, maxiter: int | None = None,
            precond: Callable | None = None, device=None):
    """:func:`cg` that also returns ``(iterations, relative_residual)``:
    the products made (up to ``CHECK_EVERY - 1`` past the iteration that
    met the tolerance, whose steps are frozen) and ``||b - A x|| /
    ||b||`` from one extra matvec.  Forward-only."""
    check_device(device, b)
    lay = matvec_layout(matvec)
    with torch.no_grad():
        x, it = _cg_loop(matvec, b, tol, maxiter, x0, atol, precond, lay)
        res = layout_norm(lay, b - matvec(x)) / layout_norm(lay, b)
    return x, it, float(res)


def _minres_loop(matvec: Callable, b, tol: float, maxiter, x0=None,
                 precond: Callable | None = None, layout=None):
    """Paige-Saunders MINRES (the JAX ``minres`` recurrence, line for
    line); returns ``(x, iterations run)``, products made, frozen ones
    included.  Once ``phibar`` meets the target every quantity of the
    state is kept, as the JAX ``while_loop`` would stop there.  Under a
    sharded ``layout`` b is the rank's rows and every dot is summed over
    the ranks (the rotations are then the same on every rank)."""
    if maxiter is None:
        maxiter = 10 * (b.shape[-1] if layout is None else layout.dim)

    def dot(a, c):
        return layout_sum(layout, hdot(a, c)).real

    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    r = b.clone() if x0 is None else b - matvec(x)
    yv = r if precond is None else precond(r)
    beta1 = torch.sqrt(torch.clamp(dot(r, yv), min=0.0))
    tol = tol_floor(tol, b.dtype)
    # The M^{-1} norm phibar tracks; for M = I and x0 = 0, tol ||b||.
    target = tol * (layout_norm(layout, b) if precond is None else beta1)
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
            # <v, A v> is real for a Hermitian A: the rotations stay real.
            alfa = dot(v, y)
            y = y - (alfa / _nonzero(beta)) * r2
            r1, r2 = r2, y
            yv = y if precond is None else precond(y)
            oldb = beta
            beta_new = torch.sqrt(torch.clamp(dot(y, yv), min=0.0))
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
    the unpreconditioned recurrence.  On a bound ``op.matvec`` of an
    operator whose vectors are sharded, ``b`` is the rank's rows and the
    dots are summed over the ranks.
    """
    check_device(device, b)
    return _minres_loop(matvec, b, tol, maxiter, x0, precond,
                        matvec_layout(matvec))[0]


def _deflated_mv(op, lam, V, sign, batched):
    """``x -> sign * P (A - lam I) P x``, ``P = I - V V^H``: on (N,)
    vectors with a scalar ``lam``, or on (N, m) blocks with one shift per
    column in ``lam`` (m,)."""
    lay = vector_layout(op)
    if batched:
        def mv(x):
            px = _project_out(V, x, lay)
            return sign * _project_out(V, op.matmat(px) - px * lam[None, :],
                                       lay)
    else:
        def mv(x):
            px = _project_out(V, x, lay)
            return sign * _project_out(V, op.matvec(px) - lam * px, lay)
    return mv


def _deflated_precond(precond, V, batched, layout=None):
    """The preconditioner projected as ``P M P``, which maps V⊥ to V⊥
    (for CG and MINRES alike: PSD with null space span(V), which the
    deflated recurrences never touch); applied column by column to an
    (N, m) block.  The recurrences hand it residuals in V⊥ already, so
    only its output is projected, as in the JAX solve."""
    if precond is None:
        return None
    if batched:
        precond = _apply_columns(precond)
    return lambda r: _project_out(V, precond(r), layout)


def _deflated_solve(op, lam, V, rhs, sign, tol, maxiter, method="cg",
                    precond=None):
    """``P solve(M, P rhs)``, the solver that the JAX package hands to
    ``custom_linear_solve``: the right-hand side is projected onto V⊥
    (a cotangent or tangent with a span(V) component would make the
    solver divide by round-off; M is singular there) and so is the
    result.  Returns ``(x, iterations)``, per column for an (N, m)
    ``rhs``."""
    batched = rhs.ndim == 2
    mv = _deflated_mv(op, lam, V, sign, batched)
    lay = vector_layout(op)
    m = _deflated_precond(precond, V, batched, lay)
    if method == "minres":
        loop = _minres_columns_loop if batched else _minres_loop
    else:
        loop = _cg_columns_loop if batched else _cg_loop
    # The loop's options only where they are set.
    kw = {k: v for k, v in (("precond", m), ("layout", lay)) if v is not None}
    x, its = loop(mv, _project_out(V, rhs, lay), tol, maxiter, **kw)
    return _project_out(V, x, lay), its


def _cg_columns_loop(matmat: Callable, B, tol: float, maxiter,
                     precond: Callable | None = None, layout=None):
    """Batched (preconditioned) CG from X0 = 0 over the columns of ``B``
    (N, m), one ``matmat`` of width m per iteration; returns ``(X,
    iterations per column)``.

    Each column has its own alpha and beta, and is frozen once its own
    residual meets ``tol`` (state kept, as a lane of a vmapped
    ``while_loop`` is): whether a column is still active is decided on
    the device every iteration, and the host reads whether any is left
    every ``CHECK_EVERY`` iterations.  ``precond`` maps (N, m) blocks.
    Under a sharded ``layout`` B is the rank's rows and the column dots
    are summed over the ranks.
    """
    n, m = B.shape
    if maxiter is None:
        maxiter = 10 * (n if layout is None else layout.dim)

    def coldot(a, c):
        return layout_sum(layout, _coldot(a, c))

    X = torch.zeros_like(B)
    R = B.clone()
    Z = R if precond is None else precond(R)
    P = Z.clone()
    rr = coldot(R, R)
    rz = rr if precond is None else coldot(R, Z)
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
            denom = coldot(P, AP)
            alpha = torch.where(active & (denom != 0), rz / _nonzero(denom),
                                zero)
            X = X + alpha * P
            R = R - alpha * AP
            Z = R if precond is None else precond(R)
            rr_new = coldot(R, R)
            rz_new = rr_new if precond is None else coldot(R, Z)
            beta = rz_new / _nonzero(rz)
            P = torch.where(active, Z + beta * P, P)
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, rr_new, rr)
            its += active
            it += 1
    return X, its


def _minres_columns_loop(matmat: Callable, B, tol: float, maxiter,
                         precond: Callable | None = None, layout=None):
    """Batched (preconditioned) MINRES from X0 = 0 over the columns of
    ``B`` (N, m), one ``matmat`` of width m per iteration; returns ``(X,
    iterations per column)``.

    Each column runs the recurrence of :func:`_minres_loop` with its own
    rotations and its own target (``tol ||b_j||``, or ``tol sqrt(b_j^H
    M^{-1} b_j)`` with a preconditioner), and freezes once its own
    ``phibar`` meets it, every quantity of its state kept (a lane of a
    vmapped ``while_loop``): decided on the device every iteration, read
    by the host every ``CHECK_EVERY`` iterations.  ``precond`` maps (N, m)
    blocks.  Under a sharded ``layout`` B is the rank's rows and the
    column dots are summed over the ranks."""
    n, m = B.shape
    if maxiter is None:
        maxiter = 10 * (n if layout is None else layout.dim)

    def coldot(a, c):
        return layout_sum(layout, _coldot(a, c))

    X = torch.zeros_like(B)
    Yv = B if precond is None else precond(B)
    beta1 = torch.sqrt(torch.clamp(coldot(B, Yv), min=0.0))
    tol = tol_floor(tol, B.dtype)
    target = tol * (layout_norm(layout, B, dim=0) if precond is None
                    else beta1)
    zero = torch.zeros_like(beta1)
    tiny = torch.finfo(B.dtype).tiny
    # X, R1, R2, Yv, W, W2, oldb, beta, dbar, epsln, cs, sn, phibar: the
    # blocks (N, m), the scalars of each column (m,).
    state = [X, B, B, Yv, torch.zeros_like(B), torch.zeros_like(B), zero,
             beta1, zero, zero, -torch.ones_like(beta1), zero, beta1]
    its = torch.zeros(m, dtype=torch.int64, device=B.device)
    it = 0
    while it < maxiter:
        if not bool((state[-1] > target).any()):
            break
        for _ in range(min(CHECK_EVERY, maxiter - it)):
            (X, R1, R2, Yv, W, W2, oldb, beta, dbar, epsln, cs, sn,
             phibar) = state
            active = phibar > target
            V = Yv / _nonzero(beta)
            Y = matmat(V)
            if it >= 1:
                Y = Y - (beta / _nonzero(oldb)) * R1
            alfa = coldot(V, Y)
            Y = Y - (alfa / _nonzero(beta)) * R2
            R1, R2 = R2, Y
            Yv = Y if precond is None else precond(Y)
            oldb = beta
            beta_new = torch.sqrt(torch.clamp(coldot(Y, Yv), min=0.0))
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
            W1, W2_new = W2, W
            W_new = (V - oldeps * W1 - delta * W2_new) / gamma
            X = X + phi * W_new
            new = (X, R1, R2, Yv, W_new, W2_new, oldb, beta_new, dbar,
                   epsln, cs, sn, phibar)
            state = [torch.where(active, a, o) for a, o in zip(new, state)]
            its += active
            it += 1
    return state[0], its


def _deflated_mv_tangent(op, lam, V, sign, x, dlam, dV, dparams):
    """The tangent of ``x -> sign P (A - λ) P x`` at a fixed ``x`` along
    ``(dλ, dV, dθ)`` (the ``Ṁ x`` of the solve's JVP), or None when
    nothing moves:

        y = P x,  u = A y - λ y,
        Ṁ x = sign (dP u + P (dA y + A dP x - dλ y - λ dP x))."""
    batched = x.ndim == 2
    lay = vector_layout(op)
    y = _project_out(V, x, lay)
    dy = None if dV is None else _projector_tangent(V, dV, x, lay)
    du = _tangent_product(op, y, dparams)
    if dlam is not None:
        dlam = layout_bcast(lay, dlam)
        du = _add(du, -(y * dlam[None, :] if batched else dlam * y))
    if dy is not None:
        a_dy = op.matmat(dy) if batched else op.matvec(dy)
        du = _add(du, a_dy - (dy * lam[None, :] if batched else lam * dy))
    out = None if du is None else _project_out(V, du, lay)
    if dV is not None:
        u = (op.matmat(y) - y * lam[None, :]) if batched \
            else op.matvec(y) - lam * y
        out = _add(out, _projector_tangent(V, dV, u, lay))
    return None if out is None else sign * out


class _DeflatedSolve(torch.autograd.Function):
    """``x = M^+ rhs`` for ``M = sign P (A(θ) - λ) P``, differentiable in
    ``rhs``, ``λ``, ``V`` and the operator's parameters θ by the rule of
    ``lax.custom_linear_solve`` (M is symmetric, so its transpose solve
    is the same solve):

        w = M^+ x̄,   rhs̄ = w,   (λ̄, V̄, θ̄) = -∂/∂(λ, V, θ) <w, M x>,

    the last with x held constant: one more solve (the same ``method``
    and preconditioner) and one deflated product per backward.  Forward
    mode is the JVP of the same rule, one more solve of this Function,

        ẋ = M^+ (rhs̊ - Ṁ x),

    ``Ṁ x`` carrying the tangents of λ, V and θ (:func:`_deflated_mv_tangent`).
    For a complex Hermitian M, ``x̄`` is PyTorch's (conjugate) gradient
    and the solve it needs is by ``M^H = M``, so the rule is the same.
    The forward runs the solver with no graph (no iteration is ever
    recorded); the rules are built of this Function and differentiable
    operations only, on the operator rebuilt from the parameters they are
    handed, so they differentiate again, in either mode, to any order.
    Under ``torch.func.vmap`` a batch of right-hand sides (and shifts)
    over a shared operator and V is one batched CG (or MINRES) over the
    columns, one matmat per iteration (the vmapped solve of JAX's block
    rules); anything else goes lane by lane.  An empty (N, 0) ``V`` deflates
    nothing: that is :func:`solve_spd` and :func:`solve_symmetric`."""

    @staticmethod
    def forward(op, sign, tol, maxiter, method, precond, rhs, lam, V,
                *params):
        x, _ = _deflated_solve(rebind(op, params), lam, V, rhs, sign,
                               tol, maxiter, method, precond)
        return x

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, sign, tol, maxiter, method, precond, rhs, lam, V, *params = inputs
        ctx.op, ctx.cfg = op, (sign, tol, maxiter, method, precond)
        ctx.save_for_backward(output, lam, V, *params)
        ctx.save_for_forward(output, lam, V, *params)

    @staticmethod
    @nestable_jvp
    def jvp(ctx, _op, _sign, _tol, _maxiter, _method, _precond, drhs, dlam,
            dV, *dparams):
        x, lam, V, *params = ctx.saved_tensors
        op = rebind(ctx.op, params)
        mdot = _deflated_mv_tangent(op, lam, V, ctx.cfg[0], x, dlam, dV,
                                    dparams)
        b = drhs if mdot is None else \
            -mdot if drhs is None else drhs - mdot
        if b is None:
            return torch.zeros_like(x)
        return _DeflatedSolve.apply(ctx.op, *ctx.cfg, b, lam, V, *params)

    @staticmethod
    def backward(ctx, x_bar):
        sign = ctx.cfg[0]
        x, lam, V, *params = ctx.saved_tensors
        op = rebind(ctx.op, params)
        w = _DeflatedSolve.apply(ctx.op, *ctx.cfg, x_bar, lam, V, *params)
        grads = partial_vjp(
            op, lambda held, lam_, V_: _deflated_mv(held, lam_, V_, sign,
                                                    x.ndim == 2)(x),
            [lam, V], -w, ctx.needs_input_grad[7:])
        rhs_bar = w if ctx.needs_input_grad[6] else None
        return (None,) * 6 + (rhs_bar, *grads)

    @staticmethod
    def vmap(info, in_dims, op, sign, tol, maxiter, method, precond, rhs,
             lam, V, *params):
        rhs_dim, lam_dim, v_dim = in_dims[6:9]
        if v_dim is not None or any(
                d is not None for d in in_dims[9:]):
            return _per_lane(_DeflatedSolve, info, in_dims,
                             (op, sign, tol, maxiter, method, precond, rhs,
                              lam, V, *params))
        # The lanes become columns: rhs (N[, m]) -> (N, [m *] B), one
        # shift per column.
        nb = info.batch_size
        rhs = rhs.unsqueeze(-1).expand(*rhs.shape, nb) if rhs_dim is None \
            else rhs.movedim(rhs_dim, -1)
        lam = lam.unsqueeze(-1).expand(*lam.shape, nb) if lam_dim is None \
            else lam.movedim(lam_dim, -1)
        cols = rhs.reshape(rhs.shape[0], -1).contiguous()
        x = _DeflatedSolve.apply(op, sign, tol, maxiter, method, precond,
                                 cols, lam.reshape(-1),
                                 V[:, None] if V.ndim == 1 else V, *params)
        return x.reshape(rhs.shape), rhs.ndim - 1


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
    sign = float(definite_sign)
    lay = vector_layout(op)
    with torch.no_grad():
        lam = _shifts(lam, b)
        rhs = sign * _project_out(V, b, lay)
        x, its = _deflated_solve(op, lam, V, rhs, sign, tol, maxiter,
                                 "cg", precond)
        mv = _deflated_mv(op, lam, V, sign, b.ndim == 2)
        rhs = _project_out(V, rhs, lay)
        bnorm = layout_norm(lay, rhs, dim=0)
        res = layout_norm(lay, rhs - mv(x), dim=0) / _nonzero(bnorm)
    if b.ndim == 2:
        return x, its.tolist(), res.tolist()
    return x, its, float(res)


def solve_deflated(op, lam, V, b, *, definite_sign: float = 1.0,
                   tol: float = 1e-7, maxiter: int | None = None,
                   method: str = "cg", precond: Callable | None = None,
                   device=None) -> torch.Tensor:
    """Solve ``P (A - lam I) P x = P b`` on ``span(V)⊥``,
    ``P = I - V V^H``, differentiably (see :class:`_DeflatedSolve`).

    ``V`` is the (N,) unit eigenvector being deflated, or an (N, r) block
    of orthonormal ones.  ``b`` is (N,) with a scalar ``lam``, or (N, m)
    with one shift per column in ``lam`` (m,), solved by the batched CG
    (each column stops at its own tolerance).  ``definite_sign`` makes the
    restricted operator positive definite for CG: +1 when ``lam`` is the
    algebraic minimum, -1 when it is the maximum (CG then runs on
    ``lam I - A``).  ``method="minres"`` solves the (possibly indefinite)
    restriction with MINRES instead, for an interior ``lam`` (an (N, m)
    ``b`` by the batched MINRES, each column stopping at its own
    tolerance); ``definite_sign`` is then ignored.  ``precond`` is an SPD
    approximate inverse ``z = M^{-1} r`` in the vector convention, used
    projected (``P M P``) by either solver and, for an (N, m) ``b``,
    column by column.  The returned x solves the unsigned equation and is
    the solution orthogonal to V.  It is differentiable in ``b``,
    ``lam``, ``V`` and ``op.parameters()``, to any order in either mode
    (``torch.func`` transforms included), and no derivative is taken
    through the solver's iterations.  Under ``torch.func.vmap`` over
    ``b`` and ``lam`` (a shared operator and V) it is one batched solve.
    """
    if method not in ("cg", "minres"):
        raise ValueError(f"method must be cg|minres, got {method!r}")
    op = as_operator(op)
    check_device(device, op, V, b)
    sign = 1.0 if method == "minres" else float(definite_sign)
    lay = vector_layout(op)
    # λ enters the rank's rows: a backward sums its ranks' shares.
    lam = layout_bcast(lay, _shifts(lam, b))
    # The two projections of the JAX solve: this one differentiable, the
    # second inside the solver (a right-hand side nearly parallel to V
    # leaves a round-off remainder whose own V component is large).
    rhs = sign * _project_out(V, b, lay)
    x = _DeflatedSolve.apply(op, sign, tol, maxiter, method, precond, rhs,
                             lam, V, *op.parameters())
    # Keep x exactly in V⊥, differentiably: round-off would leak a
    # span(V) component into the gradients downstream.
    return _project_out(V, x, lay)


def _solve_operator(op, b, device):
    """The operator of a differentiable solve, on the call's device: a
    ``LinearOperator`` or a dense tensor, never a bare callable."""
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
    return op


def _undeflated(op, b, tol, maxiter, method, device):
    """``A^{-1} b`` through :class:`_DeflatedSolve` with nothing deflated
    (an empty (N, 0) V, λ = 0): gradients to ``b`` and
    ``op.parameters()``."""
    op = _solve_operator(op, b, device)
    empty = torch.zeros((local_dim(op), 0), dtype=b.dtype, device=b.device)
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


def _bordered_layout(op, k):
    """``layout.bordered(k)`` of ``op``'s sharded vectors: the layout of
    a bordered vector ``(x; ν)`` with a border of ``k`` entries; None for
    whole vectors, or with no border (z is x)."""
    lay = vector_layout(op)
    return None if lay is None or k == 0 else lay.bordered(k)


def _bordered_mv(op, transpose, lam, U, W):
    """``z = (x; ν) -> (M x + conj(U) ν; conj(W)^T x)``, ``M = A - λ I``
    (``A^T - λ I`` with ``transpose``): the bordered matrix of the JAX
    ``_bordered_solve``, U and W of shape (N, k), k = 1 for a border and
    0 for a plain system.  The border vectors are conjugated as the JAX
    code writes them (a complex pair's isotropic eigenvectors need it);
    for real dtypes that is the identity.  Its transpose is the same map
    on ``A^T`` with U and W swapped.  Over sharded vectors x, U and W are
    the rank's rows and z is laid out by ``layout.bordered(k)``: ν is read
    from the first rank and ``conj(W)^T x``, summed over the ranks, is
    written there (one all-reduce for both); λ enters marked by the
    caller."""
    apply = op.rmatvec if transpose else op.matvec
    n = local_dim(op)
    uc, wc = U.conj(), W.conj()
    bl = _bordered_layout(op, U.shape[-1])

    def mv(z):
        x, nu = z[:n], z[n:]
        wx = hmatmul(wc.T, x)
        if bl is not None:
            nu, wx = bl.exchange(nu, wx)
        top = apply(x) - lam * x + hmatmul(uc, nu)
        return torch.cat([top, wx]) if bl is None else bl.join(top, wx)
    return mv


def _general_loop(mv, rmv, rhs, tol, maxiter, method, layout=None):
    """The solver of :class:`_GeneralSolve` on ``mv`` (``rmv``, its
    transpose, only CGNR uses), on the ``layout`` of ``rhs``."""
    if method == "bicgstab":
        return _bicgstab_loop(mv, rhs, tol, maxiter, layout=layout)[0]
    if method == "gmres":
        return _gmres_loop(mv, rhs, tol, maxiter, layout=layout)[0]

    # CG on the normal equations needs the adjoint B^H, not the bilinear
    # transpose: B^H x = conj(B^T conj(x)), the identity for real dtypes.
    def adj(x):
        return rmv(x.conj()).conj()
    return _cg_loop(lambda x: adj(mv(x)), adj(rhs), tol, maxiter,
                    layout=layout)[0]


def _bordered_mv_tangent(op, transpose, lam, U, W, z, dlam, dU, dW,
                         dparams):
    """The tangent of ``z -> B z`` (:func:`_bordered_mv`) at a fixed
    ``z = (x; ν)`` along ``(dλ, dU, dW, dθ)``, or None when nothing
    moves: ``(dA x - dλ x + conj(dU) ν; conj(dW)^T x)``, on z's layout
    (ν read from the first rank, the border written there)."""
    n = local_dim(op)
    x, nu = z[:n], z[n:]
    bl = _bordered_layout(op, U.shape[-1])
    bottom = None if dW is None else hmatmul(dW.conj().T, x)
    if bl is not None and (dU is not None or dW is not None):
        nu, wx = bl.exchange(nu, torch.zeros_like(nu) if bottom is None
                             else bottom)
        bottom = None if dW is None else wx
    top = _tangent_product(op, x, dparams, transpose)
    if dlam is not None:
        top = _add(top, -layout_bcast(vector_layout(op), dlam) * x)
    if dU is not None:
        top = _add(top, hmatmul(dU.conj(), nu))
    if top is None and bottom is None:
        return None
    if top is None:
        top = torch.zeros_like(x)
    if bottom is None:
        bottom = torch.zeros_like(nu)
    return torch.cat([top, bottom]) if bl is None else bl.join(top, bottom)


@per_lane_vmap
class _GeneralSolve(torch.autograd.Function):
    """``z = B^{-1} rhs`` for the bordered matrix B of
    :func:`_bordered_mv` (A itself when the border is empty and λ = 0),
    by BiCGStab, GMRES or CGNR; differentiable in ``rhs``, ``λ``, ``U``,
    ``W`` and the operator's parameters θ by the rule of
    ``lax.custom_linear_solve`` with ``transpose_solve``, in PyTorch's
    conjugate convention:

        y = B^{-H} z̄ = conj(B^{-T} conj(z̄)),  rhs̄ = y,
        (λ̄, Ū, W̄, θ̄) = -∂/∂(λ, U, W, θ) <y, B z>,

    the transposed solve being this Function on ``A^T`` with U and W
    swapped (between two conjugations, the identity for real dtypes), and
    the last term one bordered product with z held constant.  Forward
    mode is one more solve of this Function, ``ż = B^{-1} (rhs̊ - Ḃ z)``
    (:func:`_bordered_mv_tangent`).  The forward records no graph; the
    rules are built of this Function and differentiable operations on
    the operator rebuilt from their parameters, so they differentiate
    again, in either mode; ``vmap`` goes lane by lane.  Over sharded
    vectors ``rhs`` and z are laid out by ``layout.bordered(k)`` (the
    border on the first rank, zeros on the others), which the solvers'
    products keep."""

    @staticmethod
    def forward(op, transpose, tol, maxiter, method, rhs, lam, U, W,
                *params):
        op = rebind(op, params)
        mv = _bordered_mv(op, transpose, lam, U, W)
        rmv = _bordered_mv(op, not transpose, lam, W, U)
        bl = _bordered_layout(op, U.shape[-1])
        return _general_loop(mv, rmv, rhs, tol, maxiter, method,
                             vector_layout(op) if bl is None else bl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, transpose, tol, maxiter, method, rhs, lam, U, W, *params = inputs
        ctx.op, ctx.cfg = op, (transpose, tol, maxiter, method)
        ctx.save_for_backward(output, lam, U, W, *params)
        ctx.save_for_forward(output, lam, U, W, *params)

    @staticmethod
    @nestable_jvp
    def jvp(ctx, _op, _transpose, _tol, _maxiter, _method, drhs, dlam, dU,
            dW, *dparams):
        z, lam, U, W, *params = ctx.saved_tensors
        transpose = ctx.cfg[0]
        op = rebind(ctx.op, params)
        bdot = _bordered_mv_tangent(op, transpose, lam, U, W, z, dlam, dU,
                                    dW, dparams)
        b = drhs if bdot is None else \
            -bdot if drhs is None else drhs - bdot
        if b is None:
            return torch.zeros_like(z)
        return _GeneralSolve.apply(ctx.op, *ctx.cfg, b, lam, U, W, *params)

    @staticmethod
    def backward(ctx, z_bar):
        transpose, tol, maxiter, method = ctx.cfg
        z, lam, U, W, *params = ctx.saved_tensors
        op = rebind(ctx.op, params)
        y = _GeneralSolve.apply(ctx.op, not transpose, tol, maxiter, method,
                                z_bar.conj(), lam, W, U, *params).conj()
        grads = partial_vjp(
            op, lambda held, lam_, U_, W_: _bordered_mv(
                held, transpose, lam_, U_, W_)(z),
            [lam, U, W], -y, ctx.needs_input_grad[6:])
        rhs_bar = y if ctx.needs_input_grad[5] else None
        return (None,) * 5 + (rhs_bar, *grads)


def solve_general(op, b: torch.Tensor, *, tol: float = 1e-7,
                  maxiter: int | None = None, method: str = "bicgstab",
                  device=None) -> torch.Tensor:
    """Differentiable solve ``A x = b`` for a general (non-symmetric)
    operator, to any order in ``b`` and ``op.parameters()``.

    ``method``: "bicgstab" (default, κ(A) cost), "gmres" (restarted
    every 32 steps) or "cgnr" (CG on ``A^H A x = A^H b``, at κ² cost: a
    fallback when BiCGStab stagnates on a wildly non-normal system).
    The backward is the same solve on ``op.rmatvec``
    (:class:`_GeneralSolve`).  Where the JAX function takes a matvec and
    an rmatvec, this one takes a :class:`~.operators.LinearOperator` (or
    a dense tensor), which carries both and exposes the tensors the
    gradients go to; a bare callable raises TypeError.  Over an operator
    whose vectors are sharded, ``b`` and x are the rank's rows.
    """
    if method not in ("bicgstab", "cgnr", "gmres"):
        raise ValueError(
            f"method must be bicgstab|cgnr|gmres, got {method!r}")
    op = _solve_operator(op, b, device)
    empty = torch.zeros((local_dim(op), 0), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    return _GeneralSolve.apply(op, False, tol, maxiter, method, b, zero,
                               empty, empty, *op.parameters())
