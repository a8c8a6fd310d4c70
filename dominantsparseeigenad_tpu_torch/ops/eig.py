"""Differentiable dominant eigensolver for general (non-symmetric) operators.

Counterpart of the real-arithmetic half of
``dominantsparseeigenad_tpu/ops/eig.py``: ``dominant_eig``,
``dominant_eig_multi``, ``EigOptions`` and ``PowerInfo``.  The solver is
for transfer matrices, whose dominant eigenvalue is real, positive and
simple (Perron-Frobenius); it measures that assumption
(``PowerInfo.rank1_defect``) rather than trusting it.

Forward: a two-sided power iteration (A for the right vector r, A^T for
the left vector l), stopped on the scale-free residual, optionally seeded
by the dominant Ritz vectors of a k-step Arnoldi sweep; gauge ``||r|| =
1``, the largest-magnitude entry of r positive, ``l^T r = 1``.

The JAX package registers the implicit-function-theorem tangents as a
JVP and lets JAX transpose it.  Here the JVP is the Function's ``jvp``
(forward mode), as written there,

    dλ = l^T (dA) r,
    dr  = S_r b_r,  b_r = -((dA) r - dλ r),
    dl0 = S_l b_l,  b_l = -((dA)^T l - dλ l),
    dl  = dl0 + c l,  c = -l^T dr - r^T dl0,

where ``S_r`` solves the bordered system ``[[A - λI, l], [r^T, 0]]`` and
``S_l`` the one ``[[A^T - λI, r], [l^T, 0]]`` (Nelson's method: the
singular tangent systems made nonsingular at their own condition number),
by BiCGStab, GMRES or CGNR.  The backward is that map transposed.  The
transpose of ``S_r`` is ``S_l`` and that of ``S_l`` is ``S_r``, so for
cotangents (λ̄, l̄, r̄)

    g_l0 = l̄ - (l̄^T l) r,   g_r = r̄ - (l̄^T l) l,
    b̄_r = S_l g_r,   b̄_l = S_r g_l0,
    λ̄_tot = λ̄ + b̄_r^T r + b̄_l^T l,
    Ā = λ̄_tot l r^T - b̄_r r^T - l b̄_l^T,

and the operator's cotangent is applied as ``partial_vjp`` of one
``matvec(r)`` (output cotangent ``λ̄_tot l - b̄_r``) and one ``rmatvec(l)``
(cotangent ``-b̄_l``), never as a dense outer product.  The bordered
solves are the differentiable ``cg._GeneralSolve``, and the backward is
built of differentiable operations on the saved (λ, l, r), so under
``create_graph`` it differentiates again, to any order.  The pairings of
l with r are bilinear, as in the JAX code.

``dominant_eig_multi`` deflates each converged triple out of the operator
(Wielandt, ``M - λ r l^T``) through a ``MatrixFreeOperator`` that holds
the operator before it, so the gradients of every stage reach the
innermost operator's tensors.  The complex half of the JAX module
(``dominant_eig_pair``, ``dominant_eig_spectrum``, ``spectrum_structure``)
waits for complex operators (``ROADMAP.md`` queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .cg import CHECK_EVERY, _GeneralSolve
from .lanczos import arnoldi_step
from .operators import (MatrixFreeOperator, as_operator, check_device, hdot,
                        hmatmul, partial_vjp, tol_floor)


@dataclasses.dataclass(frozen=True)
class EigOptions:
    """Configuration of :func:`dominant_eig`.

    ``num_iters`` is the power iteration's budget: the loop stops as soon
    as both one-sided residuals are below ``power_tol`` (relative to
    ``|λ|``).  ``tol`` and ``maxiter`` are those of the IFT tangent
    solves."""

    num_iters: int = 500
    tol: float = 1e-10
    maxiter: int | None = None
    seed: int = 0
    power_tol: float = 1e-12
    solver: str = "bicgstab"
    method: str = "power"
    arnoldi_k: int = 32


class PowerInfo(NamedTuple):
    """Report of the two-sided power iteration (float scalar tensors,
    zero tangents, no gradient).

    iterations   : power steps run (the loop's own count, not its budget)
    residual     : ``max(||A r - λ r||, ||A^T l - λ l||) / |λ|`` at exit
    converged    : 1.0 if the residual met ``power_tol``
    rank1_defect : the Perron guard, σ₂/σ₁ of the repeatedly squared
                   Hessenberg block (the seeding sweep's, or under
                   ``method="power"`` a 6-step Arnoldi probe of the exit
                   iterates): ~0 when a real simple pair dominates, O(1)
                   when a complex pair or a degenerate cluster does and
                   the triple is not to be trusted.
    """

    iterations: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor
    rank1_defect: torch.Tensor


def _bdot(a, b):
    """The bilinear pairing ``sum(a * b)`` (never conjugated: l is the
    transpose left eigenvector, and its annihilator row is l^T)."""
    return torch.dot(a, b)


def _hessenberg_defect(hk):
    """``(M, σ₂/σ₁ of M)``, M the (k, k) block ``hk`` normalized and
    squared 24 times (each time normalized again).  M collapses to the
    rank-1 outer product of the dominant pair at rate ``gap_ratio^(2^p)``
    when that pair is real and simple, so the ratio is ~0 there and O(1)
    for a complex or degenerate dominant cluster.  The squarings run
    through :func:`~.operators.hmatmul` (never TF32: 24 chained products
    amplify a rounded operand exponentially)."""
    tiny = torch.finfo(hk.dtype).tiny
    m = hk / torch.clamp(torch.linalg.matrix_norm(hk), min=tiny)
    for _ in range(24):
        m = hmatmul(m, m)
        m = m / torch.clamp(torch.linalg.matrix_norm(m), min=tiny)
    s = torch.linalg.svdvals(m)
    return m, s[1] / torch.clamp(s[0], min=tiny)


def _arnoldi_factorization(mv, n, k, q0, dtype):
    """k Arnoldi steps from the unit vector ``q0``: ``(basis (k+1, N),
    H (k+1, k))``."""
    basis = torch.zeros((k + 1, n), dtype=dtype, device=q0.device)
    basis[0] = q0
    h = torch.zeros((k + 1, k), dtype=dtype, device=q0.device)
    for j in range(k):
        arnoldi_step(mv, basis, h, j)
    return basis, h


def _probe_defect(mv, n, k, v0, dtype):
    """The Perron defect of a k-step Arnoldi probe from ``v0`` (the power
    loop's exit iterate): a converged simple real pair breaks the probe
    down at once (defect ~0); a complex dominant pair keeps the iterate
    wandering in its invariant plane, which the probe captures (O(1))."""
    _, h = _arnoldi_factorization(mv, n, k, v0, dtype)
    return _hessenberg_defect(h[:k, :k])[1]


def _arnoldi_ritz_vector(mv, n, k, q0, dtype):
    """``(v, defect)``: the dominant Ritz vector of a k-step Arnoldi
    factorization of ``mv`` from the unit ``q0``, and the Perron defect of
    its Hessenberg block.  The dominant eigenvector of the small block is
    a column of its collapsed power (:func:`_hessenberg_defect`), the
    strongest one, as in the JAX package (whose TPU had no non-symmetric
    ``eig``); forward only, the IFT rule wraps the converged triple."""
    tiny = torch.finfo(dtype).tiny
    basis, h = _arnoldi_factorization(mv, n, k, q0, dtype)
    mp, defect = _hessenberg_defect(h[:k, :k])
    y = mp[:, torch.argmax(torch.linalg.vector_norm(mp, dim=0))]
    y = y / torch.clamp(torch.linalg.vector_norm(y), min=tiny)
    v = hmatmul(basis[:k].T, y)
    return v / torch.clamp(torch.linalg.vector_norm(v), min=tiny), defect


def _unit(n, dtype, generator):
    """A unit start vector drawn from ``generator``."""
    v = torch.randn(n, dtype=dtype, device=generator.device,
                    generator=generator)
    return v / torch.linalg.vector_norm(v)


def _power_pair(op, opts: EigOptions):
    """Two-sided power iteration: ``(λ, l, r, PowerInfo)`` with ``||r|| =
    1``, the pivot entry of r positive and ``l^T r = 1``.

    Stops on ``max(||A r - λ_r r||, ||A^T l - λ_l l||) / |λ_r| <=
    power_tol`` (clamped by ``tol_floor``) or after ``num_iters`` steps.
    The host reads the residual every ``CHECK_EVERY`` steps; in between
    the state freezes on the device once the residual meets the target,
    so the iterate and the step count are those of the JAX
    ``while_loop``."""
    n, dtype = op.dim, op.dtype
    tiny = torch.finfo(dtype).tiny
    generator = torch.Generator(device=op.device).manual_seed(opts.seed)
    r0, l0 = _unit(n, dtype, generator), _unit(n, dtype, generator)
    defect = None
    if opts.method == "arnoldi":
        # A Krylov-filtered start: the loop then only polishes the Ritz
        # vectors and certifies them.
        k = max(2, min(opts.arnoldi_k, n))
        r0, defect_r = _arnoldi_ritz_vector(op.matvec, n, k, r0, dtype)
        l0, defect_l = _arnoldi_ritz_vector(op.rmatvec, n, k, l0, dtype)
        defect = torch.maximum(defect_r, defect_l)
    ptol = tol_floor(opts.power_tol, dtype)
    r, l = r0, l0
    resid = torch.full((), float("inf"), dtype=dtype, device=r.device)
    its = torch.zeros((), dtype=torch.int64, device=r.device)
    it = 0
    while it < opts.num_iters:
        if not bool(resid > ptol):
            break
        for _ in range(min(CHECK_EVERY, opts.num_iters - it)):
            active = resid > ptol
            wr = op.matvec(r)
            lam_r = hdot(r, wr)
            res_r = torch.linalg.vector_norm(wr - lam_r * r)
            wl = op.rmatvec(l)
            lam_l = hdot(l, wl)
            res_l = torch.linalg.vector_norm(wl - lam_l * l)
            scale = torch.clamp(lam_r.abs(), min=tiny)
            res_new = torch.maximum(res_r, res_l) / scale
            r = torch.where(active, wr / torch.linalg.vector_norm(wr), r)
            l = torch.where(active, wl / torch.linalg.vector_norm(wl), l)
            resid = torch.where(active, res_new, resid)
            its = its + active
            it += 1
    if defect is None:
        # The power path's Perron guard: a 6-step probe of each exit
        # iterate, once.
        kd = max(2, min(6, n))
        defect = torch.maximum(_probe_defect(op.matvec, n, kd, r, dtype),
                               _probe_defect(op.rmatvec, n, kd, l, dtype))
    r = r * torch.sign(r[torch.argmax(r.abs())]).conj()
    ln = _bdot(l, r)
    lam = _bdot(l, op.matvec(r)) / ln
    l = l / ln
    info = PowerInfo(iterations=its.to(dtype), residual=resid,
                     converged=(resid <= ptol).to(dtype),
                     rank1_defect=defect.to(dtype))
    return lam, l, r, info


def _bordered_solve(op, transpose, u, w, b, lam, opts):
    """x of the bordered system ``[[M, u], [w^T, 0]] (x; ν) = (b; 0)``,
    ``M = A - λI`` (``A^T - λI`` with ``transpose``): the solution of
    ``M x = b - ν u`` with ``w^T x = 0``, by ``opts.solver``,
    differentiable (``cg._GeneralSolve``; its backward solves the
    transposed system ``[[M^T, w], [u^T, 0]]``)."""
    rhs = torch.cat([b, b.new_zeros(1)])
    z = _GeneralSolve.apply(op, transpose, opts.tol, opts.maxiter,
                            opts.solver, rhs, lam, u[:, None], w[:, None],
                            *op.parameters())
    return z[:op.dim]


class _DominantEig(torch.autograd.Function):
    """Outputs ``(λ, l, r)``, then the four :class:`PowerInfo` fields
    with ``with_info`` (see the module docstring for the rules)."""

    @staticmethod
    def forward(ctx, op, opts, with_info, *params):
        lam, l, r, info = _power_pair(op, opts)
        info = tuple(info) if with_info else ()
        ctx.op, ctx.opts, ctx.n_info = op, opts, len(info)
        ctx.save_for_backward(lam, l, r)
        ctx.save_for_forward(lam, l, r)
        ctx.mark_non_differentiable(*info)
        # An output the loss does not use brings no cotangent (None) and
        # costs no solve.
        ctx.set_materialize_grads(False)
        return (lam, l, r, *info)

    @staticmethod
    def jvp(ctx, _op, _opts, _with_info, *dparams):
        """The JAX package's ``_eig_tangents``: two tangent products and
        two bordered solves; zero tangents (None) for the info fields."""
        op, opts = ctx.op, ctx.opts
        lam, l, r = ctx.saved_tensors
        info = (None,) * ctx.n_info
        if all(t is None for t in dparams):
            return (torch.zeros_like(lam), torch.zeros_like(l),
                    torch.zeros_like(r), *info)
        dar = op.tangent_matvec(r, dparams)
        datl = op.tangent_rmatvec(l, dparams)
        dlam = _bdot(l, dar)
        dr = _bordered_solve(op, False, l, r, -(dar - dlam * r), lam, opts)
        dl0 = _bordered_solve(op, True, r, l, -(datl - dlam * l), lam, opts)
        c = -_bdot(l, dr) - _bdot(r, dl0)
        return (dlam, dl0 + c * l, dr, *info)

    @staticmethod
    def backward(ctx, lam_bar, l_bar, r_bar, *info_bar):
        op, opts = ctx.op, ctx.opts
        lam, l, r = ctx.saved_tensors
        if lam_bar is None and l_bar is None and r_bar is None:
            return (None,) * (3 + len(op.parameters()))
        lam_tot = torch.zeros_like(lam) if lam_bar is None else lam_bar
        # Through dl = dl0 + c l, c = -l^T dr - r^T dl0: the l-cotangent
        # reaches dl0 and dr.
        g_l0 = g_r = None
        if l_bar is not None:
            c_bar = _bdot(l_bar, l)
            g_l0 = l_bar - c_bar * r
            g_r = -c_bar * l
        if r_bar is not None:
            g_r = r_bar if g_r is None else g_r + r_bar
        # S_r^T = S_l and S_l^T = S_r (the bordered systems transpose
        # into each other).  S_l r = 0 and S_r l = 0, so the right-hand
        # sides lose their components along r and l first (the range of
        # A^T - λ is r⊥, that of A - λ is l⊥).  That changes no solution,
        # and keeps BiCGStab off a breakdown: for g_r ∥ l (an l̄ alone),
        # B (g_r; 0) = (0; l^T g_r) is orthogonal to (g_r; 0), and the
        # first step would divide by round-off.
        cot_ar = None
        if g_r is not None:
            g_r = g_r - _bdot(r, g_r) / _bdot(r, r) * r
            bb_r = _bordered_solve(op, True, r, l, g_r, lam, opts)
            lam_tot = lam_tot + _bdot(bb_r, r)
            cot_ar = -bb_r
        cot_atl = None
        if g_l0 is not None:
            g_l0 = g_l0 - _bdot(l, g_l0) / _bdot(l, l) * l
            bb_l = _bordered_solve(op, False, l, r, g_l0, lam, opts)
            lam_tot = lam_tot + _bdot(bb_l, l)
            cot_atl = -bb_l
        cot_ar = lam_tot * l if cot_ar is None else lam_tot * l + cot_ar
        # Ā = cot_ar r^T + l cot_atl^T, applied as the partials of one
        # matvec(r) and one rmatvec(l), r and l held constant.
        if cot_atl is None:
            grads = partial_vjp(op, lambda held: held.matvec(r), [], cot_ar,
                                ctx.needs_input_grad[3:])
        else:
            grads = partial_vjp(
                op, lambda held: torch.cat([held.matvec(r),
                                            held.rmatvec(l)]),
                [], torch.cat([cot_ar, cot_atl]), ctx.needs_input_grad[3:])
        return (None, None, None, *grads)


def dominant_eig(op, num_iters: int = 500, *, tol: float = 1e-10,
                 maxiter: int | None = None, seed: int = 0,
                 power_tol: float = 1e-12, with_info: bool = False,
                 solver: str = "bicgstab", method: str = "power",
                 arnoldi_k: int = 32, device=None):
    """Dominant eigenvalue of a general square operator with its left and
    right eigenvectors, differentiable to any order in
    ``op.parameters()``: reverse mode (again under ``create_graph``) and
    forward mode (``torch.autograd.forward_ad``; the operator needs
    ``tangent_matvec`` and ``tangent_rmatvec``).

    Assumes the dominant eigenvalue is real, positive and simple (the
    Perron-Frobenius setting of transfer matrices), and measures it:
    ``PowerInfo.rank1_defect`` (``with_info=True``) is ~0 when that holds
    and O(1) when a complex or degenerate pair dominates (treat ≳ 1e-2 as
    "untrustworthy"); ``converged`` stays 0 when the residual oscillates.

    num_iters : the power iteration's budget; it stops once both
                residuals are below ``power_tol * |λ|``.
    tol, maxiter : the IFT tangent solves' (bordered, by ``solver``:
                "bicgstab", "gmres" or "cgnr").
    method    : "power", or "arnoldi": start from the dominant Ritz
                vectors of an ``arnoldi_k``-step Arnoldi sweep per side,
                a polynomial filter in place of the O(1/gap) power steps
                a near-degenerate spectrum needs.
    seed      : seeds the generator of the start vectors (the JAX
                package's PRNG draws other numbers; a converged triple is
                the same after the gauge).
    device    : where the solve runs (CUDA when None).

    Returns ``(λ, l, r)`` with ``||r|| = 1``, the largest-magnitude entry
    of r positive and ``l^T r = 1``; with ``with_info`` also a
    :class:`PowerInfo`.
    """
    if solver not in ("bicgstab", "cgnr", "gmres"):
        raise ValueError(
            f"solver must be bicgstab|cgnr|gmres, got {solver!r}")
    if method not in ("power", "arnoldi"):
        raise ValueError(f"method must be power|arnoldi, got {method!r}")
    op = as_operator(op)
    check_device(device, op)
    opts = EigOptions(num_iters=int(num_iters), tol=float(tol),
                      maxiter=None if maxiter is None else int(maxiter),
                      seed=int(seed), power_tol=float(power_tol),
                      solver=solver, method=method,
                      arnoldi_k=int(arnoldi_k))
    out = _DominantEig.apply(op, opts, bool(with_info), *op.parameters())
    if with_info:
        return out[0], out[1], out[2], PowerInfo(*out[3:])
    return out


def _wielandt_deflate_mv(params, x):
    """``(M - λ r l^T) x`` with ``l^T r = 1``: removes λ from the spectrum
    and leaves every other eigenvalue and its vectors as they were."""
    lam, l, r, inner = params
    return inner.matvec(x) - lam * r * _bdot(l, x)


def _wielandt_deflate_rmv(params, x):
    lam, l, r, inner = params
    return inner.rmatvec(x) - lam * l * _bdot(r, x)


def dominant_eig_multi(op, m: int = 2, *, num_iters: int = 500,
                       tol: float = 1e-10, maxiter: int | None = None,
                       seed: int = 0, power_tol: float = 1e-12,
                       solver: str = "bicgstab", method: str = "arnoldi",
                       arnoldi_k: int = 32, with_info: bool = False,
                       device=None):
    """The top-m eigentriples (by |λ|) of a general square operator, by
    sequential Wielandt deflation: after each triple the next
    :func:`dominant_eig` (seed ``seed + j``) runs on ``M - λ_j r_j
    l_j^T``, a ``MatrixFreeOperator`` that holds the operator before it,
    so no dense matrix is formed and the derivatives of every stage
    reach ``op.parameters()`` through the stages before it.

    Arnoldi-seeded by default (sub-dominant transfer eigenvalues cluster).
    Assumes the top m eigenvalues are simple and real: a complex
    sub-dominant pair of a real operator cannot be one real triple, and
    its stage reports ``converged = 0`` (``with_info=True``).

    Returns ``(lams (m,), ls (N, m), rs (N, m))`` with ``||r_j|| = 1`` and
    ``l_j^T r_j = 1``; with ``with_info`` also a :class:`PowerInfo` of
    (m,) fields.
    """
    op = as_operator(op)
    dev = check_device(device, op)
    m = int(m)
    if m < 1:
        raise ValueError("m must be >= 1")
    lams, ls, rs, infos = [], [], [], []
    cur = op
    for j in range(m):
        out = dominant_eig(cur, num_iters=num_iters, tol=tol,
                           maxiter=maxiter, seed=seed + j,
                           power_tol=power_tol, solver=solver,
                           method=method, arnoldi_k=arnoldi_k,
                           with_info=with_info, device=dev)
        lam, l, r = out[:3]
        if with_info:
            infos.append(out[3])
        lams.append(lam)
        ls.append(l)
        rs.append(r)
        if j + 1 < m:
            cur = MatrixFreeOperator(_wielandt_deflate_mv, (lam, l, r, cur),
                                     dim=op.dim, dtype=op.dtype,
                                     rmatvec_fn=_wielandt_deflate_rmv,
                                     symmetric=False, device=dev)
    out = (torch.stack(lams), torch.stack(ls, dim=-1),
           torch.stack(rs, dim=-1))
    if with_info:
        return out + (PowerInfo(*(torch.stack(f) for f in zip(*infos))),)
    return out
