"""Differentiable dominant eigensolver for general (non-symmetric) operators.

Counterpart of ``dominantsparseeigenad_tpu/ops/eig.py``: ``dominant_eig``,
``dominant_eig_multi``, ``EigOptions`` and ``PowerInfo``, and its complex
half, ``dominant_eig_pair``, ``dominant_eig_spectrum`` and
``spectrum_structure``.  ``dominant_eig`` is for transfer matrices, whose
dominant eigenvalue is real, positive and simple (Perron-Frobenius); it
measures that assumption (``PowerInfo.rank1_defect``) rather than
trusting it.  It also takes a complex non-symmetric operator, whose
dominant eigenvalue is then complex.

Forward: a two-sided power iteration (A for the right vector r, A^T for
the left vector l), stopped on the scale-free residual, optionally seeded
by the dominant Ritz vectors of a k-step Arnoldi sweep; gauge ``||r|| =
1``, the largest-magnitude entry of r real and positive, ``l^T r = 1``
(bilinear, for complex vectors too).

The JAX package registers the implicit-function-theorem tangents as a
JVP and lets JAX transpose it.  Here the JVP is the Function's ``jvp``
(forward mode), as written there,

    dλ = l^T (dA) r,
    dr  = S_r b_r,  b_r = -((dA) r - dλ r),
    dl0 = S_l b_l,  b_l = -((dA)^T l - dλ l),
    dl  = dl0 + c l,  c = -l^T dr - r^T dl0,

(for a complex r, dr first moves along r to keep ``Re <r, dr> = 0`` and
the pivot entry real: ``dr += (-Re<r, dr> - i Im dr[p] / r[p]) r``), where
``S_r`` solves the bordered system ``[[A - λI, l], [r^T, 0]]`` and
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

For complex (λ, l, r) the backward is the same map in PyTorch's
conjugate convention: every cotangent that the formulas above pair
bilinearly with l or r is conjugated (``g_l0 = l̄ - conj(l^H l̄) conj(r)``,
``b̄_r = conj(S_l conj(g_r))``, ``λ̄_tot = λ̄ + <r, b̄_r> + <l, b̄_l>``,
output cotangent ``λ̄_tot conj(l) - b̄_r``), and the pivot gauge's shift
of dr is transposed onto g_r first (``g_r += i (Im<g_r, r> / r[p]) e_p``;
its part along r is dropped with the border component).

``dominant_eig_multi`` deflates each converged triple out of the operator
(Wielandt, ``M - λ r l^T``) through a ``MatrixFreeOperator`` that holds
the operator before it, so the gradients of every stage reach the
innermost operator's tensors.

The complex half.  ``dominant_eig_pair`` takes a REAL operator whose
dominant eigenvalue may be one of a complex-conjugate pair: a block power
iteration finds the dominant 2-D invariant subspace (once for A, once for
A^T), the 2 x 2 restriction gives λ (``Im λ >= 0``) and its eigenvectors
in closed form, and the same IFT rule runs in complex arithmetic on the
real operator lifted to complex vectors (``_ComplexifiedOperator``), so
the gradients land on the real operator's tensors.  ``dominant_eig_spectrum``
runs the top-m spectrum of a real operator as a cascade of stages, each a
real simple eigenvalue (``dominant_eig``) or a conjugate pair
(``dominant_eig_pair``), deflating pairs by ``M - 2 Re(λ r l^T)`` so that
every stage's operator stays real.  The structure of the cascade is
found on the host from concrete values; ``spectrum_structure`` returns it
so that a derivative run can replay it.

Sharded vectors (``operators.vector_layout``): every entry point runs on
an operator whose vectors are the rank's rows.  The start vectors are the
rank's rows of the whole draw, the Arnoldi bases hold the rank's columns,
every pairing and norm is summed over the ranks, the pivot and the phase
shifts read the whole vector (``layout.pivot``, ``take``, ``one_hot``),
the block power iteration orthonormalizes by a QR across the ranks
(``layout.tall_qr``), and the deflated and complexified operators carry
the layout.  Every host decision reads a value that is the same on every
rank, so the ranks run the same collectives; a replicated value (λ, a
pairing) entering the rank's rows is marked (``layout_bcast``), so that
a second backward sums its shares.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .cg import CHECK_EVERY, _GeneralSolve
from .lanczos import arnoldi_step
from .operators import (LinearOperator, MatrixFreeOperator, _reduced,
                        as_operator,
                        check_device, hdot, hmatmul, layout_bcast,
                        layout_norm, layout_sum, local_dim, nestable_jvp,
                        partial_vjp, per_lane_vmap, pivot_gauge, real_dtype,
                        rebind, tol_floor, vector_layout)


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


def _bdot(a, b, layout=None):
    """The bilinear pairing ``sum(a * b)`` (never conjugated: l is the
    transpose left eigenvector, and its annihilator row is l^T), summed
    over the ranks under a sharded ``layout``."""
    return layout_sum(layout, torch.dot(a, b))


def _hdot(a, b, layout=None):
    """``hdot`` over the whole vector."""
    return layout_sum(layout, hdot(a, b))


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


def _arnoldi_factorization(mv, n, k, q0, dtype, layout=None):
    """k Arnoldi steps from the unit vector ``q0``: ``(basis (k+1, N),
    H (k+1, k))``; the basis holds the rank's columns under a sharded
    ``layout`` (H is the same on every rank)."""
    basis = torch.zeros((k + 1, q0.shape[0]), dtype=dtype, device=q0.device)
    basis[0] = q0
    h = torch.zeros((k + 1, k), dtype=dtype, device=q0.device)
    for j in range(k):
        arnoldi_step(mv, basis, h, j, layout)
    return basis, h


def _probe_defect(mv, n, k, v0, dtype, layout=None):
    """The Perron defect of a k-step Arnoldi probe from ``v0`` (the power
    loop's exit iterate): a converged simple real pair breaks the probe
    down at once (defect ~0); a complex dominant pair keeps the iterate
    wandering in its invariant plane, which the probe captures (O(1))."""
    _, h = _arnoldi_factorization(mv, n, k, v0, dtype, layout)
    return _hessenberg_defect(h[:k, :k])[1]


def _arnoldi_ritz_vector(mv, n, k, q0, dtype, layout=None):
    """``(v, defect)``: the dominant Ritz vector of a k-step Arnoldi
    factorization of ``mv`` from the unit ``q0``, and the Perron defect of
    its Hessenberg block.  The dominant eigenvector of the small block is
    a column of its collapsed power (:func:`_hessenberg_defect`), the
    strongest one, as in the JAX package (whose TPU had no non-symmetric
    ``eig``); forward only, the IFT rule wraps the converged triple."""
    tiny = torch.finfo(dtype).tiny
    basis, h = _arnoldi_factorization(mv, n, k, q0, dtype, layout)
    mp, defect = _hessenberg_defect(h[:k, :k])
    y = mp[:, torch.argmax(torch.linalg.vector_norm(mp, dim=0))]
    y = y / torch.clamp(torch.linalg.vector_norm(y), min=tiny)
    v = hmatmul(basis[:k].T, y)
    return v / torch.clamp(layout_norm(layout, v), min=tiny), defect


def _unit(n, dtype, generator, layout=None):
    """A unit start vector drawn from ``generator`` (the rank's rows of
    the whole draw under a sharded ``layout``)."""
    if layout is None:
        v = torch.randn(n, dtype=dtype, device=generator.device,
                        generator=generator)
    else:
        v = layout.draw((n,), generator, dtype, generator.device)
    return v / layout_norm(layout, v)


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
    rdt = real_dtype(dtype)
    tiny = torch.finfo(dtype).tiny
    lay = vector_layout(op)
    generator = torch.Generator(device=op.device).manual_seed(opts.seed)
    r0 = _unit(n, dtype, generator, lay)
    l0 = _unit(n, dtype, generator, lay)
    defect = None
    if opts.method == "arnoldi":
        # A Krylov-filtered start: the loop then only polishes the Ritz
        # vectors and certifies them.
        k = max(2, min(opts.arnoldi_k, n))
        r0, defect_r = _arnoldi_ritz_vector(op.matvec, n, k, r0, dtype, lay)
        l0, defect_l = _arnoldi_ritz_vector(op.rmatvec, n, k, l0, dtype,
                                            lay)
        defect = torch.maximum(defect_r, defect_l)
    ptol = tol_floor(opts.power_tol, dtype)
    r, l = r0, l0
    resid = torch.full((), float("inf"), dtype=rdt, device=r.device)
    its = torch.zeros((), dtype=torch.int64, device=r.device)
    it = 0
    while it < opts.num_iters:
        if not bool(resid > ptol):
            break
        for _ in range(min(CHECK_EVERY, opts.num_iters - it)):
            active = resid > ptol
            wr = op.matvec(r)
            lam_r = _hdot(r, wr, lay)
            res_r = layout_norm(lay, wr - lam_r * r)
            wl = op.rmatvec(l)
            lam_l = _hdot(l, wl, lay)
            res_l = layout_norm(lay, wl - lam_l * l)
            scale = torch.clamp(lam_r.abs(), min=tiny)
            res_new = torch.maximum(res_r, res_l) / scale
            r = torch.where(active, wr / layout_norm(lay, wr), r)
            l = torch.where(active, wl / layout_norm(lay, wl), l)
            resid = torch.where(active, res_new, resid)
            its = its + active
            it += 1
    if defect is None:
        # The power path's Perron guard: a 6-step probe of each exit
        # iterate, once.
        kd = max(2, min(6, n))
        defect = torch.maximum(
            _probe_defect(op.matvec, n, kd, r, dtype, lay),
            _probe_defect(op.rmatvec, n, kd, l, dtype, lay))
    r = pivot_gauge(r, layout=lay)
    ln = _bdot(l, r, lay)
    lam = _bdot(l, op.matvec(r), lay) / ln
    l = l / ln
    info = PowerInfo(iterations=its.to(rdt), residual=resid,
                     converged=(resid <= ptol).to(rdt),
                     rank1_defect=defect.to(rdt))
    return lam, l, r, info


def _bordered_solve(op, transpose, u, w, b, lam, opts):
    """x of the bordered system ``[[M, u], [w^T, 0]] (x; ν) = (b; 0)``,
    ``M = A - λI`` (``A^T - λI`` with ``transpose``): the solution of
    ``M x = b - ν u`` with ``w^T x = 0``, by ``opts.solver``,
    differentiable (``cg._GeneralSolve``; its backward solves the
    transposed system ``[[M^T, w], [u^T, 0]]``).  Over sharded vectors
    b, u, w and x are the rank's rows; λ enters them marked."""
    rhs = torch.cat([b, b.new_zeros(1)])
    z = _GeneralSolve.apply(op, transpose, opts.tol, opts.maxiter,
                            opts.solver, rhs,
                            layout_bcast(vector_layout(op), lam),
                            u[:, None], w[:, None], *op.parameters())
    return z[:local_dim(op)]


def _pivot_entries(r, *ts, layout=None):
    """``(r[p], *(t[p] for t in ts), e_p)``: the entries of r and of each
    ``t`` at r's pivot p (its first largest |r|) and the rows of the unit
    vector there, over the whole vector under a sharded ``layout``."""
    if layout is None:
        p = torch.argmax(r.abs())
        return (r[p], *(t[p] for t in ts),
                torch.nn.functional.one_hot(p, r.shape[0]).to(r.dtype))
    p, _ = layout.pivot(r)
    return (layout.take(r, p), *(layout.take(t, p) for t in ts),
            layout.one_hot(p, r.dtype))


def _phase_shift(r, dr, layout=None):
    """The JAX ``_eig_tangents``' shift of a complex dr along r:
    ``dr + (-Re<r, dr> - i Im dr[p] / r[p]) r`` keeps ``||r||`` and the
    pivot entry's phase; the identity for a real dtype."""
    if not r.is_complex():
        return dr
    rp, drp, _ = _pivot_entries(r, dr, layout=layout)
    c = -_hdot(r, dr, layout).real - 1j * drp.imag / rp.real
    return dr + layout_bcast(layout, c) * r


def _phase_shift_cotangent(r, g, layout=None):
    """The transpose of :func:`_phase_shift` on a cotangent of dr, up to
    a multiple of r (which the caller drops: the solve it feeds annihilates
    r): ``g + i (Im<g, r> / r[p]) e_p``."""
    if not r.is_complex():
        return g
    rp, e = _pivot_entries(r, layout=layout)
    c = 1j * (_hdot(g, r, layout).imag / rp.real)
    return g + layout_bcast(layout, c) * e


def _outputs(with_info, lam, l, r, info):
    """The Function's outputs: ``(λ, l, r)``, then the info fields."""
    return (lam, l, r, *(tuple(info) if with_info else ()))


def _setup(ctx, inputs, output, op):
    """The bookkeeping of :class:`_DominantEig` and
    :class:`_DominantEigPair`: ``op`` is the operator the rules apply
    (lifted to complex vectors for a pair), rebuilt by the rules on the
    saved parameters."""
    _, opts, _, *params = inputs
    ctx.op, ctx.opts, ctx.n_info = op, opts, len(output) - 3
    ctx.save_for_backward(*output[:3], *params)
    ctx.save_for_forward(*output[:3], *params)
    ctx.mark_non_differentiable(*output[3:])
    # An output the loss does not use brings no cotangent (None) and
    # costs no solve.
    ctx.set_materialize_grads(False)


def _saved(ctx):
    """``(op, λ, l, r)``: the rules' operator on the saved parameters."""
    lam, l, r, *params = ctx.saved_tensors
    return rebind(ctx.op, params), lam, l, r


@per_lane_vmap
class _DominantEig(torch.autograd.Function):
    """Outputs ``(λ, l, r)``, then the four :class:`PowerInfo` fields
    with ``with_info`` (see the module docstring for the rules)."""

    @staticmethod
    def forward(op, opts, with_info, *params):
        return _outputs(with_info,
                        *_power_pair(rebind(op, params), opts))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _setup(ctx, inputs, output, inputs[0])

    @staticmethod
    @nestable_jvp
    def jvp(ctx, _op, _opts, _with_info, *dparams):
        """The JAX package's ``_eig_tangents``: two tangent products and
        two bordered solves; zero tangents (None) for the info fields."""
        opts = ctx.opts
        op, lam, l, r = _saved(ctx)
        lay = vector_layout(op)
        info = (None,) * ctx.n_info
        if all(t is None for t in dparams):
            return (torch.zeros_like(lam), torch.zeros_like(l),
                    torch.zeros_like(r), *info)
        dar = op.tangent_matvec(r, dparams)
        datl = op.tangent_rmatvec(l, dparams)
        dlam = _bdot(l, dar, lay)
        dlam_rows = layout_bcast(lay, dlam)
        dr = _bordered_solve(op, False, l, r, -(dar - dlam_rows * r), lam,
                             opts)
        dr = _phase_shift(r, dr, lay)
        dl0 = _bordered_solve(op, True, r, l, -(datl - dlam_rows * l), lam,
                              opts)
        c = -_bdot(l, dr, lay) - _bdot(r, dl0, lay)
        return (dlam, dl0 + layout_bcast(lay, c) * l, dr, *info)

    @staticmethod
    def backward(ctx, lam_bar, l_bar, r_bar, *info_bar):
        opts = ctx.opts
        op, lam, l, r = _saved(ctx)
        lay = vector_layout(op)
        if lam_bar is None and l_bar is None and r_bar is None:
            return (None,) * (3 + len(op.parameters()))
        lam_tot = torch.zeros_like(lam) if lam_bar is None else lam_bar
        # Through dl = dl0 + c l, c = -l^T dr - r^T dl0: the l-cotangent
        # reaches dl0 and dr (conj(l^H l̄) is l̄ . l for real dtypes).
        g_l0 = g_r = None
        if l_bar is not None:
            c_bar = _reduced(lay, hdot(l, l_bar))
            g_l0 = l_bar - c_bar * r.conj()
            g_r = -c_bar * l.conj()
        if r_bar is not None:
            g_r = r_bar if g_r is None else g_r + r_bar
        # S_r^T = S_l and S_l^T = S_r (the bordered systems transpose
        # into each other); PyTorch's cotangents take the adjoints,
        # conj(S_l conj(.)) and conj(S_r conj(.)).  S_r^H r = 0 and
        # S_l^H l = 0, so the right-hand sides lose their components
        # along r and l first.  That changes no solution, and keeps
        # BiCGStab off a breakdown: for g_r ∥ l (an l̄ alone, real
        # dtypes), B (g_r; 0) = (0; l^T g_r) is orthogonal to (g_r; 0),
        # and the first step would divide by round-off.
        cot_ar = None
        if g_r is not None:
            g_r = _phase_shift_cotangent(r, g_r, lay)
            g_r = g_r - layout_bcast(
                lay, _hdot(r, g_r, lay) / _hdot(r, r, lay)) * r
            bb_r = _bordered_solve(op, True, r, l, g_r.conj(), lam,
                                   opts).conj()
            lam_tot = lam_tot + _hdot(r, bb_r, lay)
            cot_ar = -bb_r
        cot_atl = None
        if g_l0 is not None:
            g_l0 = g_l0 - layout_bcast(
                lay, _hdot(l, g_l0, lay) / _hdot(l, l, lay)) * l
            bb_l = _bordered_solve(op, False, l, r, g_l0.conj(), lam,
                                   opts).conj()
            lam_tot = lam_tot + _hdot(l, bb_l, lay)
            cot_atl = -bb_l
        cot_ar = layout_bcast(lay, lam_tot) * l.conj() \
            + (0 if cot_ar is None else cot_ar)
        # The gradient of Re<cot_ar, A r> + Re<cot_atl, A^T l>: the
        # partials of one matvec(r) and one rmatvec(l), r and l held
        # constant.
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
    forward mode to any order (``torch.func.jvp``, or
    ``torch.autograd.forward_ad``; the operator needs
    ``tangent_matvec`` and ``tangent_rmatvec``).

    Assumes the dominant eigenvalue is simple and, for a real operator,
    real (the Perron-Frobenius setting of transfer matrices; a complex
    dominant pair needs :func:`dominant_eig_pair`), and measures it:
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
    of r real and positive and ``l^T r = 1`` (bilinear: for a complex
    operator l is the transpose left eigenvector, ``A^T l = λ l``); with
    ``with_info`` also a :class:`PowerInfo`.  Over an operator whose
    vectors are sharded (``vectors="sharded"``), l and r are the rank's
    rows and λ is the same on every rank.
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
    and leaves every other eigenvalue and its vectors as they were (over
    sharded vectors l, r and x are the rank's rows, and λ and the pairing
    enter them marked)."""
    lam, l, r, inner = params
    lay = vector_layout(inner)
    return inner.matvec(x) - layout_bcast(lay, lam) * r \
        * _reduced(lay, torch.dot(l, x))


def _wielandt_deflate_rmv(params, x):
    lam, l, r, inner = params
    lay = vector_layout(inner)
    return inner.rmatvec(x) - layout_bcast(lay, lam) * l \
        * _reduced(lay, torch.dot(r, x))


def _deflated_stage(matvec_fn, rmatvec_fn, params, op, device):
    """The next stage's operator: ``matvec_fn``/``rmatvec_fn`` on
    ``params`` (whose last entry is the stage before it), non-symmetric,
    on ``op``'s vector layout."""
    stage = MatrixFreeOperator(matvec_fn, params, dim=op.dim, dtype=op.dtype,
                               rmatvec_fn=rmatvec_fn, symmetric=False,
                               device=device)
    stage.vector_layout = vector_layout(op)
    return stage


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
    (m,) fields.  Over sharded vectors ls and rs are the rank's rows.
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
            cur = _deflated_stage(_wielandt_deflate_mv,
                                  _wielandt_deflate_rmv, (lam, l, r, cur),
                                  op, dev)
    out = (torch.stack(lams), torch.stack(ls, dim=-1),
           torch.stack(rs, dim=-1))
    if with_info:
        return out + (PowerInfo(*(torch.stack(f) for f in zip(*infos))),)
    return out


class _ComplexifiedOperator(LinearOperator):
    """A real operator lifted to complex vectors, ``A x = A Re x + i A Im
    x`` (and so for the transpose and the tangent products), so that the
    complex-pair rules run the generic machinery while the gradients go
    to the real operator's own tensors; its inner matvec never sees a
    complex vector."""

    def __init__(self, inner):
        self.inner = inner

    def _lift(self, f, x):
        if not x.is_complex():
            return f(x).to(self.dtype)
        return torch.complex(f(x.real), f(x.imag))

    def matvec(self, x):
        return self._lift(self.inner.matvec, x)

    def rmatvec(self, x):
        return self._lift(self.inner.rmatvec, x)

    def tangent_matvec(self, x, dparams):
        return self._lift(lambda z: self.inner.tangent_matvec(z, dparams),
                          x)

    def tangent_rmatvec(self, x, dparams):
        return self._lift(lambda z: self.inner.tangent_rmatvec(z, dparams),
                          x)

    def parameters(self):
        return self.inner.parameters()

    def with_parameters(self, tensors):
        return _ComplexifiedOperator(self.inner.with_parameters(tensors))

    @property
    def vector_layout(self):
        return vector_layout(self.inner)

    @property
    def dim(self):
        return self.inner.dim

    @property
    def dtype(self):
        return (torch.complex128 if self.inner.dtype == torch.float64
                else torch.complex64)

    @property
    def device(self):
        return self.inner.device


def _block_eigvec(b, lam):
    """The right eigenvector of the 2 x 2 block ``b`` for ``lam`` in
    closed form, from the better-conditioned of its two rows; ``e_0``
    where that row is zero (a diagonal b with lam in slot 0)."""
    b = b.to(lam.dtype)
    y1 = torch.stack([b[0, 1], lam - b[0, 0]])
    y2 = torch.stack([lam - b[1, 1], b[1, 0]])
    y = torch.where(b[0, 1].abs() >= b[1, 0].abs(), y1, y2)
    nrm = torch.linalg.vector_norm(y)
    tiny = torch.finfo(lam.dtype).tiny
    e0 = torch.zeros_like(y)
    e0[0] = 1.0
    return torch.where(nrm > tiny, y / torch.clamp(nrm, min=tiny), e0)


def _orthonormal(z, layout=None):
    """The Q of the thin QR of the whole (N, 2) block ``z`` (the rank's
    rows of it under a sharded ``layout``: a QR across the ranks), its
    columns' signs fixed so that R has a non-negative diagonal: Q is then
    unique, and an iteration on it converges pointwise."""
    qn, rr = torch.linalg.qr(z) if layout is None else layout.tall_qr(z)
    d = torch.diagonal(rr)
    sgn = torch.sign(torch.where(d == 0, torch.ones_like(d), d))
    return qn * sgn[None, :]


def _subspace_2(mm, n, dtype, generator, num_iters, tol, layout=None):
    """The dominant 2-D invariant subspace of a real operator by
    orthogonal (block power) iteration on its (N, 2) products ``mm``:
    ``(Q (N, 2), B = Q^T A Q, residual, iterations)``, the residual that
    of ``A Q = Q B`` relative to ||B||.  Stops once the residual is at
    most ``tol`` (read on the host every ``CHECK_EVERY`` steps, the state
    frozen on the device in between, as in :func:`_power_pair`) or after
    ``num_iters`` steps; then one more product gives the returned B and
    residual on the returned Q.  Under a sharded ``layout`` Q holds the
    rank's rows (the start those of the whole draw) and B and the
    residual are the same on every rank."""
    tiny = torch.finfo(dtype).tiny
    if layout is None:
        start = torch.randn((n, 2), dtype=dtype, device=generator.device,
                            generator=generator)
    else:
        start = layout.draw((n, 2), generator, dtype, generator.device)
    q = _orthonormal(start, layout)

    def step(q):
        z = mm(q)
        b = layout_sum(layout, hmatmul(q.T, z))
        # The Frobenius norm of the whole (N, 2) block.
        resid = (layout_norm(layout, z - hmatmul(q, b))
                 / torch.clamp(torch.linalg.matrix_norm(b), min=tiny))
        return _orthonormal(z, layout), b, resid

    resid = torch.full((), float("inf"), dtype=dtype, device=q.device)
    its = torch.zeros((), dtype=torch.int64, device=q.device)
    it = 0
    while it < num_iters:
        if not bool(resid > tol):
            break
        for _ in range(min(CHECK_EVERY, num_iters - it)):
            active = resid > tol
            qn, _, res_new = step(q)
            q = torch.where(active, qn, q)
            resid = torch.where(active, res_new, resid)
            its = its + active
            it += 1
    _, b, resid = step(q)
    return q, b, resid, its


def _pair_forward(op, opts: EigOptions):
    """``(λ, l, r, PowerInfo)`` of the dominant eigenvalue of a real
    operator, allowing a complex-conjugate pair: λ from the 2 x 2
    restriction of the dominant invariant subspace (``Im λ >= 0``), r its
    eigenvector in that subspace (unit, pivot entry real positive), l the
    one of the transpose's, ``l^T r = 1``.  A numerically defective pair
    (``|l^T r|`` of the unit vectors below 100 eps) keeps l unit instead
    and reports ``converged = 0``."""
    n, dtype = op.dim, op.dtype
    lay = vector_layout(op)
    ptol = tol_floor(opts.power_tol, dtype)
    generator = torch.Generator(device=op.device).manual_seed(opts.seed)
    qr_, br, resid_r, it_r = _subspace_2(op.matmat, n, dtype, generator,
                                         opts.num_iters, ptol, lay)
    ql_, bl, resid_l, it_l = _subspace_2(op.rmatmat, n, dtype, generator,
                                         opts.num_iters, ptol, lay)
    resid = torch.maximum(resid_r, resid_l)
    cdtype = _ComplexifiedOperator(op).dtype
    tr = br[0, 0] + br[1, 1]
    det = br[0, 0] * br[1, 1] - br[0, 1] * br[1, 0]
    disc = tr * tr / 4 - det
    # A complex pair when disc < 0 (Im λ >= 0).  Otherwise the dominant
    # REAL eigenvalue is the larger-magnitude root, tr/2 ± sqrt(disc) as
    # the sign of tr says (a plain + would return the subdominant root
    # of a negative dominant eigenvalue: spectrum {-5, 2} -> 2).
    root = torch.sqrt(torch.clamp(disc.abs(), min=0.0))
    sgn = torch.where(tr >= 0, torch.ones_like(tr), -torch.ones_like(tr))
    lam = torch.where(disc < 0, torch.complex(tr / 2, root),
                      torch.complex(tr / 2 + sgn * root,
                                    torch.zeros_like(tr)))
    r = hmatmul(qr_.to(cdtype), _block_eigvec(br, lam))
    r = pivot_gauge(r / layout_norm(lay, r), layout=lay)
    # The left vector: A^T l = λ l, the same eigenvalue of B_l (the real
    # operator's spectrum is that of its transpose).  Unit first, so that
    # |l^T r| is the left/right cosine, and the bilinear scale only where
    # it is finite.
    l = hmatmul(ql_.to(cdtype), _block_eigvec(bl, lam))
    rtiny = torch.finfo(dtype).tiny
    l = l / torch.clamp(layout_norm(lay, l), min=rtiny)
    s = _bdot(l, r, lay)
    well_cond = s.abs() >= 100 * torch.finfo(dtype).eps
    l = l / torch.where(well_cond, s, torch.ones_like(s))
    info = PowerInfo(
        iterations=torch.maximum(it_r, it_l).to(dtype), residual=resid,
        converged=((resid <= ptol) & well_cond).to(dtype),
        # The 2-D subspace represents a dominant pair exactly: no rank-1
        # collapse to measure.
        rank1_defect=torch.zeros((), dtype=dtype, device=r.device))
    return lam, l, r, info


@per_lane_vmap
class _DominantEigPair(_DominantEig):
    """:class:`_DominantEig`'s rules on the real operator lifted to
    complex vectors, around the pair forward."""

    @staticmethod
    def forward(op, opts, with_info, *params):
        return _outputs(with_info,
                        *_pair_forward(rebind(op, params), opts))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _setup(ctx, inputs, output, _ComplexifiedOperator(inputs[0]))


def _check_real(op, name):
    if op.dtype.is_complex:
        raise ValueError(f"{name} expects a REAL operator; complex "
                         f"operators are handled by dominant_eig")


def dominant_eig_pair(op, num_iters: int = 500, *, tol: float = 1e-10,
                      maxiter: int | None = None, seed: int = 0,
                      power_tol: float = 1e-12, solver: str = "bicgstab",
                      with_info: bool = False, device=None):
    """The dominant eigenvalue of a REAL square operator, allowing a
    complex-conjugate dominant pair (the case :func:`dominant_eig`'s
    Perron guard diagnoses but cannot solve), with its left and right
    eigenvectors, differentiable to any order in ``op.parameters()``
    in either mode.

    A block power iteration of ``num_iters`` steps at most, stopped at
    ``power_tol``, finds the dominant 2-D invariant subspace of A and of
    A^T (the subspaces' seed is ``seed``); λ is ``a + bi`` with ``b >= 0``
    (the other member is ``conj(λ)`` with ``conj(l)``, ``conj(r)``), and a
    dominant real simple eigenvalue comes out as in :func:`dominant_eig`.
    The derivatives are :func:`dominant_eig`'s bordered IFT rule (``tol``,
    ``maxiter``, ``solver``) in complex arithmetic on the real operator.

    Returns complex ``(λ, l, r)`` with ``||r|| = 1``, the pivot entry of r
    real and positive and ``l^T r = 1`` (bilinear), except for a
    numerically defective pair (left/right cosine below ~100 eps, e.g. a
    perturbed Jordan block): l is then unit, and ``with_info=True``
    reports ``converged = 0``; consumers of the bilinear contract must
    treat that as "no usable pair" (:func:`dominant_eig_spectrum` raises
    on it).  With ``with_info`` also a :class:`PowerInfo` of the two
    subspace iterations (their larger residual and step count;
    ``rank1_defect`` 0).  Over sharded vectors l and r are the rank's
    rows.
    """
    if solver not in ("bicgstab", "cgnr", "gmres"):
        raise ValueError(
            f"solver must be bicgstab|cgnr|gmres, got {solver!r}")
    op = as_operator(op)
    check_device(device, op)
    _check_real(op, "dominant_eig_pair")
    opts = EigOptions(num_iters=int(num_iters), tol=float(tol),
                      maxiter=None if maxiter is None else int(maxiter),
                      seed=int(seed), power_tol=float(power_tol),
                      solver=solver)
    out = _DominantEigPair.apply(op, opts, bool(with_info),
                                 *op.parameters())
    if with_info:
        return out[0], out[1], out[2], PowerInfo(*out[3:])
    return out


def _real_pair_deflate_mv(params, x):
    """``(M - 2 Re(λ r l^T)) x``, real: a conjugate pair deflated at once,
    with ``a = Re(λ r)``, ``b = Im(λ r)``, ``l = lr + i li`` (the rank's
    rows over sharded vectors, the pairings entering them marked)."""
    a, b, lr, li, inner = params
    lay = vector_layout(inner)
    return inner.matvec(x) - 2.0 * (a * _reduced(lay, torch.dot(lr, x))
                                    - b * _reduced(lay, torch.dot(li, x)))


def _real_pair_deflate_rmv(params, x):
    a, b, lr, li, inner = params
    lay = vector_layout(inner)
    return inner.rmatvec(x) - 2.0 * (lr * _reduced(lay, torch.dot(a, x))
                                     - li * _reduced(lay, torch.dot(b, x)))


def dominant_eig_spectrum(op, m: int = 4, *, num_iters: int = 500,
                          tol: float = 1e-10, maxiter: int | None = None,
                          seed: int = 0, power_tol: float = 1e-12,
                          solver: str = "bicgstab", imag_tol: float = 1e-8,
                          structure: tuple | None = None, device=None):
    """The top-m eigenvalues (by modulus) of a REAL operator, complex
    conjugate pairs allowed anywhere, with their left and right vectors.

    A cascade of stages.  Stage s first measures the Perron defect of an
    Arnoldi sweep of 32 steps per side (seeded ``seed + s``); below 1e-2
    it runs :func:`dominant_eig` (``method="arnoldi"``), and if that
    converges with a defect below 1e-2 the stage is ``"real"``.  Any
    other stage runs :func:`dominant_eig_pair`: a genuinely complex λ
    (``|Im λ| > imag_tol |λ|``) is ``"pair"``, takes two slots (λ, conj λ)
    and deflates both at once by ``M - 2 Re(λ r l^T)``; a real one (a
    tied-modulus real cluster) is ``"pair_real"``, one slot, deflated
    rank-1 as a ``"real"`` stage is (Wielandt).  Every stage's operator
    is real.  Discovery raises RuntimeError on a numerically defective
    pair (left/right cosine below 1000 eps), whose projector has no
    finite deflation.

    With ``structure=None`` the kinds are decided on the host from
    concrete values.  For derivatives, find ``structure`` once
    (:func:`spectrum_structure`) and pass it back: each stage is then
    replayed by the same solver, with no decision, and the cascade is
    differentiable to any order in ``op.parameters()``.

    Returns ``(lams, ls, rs, structure)``: complex ``lams`` by descending
    |λ| (conjugate members adjacent) and (N, len(lams)) ``ls``, ``rs``
    with ``||r_j|| = 1`` and ``l_j^T r_j = 1``.  A pair is never split:
    when the m-th slot falls on its first member both are returned, and
    ``lams`` has m + 1 entries.  Over sharded vectors ls and rs are the
    rank's rows, and every decision reads values that are the same on
    every rank.
    """
    op = as_operator(op)
    dev = check_device(device, op)
    _check_real(op, "dominant_eig_spectrum")
    lay = vector_layout(op)
    cdtype = _ComplexifiedOperator(op).dtype
    kw = dict(num_iters=num_iters, tol=tol, maxiter=maxiter,
              power_tol=power_tol, solver=solver, device=dev)
    lams, ls, rs, built = [], [], [], []
    cur = op
    stage = 0
    while len(lams) < m:
        probe = None
        if structure is not None:
            kind = structure[stage]
        else:
            # The Arnoldi sweep's defect alone decides a complex-dominant
            # stage in ~64 products, before the 1-D solve would burn its
            # whole budget on it.
            gen = torch.Generator(device=dev).manual_seed(seed + stage)
            kk = max(2, min(32, op.dim))
            d_r = _arnoldi_ritz_vector(cur.matvec, cur.dim, kk,
                                       _unit(cur.dim, cur.dtype, gen, lay),
                                       cur.dtype, lay)[1]
            d_l = _arnoldi_ritz_vector(cur.rmatvec, cur.dim, kk,
                                       _unit(cur.dim, cur.dtype, gen, lay),
                                       cur.dtype, lay)[1]
            kind = "pair"
            if float(torch.maximum(d_r, d_l)) < 1e-2:
                probe = dominant_eig(cur, seed=seed + stage,
                                     method="arnoldi", with_info=True, **kw)
                info = probe[3]
                if bool((info.converged == 1.0)
                        & (info.rank1_defect < 1e-2)):
                    kind = "real"
        built.append(kind)
        if kind == "real":
            if probe is None:
                probe = dominant_eig(cur, seed=seed + stage,
                                     method="arnoldi", **kw)
            lam, l, r = (t.to(cdtype) for t in probe[:3])
        else:
            lam, l, r = dominant_eig_pair(cur, seed=seed + stage, **kw)
            if structure is None:
                tiny = torch.finfo(op.dtype).tiny
                cos_lr = float(_bdot(l, r, lay).abs() / torch.clamp(
                    layout_norm(lay, l) * layout_norm(lay, r), min=tiny))
                # 10x the solver's own floor: below it l's scale is
                # unusable and the deflation would not remove the pair.
                if cos_lr < 1000 * float(torch.finfo(op.dtype).eps):
                    raise RuntimeError(
                        f"dominant_eig_spectrum stage {stage}: the "
                        f"dominant pair is numerically defective "
                        f"(left/right cosine {cos_lr:.2e}); its spectral "
                        f"projector has no finite Wielandt deflation, so "
                        f"the remaining spectrum cannot be extracted")
                # A real result (a tied-modulus real cluster stalls the
                # probe too) takes one slot, deflated rank-1, and is
                # replayed by this same solver.
                lam_c = complex(lam)
                if abs(lam_c.imag) <= imag_tol * max(abs(lam_c), tiny):
                    kind = built[-1] = "pair_real"
        if kind == "pair":
            lams += [lam, lam.conj()]
            ls += [l, l.conj()]
            rs += [r, r.conj()]
            lr_ = layout_bcast(lay, lam) * r
            cur = _deflated_stage(_real_pair_deflate_mv,
                                  _real_pair_deflate_rmv,
                                  (lr_.real, lr_.imag, l.real, l.imag, cur),
                                  op, dev)
        else:
            lam_r, l_r, r_r = lam.real, l.real, r.real
            lams.append(lam_r.to(cdtype))
            ls.append(l_r.to(cdtype))
            rs.append(r_r.to(cdtype))
            cur = _deflated_stage(_wielandt_deflate_mv,
                                  _wielandt_deflate_rmv,
                                  (lam_r, l_r, r_r, cur), op, dev)
        stage += 1
    return (torch.stack(lams), torch.stack(ls, dim=-1),
            torch.stack(rs, dim=-1), tuple(built))


def spectrum_structure(op, m: int = 4, **kwargs) -> tuple:
    """The ``structure`` of :func:`dominant_eig_spectrum` (one discovery
    run, on the host), to pass back for a replay that derivatives can
    run through.  It depends only on the layout of real and pair slots
    in modulus order, so one discovery serves a sweep of parameters
    until a real eigenvalue collides into a pair.  Takes the keyword
    arguments of :func:`dominant_eig_spectrum`."""
    kwargs.pop("structure", None)
    return dominant_eig_spectrum(op, m, **kwargs)[3]
