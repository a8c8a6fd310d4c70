"""Differentiable generalized symmetric-definite eigensolver,
``A x = lam B x`` with Hermitian ``A`` and Hermitian positive definite
``B`` (overlap and mass-matrix problems).

Counterpart of ``dominantsparseeigenad_tpu/ops/gen.py``.  The forward is
:func:`~.lobpcg.lobpcg_eigh_general` (B-metric LOBPCG, one ``A`` and one
``B`` block product per iteration, optionally preconditioned); the
derivatives come from the implicit-function theorem on the pencil, to any
order in the parameters of both operators.  For a B-orthonormal block
``V`` (``V^H B V = I``), with ``K = dA V - dB V Λ`` (column i:
``(dA - λ_i dB) v_i``) and ``M = V^H K``:

    dλ_i = Re M_ii,
    dV   = V C + W,   C = F ∘ M - ½ diag(V^H dB V)   (the gauge v^H B v = 1),
    (A - λ_i B) w_i = -(I - B V V^H) K_i   on the B-orthogonal complement
                                           of span(V),

``F[j, i] = g / (g² + gap_eps²)``, ``g = λ_i - λ_j``, ``F[i, i] = 0``,
then the pivot-phase projection of each column (complex dtypes).  That is
the ``jvp`` of :class:`_DominantEighGen`; its ``backward`` is the
transpose written out: for cotangents (λ̄, V̄), ``W = V^H V̄``,

    U = V (diag(λ̄) + F ∘ W) + X,   X[:, i] = pencil solve of -V̄[:, i],
    Z = -U Λ - ½ V diag(Re W_ii),

and the gradients are ``autograd.grad`` of one ``A(θ) V`` with output
cotangent U and of one ``B(φ) V`` with Z.  The out-of-block solves are
:func:`solve_deflated_pencil`, one batched CG over the r columns, whose
own Function (:class:`_DeflatedPencilSolve`, the JAX package's
``custom_linear_solve``) differentiates by one more pencil solve, so no
derivative is ever taken through the LOBPCG or CG iterations.
"""

from __future__ import annotations

import dataclasses

import torch

from .cg import _cg_columns_loop, _cg_loop, _shifts
from .eigh import _gap_inverses, _pivot_phase_cotangent, _pivot_phase_project
from .lanczos import LanczosInfo
from .lobpcg import lobpcg_eigh_general
from .operators import (_add, _per_lane, _tangent_product, as_operator,
                        check_device, hmatmul, nestable_jvp, partial_vjp,
                        per_lane_vmap, rebind)
from .precond import _apply_columns


class _Pencil:
    """The operators (A, B) as one object for the Functions' rules: its
    parameters are A's, then B's (``rebind`` and ``partial_vjp`` rebuild
    both)."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def parameters(self) -> list:
        return [*self.a.parameters(), *self.b.parameters()]

    def with_parameters(self, tensors):
        na = len(self.a.parameters())
        return _Pencil(rebind(self.a, tensors[:na]),
                       rebind(self.b, tensors[na:]))

    def split(self, items):
        """``items`` (one per parameter) as (A's, B's)."""
        na = len(self.a.parameters())
        return items[:na], items[na:]


def _proj_r(V, BV, x):
    """``x - V (B V)^H x``: onto the B-orthogonal complement of span(V)."""
    return x - hmatmul(V, hmatmul(BV.mH, x))


def _proj_l(V, BV, y):
    """``y - B V V^H y``, the adjoint of :func:`_proj_r`."""
    return y - hmatmul(BV, hmatmul(V.mH, y))


def _shifted(pencil, y, lam):
    """``A y - lam B y``: one shift for an (N,) ``y``, one per column for
    an (N, m) block (one block product of each operator)."""
    if y.ndim == 2:
        return pencil.a.matmat(y) - pencil.b.matmat(y) * lam[None, :]
    return pencil.a.matvec(y) - lam * pencil.b.matvec(y)


def _pencil_mv(pencil, lam, V, BV, sign):
    """``x -> sign P_L (A - lam B) P_R x``."""
    return lambda x: sign * _proj_l(V, BV, _shifted(pencil, _proj_r(V, BV, x),
                                                    lam))


def _pencil_solve(pencil, lam, V, BV, rhs, sign, tol, maxiter, precond):
    """``P_R cg(M, P_L rhs)``, the solver the JAX package hands to its
    linear solve; the preconditioner is applied as ``P_R M^{-1}``, column
    by column for an (N, m) ``rhs``."""
    batched = rhs.ndim == 2
    loop = _cg_columns_loop if batched else _cg_loop
    args = (_pencil_mv(pencil, lam, V, BV, sign), _proj_l(V, BV, rhs), tol,
            maxiter)
    if precond is None:
        x, _ = loop(*args)
    else:
        apply = _apply_columns(precond) if batched else precond
        x, _ = loop(*args, precond=lambda r: _proj_r(V, BV, apply(r)))
    return _proj_r(V, BV, x)


def _scaled(y, lam):
    return y * lam[None, :] if y.ndim == 2 else lam * y


def _pencil_mv_tangent(pencil, lam, V, BV, sign, x, dlam, dV, dBV, dparams):
    """The tangent of ``x -> sign P_L (A - λB) P_R x`` at a fixed ``x``
    along ``(dλ, dV, dBV, dθ)``, or None when nothing moves:

        y = P_R x,  dy = -(dV BV^H x + V dBV^H x),
        u = A y - λ B y,
        du = dA y + A dy - dλ B y - λ (dB y + B dy),
        Ṁ x = sign (P_L du - dBV V^H u - BV dV^H u)."""
    da, db = pencil.split(dparams)
    y = _proj_r(V, BV, x)
    dy = None
    if dV is not None:
        dy = -hmatmul(dV, hmatmul(BV.mH, x))
    if dBV is not None:
        dy = _add(dy, -hmatmul(V, hmatmul(dBV.mH, x)))
    du = _tangent_product(pencil.a, y, da)
    dby = _tangent_product(pencil.b, y, db)
    if dby is not None:
        du = _add(du, -_scaled(dby, lam))
    if dlam is not None:
        by = pencil.b.matmat(y) if y.ndim == 2 else pencil.b.matvec(y)
        du = _add(du, -_scaled(by, dlam))
    if dy is not None:
        du = _add(du, _shifted(pencil, dy, lam))
    out = None if du is None else _proj_l(V, BV, du)
    if dV is not None or dBV is not None:
        u = _shifted(pencil, y, lam)
        if dBV is not None:
            out = _add(out, -hmatmul(dBV, hmatmul(V.mH, u)))
        if dV is not None:
            out = _add(out, -hmatmul(BV, hmatmul(dV.mH, u)))
    return None if out is None else sign * out


class _DeflatedPencilSolve(torch.autograd.Function):
    """``x = M^+ rhs`` for ``M = sign P_L (A(θ) - λ B(φ)) P_R``, Hermitian
    (``P_L = P_R^H``), differentiable in ``rhs``, λ, V, BV and both
    operators' parameters by the rule of ``_DeflatedSolve`` (``cg.py``):

        w = M^+ x̄,   rhs̄ = w,   (λ̄, V̄, BV̄, θ̄, φ̄) = -∂/∂(...) <w, M x>,

    the last with x held constant; forward mode ``ẋ = M^+ (rhs̊ - Ṁ x)``.
    Both rules are one more solve of this Function plus differentiable
    products, so they differentiate again, to any order.  Under
    ``torch.func.vmap`` a batch of right-hand sides and shifts over a
    shared pencil, V and BV is one batched CG over the columns (the
    vmapped solve of the JAX package's tangent rule); anything else goes
    lane by lane."""

    @staticmethod
    def forward(pencil, sign, tol, maxiter, precond, rhs, lam, V, BV,
                *params):
        return _pencil_solve(rebind(pencil, params), lam, V, BV, rhs, sign,
                             tol, maxiter, precond)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pencil, sign, tol, maxiter, precond, rhs, lam, V, BV, *params = \
            inputs
        ctx.pencil, ctx.cfg = pencil, (sign, tol, maxiter, precond)
        ctx.save_for_backward(output, lam, V, BV, *params)
        ctx.save_for_forward(output, lam, V, BV, *params)

    @staticmethod
    @nestable_jvp
    def jvp(ctx, _pencil, _sign, _tol, _maxiter, _precond, drhs, dlam, dV,
            dBV, *dparams):
        x, lam, V, BV, *params = ctx.saved_tensors
        pencil = rebind(ctx.pencil, params)
        mdot = _pencil_mv_tangent(pencil, lam, V, BV, ctx.cfg[0], x, dlam,
                                  dV, dBV, dparams)
        b = drhs if mdot is None else \
            -mdot if drhs is None else drhs - mdot
        if b is None:
            return torch.zeros_like(x)
        return _DeflatedPencilSolve.apply(ctx.pencil, *ctx.cfg, b, lam, V,
                                          BV, *params)

    @staticmethod
    def backward(ctx, x_bar):
        sign = ctx.cfg[0]
        x, lam, V, BV, *params = ctx.saved_tensors
        pencil = rebind(ctx.pencil, params)
        w = _DeflatedPencilSolve.apply(ctx.pencil, *ctx.cfg, x_bar, lam, V,
                                       BV, *params)
        grads = partial_vjp(
            pencil, lambda held, lam_, V_, BV_: _pencil_mv(
                held, lam_, V_, BV_, sign)(x),
            [lam, V, BV], -w, ctx.needs_input_grad[6:])
        rhs_bar = w if ctx.needs_input_grad[5] else None
        return (None,) * 5 + (rhs_bar, *grads)

    @staticmethod
    def vmap(info, in_dims, pencil, sign, tol, maxiter, precond, rhs, lam,
             V, BV, *params):
        rhs_dim, lam_dim = in_dims[5:7]
        args = (pencil, sign, tol, maxiter, precond, rhs, lam, V, BV,
                *params)
        if any(d is not None for d in in_dims[7:]):
            return _per_lane(_DeflatedPencilSolve, info, in_dims, args)
        # The lanes become columns: rhs (N[, m]) -> (N, [m *] B), one
        # shift per column.
        nb = info.batch_size
        rhs = rhs.unsqueeze(-1).expand(*rhs.shape, nb) if rhs_dim is None \
            else rhs.movedim(rhs_dim, -1)
        lam = lam.unsqueeze(-1).expand(*lam.shape, nb) if lam_dim is None \
            else lam.movedim(lam_dim, -1)
        cols = rhs.reshape(rhs.shape[0], -1).contiguous()
        x = _DeflatedPencilSolve.apply(pencil, sign, tol, maxiter, precond,
                                       cols, lam.reshape(-1), V, BV,
                                       *params)
        return x.reshape(rhs.shape), rhs.ndim - 1


def solve_deflated_pencil(a, b, lam, v, bv, rhs, *,
                          definite_sign: float = 1.0, tol: float = 1e-8,
                          maxiter: int | None = None, precond=None,
                          device=None) -> torch.Tensor:
    """Differentiable solve of the B-deflated pencil system

        P_L (A - lam B) P_R x = P_L rhs,
        P_R = I - V (B V)^H,   P_L = P_R^H = I - (B V) V^H,

    returning the solution with ``(B V)^H x = 0``.  ``v`` is an (N, r)
    B-orthonormal block (or one (N,) vector) and ``bv`` its image ``B v``.
    ``rhs`` is (N,) with a scalar ``lam``, or (N, m) with one shift per
    column in ``lam`` (m,), solved by one batched CG.  The projected
    operator is Hermitian, and positive definite after ``definite_sign``
    (+1 when ``lam`` is the algebraically smallest pencil eigenvalue, -1
    the largest), so CG applies.  ``precond`` is an SPD approximate
    inverse in the vector convention, used as ``P_R M^{-1}``.
    Differentiable in ``rhs``, ``lam``, ``v``, ``bv`` and the parameters
    of both operators, to any order in either mode, with no derivative
    taken through the CG iterations.
    """
    a, b = as_operator(a), as_operator(b)
    check_device(device, a, b, v, bv, rhs)
    V = v[:, None] if v.ndim == 1 else v
    BV = bv[:, None] if bv.ndim == 1 else bv
    sign = float(definite_sign)
    lam = _shifts(lam, rhs)
    pencil = _Pencil(a, b)
    x = _DeflatedPencilSolve.apply(pencil, sign, tol, maxiter, precond,
                                   sign * _proj_l(V, BV, rhs), lam, V, BV,
                                   *pencil.parameters())
    return _proj_r(V, BV, x)


@dataclasses.dataclass(frozen=True)
class EighGenOptions:
    """Configuration of :func:`dominant_eigh_gen`."""

    r: int = 4
    extreme: str = "min"
    maxiter: int = 200
    tol: float = 1e-8
    solve_tol: float = 1e-8
    solve_maxiter: int | None = None
    gap_eps: float = 1e-12
    # An SPD approximate inverse of A - σB (vector convention): the
    # LOBPCG forward's, column by column, and the pencil solves'.
    precond: object = None
    with_info: bool = False


@per_lane_vmap
class _DominantEighGen(torch.autograd.Function):
    """Outputs ``(λ (r,), V (N, r))``, then the three
    :class:`~.lanczos.LanczosInfo` fields with ``with_info``."""

    @staticmethod
    def forward(pencil, opts, x0, generator, *params):
        pencil = rebind(pencil, params)
        precond = None if opts.precond is None \
            else _apply_columns(opts.precond)
        out = lobpcg_eigh_general(
            pencil.a, pencil.b, opts.r, extreme=opts.extreme,
            maxiter=opts.maxiter, tol=opts.tol, x0=x0, generator=generator,
            precond=precond, with_info=opts.with_info,
            device=pencil.a.device)
        return tuple(out[:2]) + tuple(out[2] if opts.with_info else ())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pencil, opts, _, _, *params = inputs
        ctx.pencil, ctx.opts = pencil, opts
        ctx.n_info = 3 if opts.with_info else 0
        ctx.save_for_backward(*output[:2], *params)
        ctx.save_for_forward(*output[:2], *params)
        ctx.mark_non_differentiable(*output[2:])
        ctx.set_materialize_grads(False)

    @staticmethod
    def _saved(ctx):
        lams, v, *params = ctx.saved_tensors
        return rebind(ctx.pencil, params), lams, v

    @staticmethod
    def _solve(pencil, opts, lams, v, rhs):
        """The out-of-block pencil solves, one per column of ``rhs``."""
        return solve_deflated_pencil(
            pencil.a, pencil.b, lams, v, pencil.b.matmat(v), rhs,
            definite_sign=1.0 if opts.extreme == "min" else -1.0,
            tol=opts.solve_tol, maxiter=opts.solve_maxiter,
            precond=opts.precond, device=v.device)

    @staticmethod
    @nestable_jvp
    def jvp(ctx, _pencil, _opts, _x0, _generator, *dparams):
        """The pencil's block IFT tangents (the JAX package's
        ``_gen_tangents``, module docstring): one tangent product of each
        operator and one batched pencil solve."""
        opts = ctx.opts
        pencil, lams, v = _DominantEighGen._saved(ctx)
        info = (None,) * ctx.n_info
        if all(t is None for t in dparams):
            return (torch.zeros_like(lams), torch.zeros_like(v), *info)
        da, db = pencil.split(dparams)
        dav = _tangent_product(pencil.a, v, da)
        dbv = _tangent_product(pencil.b, v, db)
        k = dav
        if dbv is not None:
            k = _add(k, -dbv * lams[None, :].to(v.dtype))
        m = hmatmul(v.mH, k)
        dlams = torch.diagonal(m).real.clone()
        c = _gap_inverses(lams, opts).to(m.dtype) * m
        if dbv is not None:
            # The B-normalization gauge v^H B v = 1.
            c = c - 0.5 * torch.diag(torch.diagonal(hmatmul(v.mH, dbv)))
        dv = hmatmul(v, c) + _DominantEighGen._solve(pencil, opts, lams, v,
                                                     -k)
        return (dlams, _pivot_phase_project(v, dv), *info)

    @staticmethod
    def backward(ctx, lams_bar, v_bar, *info_bar):
        opts = ctx.opts
        pencil, lams, v = _DominantEighGen._saved(ctx)
        if lams_bar is None and v_bar is None:
            return (None,) * (4 + len(pencil.parameters()))
        g = torch.zeros((opts.r, opts.r), dtype=v.dtype, device=v.device) \
            if lams_bar is None else torch.diag(lams_bar).to(v.dtype)
        z = None
        if v_bar is not None:
            v_bar = _pivot_phase_cotangent(v, v_bar)
            w = hmatmul(v.mH, v_bar)
            g = g + _gap_inverses(lams, opts).to(v.dtype) * w
            # The gauge term's transpose: -½ Re W_ii v_i into B's.
            z = -0.5 * v * torch.diagonal(w).real[None, :]
        u = hmatmul(v, g)
        if v_bar is not None:
            u = u + _DominantEighGen._solve(pencil, opts, lams, v, -v_bar)
        z = _add(z, -u * lams[None, :].to(v.dtype))
        need_a, need_b = pencil.split(ctx.needs_input_grad[4:])
        grads = partial_vjp(pencil.a, lambda held: held.matmat(v), [], u,
                            need_a)
        grads += partial_vjp(pencil.b, lambda held: held.matmat(v), [], z,
                             need_b)
        return (None, None, None, None, *grads)


def dominant_eigh_gen(a, b, r: int = 4, *, extreme: str = "min",
                      maxiter: int = 200, tol: float = 1e-8,
                      solve_tol: float | None = None,
                      solve_maxiter: int | None = None, seed: int = 0,
                      gap_eps: float = 1e-12, precond=None,
                      with_info: bool = False,
                      x0: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      device=None):
    """Top-r extremal eigenpairs of the generalized pencil ``A x = lam B
    x`` (``B`` Hermitian positive definite), differentiable to any order
    in the parameters of both operators: reverse mode (again under
    ``create_graph``), forward mode (``torch.func.jvp``, nested), and
    ``torch.func.vmap`` (lane by lane).

    maxiter : the LOBPCG iteration budget (each iteration one ``A`` and
              one ``B`` block product, and both on the conjugate
              directions); ``tol`` its residual target.
    solve_tol, solve_maxiter : the derivative rules' pencil CG (``tol``
              and 10 N iterations by default).
    precond : an approximate inverse of ``A - σB`` in the vector
              convention ``z = M^{-1} r``, used by the LOBPCG forward
              (column by column) and by the pencil solves of the rules.
    x0, generator, seed : the (N, r) start block, else drawn from
              ``generator`` (seeded ``seed`` on the device when None).
    device  : where the solve runs (CUDA when None).

    Returns ``(lams, V)`` with ``V^H B V = I``, plus a
    :class:`~.lanczos.LanczosInfo` with ``with_info`` (residual ``max_i
    ||A v_i - lam_i B v_i|| / max(|lam_i|, 1)``, effective_k the LOBPCG
    iterations run; zero tangents, no gradient).
    """
    a = as_operator(a)
    b = as_operator(b)
    if extreme not in ("min", "max"):
        raise ValueError(f"extreme must be min|max, got {extreme!r}")
    dev = check_device(device, a, b)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    opts = EighGenOptions(
        r=int(r), extreme=extreme, maxiter=int(maxiter), tol=float(tol),
        solve_tol=float(tol if solve_tol is None else solve_tol),
        solve_maxiter=None if solve_maxiter is None else int(solve_maxiter),
        gap_eps=float(gap_eps), precond=precond, with_info=bool(with_info))
    pencil = _Pencil(a, b)
    out = _DominantEighGen.apply(pencil, opts, x0, generator,
                                 *pencil.parameters())
    if with_info:
        return out[0], out[1], LanczosInfo(*out[2:])
    return out
