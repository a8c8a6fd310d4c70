"""Polynomial spectrum slicing and the kernel polynomial method.

Counterpart of ``dominantsparseeigenad_tpu/ops/slicing.py``: every
eigenpair of a symmetric (Hermitian) operator inside an interval [a, b],
differentiable, and the stochastic Chebyshev estimators of the density
of states, ``Tr f(A)`` and ``log det A``.

1. **Bound** the spectrum by a short Lanczos run, padded outward
   (:func:`spectral_bounds`).
2. **Filter**: ``p(A)``, the degree-m Chebyshev expansion of the
   indicator of [a, b], Jackson-damped, applied by the three-term
   recurrence.  The filtered operator's ``matmat`` runs the recurrence
   on the whole (N, r) block through ``op.matmat``, so each step is one
   block product (one SpMM on a ``BellOperator``), what JAX's ``vmap``
   of its per-vector filter gives.
3. **Extract**: the slice's eigenvectors are ``p(A)``'s top ones, found
   by ``lobpcg_eigh(extreme="max")`` on the filtered operator.
4. **Rayleigh-Ritz on A** in that subspace: exact eigenvalues of A,
   ascending, pivot-gauged, with the report :class:`SliceInfo`.

Derivatives (:class:`_SpectralSlice`): the block IFT rule of
``dominant_eigh_multi`` (``eigh.py::_block_tangents`` and its transpose),
with the out-of-block deflated systems, indefinite for interior
eigenvalues, solved by one batched MINRES over the r columns (one block
product an iteration).  The KPM estimators are a fixed composition of
block products and differentiate by plain autograd, as in JAX.

Where JAX takes a ``key``, the functions here take a ``generator``; the
private :func:`_chebyshev_moments` takes the probe block itself.

Over sharded vectors (``operators.vector_layout``) every vector and block
is the rank's rows: the filtered operator carries the layout into
LOBPCG, the Rayleigh-Ritz matrix, the residual norms and the pivot are
the whole block's, the probes are the whole Rademacher draw narrowed to
the rank's rows, and the moments are summed over the ranks (``N`` stays
the whole dimension).  The enclosure and the mapped operator's centre
and half-width are replicated, marked where they enter the rank's rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .cg import solve_deflated
from .eigh import _block_cotangent, _block_tangents, dominant_eigh
from .lanczos import _tridiagonal, lanczos
from .lobpcg import lobpcg_eigh
from .operators import (_BlockMatrixFreeOperator, _product, as_operator,
                        check_device, hmatmul, layout_bcast, layout_norm,
                        layout_sum, nestable_jvp, partial_vjp, per_lane_vmap,
                        pivot_gauge, real_dtype, rebind, tol_floor,
                        vector_layout)


class SliceInfo(NamedTuple):
    """Report of a :func:`spectral_slice` solve (tensors with zero
    tangents and no gradient).

    n_inside  : how many of the r returned pairs lie inside [a, b]
    residual  : max true relative residual over the inside pairs only
                (the outside slots are the block's buffer)
    residuals : (r,) per-pair ``||A v_i - lam_i v_i|| / max(|lam_i|, 1)``
    converged : 1.0 if there is at least one inside pair and every inside
                pair meets ``tol`` (an empty slice is a failure)
    """

    n_inside: torch.Tensor
    residual: torch.Tensor
    residuals: torch.Tensor
    converged: torch.Tensor


def spectral_bounds(op, k: int = 30, *, v0: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    margin: float = 0.1, device=None):
    """Safe enclosure ``(lo, hi)`` of the spectrum from a short Lanczos
    run (one reorthogonalization pass): the extremal Ritz values padded
    by ``margin * spread`` plus the last Lanczos β and eps (too wide is
    safe for a filter, too narrow is not).  ``v0`` is the start vector,
    drawn from ``generator`` (seeded 1 on the device when None) if not
    given (the rank's rows of it over sharded vectors)."""
    op = as_operator(op)
    dev = check_device(device, op)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(1)
    res = lanczos(op, min(int(k), op.dim), v0=v0, generator=generator,
                  reorth_passes=1, device=dev)
    evals = torch.linalg.eigvalsh(_tridiagonal(res.alphas, res.betas))
    lo, hi = evals[0], evals[-1]
    beta_last = (res.betas[-1].abs() if res.betas.shape[0]
                 else res.alphas[0].abs() * 0)
    pad = margin * (hi - lo) + beta_last + torch.finfo(evals.dtype).eps
    return lo - pad, hi + pad


def _jackson_damping(degree: int, dtype, device=None):
    """Jackson damping factors g_0..g_degree, shared by the slice filter
    and the KPM estimators."""
    m = degree + 1
    arg = math.pi / m
    j = torch.arange(0, degree + 1, dtype=dtype, device=device)
    return ((m - j) * torch.cos(j * arg)
            + torch.sin(j * arg) / math.tan(arg)) / m


def _jackson_indicator_coeffs(a_hat, b_hat, degree: int):
    """Jackson-damped Chebyshev coefficients of the indicator of
    [a_hat, b_hat] ⊂ [-1, 1] (tensors): c_0 = (θa − θb)/π,
    c_j = 2(sin j·θa − sin j·θb)/(π j), θ = arccos."""
    theta_a = torch.arccos(torch.clamp(a_hat, -1.0, 1.0))
    theta_b = torch.arccos(torch.clamp(b_hat, -1.0, 1.0))
    j = torch.arange(1, degree + 1, dtype=theta_a.dtype,
                     device=theta_a.device)
    c0 = (theta_a - theta_b) / math.pi
    cj = 2.0 * (torch.sin(j * theta_a) - torch.sin(j * theta_b)) \
        / (math.pi * j)
    g = _jackson_damping(degree, theta_a.dtype, theta_a.device)
    return torch.cat([c0[None], cj]) * g


def _filtered_matvec(params, x):
    """``p(A) x`` by the Chebyshev three-term recurrence on
    ``Ã = (A - c I) / h`` (the JAX ``_filtered_matvec``), for ``x`` of
    shape (N,) or (N, m): a block runs as one block product a step."""
    op, lo, hi, coeffs = (params["op"], params["lo"], params["hi"],
                          params["coeffs"])
    layout = vector_layout(op)
    center = layout_bcast(layout, (hi + lo) / 2.0)
    halfwidth = layout_bcast(layout, (hi - lo) / 2.0)
    coeffs = layout_bcast(layout, coeffs)

    def amap(v):
        return (_product(op, v) - center * v) / halfwidth

    t_prev, t_cur = x, amap(x)
    acc = coeffs[0] * t_prev + coeffs[1] * t_cur
    for jj in range(2, coeffs.shape[0]):
        t_prev, t_cur = t_cur, 2.0 * amap(t_cur) - t_prev
        acc = acc + coeffs[jj] * t_cur
    return acc


def _filtered_operator(op, lo, hi, a, b, degree):
    """``p(A)`` for the slice [a, b] on the enclosure [lo, hi], a
    :class:`_BlockMatrixFreeOperator` (its ``matmat`` one recurrence on
    the block)."""
    center = (hi + lo) / 2.0
    halfwidth = (hi - lo) / 2.0
    coeffs = _jackson_indicator_coeffs((a - center) / halfwidth,
                                       (b - center) / halfwidth, degree)
    fop = _BlockMatrixFreeOperator(
        _filtered_matvec,
        {"op": op, "lo": lo, "hi": hi, "coeffs": coeffs.to(op.dtype)},
        dim=op.dim, dtype=op.dtype)
    # p(A) acts row by row on the rank's rows, as A does.
    fop.vector_layout = vector_layout(op)
    return fop


@dataclasses.dataclass(frozen=True)
class SliceOptions:
    """Configuration of :func:`spectral_slice`."""

    r: int = 8
    degree: int = 80
    maxiter: int = 150
    tol: float = 1e-8
    solve_tol: float = 1e-8
    solve_maxiter: int | None = None
    seed: int = 0
    bounds_k: int = 30
    gap_eps: float = 1e-12
    # An SPD approximate inverse for the derivative solves only (the
    # LOBPCG forward runs on the filtered operator, whose spectrum an
    # A-based preconditioner does not approximate).
    solve_precond: object = None


def _slice_forward(op, a, b, opts, generator):
    dev = op.device
    rdt = real_dtype(op.dtype)
    lo, hi = spectral_bounds(op, opts.bounds_k, generator=generator,
                             device=dev)
    a_t = torch.tensor(a, dtype=rdt, device=dev)
    b_t = torch.tensor(b, dtype=rdt, device=dev)
    fop = _filtered_operator(op, lo, hi, a_t, b_t, opts.degree)
    # Top-r eigenvectors of p(A) span the slice (filter ~1 inside, ~0
    # outside); the filter plateau is quasi-degenerate, so ``maxiter`` is
    # the practical control, and the true A-residuals below are what to
    # trust.
    _, v = lobpcg_eigh(fop, opts.r, extreme="max", maxiter=opts.maxiter,
                       tol=opts.tol, generator=generator, device=dev)
    # Rayleigh-Ritz on A in span(v): exact eigenvalues, ascending.
    layout = vector_layout(op)
    av = op.matmat(v)
    bmat = layout_sum(layout, hmatmul(v.mH, av))
    theta, y = torch.linalg.eigh(0.5 * (bmat + bmat.mH))
    v, av = pivot_gauge(hmatmul(v, y), hmatmul(av, y), layout=layout)
    lams = theta.to(rdt)
    resids = layout_norm(layout, av - v * lams[None, :], dim=0).to(rdt)
    resids = resids / torch.clamp(lams.abs(), min=1.0)
    inside = (lams >= a_t) & (lams <= b_t)
    n_inside = inside.sum().to(rdt)
    resid_in = torch.where(inside, resids, torch.zeros_like(resids)).max()
    # An empty slice does not report success.
    ok = (n_inside > 0) & (resid_in <= tol_floor(opts.tol, op.dtype))
    return lams, v, n_inside, resid_in, resids, ok.to(rdt)


@per_lane_vmap
class _SpectralSlice(torch.autograd.Function):
    """Outputs ``(λ (r,), V (N, r))`` and the four :class:`SliceInfo`
    fields (no gradient, zero tangents)."""

    @staticmethod
    def forward(op, a, b, opts, generator, *params):
        return _slice_forward(rebind(op, params), a, b, opts, generator)

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, _, _, opts, _, *params = inputs
        ctx.op, ctx.opts = op, opts
        ctx.save_for_backward(*output[:2], *params)
        ctx.save_for_forward(*output[:2], *params)
        ctx.mark_non_differentiable(*output[2:])
        ctx.set_materialize_grads(False)

    @staticmethod
    def _saved(ctx):
        lams, v, *params = ctx.saved_tensors
        op = rebind(ctx.op, params)
        opts = ctx.opts

        def solve(rhs):
            # One batched MINRES over the r columns, one shift each.
            return solve_deflated(op, lams, v, rhs, method="minres",
                                  tol=opts.solve_tol,
                                  maxiter=opts.solve_maxiter,
                                  precond=opts.solve_precond,
                                  device=op.device)
        return op, lams, v, solve

    @staticmethod
    @nestable_jvp
    def jvp(ctx, _op, _a, _b, _opts, _generator, *dparams):
        """The JAX ``_spectral_slice_jvp``: in-block rotations by the
        broadened gap inverses, the out-of-block part by one batched
        deflated MINRES, the pivot-phase projection."""
        op, lams, v, solve = _SpectralSlice._saved(ctx)
        info = (None,) * 4
        if all(t is None for t in dparams):
            return (torch.zeros_like(lams), torch.zeros_like(v), *info)
        return (*_block_tangents(op, lams, v, dparams, ctx.opts, solve),
                *info)

    @staticmethod
    def backward(ctx, lams_bar, v_bar, *info_bar):
        op, lams, v, solve = _SpectralSlice._saved(ctx)
        if lams_bar is None and v_bar is None:
            return (None,) * (5 + len(op.parameters()))
        u = _block_cotangent(lams, v, lams_bar, v_bar, ctx.opts, solve,
                             vector_layout(op))
        grads = partial_vjp(op, lambda held: held.matmat(v), [], u,
                            ctx.needs_input_grad[5:])
        return (None,) * 5 + tuple(grads)


def spectral_slice(op, a: float, b: float, r: int = 8, *,
                   degree: int = 80, maxiter: int = 150,
                   tol: float = 1e-8, solve_tol: float | None = None,
                   solve_maxiter: int | None = None, seed: int = 0,
                   bounds_k: int = 30, gap_eps: float = 1e-12,
                   solve_precond=None,
                   generator: torch.Generator | None = None, device=None):
    """The ``r`` eigenpairs of a symmetric operator nearest / inside
    ``[a, b]``, differentiable to any order in ``op.parameters()``, in
    either mode and under ``torch.func``.

    r       : block size; choose r >= the expected count in [a, b]
              (``info.n_inside == r`` says the slice may hold more).
    degree  : Chebyshev filter degree (block products per filtered apply).
    maxiter : LOBPCG iteration cap on the filtered operator.
    tol     : the true A-residual target (reported in ``info``; floored
              at 50 eps).
    solve_tol / solve_maxiter : the derivative rules' batched deflated
              MINRES (``solve_tol`` defaults to ``tol``).
    solve_precond : an SPD approximate inverse for those solves, e.g.
              ``jacobi_precond(op, shift=0.5 * (a + b))``.
    bounds_k : Lanczos steps of the spectral enclosure.
    generator : draws the enclosure's Lanczos start vector, then the
              LOBPCG start block (seeded ``seed`` on the device when
              None).
    device  : where the solve runs (CUDA when None).

    Returns ``(lams, V, info)``: ``lams`` (r,) ascending, ``V`` (N, r)
    orthonormal and pivot-gauged, ``info`` a :class:`SliceInfo`.  The
    slice edges belong in spectral gaps: an edge through a multiplet
    leaves the subspace ill-defined.
    """
    op = as_operator(op)
    a, b = float(a), float(b)
    if not a < b:
        raise ValueError(f"need a < b, got [{a}, {b}]")
    r = int(r)
    if op.dim < 3 * r:
        raise ValueError(f"spectral_slice needs dim >= 3*r (LOBPCG "
                         f"subspace); got dim={op.dim}, r={r}")
    if int(degree) < 2:
        raise ValueError(f"filter degree must be >= 2, got {degree} "
                         f"(the recurrence reads T_0, T_1 and at least "
                         f"one higher moment)")
    dev = check_device(device, op)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    opts = SliceOptions(
        r=r, degree=int(degree), maxiter=int(maxiter), tol=float(tol),
        solve_tol=float(tol if solve_tol is None else solve_tol),
        solve_maxiter=None if solve_maxiter is None else int(solve_maxiter),
        seed=int(seed), bounds_k=int(bounds_k), gap_eps=float(gap_eps),
        solve_precond=solve_precond)
    out = _SpectralSlice.apply(op, a, b, opts, generator, *op.parameters())
    return out[0], out[1], SliceInfo(*out[2:])


def _chebyshev_moments(op, degree: int, z, lo, hi):
    """Hutchinson estimates ``mu_j = (1/N) Tr T_j(Ã)``, j = 0..degree, of
    the operator mapped from ``[lo, hi]`` onto [-1, 1], from the probe
    block ``z`` (N, s): one three-term recurrence over the block, one
    block product a step.  Returns ``(mus, center, halfwidth)``.  Over
    sharded vectors ``z`` is the rank's rows and the moments are summed
    over the ranks."""
    dtype = op.dtype
    layout = vector_layout(op)
    center = (hi + lo) / 2.0
    halfwidth = (hi - lo) / 2.0
    c_rows = layout_bcast(layout, center.to(dtype))
    h_rows = layout_bcast(layout, halfwidth.to(dtype))

    def amap(v):
        return (op.matmat(v) - c_rows * v) / h_rows

    scale = op.dim * z.shape[1]

    def moment(t):  # (1/(N*s)) sum_z z^H T_j(Ã) z
        return (z.conj() * t).sum().real / scale

    t_prev, t_cur = z, amap(z)
    mus = [moment(t_prev), moment(t_cur)]
    for _ in range(int(degree) - 1):
        t_prev, t_cur = t_cur, 2.0 * amap(t_cur) - t_prev
        mus.append(moment(t_cur))
    # One sum over the ranks for all the moments.
    mus = layout_sum(layout, torch.stack(mus))
    return mus.to(real_dtype(dtype)), center, halfwidth


def _moments(op, degree, n_probe, generator, bounds, bounds_k, device):
    """:func:`_chebyshev_moments` with the enclosure from ``bounds`` (or
    :func:`spectral_bounds`) and ``n_probe`` Rademacher probes, both drawn
    from ``generator`` (seeded 7 on the device when None), the enclosure
    first."""
    op = as_operator(op)
    dev = check_device(device, op)
    rdt = real_dtype(op.dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(7)
    if bounds is None:
        lo, hi = spectral_bounds(op, bounds_k, generator=generator,
                                 device=dev)
    else:
        lo, hi = (torch.as_tensor(t, dtype=rdt, device=dev) for t in bounds)
    z = _rademacher((op.dim, int(n_probe)), generator, rdt, dev)
    layout = vector_layout(op)
    if layout is not None:
        # The whole draw, narrowed: the probes an unsharded run takes.
        z = layout.rows(z).clone()
    return _chebyshev_moments(op, degree, z.to(op.dtype), lo, hi)


def _rademacher(shape, generator, dtype, device):
    """A block of independent ±1 entries drawn from ``generator``."""
    return torch.randint(0, 2, shape, generator=generator,
                         device=device).to(dtype) * 2.0 - 1.0


def spectral_density(op, energies, *, degree: int = 120, n_probe: int = 16,
                     generator: torch.Generator | None = None, bounds=None,
                     bounds_k: int = 30, device=None):
    """Smoothed density of states by the kernel polynomial method:
    Rademacher-probe Chebyshev moments of the mapped operator,
    Jackson-damped and summed against the Chebyshev kernel at
    ``energies`` (m,); normalized so that its integral is ~1.

    Differentiable by plain autograd in ``op.parameters()`` (a fixed
    composition of block products).  ``bounds`` is an optional (lo, hi)
    enclosure, else :func:`spectral_bounds` with ``bounds_k`` steps;
    ``generator`` draws the enclosure's start vector and the probes
    (seeded 7 on the device when None).
    """
    op = as_operator(op)
    mus, center, halfwidth = _moments(op, int(degree), n_probe, generator,
                                      bounds, int(bounds_k), device)
    rdt = mus.dtype
    j = torch.arange(int(degree) + 1, dtype=rdt, device=mus.device)
    g = _jackson_damping(int(degree), rdt, mus.device)
    e_hat = torch.clamp((torch.as_tensor(energies, dtype=rdt).to(mus.device)
                         - center) / halfwidth, -1.0 + 1e-7, 1.0 - 1e-7)
    tj = torch.cos(torch.arccos(e_hat)[None, :] * j[:, None])
    weights = torch.where(j == 0, 1.0, 2.0) * g * mus
    rho_hat = (weights[None, :] @ tj)[0] / (math.pi
                                            * torch.sqrt(1 - e_hat ** 2))
    return rho_hat / halfwidth


def trace_function(op, f, *, degree: int = 120, n_probe: int = 16,
                   generator: torch.Generator | None = None, bounds=None,
                   bounds_k: int = 30, jackson: bool = True, device=None):
    """Stochastic Chebyshev estimate of ``Tr f(A)``: ``N sum_j g_j c_j
    mu_j`` with the probe moments of :func:`spectral_density` and ``c_j``
    the Chebyshev interpolation coefficients of ``f`` (a tensor function,
    e.g. ``torch.exp``) at the nodes of the enclosure, by a DCT; ``f``
    is evaluated only there.  ``jackson=False`` drops the damping (for an
    analytic ``f``).  Differentiable by plain autograd in the operator's
    parameters and in whatever ``f`` closes over."""
    op = as_operator(op)
    degree = int(degree)
    mus, center, halfwidth = _moments(op, degree, n_probe, generator,
                                      bounds, int(bounds_k), device)
    rdt = mus.dtype
    m = degree + 1
    j = torch.arange(m, dtype=rdt, device=mus.device)
    theta_k = math.pi * (j + 0.5) / m
    f_k = f(center + halfwidth * torch.cos(theta_k)).to(rdt)
    cos_tbl = torch.cos(j[:, None] * theta_k[None, :])
    c = (2.0 / m) * (cos_tbl @ f_k)
    c = c * torch.where(j == 0, 0.5, 1.0)
    g = _jackson_damping(degree, rdt, mus.device) if jackson else 1.0
    return op.dim * torch.sum(g * c * mus)


def logdet(op, *, degree: int = 160, n_probe: int = 16,
           generator: torch.Generator | None = None, bounds=None,
           bounds_k: int = 30, device=None):
    """Stochastic ``log det A`` of a symmetric positive definite operator,
    ``Tr ln(A)`` by :func:`trace_function` (no damping).  Without
    ``bounds`` the enclosure is tight: both extremal eigenvalues by
    ``dominant_eigh`` (k = 2 ``bounds_k``), widened by their certified
    Ritz residuals and a 1% margin, the bottom floored at 10 eps |hi|.
    The error is then the Hutchinson noise, ~``||ln A||_F sqrt(2 /
    n_probe)`` absolute."""
    op = as_operator(op)
    dev = check_device(device, op)
    rdt = real_dtype(op.dtype)
    if bounds is None:
        k = min(2 * int(bounds_k), op.dim)
        lmin, _, i_lo = dominant_eigh(op, k=k, extreme="min",
                                      with_info=True, device=dev)
        lmax, _, i_hi = dominant_eigh(op, k=k, extreme="max",
                                      with_info=True, device=dev)
        pad_lo = i_lo.residual * torch.clamp(lmin.abs(), min=1.0)
        pad_hi = i_hi.residual * torch.clamp(lmax.abs(), min=1.0)
        lo = lmin - pad_lo - 1e-2 * lmin.abs()
        hi = lmax + pad_hi + 1e-2 * lmax.abs()
        floor = torch.finfo(rdt).eps * hi.abs() * 10.0
        bounds = (torch.maximum(lo, floor), hi)
    return trace_function(op, torch.log, degree=degree, n_probe=n_probe,
                          generator=generator, bounds=bounds,
                          bounds_k=bounds_k, jackson=False, device=dev)
