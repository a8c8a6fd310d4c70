"""Degeneracy-safe differentiable dense decompositions.

Counterpart of ``dominantsparseeigenad_tpu/ops/decomp.py``.  The TRG and
CTMRG flows of ``models/ising2d.py`` differentiate the free energy through
truncated decompositions of plaquette and corner matrices whose spectra
carry exact symmetry multiplets, where the textbook derivative divides by
an eigenvalue gap ``1/(λi - λj)`` (and PyTorch's own ``eigh``/``svd``
backward returns inf or NaN).  The cure is the JAX package's: a
Lorentzian broadening of every gap inverse,

    F_ij = (λj - λi) / ((λj - λi)² + ε²),   F_ii = 0,

exact for separated pairs and zero, not infinite, inside a multiplet.
Observables invariant under rotations within a multiplet (free energy,
energy, specific heat) lose nothing by it.

Each decomposition is a ``torch.autograd.Function``.  Its forward runs
``torch.linalg.eigh``, ``svd`` or ``qr`` on the detached input; its
``jvp`` is the JAX package's tangent rule (for
``torch.autograd.forward_ad`` and ``torch.func.jvp``, nested to any
order); its ``backward`` is the transpose of that rule.  Both are
written in differentiable tensor operations and the safe Functions
themselves, so that either differentiates again, in either mode
(``grad∘jacfwd`` and ``hessian`` included), degeneracy-safe to any
order, never reaching PyTorch's own derivative of a decomposition;
``vmap`` goes lane by lane:

* ``eigh_safe`` and ``svd_safe`` build their backward on the Function's
  saved outputs, so the second derivative flows back into the same rule
  (the JAX rule calls ``eigh_safe``/``svd_safe`` again);
* the truncated forms need the full basis (or the sketch window), which
  is not an output: their backward and their jvp compute it again from
  the saved input through the safe decomposition, ``eigh_safe(a)`` and
  the k-window ``svd_safe_truncated(a, k, eps, 0, power_iters)``, as the
  JAX rules do.

The truncated SVD sketches with a fixed Gaussian Ω.  JAX draws it from
``PRNGKey(0x5eed)``; here it comes from a CPU ``torch.Generator`` seeded
0x5eed, in the working dtype, moved to the device (deterministic for each
shape), unless the caller passes ``omega=``.

Complex matrices follow the JAX rules, which are Hermitian throughout:
``eigh_safe`` decomposes ``(a + a^H)/2``, every transpose of the rules
is a conjugate transpose, dw and ds are real, and the SVD rules carry
the relative phase of each (u_i, v_i) pair, ``Im<u_i, dA v_i> / σ_i``,
on du (the JAX convention).  The backwards are written for PyTorch's
gradient of a complex tensor, the conjugate of JAX's cotangent.
"""

from __future__ import annotations

import functools

import torch

from .operators import (check_device, hmatmul, nestable_jvp,
                        outside_transforms, per_lane_vmap)

_SEED = 0x5eed


def _eps_floor(eps: float, dtype) -> float:
    """Dtype-aware broadening floor: 8 machine epsilons keep ``eps⁶``, the
    smallest power the second derivative of the Lorentzian factor forms,
    above the smallest normal number in float32 (and is below the 1e-12
    default in float64, where it changes nothing)."""
    return max(float(eps), 8.0 * float(torch.finfo(dtype).eps))


def _lorentzian(gap, eps):
    """``gap / (gap² + eps²)``: the broadened gap inverse."""
    return gap / (gap * gap + eps * eps)


def _sym(a):
    """The Hermitian part ``(a + a^H)/2`` (symmetric for a real a)."""
    return (a + a.mH) / 2


def _phase_diag(p, scale):
    """``diag(i Im(p_ii) scale_i)``'s diagonal for a complex square-ish
    ``p`` (its leading r x r block, r = len(scale)), zero for a real one:
    the relative-phase term of the SVD rules."""
    if not p.is_complex():
        return None
    r = scale.shape[0]
    return 1j * torch.diagonal(p[:r, :r]).imag * scale


def _flip_top(w_full, v_full, r):
    """The r largest eigenpairs, descending, from an ascending ``eigh``."""
    return (torch.flip(w_full, (0,))[:r],
            torch.flip(v_full, (1,))[:, :r])


def _kept_mask(rows: int, r: int, diagonal, device):
    """(rows, r) boolean mask of the kept pairs' own entries: column i is
    row ``diagonal(i)``."""
    i = torch.arange(rows, device=device)[:, None]
    j = torch.arange(r, device=device)[None, :]
    return i == diagonal(j)


@per_lane_vmap
class _EighSafe(torch.autograd.Function):
    """``(w, v) = eigh((a + aᴴ)/2)``, ascending, with broadened tangents
    ``dw = Re diag(M)``, ``dv = V (F ∘ M)``, ``M = Vᴴ sym(dA) V``;
    backward ``ā = sym(V (diag(w̄) + F ∘ Vᴴ v̄) Vᴴ)``."""

    @staticmethod
    def forward(a, eps):
        w, v = torch.linalg.eigh(_sym(a))
        return w, v

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, eps = inputs
        ctx.eps = _eps_floor(eps, a.dtype)
        ctx.save_for_backward(*output)
        ctx.save_for_forward(*output)

    @staticmethod
    def _f(w, eps):
        f = _lorentzian(w[None, :] - w[:, None], eps)
        return f * (1.0 - torch.eye(w.shape[0], dtype=w.dtype,
                                    device=w.device))

    @staticmethod
    @nestable_jvp
    def jvp(ctx, da, _eps):
        w, v = ctx.saved_tensors
        m = hmatmul(hmatmul(v.mH, _sym(da)), v)
        return (torch.diagonal(m).real.clone(),
                hmatmul(v, _EighSafe._f(w, ctx.eps).to(m.dtype) * m))

    @staticmethod
    def backward(ctx, w_bar, v_bar):
        # w and v are this Function's outputs: under create_graph their
        # cotangents come back into this same rule.
        w, v = ctx.saved_tensors
        g = (torch.diag(w_bar).to(v.dtype)
             + _EighSafe._f(w, ctx.eps).to(v.dtype) * hmatmul(v.mH, v_bar))
        return _sym(hmatmul(hmatmul(v, g), v.mH)), None


def _eigh_truncated_tangent(w_full, v_full, r, eps):
    """``(w, v, f)``: the kept pairs, descending, and the (n, r) broadened
    gap inverses ``f[j, i] = 1/(λ_i - λ_j)`` against every pair, zero on
    the kept pair's own row."""
    n = w_full.shape[0]
    w, v = _flip_top(w_full, v_full, r)
    f = _lorentzian(w[None, :] - w_full[:, None], eps)
    mask = _kept_mask(n, r, lambda j: n - 1 - j, f.device)
    return w, v, torch.where(mask, torch.zeros_like(f), f)


@per_lane_vmap
class _EighSafeTruncated(torch.autograd.Function):
    """The r largest eigenpairs, descending, with tangents only for the
    kept columns (O(n² r) rule)."""

    @staticmethod
    def forward(a, r, eps):
        w_full, v_full = torch.linalg.eigh(_sym(a))
        w, v = _flip_top(w_full, v_full, r)
        return w.clone(), v.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, r, eps = inputs
        ctx.r, ctx.eps = r, _eps_floor(eps, a.dtype)
        ctx.save_for_backward(a)
        ctx.save_for_forward(a)

    @staticmethod
    @nestable_jvp
    def jvp(ctx, da, _r, _eps):
        (a,) = ctx.saved_tensors
        # The full basis through the safe decomposition, so that the
        # tangent differentiates again (reverse or forward) safely.
        w_full, v_full = _EighSafe.apply(a, ctx.eps)
        _, v, f = _eigh_truncated_tangent(w_full, v_full, ctx.r, ctx.eps)
        da_v = hmatmul(_sym(da), v)
        dw = (v.conj() * da_v).real.sum(dim=0)
        return dw, hmatmul(v_full, f.to(v.dtype) * hmatmul(v_full.mH, da_v))

    @staticmethod
    def backward(ctx, w_bar, v_bar):
        (a,) = ctx.saved_tensors
        # The full basis through the safe decomposition of the saved
        # input, so that a create_graph backward stays degeneracy-safe.
        w_full, v_full = _EighSafe.apply(a, ctx.eps)
        _, v, f = _eigh_truncated_tangent(w_full, v_full, ctx.r, ctx.eps)
        k = (hmatmul(v_full, f.to(v.dtype) * hmatmul(v_full.mH, v_bar))
             + v * w_bar[None, :])
        return _sym(hmatmul(k, v.mH)), None, None


@per_lane_vmap
class _SvdSafe(torch.autograd.Function):
    """Economy SVD of a square matrix, descending, with broadened
    ``1/(s_j² - s_i²)`` factors."""

    @staticmethod
    def forward(a, eps):
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        return u, s, vt

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, eps = inputs
        ctx.eps = _eps_floor(eps, a.dtype)
        ctx.save_for_backward(*output)
        ctx.save_for_forward(*output)

    @staticmethod
    def _f(s, eps):
        s2 = s * s
        f = _lorentzian(s2[None, :] - s2[:, None], eps)
        return f * (1.0 - torch.eye(s.shape[0], dtype=s.dtype,
                                    device=s.device))

    @staticmethod
    def _sinv(s):
        return 1.0 / torch.clamp(s, min=torch.finfo(s.dtype).tiny)

    @staticmethod
    @nestable_jvp
    def jvp(ctx, da, _eps):
        u, s, vt = ctx.saved_tensors
        v = vt.mH
        dp = hmatmul(hmatmul(u.mH, da), v)
        f = _SvdSafe._f(s, ctx.eps).to(dp.dtype)
        du = hmatmul(u, f * (dp * s[None, :] + s[:, None] * dp.mH))
        dv = hmatmul(v, f * (s[:, None] * dp + dp.mH * s[None, :]))
        phase = _phase_diag(dp, _SvdSafe._sinv(s))
        if phase is not None:
            du = du + u * phase[None, :]
        return (du, torch.diagonal(dp).real.clone(),
                dv.mH.contiguous())

    @staticmethod
    def backward(ctx, u_bar, s_bar, vt_bar):
        u, s, vt = ctx.saved_tensors
        f = _SvdSafe._f(s, ctx.eps).to(u.dtype)
        uu = hmatmul(u.mH, u_bar)
        au = f * uu
        av = f * hmatmul(vt, vt_bar.mH)
        p_bar = (torch.diag(s_bar).to(u.dtype) + (au + au.mH) * s[None, :]
                 + s[:, None] * (av + av.mH))
        phase = _phase_diag(uu, _SvdSafe._sinv(s))
        if phase is not None:
            p_bar = p_bar + torch.diag(phase)
        return hmatmul(hmatmul(u, p_bar), vt), None


@functools.lru_cache(maxsize=64)
def _default_omega(m: int, k: int, dtype, device) -> torch.Tensor:
    """The fixed Gaussian sketch (m, k): drawn on the CPU from a generator
    seeded 0x5eed in ``dtype``, then moved to ``device``."""
    gen = torch.Generator().manual_seed(_SEED)
    # A draw that depends on no input: under vmap, one Ω for every lane.
    with outside_transforms():
        return torch.randn((m, k), generator=gen, dtype=dtype).to(device)


def _sketch_svd(a, r, power_iters, omega):
    """Halko-Martinsson-Tropp: ``Y = (A Aᴴ)^q A Ω``, orthonormalized, and
    the exact SVD of the small projection ``Qᴴ A``; the top r triplets."""
    y = hmatmul(a, omega)
    for _ in range(power_iters):
        q, _ = torch.linalg.qr(y)
        y = hmatmul(a, hmatmul(a.mH, q))
    q, _ = torch.linalg.qr(y)
    ub, s, vt = torch.linalg.svd(hmatmul(q.mH, a), full_matrices=False)
    u = hmatmul(q, ub)
    return u[:, :r], s[:r], vt[:r]


def _sketch_rank(a, r, oversample):
    return min(r + oversample, *a.shape)


def _svd_truncated_parts(uk, sk, vtk, r, eps):
    """``(u, s, v, vk, f, sinv)`` of the truncated rule from the k-window
    triplets: ``f[j, i] = 1/(σ_i² - σ_j²)`` broadened, zero on the
    diagonal; ``sinv`` the guarded ``1/σ`` of the kept values."""
    vk = vtk.mH
    u, s, v = uk[:, :r], sk[:r], vk[:, :r]
    f = _lorentzian(s[None, :] ** 2 - sk[:, None] ** 2, eps)
    mask = _kept_mask(sk.shape[0], r, lambda j: j, f.device)
    f = torch.where(mask, torch.zeros_like(f), f)
    tiny = torch.finfo(s.dtype).tiny
    s_ref = torch.clamp(s[0], min=tiny)
    ok = s > s_ref * torch.finfo(s.dtype).eps
    sinv = torch.where(ok, 1.0 / torch.where(ok, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    return u, s, v, vk, f, sinv


@per_lane_vmap
class _SvdSafeTruncated(torch.autograd.Function):
    """Top-r SVD by a randomized subspace sketch, with the truncated
    tangent rule (kept-block rotations against the k-window through
    broadened ``1/(σ_j² - σ_i²)``, plus the complement terms
    ``(I - U_k U_kᴴ) dA V Σ⁻¹`` and ``(I - V_k V_kᴴ) dAᴴ U Σ⁻¹``, and for
    a complex matrix the relative-phase term on du)."""

    @staticmethod
    def forward(a, r, eps, oversample, power_iters, omega):
        u, s, vt = _sketch_svd(a, r, power_iters, omega)
        return u.clone(), s.clone(), vt.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, r, eps, oversample, power_iters, omega = inputs
        ctx.cfg = (r, _eps_floor(eps, a.dtype), power_iters,
                   _sketch_rank(a, r, oversample))
        ctx.save_for_backward(a, omega)
        ctx.save_for_forward(a, omega)

    @staticmethod
    @nestable_jvp
    def jvp(ctx, da, *_):
        r, eps, power_iters, k = ctx.cfg
        a, omega = ctx.saved_tensors
        # The sketch window through this same Function (as the backward
        # takes it), so that the tangent differentiates again safely.
        uk, sk, vtk = _SvdSafeTruncated.apply(a, k, eps, 0, power_iters,
                                              omega)
        u, s, v, vk, f, sinv = _svd_truncated_parts(uk, sk, vtk, r, eps)
        da_v = hmatmul(da, v)
        dat_u = hmatmul(da.mH, u)
        p1 = hmatmul(uk.mH, da_v)
        p2 = hmatmul(vk.mH, dat_u)
        f = f.to(p1.dtype)
        ds = torch.diagonal(p1[:r]).real.clone()
        du = hmatmul(uk, f * (p1 * s[None, :] + sk[:, None] * p2))
        dv = hmatmul(vk, f * (p2 * s[None, :] + sk[:, None] * p1))
        du = du + (da_v - hmatmul(uk, hmatmul(uk.mH, da_v))) * sinv[None, :]
        dv = dv + (dat_u - hmatmul(vk, hmatmul(vk.mH, dat_u))) * sinv[None, :]
        phase = _phase_diag(p1, sinv)
        if phase is not None:
            du = du + u * phase[None, :]
        return du, ds, dv.mH.contiguous()

    @staticmethod
    def backward(ctx, u_bar, s_bar, vt_bar):
        r, eps, power_iters, k = ctx.cfg
        a, omega = ctx.saved_tensors
        # The sketch window (k triplets, no oversampling, the same Ω)
        # through this same Function: a create_graph backward
        # differentiates it with this rule again.
        uk, sk, vtk = _SvdSafeTruncated.apply(a, k, eps, 0, power_iters,
                                              omega)
        u, s, v, vk, f, sinv = _svd_truncated_parts(uk, sk, vtk, r, eps)
        v_bar = vt_bar.mH
        uu = hmatmul(uk.mH, u_bar)
        f = f.to(uu.dtype)
        x = f * uu
        y = f * hmatmul(vk.mH, v_bar)
        p1_bar = x * s[None, :] + sk[:, None] * y
        p2_bar = sk[:, None] * x + y * s[None, :]
        u_sinv = u_bar * sinv[None, :]
        v_sinv = v_bar * sinv[None, :]
        left = (u * s_bar[None, :] + hmatmul(uk, p1_bar)
                + u_sinv - hmatmul(uk, hmatmul(uk.mH, u_sinv)))
        phase = _phase_diag(uu, sinv)
        if phase is not None:
            left = left + u * phase[None, :]
        right = (hmatmul(vk, p2_bar)
                 + v_sinv - hmatmul(vk, hmatmul(vk.mH, v_sinv)))
        a_bar = hmatmul(left, v.mH) + hmatmul(u, right.mH)
        return a_bar, None, None, None, None, None


def _check_matrix(a, device, what, square=False):
    check_device(device, a)
    if a.ndim != 2 or (square and a.shape[0] != a.shape[1]):
        raise ValueError(f"{what} must be a {'square ' if square else ''}"
                         f"matrix, got shape {tuple(a.shape)}")


def eigh_safe(a: torch.Tensor, eps: float = 1e-12, *, device=None):
    """Full Hermitian eigendecomposition ``(w, v)`` of ``(a + aᴴ)/2``,
    ascending, with degeneracy-safe derivatives of any order: a gap
    ``|λi - λj| >> eps`` gives the exact derivative, a multiplet
    contributes ~0 instead of NaN.  ``device`` is where the call runs
    (CUDA when None); ``a`` must live there."""
    _check_matrix(a, device, "a", square=True)
    return _EighSafe.apply(a, float(eps))


def eigh_safe_truncated(a: torch.Tensor, r: int, eps: float = 1e-12, *,
                        device=None):
    """The r largest eigenpairs ``(w (r,) descending, v (n, r))`` of a
    symmetric matrix, by a full ``eigh`` forward, with degeneracy-safe
    tangents evaluated only for the kept columns."""
    _check_matrix(a, device, "a", square=True)
    return _EighSafeTruncated.apply(a, int(r), float(eps))


def svd_safe(a: torch.Tensor, eps: float = 1e-12, *, device=None):
    """SVD ``(u, s, vt)`` of a square matrix, descending, with
    degeneracy-safe derivatives (the broadened ``1/(s_j² - s_i²)``; the
    complement terms vanish for a square matrix)."""
    _check_matrix(a, device, "a", square=True)
    return _SvdSafe.apply(a, float(eps))


def svd_safe_truncated(a: torch.Tensor, r: int, eps: float = 1e-12,
                       oversample: int = 16, power_iters: int = 2, *,
                       omega=None, device=None):
    """Top-r SVD ``(u (n, r), s (r,) descending, vt (r, m))`` of a
    (possibly rectangular) matrix by randomized subspace iteration, with
    degeneracy-safe derivatives of any order.

    The sketch is ``Y = (A Aᵀ)^q A Ω`` with Ω (m, k), k = min(r +
    oversample, n, m): by default a fixed draw (see the module
    docstring); ``omega`` (a numpy array or a tensor of that shape) gives
    it explicitly, e.g. the JAX package's draw.
    """
    _check_matrix(a, device, "a")
    r, oversample, power_iters = int(r), int(oversample), int(power_iters)
    k = _sketch_rank(a, r, oversample)
    if omega is None:
        omega = _default_omega(a.shape[1], k, a.dtype, a.device)
    else:
        omega = (omega.to(dtype=a.dtype, device=a.device)
                 if isinstance(omega, torch.Tensor) else
                 torch.tensor(omega, dtype=a.dtype, device=a.device))
        if tuple(omega.shape) != (a.shape[1], k):
            raise ValueError(f"omega must have shape {(a.shape[1], k)}, "
                             f"got {tuple(omega.shape)}")
    return _SvdSafeTruncated.apply(a, r, float(eps), oversample,
                                   power_iters, omega)
