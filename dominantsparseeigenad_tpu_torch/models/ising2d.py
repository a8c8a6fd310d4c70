"""2D classical Ising model: TRG and CTMRG with a differentiable free energy.

Counterpart of ``dominantsparseeigenad_tpu/models/ising2d.py`` (BASELINE
config #4, the paper's third application): contract the square-lattice
Ising partition function by tensor renormalization, differentiate ln Z
through the truncated decompositions once (energy) and twice (specific
heat), and hold it against Onsager's exact solution.

* The decompositions are the degeneracy-safe ones of ``ops/decomp.py``
  (plaquette and corner spectra carry exact multiplets), or, opt-in, the
  block eigensolver: ``split_method="lanczos"`` splits through
  ``ops/svd.py::dominant_svd`` and ``eigh_solver="lanczos"`` renormalizes
  the corner with ``dominant_eigh_multi``.
* The JAX flows scan the shape-stable steps with ``lax.scan``; here every
  step is a Python loop, so the graph is always unrolled and
  reverse-over-reverse keeps the nested rules (``unroll=`` is accepted
  and changes nothing).
* The specific heat is ``value_d1_d2``'s jvp of a jvp, as the JAX
  package nests two forward passes; ``torch.func.grad`` of
  ``torch.func.jacfwd`` (forward over reverse) and reverse over reverse
  give it too.
* ``max |t|`` normalizations hit exact ties in the symmetric Ising
  tensors: ``amax`` splits the derivative evenly among them, as JAX's
  ``max`` does.  Square roots at exact zero modes are guarded by the
  two-sided ``where`` pattern (a safe value inside, the mask outside).
* Every contraction runs with TF32 off (``ops/operators.py`` sets the flag
  at import), the counterpart of the JAX package's HIGHEST precision.

Conventions: vertex tensor ``T[u, r, d, l]`` (up, right, down, left); the
coupling is J = 1, inverse temperature ``beta``.  The row-to-row
transfer operator of the CTMRG environment gives the two transfer
observables, ``transfer_spectral_gap`` (its dominant eigenvalue) and
``correlation_length`` (from its two leading eigenvalues), through the
non-symmetric solver of ``ops/eig.py``, differentiable in beta through
the whole environment.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.decomp import (eigh_safe, eigh_safe_truncated, svd_safe,
                          svd_safe_truncated)
from ..ops.eig import dominant_eig, dominant_eig_multi
from ..ops.eigh import dominant_eigh_multi
from ..ops.observables import value_d1_d2
from ..ops.operators import (DenseOperator, check_device, hmatmul,
                             refuse_complex, resolve_device)
from ..ops.svd import dominant_svd

_EPS = 1e-12


def _beta(beta, dtype, dev):
    """``beta`` as a scalar tensor of ``dtype`` on ``dev``; a tensor keeps
    its graph."""
    refuse_complex(dtype, "dtype", "the 2D Ising model at real beta has "
                   "real weights, tensors and transfer matrices; a complex "
                   "dtype would only carry zero imaginary parts (no "
                   "ROADMAP.md item)")
    if isinstance(beta, torch.Tensor):
        check_device(dev, beta)
        return beta.to(dtype=dtype)
    return torch.tensor(float(beta), dtype=dtype, device=dev)


def ising_vertex_tensor(beta, dtype=torch.float64, device=None):
    """``T[u,r,d,l] = Σ_s W[s,u] W[s,r] W[s,d] W[s,l]``, W the square root
    of the bond matrix ``M[s,s'] = exp(beta s s')`` built from its
    eigenpairs (2cosh β, [1,1]/√2) and (2sinh β, [1,-1]/√2), so that it
    stays differentiable in beta."""
    beta = _beta(beta, dtype, resolve_device(device))
    cp = torch.sqrt(torch.cosh(beta))
    sm = torch.sqrt(torch.sinh(beta))
    w = torch.stack([torch.stack([cp + sm, cp - sm]),
                     torch.stack([cp - sm, cp + sm])]) * (1.0 / math.sqrt(2.0))
    return torch.einsum("su,sr,sd,sl->urdl", w, w, w, w)


def onsager_free_energy(beta, n_quad: int = 64, *, dtype=torch.float64,
                        device=None):
    """Onsager's exact ln Z per site in the thermodynamic limit,

        ln 2 + (1/(8π²)) ∫∫ ln[cosh²(2β) - sinh(2β)(cos t1 + cos t2)],

    by Gauss-Legendre quadrature (nodes from ``numpy.polynomial.legendre``)
    in tensor operations, differentiable in beta: the exact energy and
    specific heat follow by autograd."""
    dev = resolve_device(device)
    beta = _beta(beta, dtype, dev)
    x, wq = np.polynomial.legendre.leggauss(n_quad)
    t = torch.tensor((x + 1.0) * np.pi, dtype=dtype, device=dev)
    wq = torch.tensor(wq * np.pi, dtype=dtype, device=dev)
    c2 = torch.cosh(2 * beta) ** 2
    s2 = torch.sinh(2 * beta)
    integrand = torch.log(c2 - s2 * (torch.cos(t)[:, None]
                                     + torch.cos(t)[None, :]))
    integral = torch.einsum("i,j,ij->", wq, wq, integrand)
    return math.log(2.0) + integral / (8.0 * math.pi ** 2)


# ---------------------------------------------------------------------------
# TRG (Levin-Nave)
# ---------------------------------------------------------------------------

def _split(m, chi, eps=_EPS, method: str = "gram", maxiter=None):
    """Factor ``m ≈ F1 @ F2ᵀ`` keeping the top-chi singular values,
    ``F1 = U √s``, ``F2 = V √s`` (the JAX ``_split``): "gram" through the
    safe truncated ``eigh`` of ``m mᵀ``, "subspace" through the sketched
    ``svd_safe_truncated`` (when ``2 chi <= dim``), "lanczos" through
    ``dominant_svd`` (when ``chi < dim``; ``maxiter`` bounds its
    backward's CG), otherwise the dense ``svd_safe``."""
    dev = m.device
    tiny = torch.finfo(m.dtype).tiny
    eps_d = float(torch.finfo(m.dtype).eps)
    if method == "gram":
        w_top, u_top = eigh_safe_truncated(hmatmul(m, m.T), chi, eps,
                                           device=dev)
        # Exact zero modes of the early steps: sqrt has an infinite
        # derivative at 0, so mask with the two-sided where (a clamp
        # would still back-propagate it).  The relative cutoff is floored
        # at eps² so that float32 drops what its round-off cannot resolve.
        w_max = torch.clamp(w_top[0], min=tiny)
        keep = w_top > w_max * max(1e-24, eps_d ** 2)
        wc = torch.where(keep, w_top, w_max)
        zero = torch.zeros_like(wc)
        sq = torch.where(keep, torch.sqrt(torch.sqrt(wc)), zero)
        v = hmatmul(m.T, u_top) / torch.where(
            keep, torch.sqrt(wc), torch.ones_like(wc))[None, :]
        v = v * keep[None, :]
        return u_top * sq[None, :], v * sq[None, :]
    # The truncated paths need sigma_chi to be a genuine singular value:
    # untruncated splits take the dense SVD.
    if method == "lanczos" and chi < m.shape[0]:
        k = min(m.shape[0] * 2, 2 * chi + 40)
        u, s, v = dominant_svd(m, r=chi, k=k, gap_eps=eps, maxiter=maxiter,
                               device=dev)
        sq = torch.sqrt(s)
        return u * sq[None, :], v * sq[None, :]
    if method == "subspace" and 2 * chi <= m.shape[0]:
        u, s, vt = svd_safe_truncated(m, chi, eps, device=dev)
        s_top = s
    else:
        u, s, vt = svd_safe(m, eps, device=dev)
        u, s_top, vt = u[:, :chi], s[:chi], vt[:chi]
    s_ref = torch.clamp(s[0], min=tiny)
    keep = s_top > s_ref * eps_d
    sq = torch.where(keep, torch.sqrt(torch.where(keep, s_top, s_ref)),
                     torch.zeros_like(s_top))
    return u * sq[None, :], vt.T * sq[None, :]


def trg_step(t, chi, eps=_EPS, method: str = "gram", maxiter=None):
    """One Levin-Nave coarse-graining step: 2 plaquette sites -> 1 site.
    The even sublattice splits (u,r)|(d,l), the odd one (l,u)|(r,d); the
    four inward half-tensors of each plaquette contract into the new
    tensor, whose legs are the old sites' split bonds."""
    d = t.shape[0]
    chi_eff = min(chi, d * d)
    ma = t.reshape(d * d, d * d)                        # (u,r) x (d,l)
    mb = torch.movedim(t, 3, 0).reshape(d * d, d * d)   # (l,u) x (r,d)
    f1, f2 = _split(ma, chi_eff, eps, method, maxiter)
    f3, f4 = _split(mb, chi_eff, eps, method, maxiter)
    f1 = f1.reshape(d, d, -1)   # [u, r, k]
    f2 = f2.reshape(d, d, -1)   # [d, l, k]
    f3 = f3.reshape(d, d, -1)   # [l, u, k]
    f4 = f4.reshape(d, d, -1)   # [r, d, k]
    # New legs (u, r, d, l) = (k of F2, F3, F1, F4), contracted in pairs
    # so that no intermediate exceeds chi⁴ (a left-to-right order would
    # build a d² chi³ one).
    top = torch.einsum("wxa,xyb->wayb", f1, f3)
    bottom = torch.einsum("yzc,zwd->ywcd", f2, f4)
    return torch.einsum("wayb,ywcd->cbad", top, bottom)


def _max_abs(t):
    return torch.amax(torch.abs(t))


def trg_free_energy(beta, *, chi: int = 24, n_steps: int = 24,
                    eps: float = _EPS, dtype=torch.float64,
                    split_method: str = "auto", unroll: bool = False,
                    lanczos_maxiter: int | None = None, device=None):
    """ln Z per site of the 2D Ising model by TRG, differentiable in beta
    to any order.  After ``n_steps`` halvings the residual lattice is
    closed by the single-site torus trace.

    ``split_method``: "gram", "subspace", "lanczos", "full", or "auto",
    which resolves by dtype as the JAX function does ("gram" in float64,
    "subspace" in float32, whose squared spectrum would lose the kept
    tail below round-off).  ``unroll`` is accepted for the JAX signature:
    the loop here is always unrolled, with the same result.
    ``lanczos_maxiter`` bounds the backward CG of every lanczos split
    (default 10 x the embedding's dimension, the JAX package's): the
    early, rank-deficient splits keep null columns whose shifted systems
    are indefinite, and their solves run to the cap.  ``device``: where
    it runs (CUDA when None).
    """
    del unroll
    dev = resolve_device(device)
    if split_method == "auto":
        split_method = "gram" if torch.finfo(dtype).bits >= 64 else "subspace"
    if split_method not in ("gram", "subspace", "lanczos", "full"):
        raise ValueError(f"unknown split_method {split_method!r}")
    t = ising_vertex_tensor(beta, dtype=dtype, device=dev)
    logz = torch.zeros((), dtype=dtype, device=dev)
    for i in range(n_steps):
        norm = _max_abs(t)
        t = t / norm
        logz = logz + torch.log(norm) / 2 ** i
        t = trg_step(t, chi, eps, split_method, lanczos_maxiter)
    norm = _max_abs(t)
    t = t / norm
    logz = logz + torch.log(norm) / 2 ** n_steps
    return logz + torch.log(torch.einsum("urur->", t)) / 2 ** n_steps


# ---------------------------------------------------------------------------
# CTMRG (symmetric: one corner and one edge)
# ---------------------------------------------------------------------------

def ctmrg_environment(beta, *, chi: int = 32, n_steps: int = 40,
                      eps: float = _EPS, dtype=torch.float64,
                      eigh_solver: str = "truncated", lanczos_k: int = 0,
                      device=None):
    """The environment ``(C, E, T)`` after ``n_steps``: corner (chi, chi),
    edge (chi, D, chi) and the vertex tensor.  Each step absorbs a row and
    a column into the corner, diagonalizes the enlarged corner, keeps its
    top chi eigenvectors and renormalizes the edge with that isometry.

    ``eigh_solver``: "truncated" (``eigh_safe_truncated``), "lanczos"
    (``dominant_eigh_multi`` with its block IFT rule; ``lanczos_k``
    overrides its k, default min(dim, 2 chi + 16)), or "full"
    (``eigh_safe`` with a magnitude-sorted truncation, the oracle).
    """
    if eigh_solver not in ("truncated", "lanczos", "full"):
        raise ValueError(f"unknown eigh_solver {eigh_solver!r}")
    dev = resolve_device(device)
    t = ising_vertex_tensor(beta, dtype=dtype, device=dev)
    d = t.shape[0]
    # C[a, b]: a the down chi-leg, b the right one (symmetric);
    # E[p, m, q]: p the left chi-leg, m the down D-leg, q the right one.
    c = torch.einsum("urdl->dr", t)
    e = torch.einsum("urdl->ldr", t)
    for _ in range(n_steps):
        chi_c = c.shape[0]
        chi_eff = min(chi, chi_c * d)
        # C'[(p, i), (q, j)] = Σ C[a,b] E[a,l,p] E[b,u,q] T[u,j,i,l]
        cp = torch.einsum("ab,alp,buq,ujil->piqj", c, e, e, t)
        cp = cp.reshape(chi_c * d, chi_c * d)
        cp = (cp + cp.T) / 2
        if eigh_solver == "truncated":
            wk, p = eigh_safe_truncated(cp, chi_eff, eps, device=dev)
        elif eigh_solver == "lanczos":
            k = lanczos_k or min(cp.shape[0], 2 * chi_eff + 16)
            wk, p = dominant_eigh_multi(DenseOperator(cp), r=chi_eff, k=k,
                                        extreme="max",
                                        gap_eps=max(eps, 1e-12), device=dev)
        else:
            w, v = eigh_safe(cp, eps, device=dev)
            order = torch.argsort(-torch.abs(w), stable=True)[:chi_eff]
            wk, p = w[order], v[:, order]
        c = torch.diag(wk / _max_abs(wk))
        # E'[k, d, k'] = Σ P[(a,l),k] E[a,u,b] T[u,r,d,l] P[(b,r),k']
        p3 = p.reshape(chi_c, d, chi_eff)
        ep = torch.einsum("alk,aub,urdl,brq->kdq", p3, e, t, p3)
        e = ep / _max_abs(ep)
    return c, e, t


def ctmrg_free_energy(beta, *, chi: int = 32, n_steps: int = 40,
                      eps: float = _EPS, dtype=torch.float64,
                      eigh_solver: str = "truncated", device=None):
    """ln Z per site from the CTMRG environment, ``κ = A B / (N_h N_v)``:
    A the 3x3 network with T in the centre, B the 2x2 corner trace, N_h
    and N_v the half networks with one edge pair (invariant under the C
    and E normalizations)."""
    c, e, t = ctmrg_environment(beta, chi=chi, n_steps=n_steps, eps=eps,
                                dtype=dtype, eigh_solver=eigh_solver,
                                device=device)
    a = torch.einsum("ab,buc,cd,dre,ef,fvg,gh,hla,urvl->",
                     c, e, c, e, c, e, c, e, t)
    b = torch.trace(hmatmul(hmatmul(hmatmul(c, c), c), c))
    nh = torch.einsum("ab,buc,cd,de,euf,fa->", c, e, c, c, e, c)
    return torch.log(a) + torch.log(b) - 2.0 * torch.log(nh)


def transfer_operator(c, e, t, *, device=None) -> DenseOperator:
    """The row-to-row transfer operator on the (chi, D, chi) boundary,
    ``M[(a,u,b),(c,v,d)] = Σ_{m,n} E[a,m,c] T[m,v,n,u] E[b,n,d]``."""
    check_device(device, c, e, t)
    chi_c, d = e.shape[0], e.shape[1]
    m = torch.einsum("amc,mvnu,bnd->aubcvd", e, t, e)
    dim = chi_c * d * chi_c
    return DenseOperator(m.reshape(dim, dim))


# ---------------------------------------------------------------------------
# Observables
# ---------------------------------------------------------------------------

def transfer_spectral_gap(beta, *, chi: int = 16, n_steps: int = 30,
                          num_iters: int = 400, dtype=torch.float64,
                          method: str = "arnoldi", device=None):
    """The dominant eigenvalue of the transfer operator of the converged
    CTMRG environment, by :func:`~..ops.eig.dominant_eig`
    (Arnoldi-seeded by default, ``arnoldi_k = min(48, dim)``: near
    criticality the transfer spectrum is nearly degenerate);
    differentiable in beta."""
    dev = resolve_device(device)
    c, e, t = ctmrg_environment(beta, chi=chi, n_steps=n_steps, dtype=dtype,
                                device=dev)
    op = transfer_operator(c, e, t, device=dev)
    lam, _, _ = dominant_eig(op, num_iters=num_iters, method=method,
                             arnoldi_k=min(48, op.dim), device=dev)
    return lam


def correlation_length(beta, *, chi: int = 16, n_steps: int = 30,
                       num_iters: int = 600, dtype=torch.float64,
                       device=None):
    """``ξ = 1 / ln(λ1 / |λ2|)`` from the two leading transfer
    eigenvalues (:func:`~..ops.eig.dominant_eig_multi`, m = 2, Wielandt
    deflation, Arnoldi-seeded, ``arnoldi_k = min(48, dim)``),
    differentiable in beta through the whole chain.  Meant for the
    disordered phase; in the ordered phase the top pair is nearly
    degenerate, and the gap is clamped at machine epsilon so that ξ
    saturates at a large positive value (~1/eps) instead of turning
    negative."""
    dev = resolve_device(device)
    c, e, t = ctmrg_environment(beta, chi=chi, n_steps=n_steps, dtype=dtype,
                                device=dev)
    op = transfer_operator(c, e, t, device=dev)
    lams, _, _ = dominant_eig_multi(op, m=2, num_iters=num_iters,
                                    arnoldi_k=min(48, op.dim), device=dev)
    gap = torch.log(lams[0] / torch.abs(lams[1]))
    return 1.0 / torch.clamp(gap, min=torch.finfo(lams.dtype).eps)


def ising_observables(beta, *, method: str = "trg", chi: int = 24,
                      n_steps: int = 24, dtype=torch.float64, device=None):
    """``(ln Z/N, u, c_v)`` at ``beta``: the energy per site
    ``u = -d lnZ/dβ`` and the specific heat ``c_v = β² d² lnZ/dβ²``,
    differentiated through the whole renormalization flow
    (:func:`~..ops.observables.value_d1_d2`: a jvp of a jvp, one pass)."""
    f = {"trg": trg_free_energy, "ctmrg": ctmrg_free_energy}[method]
    dev = resolve_device(device)
    beta = _beta(beta, dtype, dev).detach()
    lnz, d1, d2 = value_d1_d2(
        lambda b: f(b, chi=chi, n_steps=n_steps, dtype=dtype, device=dev),
        beta, device=dev)
    return lnz, -d1, beta ** 2 * d2
