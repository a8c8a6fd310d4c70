"""LOBPCG block forward engine for extremal eigenpairs.

Counterpart of ``lobpcg_eigh`` in ``dominantsparseeigenad_tpu/ops/lobpcg.py``
(Knyazev 2001, with the basis hygiene of Duersch-Shao-Yang 2018).  Every
iteration is two blocked matvecs of width r (``A W`` and ``A P``; on a
``BellOperator`` each is one launch of the SpMM kernel) plus a few
(N, 3r) x (3r, 3r) products and two small symmetric eigenproblems, which
stay ``hmatmul`` and ``torch.linalg.eigh`` as the JAX package leaves them
to XLA.

The search subspace ``S = [X, W, P]`` is orthonormalized by whitening its
3r x 3r Gram matrix with masked dropping: near-null Gram directions are
zeroed and their Rayleigh-Ritz eigenvalues pushed above the spectrum, so
the fixed-shape Ritz selection never picks them.

The JAX loop is a ``lax.while_loop`` that stops at the first iteration
whose block residual passes.  Here the residual is read on the host
every iteration, so the loop stops at exactly that iteration too:
iterating past it can destabilize LOBPCG (the whitened Gram matrix turns
ill-conditioned once the residual block is at round-off), and one read
is small next to two SpMMs.

A complex Hermitian operator runs the same iteration with Hermitian Gram
matrices and conjugated projections; the Ritz values are real.

Forward only: gradients come from the implicit-function-theorem rule of
``eigh.py`` (``dominant_eigh_multi(..., method="lobpcg")``).
``lobpcg_eigh_general`` waits for the generalized-pencil slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .operators import (as_operator, check_device, hmatmul, pivot_gauge,
                        real_dtype, tol_floor)


class LobpcgInfo(NamedTuple):
    """Convergence report (float scalar tensors).

    iterations : LOBPCG iterations executed
    residual   : final max over the block of
                 ``||A x - lam x|| / max(|lam|, 1)``
    converged  : 1.0 if the residual test passed before ``maxiter``
    """

    iterations: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor


def _colnormalize(blocks):
    """Scale the columns of the first block to unit norm, and the
    companion blocks (their A-images) by the same factors."""
    m = blocks[0]
    tiny = torch.finfo(m.dtype).tiny
    nrm = torch.linalg.vector_norm(m, dim=0)
    scl = torch.where(nrm > tiny, 1.0 / torch.clamp(nrm, min=tiny),
                      torch.zeros_like(nrm))
    return tuple(b * scl[None, :] for b in blocks)


def _whiten_metric(S, MS, companions, drop_tol):
    """Orthonormalize the columns of ``S`` in the metric whose image is
    ``MS`` by Gram whitening, applying the same transform ``t`` to every
    companion block; near-dependent directions are dropped by masking
    (their columns zeroed, ``keep`` returned) instead of shrinking
    shapes.  ``t`` maps whitened coefficients back to the columns of
    ``S`` (``S_white = S t``)."""
    g = hmatmul(S.mH, MS)
    g = 0.5 * (g + g.mH)
    d, u = torch.linalg.eigh(g)
    tiny = torch.finfo(d.dtype).tiny
    keep = d > drop_tol * torch.clamp(d[-1], min=tiny)
    scale = torch.where(keep, torch.rsqrt(torch.clamp(d, min=tiny)),
                        torch.zeros_like(d))
    t = u * scale.to(u.dtype)[None, :]
    return tuple(hmatmul(c, t) for c in companions), keep, t


def _whiten(S, AS, drop_tol):
    """Euclidean-metric whitening of ``(S, AS)``."""
    (so, aso), keep, t = _whiten_metric(S, S, (S, AS), drop_tol)
    return so, aso, keep, t


def _rayleigh_ritz(So, ASo, keep, r):
    """The r lowest Ritz pairs of the (masked-)orthonormal basis ``So``;
    dropped directions get an eigenvalue above the spectrum (about
    2·||T||_F, not a huge constant: eigh's absolute error scales with the
    matrix norm)."""
    t = hmatmul(So.mH, ASo)
    t = 0.5 * (t + t.mH)
    big = 2.0 * torch.linalg.matrix_norm(t) + 1.0
    penalty = torch.where(keep, torch.zeros_like(big), big)
    evals, evecs = torch.linalg.eigh(t + torch.diag(penalty).to(t.dtype))
    return evals[:r], evecs[:, :r]


def lobpcg_eigh(op, r: int = 4, *, extreme: str = "min", maxiter: int = 200,
                tol: float = 1e-8, x0: torch.Tensor | None = None,
                generator: torch.Generator | None = None, precond=None,
                with_info: bool = False, device=None):
    """Top-``r`` extremal eigenpairs of a symmetric operator by block
    iteration (LOBPCG).

    op      : LinearOperator (or dense symmetric tensor); needs ``matmat``.
    r       : block size = number of eigenpairs returned.
    extreme : "min" (algebraically smallest, ascending) or "max"
              (largest, descending).
    maxiter : iteration cap (each = 2 width-``r`` blocked matvecs).
    tol     : relative residual target ``max_i ||A x_i - lam_i x_i|| /
              max(|lam_i|, 1)``, floored at 50 eps of the dtype.
    x0      : the (N, r) start block; drawn from ``generator`` (seeded 0
              on the device when None) if not given.
    precond : optional SPD approximate inverse applied to the (N, r)
              residual block, ``W = M^{-1} R``.
    device  : where the solve runs (CUDA when None).

    Returns ``(lams, X)``, ``X`` (N, r) orthonormal with the pivot sign
    gauge, or ``(lams, X, info)`` with a :class:`LobpcgInfo`.
    """
    op = as_operator(op)
    if extreme not in ("min", "max"):
        raise ValueError(f"extreme must be min|max, got {extreme!r}")
    dev = check_device(device, op)
    r = int(r)
    n = op.dim
    if n < 3 * r:
        raise ValueError(
            f"LOBPCG needs dim >= 3*r for its [X, W, P] subspace; got "
            f"dim={n}, r={r} — use dominant_eigh_multi(method='lanczos')")
    dtype = op.dtype
    rdt = real_dtype(dtype)
    sign = 1.0 if extreme == "min" else -1.0
    tol = tol_floor(tol, dtype)
    # Whitening drop threshold: directions this far below the dominant
    # Gram eigenvalue are numerically dependent at working precision.
    drop_tol = 50.0 * float(torch.finfo(dtype).eps)

    def amat(X):
        return sign * op.matmat(X)

    if x0 is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        # A real draw, cast (the JAX package's start block).
        x0 = torch.randn((n, r), generator=generator, dtype=rdt,
                         device=dev).to(dtype)
    else:
        x0 = torch.as_tensor(x0).to(device=dev, dtype=dtype)
        if x0.shape != (n, r):
            raise ValueError(f"x0 must be ({n}, {r}), got {tuple(x0.shape)}")
    zeros = torch.zeros((n, r), dtype=dtype, device=dev)
    # A random (n, r) block is full rank at working precision, so the
    # whitening mask is all-keep here.
    x, _, _, _ = _whiten(x0, zeros, drop_tol)
    ax = amat(x)
    lams = (x.conj() * ax).real.sum(dim=0)

    def resid_norm(x, ax, lams):
        nrm = torch.linalg.vector_norm(ax - x * lams[None, :], dim=0)
        return torch.max(nrm / torch.clamp(lams.abs(), min=1.0))

    res = resid_norm(x, ax, lams)
    p = ap = zeros
    it = 0
    while it < maxiter and float(res) > tol:
        rblk = ax - x * lams[None, :]
        w = precond(rblk) if precond is not None else rblk
        # Project W off span(X) twice and unit-normalize its columns, so
        # the 3r x 3r Gram stays well scaled as the residuals shrink.
        for _ in range(2):
            w = w - hmatmul(x, hmatmul(x.mH, w))
        aw = amat(w)
        w, aw = _colnormalize((w, aw))
        s = torch.cat([x, w, p], dim=1)
        a_s = torch.cat([ax, aw, ap], dim=1)
        so, aso, keep, t = _whiten(s, a_s, drop_tol)
        lams, y = _rayleigh_ritz(so, aso, keep, r)
        x_new = hmatmul(so, y)
        ax = hmatmul(aso, y)
        # Next conjugate directions: the W/P part of the update, taken in
        # the original [X, W, P] coordinates (zero the X rows of t @ y),
        # projected off the new X and orthonormalized.  A P is applied
        # again rather than tracked: t carries rsqrt-of-tiny factors near
        # ill-conditioning, and a tracked image loses consistency.
        c_wp = hmatmul(t, y)
        c_wp[:r] = 0
        p_raw = hmatmul(s, c_wp)
        p_raw = p_raw - hmatmul(x_new, hmatmul(x_new.mH, p_raw))
        (p,), _, _ = _whiten_metric(p_raw, p_raw, (p_raw,), drop_tol)
        ap = amat(p)
        x = x_new
        res = resid_norm(x, ax, lams)
        it += 1

    lams = sign * lams
    x = pivot_gauge(x)
    if not with_info:
        return lams, x
    info = LobpcgInfo(
        iterations=torch.tensor(float(it), dtype=rdt, device=dev),
        residual=res, converged=(res <= tol).to(rdt))
    return lams, x, info
