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

``lobpcg_eigh_general`` solves the generalized pencil ``A x = lam B x``
(``B`` Hermitian positive definite) by the same scheme in the B metric:
one ``A`` and one ``B`` block product per iteration, plus both applied
again to the conjugate directions.

Forward only: gradients come from the implicit-function-theorem rules of
``eigh.py`` (``dominant_eigh_multi(..., method="lobpcg")``) and
``gen.py`` (``dominant_eigh_gen``).

On an operator whose vectors are sharded over ranks
(``operators.vector_layout``) both solvers run on the rank's rows: their
Gram matrices (the B-metric ones too), norms and projections are summed
over the ranks (every rank whitens and solves the same small problems
and reads the same residual), the start block is drawn whole and
narrowed, and a preconditioner applies to the rank's rows of the
residual block.  A pencil's two operators must share one layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .operators import (_reduced, as_operator, check_device, common_layout,
                        hmatmul, layout_norm, layout_sum, local_dim,
                        pivot_gauge, real_dtype, tol_floor, vector_layout)


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


def _colnormalize(blocks, layout=None):
    """Scale the columns of the first block to unit norm, and the
    companion blocks (their A-images) by the same factors."""
    m = blocks[0]
    tiny = torch.finfo(m.dtype).tiny
    nrm = layout_norm(layout, m, dim=0)
    scl = torch.where(nrm > tiny, 1.0 / torch.clamp(nrm, min=tiny),
                      torch.zeros_like(nrm))
    return tuple(b * scl[None, :] for b in blocks)


def _whiten_metric(S, MS, companions, drop_tol, layout=None):
    """Orthonormalize the columns of ``S`` in the metric whose image is
    ``MS`` by Gram whitening, applying the same transform ``t`` to every
    companion block; near-dependent directions are dropped by masking
    (their columns zeroed, ``keep`` returned) instead of shrinking
    shapes.  ``t`` maps whitened coefficients back to the columns of
    ``S`` (``S_white = S t``)."""
    g = layout_sum(layout, hmatmul(S.mH, MS))
    g = 0.5 * (g + g.mH)
    d, u = torch.linalg.eigh(g)
    tiny = torch.finfo(d.dtype).tiny
    keep = d > drop_tol * torch.clamp(d[-1], min=tiny)
    scale = torch.where(keep, torch.rsqrt(torch.clamp(d, min=tiny)),
                        torch.zeros_like(d))
    t = u * scale.to(u.dtype)[None, :]
    return tuple(hmatmul(c, t) for c in companions), keep, t


def _whiten(S, AS, drop_tol, layout=None):
    """Euclidean-metric whitening of ``(S, AS)``."""
    (so, aso), keep, t = _whiten_metric(S, S, (S, AS), drop_tol, layout)
    return so, aso, keep, t


def _rayleigh_ritz(So, ASo, keep, r, layout=None):
    """The r lowest Ritz pairs of the (masked-)orthonormal basis ``So``;
    dropped directions get an eigenvalue above the spectrum (about
    2·||T||_F, not a huge constant: eigh's absolute error scales with the
    matrix norm)."""
    t = layout_sum(layout, hmatmul(So.mH, ASo))
    t = 0.5 * (t + t.mH)
    big = 2.0 * torch.linalg.matrix_norm(t) + 1.0
    penalty = torch.where(keep, torch.zeros_like(big), big)
    evals, evecs = torch.linalg.eigh(t + torch.diag(penalty).to(t.dtype))
    return evals[:r], evecs[:, :r]


def _start_block(n, r, dtype, x0, generator, dev, layout=None):
    """The (N, r) start block: ``x0``, or a real draw from ``generator``
    (seeded 0 on the device when None), cast (the JAX package's); the
    rank's rows of it under a sharded ``layout``."""
    if x0 is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if layout is not None:
            return layout.draw((n, r), generator, real_dtype(dtype),
                               dev).to(dtype)
        return torch.randn((n, r), generator=generator,
                           dtype=real_dtype(dtype), device=dev).to(dtype)
    x0 = torch.as_tensor(x0).to(device=dev, dtype=dtype)
    if layout is not None:
        n = layout.local_dim
    if x0.shape != (n, r):
        raise ValueError(f"x0 must be ({n}, {r}), got {tuple(x0.shape)}")
    return x0


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
    layout = vector_layout(op)
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

    x0 = _start_block(n, r, dtype, x0, generator, dev, layout)
    zeros = torch.zeros((local_dim(op), r), dtype=dtype, device=dev)
    # A random (n, r) block is full rank at working precision, so the
    # whitening mask is all-keep here.
    x, _, _, _ = _whiten(x0, zeros, drop_tol, layout)
    ax = amat(x)
    lams = layout_sum(layout, (x.conj() * ax).real.sum(dim=0))

    def resid_norm(x, ax, lams):
        nrm = layout_norm(layout, ax - x * lams[None, :], dim=0)
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
            w = w - hmatmul(x, _reduced(layout, hmatmul(x.mH, w)))
        aw = amat(w)
        w, aw = _colnormalize((w, aw), layout)
        s = torch.cat([x, w, p], dim=1)
        a_s = torch.cat([ax, aw, ap], dim=1)
        so, aso, keep, t = _whiten(s, a_s, drop_tol, layout)
        lams, y = _rayleigh_ritz(so, aso, keep, r, layout)
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
        p_raw = p_raw - hmatmul(x_new,
                                _reduced(layout, hmatmul(x_new.mH, p_raw)))
        (p,), _, _ = _whiten_metric(p_raw, p_raw, (p_raw,), drop_tol,
                                    layout)
        ap = amat(p)
        x = x_new
        res = resid_norm(x, ax, lams)
        it += 1

    lams = sign * lams
    x = pivot_gauge(x, layout=layout)
    if not with_info:
        return lams, x
    info = LobpcgInfo(
        iterations=torch.tensor(float(it), dtype=rdt, device=dev),
        residual=res, converged=(res <= tol).to(rdt))
    return lams, x, info


def lobpcg_eigh_general(a, b, r: int = 4, *, extreme: str = "min",
                        maxiter: int = 200, tol: float = 1e-8,
                        x0: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        precond=None, with_info: bool = False, device=None):
    """Extremal eigenpairs of the generalized symmetric-definite pencil
    ``A x = lam B x`` (``B`` Hermitian positive definite) by LOBPCG with
    B-inner products (the JAX package's ``lobpcg_eigh_general``).

    The scheme of :func:`lobpcg_eigh` with the Gram whitening taken in the
    B metric (the Rayleigh-Ritz basis is B-orthonormal, so the small
    projected problem stays standard) and the residual ``R = A X - B X
    Λ``.  Each iteration is one ``A`` and one ``B`` block product of the
    new directions and both again on the conjugate directions (applied,
    not tracked).  ``x0``, ``generator``, ``precond`` (on the (N, r)
    residual block), ``with_info`` and ``device`` as in
    :func:`lobpcg_eigh`; the residual is read on the host every iteration.

    Returns ``(lams, X)`` (ascending for "min", descending for "max") with
    ``X^H B X = I`` and the pivot phase gauge, or ``(lams, X, info)``;
    ``info.residual`` is ``max_i ||A x_i - lam_i B x_i|| / max(|lam_i|,
    1)``.
    """
    a = as_operator(a)
    b = as_operator(b)
    if extreme not in ("min", "max"):
        raise ValueError(f"extreme must be min|max, got {extreme!r}")
    if a.dim != b.dim:
        raise ValueError(f"pencil dims differ: A {a.dim} vs B {b.dim}")
    dev = check_device(device, a, b)
    layout = common_layout(a, b)
    r = int(r)
    n = a.dim
    if n < 3 * r:
        raise ValueError(f"LOBPCG needs dim >= 3*r; got dim={n}, r={r}")
    dtype = a.dtype
    rdt = real_dtype(dtype)
    sign = 1.0 if extreme == "min" else -1.0
    tol = tol_floor(tol, dtype)
    drop_tol = 50.0 * float(torch.finfo(dtype).eps)

    def amat(X):
        return sign * a.matmat(X)

    x0 = _start_block(n, r, dtype, x0, generator, dev, layout)
    zeros = torch.zeros((local_dim(a), r), dtype=dtype, device=dev)
    # B-metric whitening; B(S t) = (B S) t, so the whitened block's B
    # image comes with it.
    bx0 = b.matmat(x0)
    (x, bx), _, _ = _whiten_metric(x0, bx0, (x0, bx0), drop_tol, layout)
    ax = amat(x)
    lams = layout_sum(layout, (x.conj() * ax).real.sum(dim=0))

    def resid_norm(ax, bx, lams):
        nrm = layout_norm(layout, ax - bx * lams[None, :], dim=0)
        return torch.max(nrm / torch.clamp(lams.abs(), min=1.0))

    res = resid_norm(ax, bx, lams)
    p = ap = bp = zeros
    it = 0
    while it < maxiter and float(res) > tol:
        rblk = ax - bx * lams[None, :]
        w = precond(rblk) if precond is not None else rblk
        # B-project W off span(X) twice, then unit-normalize its columns.
        for _ in range(2):
            w = w - hmatmul(x, _reduced(layout, hmatmul(bx.mH, w)))
        aw = amat(w)
        bw = b.matmat(w)
        w, aw, bw = _colnormalize((w, aw, bw), layout)
        s = torch.cat([x, w, p], dim=1)
        a_s = torch.cat([ax, aw, ap], dim=1)
        b_s = torch.cat([bx, bw, bp], dim=1)
        (so, aso, bso), keep, t = _whiten_metric(s, b_s, (s, a_s, b_s),
                                                 drop_tol, layout)
        lams, y = _rayleigh_ritz(so, aso, keep, r, layout)
        x_new, ax, bx_new = hmatmul(so, y), hmatmul(aso, y), hmatmul(bso, y)
        # The W/P part of the update in the original [X, W, P]
        # coordinates, B-projected off the new X, Euclidean-whitened for
        # scale, and both operators applied again (as in lobpcg_eigh).
        c_wp = hmatmul(t, y)
        c_wp[:r] = 0
        p_raw = hmatmul(s, c_wp)
        p_raw = p_raw - hmatmul(x_new,
                                _reduced(layout, hmatmul(bx_new.mH, p_raw)))
        (p,), _, _ = _whiten_metric(p_raw, p_raw, (p_raw,), drop_tol,
                                    layout)
        ap = amat(p)
        bp = b.matmat(p)
        x, bx = x_new, bx_new
        res = resid_norm(ax, bx, lams)
        it += 1

    lams = sign * lams
    x = pivot_gauge(x, layout=layout)
    if not with_info:
        return lams, x
    info = LobpcgInfo(
        iterations=torch.tensor(float(it), dtype=rdt, device=dev),
        residual=res, converged=(res <= tol).to(rdt))
    return lams, x, info
