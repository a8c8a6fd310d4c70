"""Plain LOBPCG (Knyazev 2001, with the basis hygiene of Duersch, Shao and
Yang 2018) for the r lowest eigenpairs of a symmetric operator.

It is the iteration the port documents: the search subspace [X, W, P]
whitened through its Gram matrix, near-null directions masked out and
pushed above the spectrum in the Rayleigh-Ritz step, W projected twice
off X and its columns normalized, P rebuilt from the W and P part of the
update and applied again, the residual read every iteration.  Its two
thresholds, the whitening drop tolerance and the stopping tolerance, are
those the configuration's float32 sets, so that an unconverged block is
the same function of its start on both sides.
"""

from __future__ import annotations

import torch

from .krylov import pivot_sign


def _whiten(s, ms, companions, drop_tol, prec):
    g = prec.mm(s.T, ms)
    g = 0.5 * (g + g.T)
    d, u = torch.linalg.eigh(g)
    tiny = torch.finfo(d.dtype).tiny
    keep = d > drop_tol * torch.clamp(d[-1], min=tiny)
    scale = torch.where(keep, torch.rsqrt(torch.clamp(d, min=tiny)),
                        torch.zeros_like(d))
    t = u * scale[None, :]
    return [prec.mm(c, t).to(prec.dtype) for c in companions], keep, t


def _rayleigh_ritz(so, aso, keep, r, prec):
    t = prec.mm(so.T, aso)
    t = 0.5 * (t + t.T)
    big = 2.0 * torch.linalg.matrix_norm(t) + 1.0
    penalty = torch.where(keep, torch.zeros_like(big), big)
    evals, evecs = torch.linalg.eigh(t + torch.diag(penalty))
    return evals[:r], evecs[:, :r]


def _colnormalize(w, aw):
    nrm = torch.linalg.vector_norm(w, dim=0)
    tiny = torch.finfo(nrm.dtype).tiny
    scl = torch.where(nrm > tiny, 1.0 / torch.clamp(nrm, min=tiny),
                      torch.zeros_like(nrm))
    return w * scl[None, :], aw * scl[None, :]


def lobpcg_min(matmat, x0, maxiter: int, tol: float, drop_tol: float,
               prec):
    """``(lams, X, iterations)``: the r = x0.shape[1] lowest Ritz pairs
    after at most ``maxiter`` iterations from the start block ``x0``, X's
    columns with their largest entry positive.  Small eigenproblems run
    in the precision's dtype (float32 for "tf32")."""
    x0 = prec.vec(x0)
    r = x0.shape[1]
    zeros = torch.zeros_like(x0)
    (x,), _, _ = _whiten(x0, x0, [x0], drop_tol, prec)
    ax = matmat(x)

    def resid(x, ax, lams):
        nrm = torch.linalg.vector_norm(ax - x * lams[None, :], dim=0)
        return float(torch.max(nrm / torch.clamp(lams.abs(), min=1.0)))

    lams = (x * ax).sum(dim=0)
    res = resid(x, ax, lams)
    p = ap = zeros
    it = 0
    while it < maxiter and res > tol:
        w = ax - x * lams[None, :]
        for _ in range(2):
            w = w - prec.mm(x, prec.mm(x.T, w)).to(prec.dtype)
        aw = matmat(w)
        w, aw = _colnormalize(w, aw)
        s = torch.cat([x, w, p], dim=1)
        a_s = torch.cat([ax, aw, ap], dim=1)
        (so, aso), keep, t = _whiten(s, s, [s, a_s], drop_tol, prec)
        lams, y = _rayleigh_ritz(so, aso, keep, r, prec)
        x_new = prec.mm(so, y).to(prec.dtype)
        ax = prec.mm(aso, y).to(prec.dtype)
        c_wp = prec.mm(t, y)
        c_wp[:r] = 0
        p_raw = prec.mm(s, c_wp).to(prec.dtype)
        p_raw = p_raw - prec.mm(x_new, prec.mm(x_new.T, p_raw)) \
            .to(prec.dtype)
        (p,), _, _ = _whiten(p_raw, p_raw, [p_raw], drop_tol, prec)
        ap = matmat(p)
        x = x_new
        res = resid(x, ax, lams)
        it += 1
    return lams.double().cpu(), pivot_sign(x), it
