"""Plain Krylov solvers: Lanczos with full reorthogonalization, thick-restart
Lanczos, and CG on the complement of an eigenvector.

They follow the algorithms the port documents (the same start vector,
steps, passes, windows and kept vectors), so that the Ritz pair of an
unconverged run is the same function of its inputs on both sides, and
differ only in the precision they run in.  Breakdowns do not occur at the
benchmark's sizes; one raises here rather than being handled.
"""

from __future__ import annotations

import torch


# A β this small against the step's scale would end the Krylov space;
# none occurs at the benchmark's sizes, in any precision.
BREAKDOWN = 1e-10


class Breakdown(RuntimeError):
    pass


def pivot_sign(v: torch.Tensor) -> torch.Tensor:
    """``v`` (N,) or the columns of (N, r) with the largest-magnitude
    entry made positive."""
    if v.ndim == 1:
        return v * torch.sign(v[torch.argmax(v.abs())])
    idx = torch.argmax(v.abs(), dim=0)
    return v * torch.sign(torch.gather(v, 0, idx[None]))


def _project(rows, w, prec):
    """``w - rows^T (rows w)``."""
    return w - prec.mm(rows.T, prec.mm(rows, w[:, None]))[:, 0].to(w.dtype)


def lanczos(matvec, v0, k: int, passes: int, prec):
    """``k`` Lanczos steps from ``v0``: ``(alphas, betas, rows, last)``,
    alphas (k,) and betas (k,) in float64 (betas[k-1] couples to the
    k+1-th vector), rows (k+1, N) the basis and the next vector."""
    q = prec.vec(v0)
    q = q / torch.linalg.vector_norm(q)
    n = q.shape[0]
    rows = torch.zeros((k + 1, n), dtype=prec.dtype, device=q.device)
    rows[0] = q
    alphas = torch.zeros(k, dtype=torch.float64)
    betas = torch.zeros(k, dtype=torch.float64)
    beta_prev = None
    for i in range(k):
        w = matvec(rows[i])
        a = torch.dot(rows[i], w)
        w = w - a * rows[i]
        if beta_prev is not None:
            w = w - beta_prev * rows[i - 1]
        for _ in range(passes):
            w = _project(rows[:i + 1], w, prec)
        b = torch.linalg.vector_norm(w)
        alphas[i], betas[i] = float(a), float(b)
        if float(b) <= BREAKDOWN * (abs(float(a))
                                    + abs(float(beta_prev or 0.0)) + 1.0):
            raise Breakdown(f"Lanczos broke down at step {i}")
        rows[i + 1] = w / b
        beta_prev = b
    return alphas, betas, rows


def tridiagonal_eigh(alphas, betas):
    t = torch.diag(alphas)
    if len(alphas) > 1:
        t = t + torch.diag(betas[:len(alphas) - 1], 1) \
            + torch.diag(betas[:len(alphas) - 1], -1)
    return torch.linalg.eigh(t)


def lanczos_min_pair(matvec, v0, k: int, passes: int, prec):
    """The lowest Ritz pair ``(λ, v)`` of ``k`` Lanczos steps from ``v0``:
    λ from the float64 tridiagonal, v normalized, largest entry positive."""
    alphas, betas, rows = lanczos(matvec, v0, k, passes, prec)
    evals, evecs = tridiagonal_eigh(alphas, betas)
    y = evecs[:, 0].to(rows.device)
    v = prec.mm(rows[:k].T, y[:, None])[:, 0].to(prec.dtype)
    v = v / torch.linalg.vector_norm(v)
    return float(evals[0]), pivot_sign(v)


def thick_restart_min_pair(matvec, v0, k: int, cycles: int, passes: int,
                           prec):
    """The lowest pair of thick-restart Lanczos (Wu & Simon) with a
    (k+1, N) window: a k-step run, then ``cycles`` cycles that each keep
    the ``l = max(1, k // 4)`` lowest Ritz vectors and the next Lanczos
    vector, restart the projected matrix as an arrowhead (diag(θ)
    bordered by the couplings s) and run on to k rows."""
    dev = v0.device
    l = max(1, k // 4)
    alphas, betas, rows = lanczos(matvec, v0, k, passes, prec)
    evals, evecs = tridiagonal_eigh(alphas, betas)
    sel = evecs[:, :l]
    theta = evals[:l]
    y = prec.mm(sel.T.to(dev), rows[:k]).to(prec.dtype)          # (l, N)
    # The continuation vector q_{k+1}, rebuilt by one more product and
    # projected twice off the k rows.
    qk = rows[k - 1]
    w = matvec(qk) - alphas[k - 1].item() * qk
    if k > 1:
        w = w - betas[k - 2].item() * rows[k - 2]
    w = _project(rows[:k], _project(rows[:k], w, prec), prec)
    beta = torch.linalg.vector_norm(w)
    q = w / beta
    s = float(beta) * sel[k - 1]
    for _ in range(cycles):
        slab = torch.zeros((k + 1, q.shape[0]), dtype=prec.dtype,
                           device=dev)
        slab[:l] = y
        slab[l] = q
        t = torch.zeros((k, k), dtype=torch.float64)
        t[torch.arange(l), torch.arange(l)] = theta
        t[l, :l] = s
        t[:l, l] = s
        w = matvec(slab[l])
        a = torch.dot(slab[l], w)
        w = w - a * slab[l] - prec.mm(s[None, :].to(dev), slab[:l])[0] \
            .to(prec.dtype)
        for _ in range(passes):
            w = _project(slab[:l + 1], w, prec)
        b = torch.linalg.vector_norm(w)
        slab[l + 1] = w / b
        t[l, l] = float(a)
        t[l + 1, l] = t[l, l + 1] = float(b)
        beta_prev = b
        for j in range(l + 1, k):
            w = matvec(slab[j])
            a = torch.dot(slab[j], w)
            w = w - a * slab[j] - beta_prev * slab[j - 1]
            for _ in range(passes):
                w = _project(slab[:j + 1], w, prec)
            b = torch.linalg.vector_norm(w)
            slab[j + 1] = w / b
            t[j, j] = float(a)
            if j + 1 < k:
                t[j + 1, j] = t[j, j + 1] = float(b)
            beta_prev = b
        evals, evecs = torch.linalg.eigh(t)
        theta = evals[:l]
        sel = evecs[:, :l]
        y = prec.mm(sel.T.to(dev), slab[:k]).to(prec.dtype)
        s = float(beta_prev) * sel[k - 1]
        q = slab[k].clone()
    v = y[0] / torch.linalg.vector_norm(y[0])
    return float(theta[0]), pivot_sign(v)


def deflated_cg(matvec, lam: float, v, b, tol: float, maxiter: int):
    """x with ``(I - v v^T)(A - λ)(I - v v^T) x = b``, b orthogonal to v,
    by CG from zero until ``||r|| <= tol ||b||``: the tangent of an
    eigenvector.  Returns ``(x, iterations)``."""
    def proj(z):
        return z - v * torch.dot(v, z)

    b = proj(b)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    stop = tol * float(torch.linalg.vector_norm(b))
    for it in range(1, maxiter + 1):
        ap = proj(matvec(p) - lam * p)
        alpha = rr / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = torch.dot(r, r)
        if float(rr_new) ** 0.5 <= stop:
            return x, it
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x, maxiter
