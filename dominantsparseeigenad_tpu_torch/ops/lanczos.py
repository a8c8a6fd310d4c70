"""k-step Lanczos with full reorthogonalization.

Counterpart of ``lanczos``/``lanczos_eigh`` in
``dominantsparseeigenad_tpu/ops/lanczos.py``.  The JAX loop is a
``lax.scan`` with static shapes; here it is a Python loop over steps
that writes each new basis vector into a preallocated (k+1, N) buffer.
Gradients never flow through this loop: ``eigh.py`` wraps it in an
implicit-function-theorem rule.

Not ported yet: ``reorth_chunks``, ``basis_dtype``,
``restart_mode="carry"``, ``lanczos_adaptive``, ``power_iteration`` and
``arnoldi_step``.  ``LanczosInfo`` is here for the block eigensolver's
convergence report.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .operators import as_operator, check_device, hdot, hmatmul, pivot_gauge


def _breakdown_rel_tol(real_dtype) -> float:
    """Relative beta threshold for a happy breakdown, ~100 eps of the
    working dtype (f32 ~1.2e-5, f64 ~2.2e-14)."""
    return 100.0 * float(torch.finfo(real_dtype).eps)


class LanczosResult(NamedTuple):
    """Raw k-step Lanczos factorization ``A Q ≈ Q T``.

    alphas : (k,)   diagonal of the tridiagonal T
    betas  : (k-1,) off-diagonal of T (0 where a breakdown restarted)
    basis  : (N, k) orthonormal Lanczos vectors Q
    """

    alphas: torch.Tensor
    betas: torch.Tensor
    basis: torch.Tensor


class LanczosInfo(NamedTuple):
    """Convergence report of a solve (float scalar tensors).

    effective_k : steps (or block iterations) actually run
    residual    : Ritz residual, relative (see the function that returns it)
    converged   : 1.0 if the residual test passed
    """

    effective_k: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor


def _tridiagonal(alphas, betas):
    t = torch.diag(alphas)
    if alphas.shape[0] > 1:
        t = t + torch.diag(betas, 1) + torch.diag(betas, -1)
    return t


def _tridiagonal_eigh(alphas, betas):
    """Eigenpairs ``(evals, evecs)`` of the tridiagonal T, ascending,
    computed in float64 and returned in the working dtype.  cuSOLVER's
    float32 ``eigh`` of a 60 x 60 T on an H100 put λ_min 6.6e-6 (relative)
    off the float64 eigenvalue of the same T, 50 times float32 round-off;
    T is small, so the float64 solve costs nothing that matters."""
    evals, evecs = torch.linalg.eigh(_tridiagonal(alphas.double(),
                                                  betas.double()))
    return evals.to(alphas.dtype), evecs.to(alphas.dtype)


def _project_out(basis, w):
    """``w - Q Q^T w`` against the rows of ``basis``."""
    return w - hmatmul(basis.T, hmatmul(basis, w))


def lanczos(op, k: int, *, v0: torch.Tensor | None = None,
            generator: torch.Generator | None = None,
            reorthogonalize: bool = True, reorth_passes: int = 2,
            device=None) -> LanczosResult:
    """Run k steps of Lanczos on a symmetric operator.

    ``v0`` is the start vector (drawn from ``generator`` when None);
    ``generator`` (seeded 0 on the device when None) also draws the restart
    vector after a breakdown.  With ``reorthogonalize`` each step projects
    the new vector ``reorth_passes`` times against the vectors written so
    far, ``basis[:i+1]``: the JAX loop projects against the whole
    zero-padded buffer, which gives the same sums.

    Each step reads ``beta`` on the host (one synchronization) to choose
    between the next Lanczos vector and a breakdown restart, the choice
    the JAX loop makes with ``lax.cond``.  The read waits for the step's
    own work, so the card idles for the host time of the next step's
    launches, small against a step's SpMV at the sizes this targets.
    """
    op = as_operator(op)
    dev = check_device(device, op)
    n, dtype = op.dim, op.dtype
    k = int(k)
    if k < 1:
        raise ValueError("k must be >= 1")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if v0 is None:
        q = torch.randn(n, generator=generator, dtype=dtype, device=dev)
    else:
        q = torch.as_tensor(v0).to(device=dev, dtype=dtype)
    q = q / torch.linalg.vector_norm(q)

    basis = torch.zeros((k + 1, n), dtype=dtype, device=dev)
    basis[0] = q
    alphas = torch.zeros(k, dtype=dtype, device=dev)
    betas = torch.zeros(k, dtype=dtype, device=dev)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((), dtype=dtype, device=dev)
    rel_tol = _breakdown_rel_tol(dtype)
    for i in range(k):
        w = op.matvec(q)
        alpha = hdot(q, w)
        w = w - alpha * q - beta_prev * q_prev
        if reorthogonalize:
            for _ in range(reorth_passes):
                w = _project_out(basis[:i + 1], w)
        beta = torch.linalg.vector_norm(w)
        scale = torch.sqrt(alpha * alpha + beta_prev * beta_prev) + 1.0
        if bool(beta <= rel_tol * scale):
            # Breakdown: an invariant subspace was found.  Go on with a
            # random vector orthogonal to the basis, and a zero beta.
            r = torch.randn(n, generator=generator, dtype=dtype, device=dev)
            r = _project_out(basis[:i + 1], r)
            q_next = r / (torch.linalg.vector_norm(r)
                          + torch.finfo(dtype).tiny)
            beta = torch.zeros_like(beta)
        else:
            q_next = w / beta
        alphas[i] = alpha
        betas[i] = beta
        basis[i + 1] = q_next
        q_prev, q, beta_prev = q, q_next, beta
    return LanczosResult(alphas=alphas, betas=betas[:-1],
                         basis=basis[:k].T)


def lanczos_eigh(op, k: int, *, extreme: str = "both",
                 v0: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 reorthogonalize: bool = True, reorth_passes: int = 2,
                 device=None):
    """Extremal eigenpair(s) of a symmetric operator via k-step Lanczos.

    Returns ``(lambda, v)`` for ``extreme`` "min" or "max", and
    ``(lambda_min, v_min, lambda_max, v_max)`` for "both"; each ``v`` is
    normalized and sign-gauged (largest-magnitude entry positive).
    """
    if extreme not in ("min", "max", "both"):
        raise ValueError(f"extreme must be min|max|both, got {extreme!r}")
    op = as_operator(op)
    res = lanczos(op, k, v0=v0, generator=generator,
                  reorthogonalize=reorthogonalize,
                  reorth_passes=reorth_passes, device=device)
    evals, evecs = _tridiagonal_eigh(res.alphas, res.betas)

    def _pair(idx):
        v = hmatmul(res.basis, evecs[:, idx])
        return evals[idx], pivot_gauge(v / torch.linalg.vector_norm(v))

    if extreme == "min":
        return _pair(0)
    if extreme == "max":
        return _pair(k - 1)
    return _pair(0) + _pair(k - 1)
