"""Krylov forward engines: k-step Lanczos with full reorthogonalization,
its early-exit form, and power iteration.

Counterpart of ``lanczos``, ``lanczos_eigh``, ``lanczos_adaptive`` and
``power_iteration`` in ``dominantsparseeigenad_tpu/ops/lanczos.py``.  The
JAX loop is a ``lax.scan`` with static shapes; here it is a Python loop
over steps that writes each new basis vector into a preallocated
(k+1, N) buffer.  Gradients never flow through these loops: ``eigh.py``
wraps them in an implicit-function-theorem rule.

``arnoldi_step`` is the step shared by GMRES (``cg.py``) and the
Arnoldi-seeded non-symmetric solver (``eig.py``).  ``LanczosInfo`` is
also the block eigensolver's convergence report.

A complex Hermitian operator runs the same loops: the projections
conjugate the basis, α = Re<q, A q> and β = ||w|| are real, so the
tridiagonal T stays real (solved in float64) and the Ritz values are
real; a complex basis cannot be stored narrower (no complex bfloat16).

Profiler ranges name the step's phases as the JAX package's
``jax.named_scope`` does: ``lanczos_matvec`` around the product,
``lanczos_reorth`` around the reorthogonalization passes.

On an operator whose vectors are sharded over ranks
(``operators.vector_layout``) the loops run on the rank's rows: a
(k+1, N/p) basis, α, β and the projections summed over the ranks (so
every rank reads the same β and takes the same branch), the start,
breakdown and carried restart vectors drawn whole and narrowed, the
pivot the whole vector's.  A narrow basis sums its float32 projection
coefficients over the ranks.  α and β are marked where they enter the
rank's rows (``layout_bcast``), so a run differentiated by autograd
sums their gradients over the ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch._C._functorch import is_functorch_wrapped_tensor
from torch.profiler import record_function

from .operators import (_reduced, as_operator, check_device, hdot, hmatmul,
                        layout_bcast, layout_norm, layout_sum, local_dim,
                        outside_transforms, pivot_gauge, real_dtype,
                        tol_floor, under_vmap, vector_layout)


def _breakdown_rel_tol(real_dtype) -> float:
    """Relative beta threshold for a happy breakdown, ~100 eps of the
    working dtype (f32 ~1.2e-5, f64 ~2.2e-14)."""
    return 100.0 * float(torch.finfo(real_dtype).eps)


class LanczosResult(NamedTuple):
    """Raw k-step Lanczos factorization ``A Q ≈ Q T``.

    alphas : (k,)   diagonal of the tridiagonal T
    betas  : (k-1,) off-diagonal of T (0 where a breakdown restarted)
    basis  : (N, k) orthonormal Lanczos vectors Q, in the storage dtype
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


def arnoldi_step(mv, basis, h, j: int, layout=None):
    """One Arnoldi step: ``basis`` is (k+1, N) with rows > j zero, ``h``
    the (k+1, k) Hessenberg matrix; writes basis row ``j + 1`` and
    column ``j`` of ``h`` in place and returns ``(basis, h)``.

    Two-pass block Gram-Schmidt ("twice is enough") as products with the
    whole basis (the zero rows project out nothing), through
    :func:`~.operators.hmatmul`.  A happy breakdown (a residual of norm
    <= tiny) leaves the next row zero, and the GMRES least squares and
    the Ritz extraction see zero columns after it, as in the JAX step.
    Under a sharded ``layout`` (``operators.vector_layout``) the basis
    is (k+1, N/p), the rank's columns, and both passes' coefficients and
    the norm are summed over the ranks: h is the same on every rank.
    """
    tiny = torch.finfo(basis.dtype).tiny
    w = mv(basis[j])
    coeffs = layout_sum(layout, hmatmul(basis.conj(), w))
    w = w - hmatmul(basis.T, coeffs)
    extra = layout_sum(layout, hmatmul(basis.conj(), w))
    w = w - hmatmul(basis.T, extra)
    coeffs = coeffs + extra
    hj = layout_norm(layout, w)
    w = torch.where(hj > tiny, w / torch.clamp(hj, min=tiny),
                    torch.zeros_like(w))
    basis[j + 1] = w
    coeffs[j + 1] = hj.to(coeffs.dtype)
    h[:, j] = coeffs
    return basis, h


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


def _narrow_mm(a, b):
    """``a @ b`` for a 2-D ``a`` stored narrow (bfloat16) and a 2-D ``b``
    in the working dtype: ``b`` is rounded to ``a``'s dtype and the
    products accumulate in ``b``'s, as the JAX package's
    ``preferred_element_type`` GEMMs do.  On the card one
    ``torch.mm(..., out_dtype=)`` on the narrow operands (no widened copy
    of ``a``, which would cost back the traffic the narrow storage
    saves); it raises where cuBLAS has no such GEMM.  On the CPU, which
    has no such GEMM, the plain path widens both."""
    b_narrow = b.to(a.dtype)
    if a.device.type == "cuda":
        return torch.mm(a, b_narrow, out_dtype=b.dtype)
    return a.to(b.dtype) @ b_narrow.to(b.dtype)


def _project_out(basis, w, layout=None):
    """``w - Q Q^H w`` against the rows of ``basis`` (the coefficients
    summed over the ranks of a sharded ``layout``); a narrow-stored
    basis projects by :func:`_narrow_mm` (w and the coefficients rounded
    to the storage dtype, both products accumulated in w's)."""
    if basis.dtype == w.dtype:
        return w - hmatmul(basis.T,
                           _reduced(layout, hmatmul(basis.conj(), w)))
    coeffs = _reduced(layout, _narrow_mm(basis, w[:, None]))
    return w - _narrow_mm(basis.T, coeffs)[:, 0]


def _ritz_vector(basis, y, layout=None):
    """``Q y`` normalized, for a (N, m) ``basis`` (of any storage dtype)
    and real coefficients ``y`` in the working precision."""
    if basis.dtype.is_complex:
        v = hmatmul(basis, y.to(basis.dtype))
    elif basis.dtype == y.dtype:
        v = hmatmul(basis, y)
    else:
        v = _narrow_mm(basis, y[:, None])[:, 0]
    return v / layout_norm(layout, v)


def _draw(n, generator, dtype, dev, layout=None):
    """``n`` normal numbers from ``generator``: one plain tensor, outside
    any ``torch.func`` transform (every lane of a ``vmap`` draws the same,
    as an unbatched JAX key gives); the rank's rows of them under a
    sharded ``layout``."""
    with outside_transforms():
        if layout is not None:
            return layout.draw((n,), generator, dtype, dev)
        return torch.randn(n, generator=generator, dtype=dtype, device=dev)


def _refuse_host_reads(what: str):
    """Raise under ``torch.func.vmap``, where a host read of a batched
    test cannot run."""
    if under_vmap():
        raise RuntimeError(
            f"{what} reads a breakdown or convergence test on the host "
            f"every step, which torch.func.vmap cannot batch; call "
            f"lanczos/lanczos_eigh with restart_mode='carry' under vmap "
            f"(dominant_eigh runs each lane on its own and takes either "
            f"mode)")


def _differentiated(op) -> bool:
    """Whether a run on ``op`` is recorded for differentiation."""
    return any((torch.is_grad_enabled() and p.requires_grad)
               or is_functorch_wrapped_tensor(p) for p in op.parameters())


def _put(buf, i: int, value, batched: bool):
    """``buf`` with row ``i`` set to ``value``: in place, or out of place
    (``batched``) under ``torch.func.vmap``, where a lane's value cannot
    be written into an unbatched buffer, and where the run is
    differentiated."""
    if batched:
        return torch.cat([buf[:i], value[None].to(buf.dtype), buf[i + 1:]])
    buf[i] = value
    return buf


def _start(op, v0, generator, dev):
    """The unit start vector: ``v0`` (the rank's rows of it under a
    sharded layout), or a draw from ``generator``."""
    layout = vector_layout(op)
    if v0 is None:
        q = _draw(op.dim, generator, op.dtype, dev, layout)
    else:
        q = torch.as_tensor(v0).to(device=dev, dtype=op.dtype)
        if layout is not None and q.shape[0] != layout.local_dim:
            raise ValueError(f"v0 has {q.shape[0]} rows; vectors sharded "
                             f"over the ranks take the rank's "
                             f"{layout.local_dim} (shard_vector)")
    return q / layout_norm(layout, q)


def _step(op, basis, i, q, q_prev, beta_prev, generator, reorthogonalize,
          reorth_passes, r_perp):
    """One Lanczos step at index ``i``: returns ``(q_next, alpha, beta,
    r_perp)``, ``q_next`` the caller's ``basis[i + 1]``.  Shared by
    :func:`lanczos` and :func:`lanczos_adaptive`.

    The projections run against the rows written so far,
    ``basis[:i + 1]``: the JAX loop projects against the whole
    zero-padded buffer (or a chunk's slab of it), which gives the same
    sums.  The three-term recurrence (q, α, β) stays in the operator's
    dtype whatever the basis is stored in.

    On a breakdown (β ~ 0, an invariant subspace found) the run goes on
    with a vector orthogonal to the basis and a zero β.  With ``r_perp``
    None (restart mode "cond") the host reads β (one synchronization per
    step, the JAX ``lax.cond``) and only then draws a fresh vector from
    ``generator`` and projects it.  With a carried ``r_perp`` (mode
    "carry") the restart direction is kept orthogonal to the basis by one
    dot and one axpy per step, and the step is a ``torch.where`` select:
    no host read.
    """
    dtype = real_dtype(q.dtype)
    layout = vector_layout(op)
    with record_function("lanczos_matvec"):
        w = op.matvec(q)
    # <q, A q> is real for a Hermitian A: T stays real.
    alpha = layout_sum(layout, hdot(q, w)).real
    w = w - layout_bcast(layout, alpha) * q \
        - layout_bcast(layout, beta_prev) * q_prev
    if reorthogonalize:
        with record_function("lanczos_reorth"):
            for _ in range(reorth_passes):
                w = _project_out(basis[:i + 1], w, layout)
    beta = layout_norm(layout, w)
    scale = torch.sqrt(alpha * alpha + beta_prev * beta_prev) + 1.0
    broke = beta <= _breakdown_rel_tol(dtype) * scale
    if r_perp is None:
        if bool(broke):
            r = _draw(op.dim, generator, q.dtype, q.device, layout)
            r = _project_out(basis[:i + 1], r, layout)
            q_next = r / (layout_norm(layout, r) + torch.finfo(dtype).tiny)
            beta = torch.zeros_like(beta)
        else:
            q_next = w / layout_bcast(layout, beta)
    else:
        # A second breakdown finds r_perp consumed by its own deflation,
        # rounding junk only: the threshold turns it into a zero vector,
        # whose zero rows the caller's residual check reports (the JAX
        # package's contract; "cond" handles any number of breakdowns).
        rnorm = layout_norm(layout, r_perp)
        alive = rnorm > (float(torch.finfo(dtype).eps) * op.dim) ** 0.5
        restart = torch.where(alive, r_perp, torch.zeros_like(r_perp)) \
            / layout_bcast(layout,
                           torch.clamp(rnorm, min=torch.finfo(dtype).tiny))
        q_next = torch.where(broke, restart,
                             w / layout_bcast(layout, torch.where(
                                 broke, torch.ones_like(beta), beta)))
        r_perp = r_perp - q_next * _reduced(layout, hdot(q_next, r_perp))
        beta = torch.where(broke, torch.zeros_like(beta), beta)
    return q_next, alpha, beta, r_perp


def lanczos(op, k: int, *, v0: torch.Tensor | None = None,
            generator: torch.Generator | None = None,
            reorthogonalize: bool = True, reorth_passes: int = 2,
            reorth_chunks: int = 0, basis_dtype=None,
            restart_mode: str = "cond", device=None) -> LanczosResult:
    """Run k steps of Lanczos on a symmetric operator.

    ``v0`` is the start vector (drawn from ``generator`` when None);
    ``generator`` (seeded 0 on the device when None) also draws the
    restart vector after a breakdown ("cond"), or the carried restart
    direction ("carry").  With ``reorthogonalize`` each step projects the
    new vector ``reorth_passes`` times against the vectors written so far.

    reorth_chunks : accepted for the JAX package's signature, where C > 1
          projects per chunk of a padded buffer; the projections here
          read only the rows written so far, which gives those sums with
          no chunks and no padding.
    basis_dtype : storage dtype of the basis history (e.g.
          ``torch.bfloat16`` on a float32 operator), the run's dominant
          memory traffic.  q, α and β stay in the operator's dtype; each
          projection takes the narrow basis and accumulates in the
          operator's dtype (:func:`_narrow_mm`).  The returned basis is
          the narrow one.
    restart_mode : "cond" (default) reads β on the host every step to
          choose the breakdown restart, "carry" keeps one restart
          direction orthogonal to the basis instead and never
          synchronizes (identical results with at most one breakdown in
          the run; a second one gives zero vectors, which the caller's
          residual check reports).
    """
    op = as_operator(op)
    dev = check_device(device, op)
    dtype = op.dtype
    k = int(k)
    if k < 1:
        raise ValueError("k must be >= 1")
    if restart_mode not in ("cond", "carry"):
        raise ValueError(f"restart_mode must be 'cond'|'carry', got "
                         f"{restart_mode!r}")
    if restart_mode == "cond":
        _refuse_host_reads("lanczos(restart_mode='cond')")
    storage = dtype if basis_dtype is None else basis_dtype
    # The operator's own dtype is a no-op; only a narrowing of a complex
    # basis is refused (the JAX package's guard and message).
    if storage != dtype and dtype.is_complex:
        raise ValueError("basis_dtype is only supported for real "
                         "operators (no complex bfloat16)")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    q = _start(op, v0, generator, dev)
    int(reorth_chunks)              # the JAX package's only check
    # Row k is a scratch slot for the last step's q_next.  The buffers
    # are written out of place under vmap, and where the run is
    # differentiated (autograd recording it, or a torch.func level on the
    # parameters), as JAX differentiates its loop: an in-place row write
    # would overwrite what the backward reads.
    batched = under_vmap() or _differentiated(op)
    basis = _put(torch.zeros((k + 1, local_dim(op)), dtype=storage,
                             device=dev), 0, q, batched)
    r_perp = None
    layout = vector_layout(op)
    if restart_mode == "carry":
        r0 = _draw(op.dim, generator, dtype, dev, layout)
        r_perp = r0 - q * _reduced(layout, hdot(q, r0))
    rdt = real_dtype(dtype)
    alphas = torch.zeros(k, dtype=rdt, device=dev)
    betas = torch.zeros(k, dtype=rdt, device=dev)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((), dtype=rdt, device=dev)
    for i in range(k):
        q_next, alpha, beta, r_perp = _step(
            op, basis, i, q, q_prev, beta_prev, generator, reorthogonalize,
            reorth_passes, r_perp)
        basis = _put(basis, i + 1, q_next, batched)
        alphas = _put(alphas, i, alpha, batched)
        betas = _put(betas, i, beta, batched)
        q_prev, q, beta_prev = q, q_next, betas[i]
    return LanczosResult(alphas=alphas, betas=betas[:-1],
                         basis=basis[:k].T)


def lanczos_eigh(op, k: int, *, extreme: str = "both",
                 v0: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 reorthogonalize: bool = True, reorth_passes: int = 2,
                 reorth_chunks: int = 0, basis_dtype=None,
                 restart_mode: str = "cond", device=None):
    """Extremal eigenpair(s) of a symmetric operator via k-step Lanczos
    (options as :func:`lanczos`).

    Returns ``(lambda, v)`` for ``extreme`` "min" or "max", and
    ``(lambda_min, v_min, lambda_max, v_max)`` for "both"; each ``v`` is
    normalized and pivot-gauged (largest-magnitude entry real and
    positive).  With a narrow ``basis_dtype`` the eigenvalue keeps the
    operator's precision (it comes from T), but the eigenvector carries
    the storage rounding (~eps_bf16 / sqrt(3)): ``dominant_eigh`` polishes
    it with one step of :func:`~.eigh.refine_eigenpair`.
    """
    if extreme not in ("min", "max", "both"):
        raise ValueError(f"extreme must be min|max|both, got {extreme!r}")
    op = as_operator(op)
    res = lanczos(op, k, v0=v0, generator=generator,
                  reorthogonalize=reorthogonalize,
                  reorth_passes=reorth_passes, reorth_chunks=reorth_chunks,
                  basis_dtype=basis_dtype, restart_mode=restart_mode,
                  device=device)
    evals, evecs = _tridiagonal_eigh(res.alphas, res.betas)
    layout = vector_layout(op)

    def _pair(idx):
        return evals[idx], pivot_gauge(
            _ritz_vector(res.basis, evecs[:, idx], layout), layout=layout)

    if extreme == "min":
        return _pair(0)
    if extreme == "max":
        return _pair(k - 1)
    return _pair(0) + _pair(k - 1)


def lanczos_adaptive(op, k: int, *, extreme: str = "min",
                     tol: float = 1e-10, v0: torch.Tensor | None = None,
                     generator: torch.Generator | None = None,
                     reorthogonalize: bool = True, reorth_passes: int = 2,
                     checkpoints: tuple[int, ...] | None = None,
                     device=None):
    """Early-exit Lanczos: run until the extremal Ritz residual converges.

    The k steps are cut at ``checkpoints`` (default 16, 24, 36, ... and
    k).  At each, the extremal Ritz pair (θ, y) of the leading m × m
    tridiagonal block gives the residual estimate ``β_m |y_m| / |θ|``;
    one host read (the JAX ``lax.cond``) stops the run once it is at most
    ``tol`` (clamped to what the dtype reaches), so a conservative ``k``
    pays only the matvecs it needs.  An unconverged run is reported, not
    silent.  The (k+1, N) basis is allocated for the whole budget.

    Returns ``(lam, v, LanczosInfo)``: ``effective_k`` the steps run,
    ``residual`` the last estimate, ``converged`` 1.0 if it met ``tol``.
    """
    if extreme not in ("min", "max"):
        raise ValueError("lanczos_adaptive supports extreme='min'|'max' "
                         f"only, got {extreme!r}")
    _refuse_host_reads("lanczos_adaptive")
    op = as_operator(op)
    dev = check_device(device, op)
    dtype = op.dtype
    tol = tol_floor(tol, dtype)
    k = int(k)
    if k < 1:
        raise ValueError("k must be >= 1")
    if checkpoints is None:
        checkpoints, c = [], 16
        while c < k:
            checkpoints.append(c)
            c = max(c + 1, int(c * 3 // 2))
    cps = sorted({int(c) for c in checkpoints if 0 < int(c) < k} | {k})
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    q = _start(op, v0, generator, dev)
    basis = torch.zeros((k + 1, local_dim(op)), dtype=dtype, device=dev)
    basis[0] = q
    rdt = real_dtype(dtype)
    alphas = torch.zeros(k, dtype=rdt, device=dev)
    betas = torch.zeros(k, dtype=rdt, device=dev)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((), dtype=rdt, device=dev)
    done = 0
    for cp in cps:
        for i in range(done, cp):
            q_next, alphas[i], betas[i], _ = _step(
                op, basis, i, q, q_prev, beta_prev, generator,
                reorthogonalize, reorth_passes, None)
            basis[i + 1] = q_next
            q_prev, q, beta_prev = q, q_next, betas[i]
        done = cp
        # betas[cp - 1] couples out of the leading block: it is the
        # residual factor, not part of T.
        w, yv = _tridiagonal_eigh(alphas[:cp], betas[:cp - 1])
        j = 0 if extreme == "min" else cp - 1
        theta, y = w[j], yv[:, j]
        resid = betas[cp - 1] * torch.abs(y[cp - 1]) / torch.clamp(
            torch.abs(theta), min=torch.finfo(rdt).tiny)
        converged = resid <= tol
        # A replicated estimate (T is the same on every rank): every rank
        # stops at the same checkpoint.
        if bool(converged):
            break
    layout = vector_layout(op)
    v = pivot_gauge(_ritz_vector(basis[:done].T, y, layout), layout=layout)
    info = LanczosInfo(
        effective_k=torch.tensor(float(done), dtype=rdt, device=dev),
        residual=resid, converged=converged.to(rdt))
    return theta, v, info


def power_iteration(op, num_iters: int = 100, *,
                    v0: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    shift: float | torch.Tensor = 0.0, device=None):
    """Dominant (largest |λ|) eigenpair by ``num_iters`` steps of power
    iteration on ``A + shift I`` (a shift turns "algebraically largest"
    into "largest magnitude" for a negative definite A).

    Returns ``(lam, v)``: ``lam`` the Rayleigh quotient ``<v, A v>`` of
    ``A`` (complex for a complex operator, as in the JAX function), ``v``
    pivot-gauged.
    """
    op = as_operator(op)
    dev = check_device(device, op)
    layout = vector_layout(op)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    q = _start(op, v0, generator, dev)
    shift = layout_bcast(layout, torch.as_tensor(shift, dtype=op.dtype,
                                                 device=dev))
    for _ in range(int(num_iters)):
        w = op.matvec(q) + shift * q
        q = w / layout_bcast(layout, layout_norm(layout, w))
    return layout_sum(layout, hdot(q, op.matvec(q))), \
        pivot_gauge(q, layout=layout)
