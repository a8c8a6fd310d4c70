"""Differentiable dominant eigensolver for symmetric operators.

Counterpart of ``dominant_eigh`` in ``dominantsparseeigenad_tpu/ops/eigh.py``
for one extremal eigenpair and first-order reverse mode.  The JAX package
registers the implicit-function-theorem rule as a JVP,

    dλ = v^T (dA) v,
    (A - λI) dv = -(I - v v^T) (dA) v,   v^T dv = 0,

and lets JAX transpose it.  Here the transpose is written out as the
backward of a ``torch.autograd.Function``, the design of the reference's
``DominantSymeig``: given the cotangents (λ̄, v̄),

    x = solve_deflated(A, λ, v, -(I - v v^T) v̄),   u = λ̄ v + x,

and the gradient of every operator parameter θ is ``u^T (∂A/∂θ) v``, taken
as ``torch.autograd.grad`` of one matvec ``A(θ) v`` with ``u`` as its
output cotangent: one matvec's cost, with no N×N matrix built.

The block solver :func:`dominant_eigh_multi` (the r extremal pairs, by
one Lanczos sweep or by LOBPCG) has the block counterpart of that rule:
for cotangents (λ̄ (r,), V̄ (N, r)), with ``W = V^T V̄`` and the broadened
gap inverses ``F[j, i] = g / (g² + gap_eps²)``, ``g = λ_i - λ_j``,
``F[i, i] = 0``,

    G = diag(λ̄) + F ∘ W,
    X[:, i] = solve_deflated(A, λ_i, V, -(I - V V^T) V̄[:, i]),
    U = V G + X,

deflated on span(V)⊥ (the whole block, so a cluster inside it stays
well conditioned) and solved by the batched CG of ``cg.py``, one matmat
per iteration; the gradient is ``autograd.grad`` of one ``A(θ) V`` with
output cotangent U.  This is the transpose of the JAX package's
``_multi_pair_tangents``.

Forward mode of :func:`dominant_eigh` (first order) is that JVP rule
itself, the JAX package's ``_pair_jvp``, as the ``jvp`` of the same
Function: under ``torch.autograd.forward_ad``, with dual tensors among
the operator's parameters,

    dA v = op.tangent_matvec(v, dθ),   dλ = v^T (dA v),
    dv = solve_deflated(A, λ, v, -(dA v - dλ v)),

one tangent product (on a ``BellOperator`` the same kernel as a matvec)
and one deflated solve.  The Lanczos loop carries no tangents: forward
AD is off inside a custom Function's forward.

Second order, forward mode of :func:`dominant_eigh_multi`,
``extreme="both"``, ``with_info`` of ``dominant_eigh``,
``restart_cycles``, ``early_exit_tol``, ``basis_dtype`` with
``refine_eigenpair``, ``reorth_chunks`` and ``precond`` wait for later
slices.
"""

from __future__ import annotations

import dataclasses

import torch

from .cg import solve_deflated
from .lanczos import LanczosInfo, _tridiagonal_eigh, lanczos, lanczos_eigh
from .lobpcg import lobpcg_eigh
from .operators import (as_operator, check_device, hdot, hmatmul,
                        pivot_gauge, tol_floor)


@dataclasses.dataclass(frozen=True)
class EighOptions:
    """Configuration of :func:`dominant_eigh`."""

    k: int = 128
    extreme: str = "min"
    tol: float = 1e-8
    maxiter: int | None = None
    reorthogonalize: bool = True
    reorth_passes: int = 2


class _DominantEigh(torch.autograd.Function):

    @staticmethod
    def forward(ctx, op, opts, v0, generator, *params):
        lam, v = lanczos_eigh(op, min(opts.k, op.dim), extreme=opts.extreme,
                              v0=v0, generator=generator,
                              reorthogonalize=opts.reorthogonalize,
                              reorth_passes=opts.reorth_passes,
                              device=op.device)
        # λ is a view into the tridiagonal's eigenvalues: forward mode
        # needs outputs that are not views of other tensors.
        lam = lam.clone()
        ctx.op, ctx.opts = op, opts
        ctx.save_for_backward(lam, v)
        ctx.save_for_forward(lam, v)
        return lam, v

    @staticmethod
    def jvp(ctx, _op, _opts, _v0, _generator, *dparams):
        """The IFT tangents (dλ, dv) for the parameters' tangents
        ``dparams`` (the JAX package's ``_pair_jvp``)."""
        op, opts = ctx.op, ctx.opts
        lam, v = ctx.saved_tensors
        if all(t is None for t in dparams):
            return torch.zeros_like(lam), torch.zeros_like(v)
        dav = op.tangent_matvec(v, dparams)
        dlam = hdot(v, dav)
        sign = 1.0 if opts.extreme == "min" else -1.0
        dv = solve_deflated(op, lam, v, -(dav - dlam * v), definite_sign=sign,
                            tol=opts.tol, maxiter=opts.maxiter,
                            device=op.device)
        return dlam, dv

    @staticmethod
    def backward(ctx, lam_bar, v_bar):
        op, opts = ctx.op, ctx.opts
        lam, v = ctx.saved_tensors
        sign = 1.0 if opts.extreme == "min" else -1.0
        b = -(v_bar - v * hdot(v, v_bar))                # -(I - v v^T) v̄
        x = solve_deflated(op, lam, v, b, definite_sign=sign, tol=opts.tol,
                           maxiter=opts.maxiter, device=op.device)
        u = lam_bar * v + x
        # u^T (dA/dθ) v: differentiate one matvec A(θ) v with output
        # cotangent u.
        grads = _parameter_grads(op, op.matvec, v, u,
                                 ctx.needs_input_grad[4:])
        return (None, None, None, None, *grads)


def _parameter_grads(op, apply, v, u, needs):
    """``u^T (∂A/∂θ) v`` for every parameter θ of ``op`` that ``needs``
    marks: ``autograd.grad`` of one ``apply(v)`` (a matvec, or a matmat
    for a block) with output cotangent ``u``."""
    params = op.parameters()
    wanted = [i for i, need in enumerate(needs) if need]
    grads = [None] * len(params)
    if wanted:
        with torch.enable_grad():
            av = apply(v.detach())
        got = torch.autograd.grad(av, [params[i] for i in wanted],
                                  grad_outputs=u, allow_unused=True)
        for i, g in zip(wanted, got):
            grads[i] = g
    return grads


def dominant_eigh(op, k: int = 128, *, extreme: str = "min",
                  tol: float = 1e-8, maxiter: int | None = None,
                  seed: int = 0, reorthogonalize: bool = True,
                  reorth_passes: int = 2, v0: torch.Tensor | None = None,
                  generator: torch.Generator | None = None, device=None):
    """Extremal eigenpair ``(λ, v)`` of a symmetric operator,
    differentiable to first order in ``op.parameters()``: reverse mode
    (``backward``) and forward mode (``torch.autograd.forward_ad`` dual
    tensors among the parameters; see the module docstring).

    op      : LinearOperator, or a dense symmetric tensor.
    k       : Lanczos steps (clamped to ``op.dim``).
    extreme : "min" or "max".
    tol     : relative residual tolerance of the deflated CG of the
              backward (or of the forward-mode tangent); ``maxiter``
              bounds its iterations (default 10 N).
    seed    : seeds the Lanczos start/restart generator when ``generator``
              is None; ``v0`` gives the start vector explicitly.
    device  : where the solve runs (CUDA when None); the operator must
              live there.

    ``v`` is normalized and sign-gauged (largest-magnitude entry
    positive).
    """
    if extreme not in ("min", "max"):
        raise ValueError(f"extreme must be min|max, got {extreme!r}")
    op = as_operator(op)
    dev = check_device(device, op)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    opts = EighOptions(k=int(k), extreme=extreme, tol=float(tol),
                       maxiter=None if maxiter is None else int(maxiter),
                       reorthogonalize=bool(reorthogonalize),
                       reorth_passes=int(reorth_passes))
    return _DominantEigh.apply(op, opts, v0, generator, *op.parameters())


@dataclasses.dataclass(frozen=True)
class EighMultiOptions:
    """Configuration of :func:`dominant_eigh_multi`."""

    r: int = 4
    k: int = 128
    extreme: str = "min"
    tol: float = 1e-8
    maxiter: int | None = None
    reorth_passes: int = 2
    gap_eps: float = 1e-12
    method: str = "lanczos"


def _multi_forward(op, opts, v0, generator):
    """``(lams, V)``: the r extremal pairs, V sign-gauged."""
    if opts.method == "lobpcg":
        # LOBPCG iterations are not bounded by the dimension: k is the
        # iteration cap, unclamped.
        return lobpcg_eigh(op, opts.r, extreme=opts.extreme,
                           maxiter=opts.k, tol=opts.tol, x0=v0,
                           generator=generator, device=op.device)
    k = min(opts.k, op.dim)
    res = lanczos(op, k, v0=v0, generator=generator,
                  reorth_passes=opts.reorth_passes, device=op.device)
    evals, evecs = _tridiagonal_eigh(res.alphas, res.betas)
    idx = torch.arange(opts.r, device=evals.device)
    if opts.extreme == "max":
        idx = k - 1 - idx
    return evals[idx], pivot_gauge(hmatmul(res.basis, evecs[:, idx]))


def _multi_forward_info(op, opts, v0, generator):
    """Forward with its :class:`LanczosInfo`: the max-over-block Ritz
    residual ``||A v - lam v|| / max(|lam|, 1)``, the LOBPCG stopping
    convention.  LOBPCG reports its own (``effective_k`` = iterations
    run, no extra matmat); the Lanczos sweep pays one width-r matmat."""
    if opts.method == "lobpcg":
        lams, v, linfo = lobpcg_eigh(
            op, opts.r, extreme=opts.extreme, maxiter=opts.k, tol=opts.tol,
            x0=v0, generator=generator, with_info=True, device=op.device)
        return lams, v, LanczosInfo(effective_k=linfo.iterations,
                                    residual=linfo.residual,
                                    converged=linfo.converged)
    lams, v = _multi_forward(op, opts, v0, generator)
    resid = torch.linalg.vector_norm(op.matmat(v) - v * lams[None, :], dim=0)
    resid = torch.max(resid / torch.clamp(lams.abs(), min=1.0))
    ref_tol = tol_floor(opts.tol, op.dtype)
    return lams, v, LanczosInfo(
        effective_k=torch.tensor(float(min(opts.k, op.dim)), dtype=v.dtype,
                                 device=v.device),
        residual=resid, converged=(resid <= ref_tol).to(v.dtype))


class _DominantEighMulti(torch.autograd.Function):

    @staticmethod
    def forward(ctx, op, opts, v0, generator, with_info, *params):
        if with_info:
            lams, v, info = _multi_forward_info(op, opts, v0, generator)
        else:
            lams, v = _multi_forward(op, opts, v0, generator)
            info = ()
        ctx.op, ctx.opts = op, opts
        ctx.save_for_backward(lams, v)
        ctx.mark_non_differentiable(*info)
        return (lams, v, *info)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            "forward mode of dominant_eigh_multi is not ported yet "
            "(ROADMAP.md queue 1 item 1); use reverse mode")

    @staticmethod
    def backward(ctx, lams_bar, v_bar, *info_bar):
        op, opts = ctx.op, ctx.opts
        lams, v = ctx.saved_tensors
        # In-block rotations: F[j, i] = g / (g² + gap_eps²), g = λ_i - λ_j,
        # finite on multiplets and exact for separated pairs.
        gap = lams[None, :] - lams[:, None]
        f = gap / (gap * gap + opts.gap_eps ** 2)
        f = f * (1.0 - torch.eye(opts.r, dtype=f.dtype, device=f.device))
        g = torch.diag(lams_bar) + f * hmatmul(v.T, v_bar)
        # Out-of-block part: one deflated solve per pair on span(V)⊥,
        # batched over the r columns.
        sign = 1.0 if opts.extreme == "min" else -1.0
        x = solve_deflated(op, lams, v, -(v_bar - hmatmul(v, hmatmul(v.T,
                                                                     v_bar))),
                           definite_sign=sign, tol=opts.tol,
                           maxiter=opts.maxiter, device=op.device)
        u = hmatmul(v, g) + x
        grads = _parameter_grads(op, op.matmat, v, u,
                                 ctx.needs_input_grad[5:])
        return (None, None, None, None, None, *grads)


def dominant_eigh_multi(op, r: int = 4, k: int = 128, *,
                        extreme: str = "min", tol: float = 1e-8,
                        maxiter: int | None = None, seed: int = 0,
                        reorth_passes: int = 2, gap_eps: float = 1e-12,
                        method: str = "lanczos", precond=None,
                        with_info: bool = False,
                        v0: torch.Tensor | None = None,
                        x0: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        device=None):
    """Top-r extremal eigenpairs of a symmetric operator, differentiable
    (first order, reverse mode) in ``op.parameters()``.

    method  : "lanczos" (one k-step sweep; ``k`` clamped to ``op.dim``,
              start vector ``v0`` (N,)) or "lobpcg" (up to ``k``
              iterations of :func:`~.lobpcg.lobpcg_eigh`, start block
              ``x0`` (N, r)); both drawn from ``generator`` (seeded
              ``seed`` on the device when None) if not given.
    extreme : "min" (ascending) or "max" (descending).
    tol     : the LOBPCG residual target and the backward's CG tolerance;
              ``maxiter`` bounds the CG's iterations (default 10 N).
    gap_eps : broadening of the in-block gap inverses.
    precond : not ported yet (raises NotImplementedError).
    device  : where the solve runs (CUDA when None).

    Returns ``(lams, V)``, lams (r,) and V (N, r) orthonormal and
    sign-gauged; with ``with_info``, ``(lams, V, info)`` where ``info`` is
    a :class:`~.lanczos.LanczosInfo` (non-differentiable) whose residual
    is the max-over-block ``||A v - lam v|| / max(|lam|, 1)``.
    """
    if extreme not in ("min", "max"):
        raise ValueError(f"extreme must be min|max, got {extreme!r}")
    if method not in ("lanczos", "lobpcg"):
        raise ValueError(f"method must be lanczos|lobpcg, got {method!r}")
    if precond is not None:
        raise NotImplementedError(
            "precond in dominant_eigh_multi waits for the preconditioned "
            "CG of a later slice")
    start = x0 if method == "lobpcg" else v0
    if (v0 if method == "lobpcg" else x0) is not None:
        raise ValueError("pass v0 (N,) for method='lanczos' and x0 (N, r) "
                         "for method='lobpcg'")
    op = as_operator(op)
    dev = check_device(device, op)
    r = int(r)
    k = int(min(k, op.dim)) if method == "lanczos" else int(k)
    if r > k:
        raise ValueError(f"need k >= r, got k={k} < r={r}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    opts = EighMultiOptions(
        r=r, k=k, extreme=extreme, tol=float(tol),
        maxiter=None if maxiter is None else int(maxiter),
        reorth_passes=int(reorth_passes), gap_eps=float(gap_eps),
        method=method)
    out = _DominantEighMulti.apply(op, opts, start, generator,
                                   bool(with_info), *op.parameters())
    if with_info:
        return out[0], out[1], LanczosInfo(*out[2:])
    return out
