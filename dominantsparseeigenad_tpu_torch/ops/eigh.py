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

Second order, forward mode, ``extreme="both"``, ``with_info``,
``restart_cycles``, ``early_exit_tol``, ``basis_dtype`` with
``refine_eigenpair`` and ``precond`` wait for later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from .cg import solve_deflated
from .lanczos import lanczos_eigh
from .operators import as_operator, check_device, hdot


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
        ctx.op, ctx.opts = op, opts
        ctx.save_for_backward(lam, v)
        return lam, v

    @staticmethod
    def backward(ctx, lam_bar, v_bar):
        op, opts = ctx.op, ctx.opts
        lam, v = ctx.saved_tensors
        sign = 1.0 if opts.extreme == "min" else -1.0
        b = -(v_bar - v * hdot(v, v_bar))                # -(I - v v^T) v̄
        x = solve_deflated(op, lam, v, b, definite_sign=sign, tol=opts.tol,
                           maxiter=opts.maxiter, device=op.device)
        u = lam_bar * v + x
        params = op.parameters()
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[4:])
                  if need]
        grads = [None] * len(params)
        if wanted:
            # u^T (dA/dθ) v: differentiate one matvec A(θ) v with output
            # cotangent u.
            with torch.enable_grad():
                av = op.matvec(v.detach())
            got = torch.autograd.grad(av, [params[i] for i in wanted],
                                      grad_outputs=u, allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g
        return (None, None, None, None, *grads)


def dominant_eigh(op, k: int = 128, *, extreme: str = "min",
                  tol: float = 1e-8, maxiter: int | None = None,
                  seed: int = 0, reorthogonalize: bool = True,
                  reorth_passes: int = 2, v0: torch.Tensor | None = None,
                  generator: torch.Generator | None = None, device=None):
    """Extremal eigenpair ``(λ, v)`` of a symmetric operator,
    differentiable (first order, reverse mode) in ``op.parameters()``.

    op      : LinearOperator, or a dense symmetric tensor.
    k       : Lanczos steps (clamped to ``op.dim``).
    extreme : "min" or "max".
    tol     : relative residual tolerance of the backward's deflated CG;
              ``maxiter`` bounds its iterations (default 10 N).
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
