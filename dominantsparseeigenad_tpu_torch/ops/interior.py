"""Interior eigenpairs by shift-invert.

Counterpart of ``dominantsparseeigenad_tpu/ops/interior.py``:
``interior_eigh(op, sigma)`` returns the eigenpair of a symmetric
(Hermitian) operator closest to the shift ``sigma``.

* Forward: Lanczos (``extreme="both"``) on the shift-inverted operator
  ``B = (A - sigma)^{-1}``, each of its matvecs an inner MINRES solve to
  ``inner_tol`` (MINRES: ``A - sigma`` is indefinite for an interior
  shift); the extremal eigenvalue of B with the larger magnitude is the
  one nearest sigma, and λ is the Rayleigh quotient of A itself.
* Derivatives: the IFT rule of ``dominant_eigh`` with the deflated solve
  run by MINRES (no sign makes the deflated restriction definite at an
  interior eigenvalue), as the ``jvp`` of :class:`_InteriorEigh` (the
  JAX ``_interior_eigh_jvp``, pivot-phase projection included) and its
  transpose as the backward, both built of differentiable operations and
  the differentiable deflated solve, so they compose to any order.
"""

from __future__ import annotations

import dataclasses

import torch

from .cg import _minres_loop, solve_deflated
from .eigh import _pivot_phase_cotangent, _pivot_phase_project
from .lanczos import lanczos_eigh
from .operators import (MatrixFreeOperator, _reduced, as_operator,
                        check_device, hdot, layout_bcast, layout_norm,
                        layout_sum, nestable_jvp, partial_vjp, per_lane_vmap,
                        rebind, vector_layout)


@dataclasses.dataclass(frozen=True)
class InteriorOptions:
    """Configuration of :func:`interior_eigh`."""

    sigma: float = 0.0
    k: int = 64
    inner_tol: float = 1e-10
    inner_maxiter: int = 1000
    tol: float = 1e-8
    maxiter: int | None = None
    seed: int = 0
    # An SPD approximate inverse of (A - sigma) for the inner MINRES
    # solves and the derivative's deflated MINRES.
    precond: object = None


def _forward(op, opts, v0, generator):
    """``(λ, v)``: the eigenpair of ``op`` nearest ``opts.sigma``."""
    sigma = opts.sigma
    layout = vector_layout(op)

    def inv_matvec(_, x):
        return _minres_loop(lambda y: op.matvec(y) - sigma * y, x,
                            opts.inner_tol, opts.inner_maxiter,
                            precond=opts.precond, layout=layout)[0]

    inv_op = MatrixFreeOperator(inv_matvec, None, dim=op.dim, dtype=op.dtype,
                                device=op.device)
    # The shift-inverted operator acts on the rank's rows, as A does.
    inv_op.vector_layout = layout
    mu_min, v_min, mu_max, v_max = lanczos_eigh(
        inv_op, min(opts.k, op.dim), extreme="both", v0=v0,
        generator=generator, device=op.device)
    v = torch.where(mu_max.abs() >= mu_min.abs(), v_max, v_min)
    v = v / layout_norm(layout, v)
    # The Rayleigh quotient of A itself (more accurate than sigma + 1/mu).
    return layout_sum(layout, hdot(v, op.matvec(v))).real.clone(), v


@per_lane_vmap
class _InteriorEigh(torch.autograd.Function):
    """Outputs ``(λ, v)``, the eigenpair nearest ``opts.sigma``."""

    @staticmethod
    def forward(op, opts, v0, generator, *params):
        return _forward(rebind(op, params), opts, v0, generator)

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, opts, _, _, *params = inputs
        ctx.op, ctx.opts = op, opts
        ctx.save_for_backward(*output, *params)
        ctx.save_for_forward(*output, *params)
        ctx.set_materialize_grads(False)

    @staticmethod
    def _saved(ctx):
        lam, v, *params = ctx.saved_tensors
        return rebind(ctx.op, params), lam, v

    @staticmethod
    def _solve(ctx, op, lam, v, b):
        opts = ctx.opts
        return solve_deflated(op, lam, v, b, method="minres", tol=opts.tol,
                              maxiter=opts.maxiter, precond=opts.precond,
                              device=op.device)

    @staticmethod
    @nestable_jvp
    def jvp(ctx, _op, _opts, _v0, _generator, *dparams):
        """``dλ = Re<v, dA v>``, ``dv = solve_deflated(A, λ, v, -(dA v -
        dλ v), method="minres")``, then the pivot-phase projection."""
        op, lam, v = _InteriorEigh._saved(ctx)
        layout = vector_layout(op)
        if all(t is None for t in dparams):
            return torch.zeros_like(lam), torch.zeros_like(v)
        dav = op.tangent_matvec(v, dparams)
        dlam = layout_sum(layout, hdot(v, dav)).real
        dv = _InteriorEigh._solve(ctx, op, lam, v,
                                  -(dav - layout_bcast(layout, dlam) * v))
        return dlam, _pivot_phase_project(v, dv, layout)

    @staticmethod
    def backward(ctx, lam_bar, v_bar):
        """The transpose of :meth:`jvp`: ``u = λ̄ v + solve_deflated(A, λ,
        v, -(I - v v^H) v̄')`` and each parameter's gradient ``u^H (∂A/∂θ)
        v``, one matvec's vjp."""
        op, lam, v = _InteriorEigh._saved(ctx)
        layout = vector_layout(op)
        if lam_bar is None and v_bar is None:
            return (None,) * (4 + len(op.parameters()))
        u = torch.zeros_like(v) if lam_bar is None \
            else layout_bcast(layout, lam_bar) * v
        if v_bar is not None:
            v_bar = _pivot_phase_cotangent(v, v_bar, layout)
            u = u + _InteriorEigh._solve(
                ctx, op, lam, v,
                -(v_bar - v * _reduced(layout, hdot(v, v_bar))))
        grads = partial_vjp(op, lambda held: held.matvec(v), [], u,
                            ctx.needs_input_grad[4:])
        return (None, None, None, None, *grads)


def interior_eigh(op, sigma: float, k: int = 64, *,
                  inner_tol: float = 1e-10, inner_maxiter: int = 1000,
                  tol: float = 1e-8, maxiter: int | None = None,
                  seed: int = 0, precond=None,
                  v0: torch.Tensor | None = None,
                  generator: torch.Generator | None = None, device=None):
    """Eigenpair of a symmetric (Hermitian) operator closest to ``sigma``,
    differentiable to any order in ``op.parameters()``, in either mode
    and under ``torch.func``.

    k       : Lanczos steps on the shift-inverted operator (clamped to
              ``op.dim``), each an inner MINRES to ``inner_tol`` (at most
              ``inner_maxiter`` iterations).
    tol / maxiter : the derivative rules' deflated MINRES.
    precond : an SPD approximate inverse of ``A - sigma`` (vector
              convention, e.g. ``jacobi_precond(op, shift=sigma)``) for
              the inner solves and the derivative solves.
    v0      : the Lanczos start vector; drawn from ``generator`` (seeded
              ``seed`` on the device when None) if not given.
    device  : where the solve runs (CUDA when None).

    Returns ``(lam, v)``, ``v`` normalized and pivot-gauged.  Over
    sharded vectors ``v`` (and ``v0``) is the rank's rows: the inner
    MINRES, the Lanczos run and the rules sum their dots over the ranks.
    """
    op = as_operator(op)
    dev = check_device(device, op)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    opts = InteriorOptions(
        sigma=float(sigma), k=int(k), inner_tol=float(inner_tol),
        inner_maxiter=int(inner_maxiter), tol=float(tol),
        maxiter=None if maxiter is None else int(maxiter), seed=int(seed),
        precond=precond)
    return _InteriorEigh.apply(op, opts, v0, generator, *op.parameters())
