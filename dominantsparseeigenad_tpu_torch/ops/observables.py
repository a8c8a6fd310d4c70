"""Differentiable observables built on the eigensolver.

Counterpart of ``fidelity_susceptibility``, ``value_d1_d2`` and
``energy_curvature`` in ``dominantsparseeigenad_tpu/ops/observables.py``.
``fidelity_susceptibility`` is one forward-mode pass through
``dominant_eigh`` (its IFT ``jvp``: one Lanczos forward and one deflated
solve) giving ∂ψ/∂g.  The second derivatives are two reverse passes
through the IFT rules (see :func:`value_d1_d2`).
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from .eigh import dominant_eigh
from .operators import hdot, resolve_device


def fidelity_susceptibility(make_operator, g, *, k: int = 100,
                            tol: float = 1e-10, maxiter: int | None = None,
                            extreme: str = "min", device=None):
    """χ_F(g) = <∂ψ|∂ψ> - |<ψ|∂ψ>|² for the extremal eigenstate of
    ``make_operator(g)``.

    ``make_operator`` maps a scalar tensor to a LinearOperator whose
    parameters it enters differentiably.  ``g`` is a float or a scalar
    tensor (a float becomes float64 on ``device``, CUDA when None).  The
    pass opens a ``torch.autograd.forward_ad`` dual level, so it cannot
    run inside another one (PyTorch does not nest them).  The gauge term
    is subtracted as the JAX function does.  For a real operator the IFT
    tangent has <ψ|∂ψ> = 0 and it vanishes; for a complex Hermitian one
    the pivot-phase projection gives <ψ|∂ψ> = iα, and <∂ψ|∂ψ> alone
    would overcount by α² (the JAX package's tests measured 1.7% on a
    24-dimensional pencil).  The subtracted form is gauge-invariant.
    """
    dev = resolve_device(device)
    if isinstance(g, torch.Tensor):
        g = g.detach().to(dev)
    else:
        g = torch.tensor(float(g), dtype=torch.float64, device=dev)
    with fwAD.dual_level():
        gd = fwAD.make_dual(g, torch.ones_like(g))
        _, v = dominant_eigh(make_operator(gd), k=k, extreme=extreme,
                             tol=tol, maxiter=maxiter, device=dev)
        psi, dpsi = fwAD.unpack_dual(v)
    return hdot(dpsi, dpsi).real - hdot(psi, dpsi).abs() ** 2


def _scalar(x, dev):
    """``x`` as a fresh leaf on ``dev`` (a float becomes float64)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev).requires_grad_(True)
    return torch.tensor(float(x), dtype=torch.float64, device=dev,
                        requires_grad=True)


def value_d1_d2(f, x, *, device=None):
    """``(f(x), f'(x), f''(x))`` for a scalar ``f`` of a scalar ``x``.

    The JAX function nests two forward-mode passes (a jvp of a jvp) in
    one traced pass.  PyTorch does not nest forward-AD dual levels, so
    here it is two reverse passes over one forward:
    ``d1 = autograd.grad(f(x), x, create_graph=True)`` and
    ``d2 = autograd.grad(d1, x)``.  Through the eigensolver's IFT rules
    that is, for an eigenvalue, one Lanczos forward, a first backward
    that runs no solve (λ alone brings no eigenvector cotangent) and a
    second backward that runs one deflated solve: the JAX pass's cost,
    and no derivative through an iteration.

    ``x`` is a float (float64 on ``device``, CUDA when None) or a scalar
    tensor (on its own device when ``device`` is None), taken as a new
    leaf; the three results are detached.
    """
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    dev = resolve_device(device)
    with torch.enable_grad():
        x = _scalar(x, dev)
        val = f(x)
        (d1,) = torch.autograd.grad(val, x, create_graph=True)
        d2 = None
        if d1.requires_grad:
            (d2,) = torch.autograd.grad(d1, x, allow_unused=True)
        if d2 is None:                  # f is at most linear in x
            d2 = torch.zeros_like(x)
    return val.detach(), d1.detach(), d2.detach()


def energy_curvature(make_operator, g, *, k: int = 100, tol: float = 1e-10,
                     maxiter: int | None = None, extreme: str = "min",
                     device=None):
    """``(E(g), dE/dg, d²E/dg²)`` of the extremal eigenvalue of
    ``make_operator(g)``, the reference's ED observables for any
    operator family, through the IFT rules (:func:`value_d1_d2`: one
    Lanczos forward and one deflated solve).

    ``make_operator`` maps a scalar tensor to a LinearOperator whose
    parameters it enters differentiably; ``tol`` and ``maxiter`` bound
    the deflated CG, ``k`` the Lanczos steps.
    """
    def e(gg):
        lam, _ = dominant_eigh(make_operator(gg), k=k, extreme=extreme,
                               tol=tol, maxiter=maxiter, device=device)
        return lam

    return value_d1_d2(e, g, device=device)
