"""Differentiable observables built on the eigensolver.

Counterpart of ``fidelity_susceptibility`` in
``dominantsparseeigenad_tpu/ops/observables.py``: one forward-mode pass
through ``dominant_eigh`` (its IFT ``jvp``: one Lanczos forward and one
deflated solve) gives ∂ψ/∂g.  ``value_d1_d2`` and ``energy_curvature``
need second order and wait for it.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from .eigh import dominant_eigh
from .operators import hdot, resolve_device


def fidelity_susceptibility(make_operator, g, *, k: int = 100,
                            tol: float = 1e-10, maxiter: int | None = None,
                            extreme: str = "min", device=None):
    """χ_F(g) = <∂ψ|∂ψ> - <ψ|∂ψ>² for the extremal eigenstate of
    ``make_operator(g)``.

    ``make_operator`` maps a scalar tensor to a LinearOperator whose
    parameters it enters differentiably.  ``g`` is a float or a scalar
    tensor (a float becomes float64 on ``device``, CUDA when None).  The
    pass opens a ``torch.autograd.forward_ad`` dual level, so it cannot
    run inside another one (PyTorch does not nest them).  The gauge term
    is subtracted as the JAX function does; for a real operator the IFT
    tangent already has <ψ|∂ψ> = 0.
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
    return hdot(dpsi, dpsi) - hdot(psi, dpsi) ** 2
