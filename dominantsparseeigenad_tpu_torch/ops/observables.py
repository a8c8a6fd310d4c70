"""Differentiable observables built on the eigensolver.

Counterpart of ``fidelity_susceptibility``, ``value_d1_d2`` and
``energy_curvature`` in ``dominantsparseeigenad_tpu/ops/observables.py``,
in the same form: ``fidelity_susceptibility`` is one ``torch.func.jvp``
through ``dominant_eigh`` (its IFT ``jvp``: one Lanczos forward and one
deflated solve) giving ∂ψ/∂g, and the second derivatives are a
``torch.func.jvp`` of a ``torch.func.jvp`` (:func:`value_d1_d2`).  Both
run inside other transforms (``vmap``, ``grad``, another ``jvp``).
"""

from __future__ import annotations

import torch

from .eigh import dominant_eigh
from .operators import hdot, layout_sum, resolve_device, vector_layout


def _scalar(x, dev):
    """``x`` as a tensor on ``dev`` (a float becomes float64); a tensor
    keeps its own dtype and whatever transform wraps it."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.tensor(float(x), dtype=torch.float64, device=dev)


def fidelity_susceptibility(make_operator, g, *, k: int = 100,
                            tol: float = 1e-10, maxiter: int | None = None,
                            extreme: str = "min", device=None):
    """χ_F(g) = <∂ψ|∂ψ> - |<ψ|∂ψ>|² for the extremal eigenstate of
    ``make_operator(g)``.

    ``make_operator`` maps a scalar tensor to a LinearOperator whose
    parameters it enters differentiably.  ``g`` is a float or a scalar
    tensor (a float becomes float64 on ``device``, CUDA when None).  The
    pass is one ``torch.func.jvp``, so it composes with other transforms
    (``vmap`` over couplings, a ``jvp`` or ``grad`` in g).  The gauge
    term is subtracted as the JAX function does.  For a real operator
    the IFT tangent has <ψ|∂ψ> = 0 and it vanishes; for a complex
    Hermitian one the pivot-phase projection gives <ψ|∂ψ> = iα, and
    <∂ψ|∂ψ> alone would overcount by α² (the JAX package's tests
    measured 1.7% on a 24-dimensional pencil).  The subtracted form is
    gauge-invariant.  An operator whose vectors are sharded over ranks
    gives the same χ_F on every rank.
    """
    dev = resolve_device(device)
    g = _scalar(g, dev)
    layouts = []

    def psi(gg):
        op = make_operator(gg)
        layouts.append(vector_layout(op))
        _, v = dominant_eigh(op, k=k, extreme=extreme, tol=tol,
                             maxiter=maxiter, device=dev)
        return v

    v, dv = torch.func.jvp(psi, (g,), (torch.ones_like(g),))
    # Over vectors sharded across ranks the inner products are summed
    # over them.
    layout = layouts[0]
    return layout_sum(layout, hdot(dv, dv)).real \
        - layout_sum(layout, hdot(v, dv)).abs() ** 2


def value_d1_d2(f, x, *, device=None):
    """``(f(x), f'(x), f''(x))`` for a scalar ``f`` of a scalar ``x``, by
    nested forward mode, as the JAX function: the outer
    ``torch.func.jvp`` of ``z -> torch.func.jvp(f, z, 1)`` gives the
    tangents ``(f'(x), f''(x))`` in one pass.  Through the eigensolver's
    IFT rules that is, for an eigenvalue, one Lanczos forward and one
    deflated solve (the tangent of dλ = <v, dA v> needs dv), and no
    derivative through an iteration.

    ``x`` is a float (float64 on ``device``, CUDA when None) or a scalar
    tensor (on its own device when ``device`` is None); the results stay
    differentiable in whatever ``x`` carries (an outer transform's level,
    or a graph).
    """
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    x = _scalar(x, resolve_device(device))
    one = torch.ones_like(x)

    def first(z):
        return torch.func.jvp(f, (z,), (one,))

    (val, d1), (_, d2) = torch.func.jvp(first, (x,), (one,))
    return val, d1, d2


def energy_curvature(make_operator, g, *, k: int = 100, tol: float = 1e-10,
                     maxiter: int | None = None, extreme: str = "min",
                     device=None):
    """``(E(g), dE/dg, d²E/dg²)`` of the extremal eigenvalue of
    ``make_operator(g)``, the reference's ED observables for any
    operator family, by nested forward mode through the IFT rules
    (:func:`value_d1_d2`: one Lanczos forward and one deflated solve).

    ``make_operator`` maps a scalar tensor to a LinearOperator whose
    parameters it enters differentiably; ``tol`` and ``maxiter`` bound
    the deflated CG, ``k`` the Lanczos steps.
    """
    def e(gg):
        lam, _ = dominant_eigh(make_operator(gg), k=k, extreme=extreme,
                               tol=tol, maxiter=maxiter, device=device)
        return lam

    return value_d1_d2(e, g, device=device)
