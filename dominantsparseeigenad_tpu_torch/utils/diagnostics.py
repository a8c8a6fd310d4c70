"""Solver diagnostics: convergence and numerical-health metrics.

Counterpart of ``dominantsparseeigenad_tpu/utils/diagnostics.py``.  The
metrics are tensors on the solver's device (feed them to
:class:`~.logging.JsonlLogger` on the host):

* Ritz residuals ``||A v - lam v||``, the true convergence measure of an
  eigenpair (independent of the solver's internal tolerances);
* the basis orthogonality loss ``max |Q^H Q - I|``, the Lanczos failure
  mode that full reorthogonalization suppresses;
* the linear-solve residual ``||b - A x|| / ||b||``.

The guards :func:`assert_converged` and :func:`assert_converged_residual`
are ``checkify`` checks in the JAX package; here they read the host and
raise at once, with the same messages.

Over vectors sharded over ranks (``ops.operators.vector_layout``) the
vectors and the basis are the rank's rows, and every norm and the Gram
are summed over the ranks through the operator's layout, so each rank
reads the whole vector's metric (the JAX package's arrays are global).
``cg_relative_residual`` finds the layout from a bound ``op.matvec``.
"""

from __future__ import annotations

import torch

from ..ops.lanczos import LanczosResult, _tridiagonal_eigh
from ..ops.operators import (as_operator, hmatmul, layout_norm, layout_sum,
                             matvec_layout, vector_layout)


def ritz_residual(op, lam, v) -> torch.Tensor:
    """||A v - lam v|| / max(1, |lam|) for an eigenpair estimate."""
    op = as_operator(op)
    r = op.matvec(v) - lam * v
    return layout_norm(vector_layout(op), r) / torch.clamp(
        torch.abs(torch.as_tensor(lam)), min=1.0)


def orthogonality_loss(res: LanczosResult, op=None) -> torch.Tensor:
    """max |Q^H Q - I| over the Lanczos basis (0 = perfectly orthogonal).

    The conjugate transpose, not the plain one: Q^T Q of an orthonormal
    complex basis is far from the identity.  ``op``, the operator of the
    run, is needed only when its vectors are sharded over ranks (the Gram
    is then summed over them)."""
    q = res.basis
    gram = layout_sum(vector_layout(op), hmatmul(q.conj().T, q))
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    return torch.max(torch.abs(gram - eye))


def lanczos_health(op, res: LanczosResult) -> dict:
    """Health metrics of a Lanczos run (tensors on its device): the
    orthogonality loss, the Ritz residuals of both extremal pairs, the
    number of breakdowns (zero betas) and the extremal Ritz values.  T's
    eigenpairs are solved in float64, as the solver does; a basis stored
    narrower than T is widened for the Ritz vectors."""
    evals, evecs = _tridiagonal_eigh(res.alphas, res.betas)
    basis = res.basis
    if not basis.dtype.is_complex and basis.dtype != evecs.dtype:
        basis = basis.to(evecs.dtype)
    vmin = hmatmul(basis, evecs[:, 0])
    vmax = hmatmul(basis, evecs[:, -1])
    return {
        "ortho_loss": orthogonality_loss(res, op),
        "ritz_residual_min": ritz_residual(op, evals[0], vmin),
        "ritz_residual_max": ritz_residual(op, evals[-1], vmax),
        "breakdowns": torch.sum(res.betas == 0),
        "ritz_extremes": (evals[0], evals[-1]),
    }


def cg_relative_residual(matvec, b, x) -> torch.Tensor:
    """||b - A x|| / ||b|| for a linear-solve result (the norms over the
    ranks when ``matvec`` is a bound ``op.matvec`` of an operator whose
    vectors are sharded)."""
    lay = matvec_layout(matvec)
    return layout_norm(lay, b - matvec(x)) / layout_norm(lay, b)


def assert_converged(info, *, name: str = "eigensolver"):
    """Raise RuntimeError unless a solver's convergence report passed.

    ``info`` is the :class:`~..ops.lanczos.LanczosInfo` returned by
    ``dominant_eigh(..., with_info=True)`` or ``lanczos_adaptive``.  It
    reads ``info.converged`` on the host, so it cannot run under
    ``torch.func.vmap`` (read each lane's report after the transform).
    """
    if not bool(info.converged > 0):
        raise RuntimeError(
            f"{name} did not converge: residual {info.residual.item()} "
            f"after {info.effective_k.item()} steps")


def assert_converged_residual(resid, tol: float, *,
                              name: str = "linear solve"):
    """Raise RuntimeError unless ``resid <= tol`` (e.g. the
    ``relative_residual`` of ``cg_info``/``solve_deflated_info``: a run
    that hit ``maxiter`` leaves it above ``tol``; a NaN fails too).
    Reads the host, so not under ``torch.func.vmap``."""
    resid = torch.as_tensor(resid)
    if not bool(resid <= tol):
        raise RuntimeError(
            f"{name} residual {resid.item()} above tolerance {tol}")
