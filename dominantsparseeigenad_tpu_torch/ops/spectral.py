"""Differentiable spectral functions by resolvent solves.

Counterpart of ``dominantsparseeigenad_tpu/ops/spectral.py``: the local
spectral function of a Hermitian operator seen from a probe vector b,

    A_b(ω) = -(1/π) Im <b| (ω + iη - H)^{-1} |b>
           = (η/π) <b| [(H - ω)² + η²]^{-1} |b>,

in real arithmetic: one SPD solve of ``(H - ω)² + η²`` per frequency.
JAX ``vmap``s the solve over the grid; here the m frequencies are the m
columns of one batched CG (:class:`_ResolventSquares` applies column j's
system to column j, two block products of H an iteration), through the
differentiable solve of ``cg.py`` with nothing deflated, as
``solve_spd``: its backward is one more batched CG, and the gradients
reach H's parameters, b and the frequencies.
"""

from __future__ import annotations

import math

import torch

from .cg import _DeflatedSolve
from .operators import (_Composite, _add, _product, _tangent_product,
                        as_operator, check_device, layout_bcast, layout_sum,
                        local_dim, real_dtype, vector_layout)


class _ResolventSquares(_Composite):
    """``X[:, j] -> ((A - ω_j)² + η²) X[:, j]`` on an (N, m) block, one
    frequency a column: symmetric positive definite for a Hermitian A.
    Its parameters are A's and then ``omegas``; ``eta`` is a constant."""

    _fields = ("op", "omegas")

    def __init__(self, op, omegas, eta: float):
        self.op = op
        self.omegas = omegas
        self.eta2 = float(eta) ** 2

    def _product(self, x, transpose):
        w = layout_bcast(self.vector_layout, self.omegas)[None, :]
        y = _product(self.op, x) - x * w
        return _product(self.op, y) - y * w + self.eta2 * x

    def _tangent(self, x, parts, transpose):
        """``dA Y + (A - ω) dY - Y dω``, ``Y = (A - ω) X``, ``dY = dA X -
        X dω``."""
        d_op, (d_om,) = parts
        lay = self.vector_layout
        w = layout_bcast(lay, self.omegas)[None, :]
        y = _product(self.op, x) - x * w
        dw = None if d_om is None else layout_bcast(lay, d_om)[None, :]
        dy = _tangent_product(self.op, x, d_op)
        if dw is not None:
            dy = _add(dy, -x * dw)
        out = _tangent_product(self.op, y, d_op)
        if dy is not None:
            out = _add(out, _product(self.op, dy) - dy * w)
        if dw is not None:
            out = _add(out, -y * dw)
        return out

    @property
    def dtype(self):
        return self.op.dtype


def spectral_function(op, b, omegas, eta: float, *, tol: float = 1e-8,
                      maxiter: int | None = None,
                      device=None) -> torch.Tensor:
    """A_b(ω) on a frequency grid for a Hermitian ``op``.

    op      : Hermitian LinearOperator (or dense symmetric tensor).
    b       : probe vector (need not be normalized).
    omegas  : (m,) frequency grid.
    eta     : Lorentzian broadening (> 0).
    tol / maxiter : the batched CG (each column stops at its own
              ``tol``; ``maxiter`` defaults to 10 N).

    Returns an (m,) tensor; it integrates to ``<b|b>`` over ω as η → 0.
    Differentiable in ``op.parameters()``, ``b`` and ``omegas``, to any
    order.  ``omegas`` and ``b`` are cast to the operator's (real) dtype.
    Over sharded vectors ``b`` is the rank's rows; the block CG and the
    final contraction sum over the ranks.
    """
    op = as_operator(op)
    dev = check_device(device, op)
    rdt = real_dtype(op.dtype)
    omegas = torch.as_tensor(omegas).to(device=dev, dtype=rdt)
    b = torch.as_tensor(b).to(device=dev, dtype=op.dtype)
    n, m = local_dim(op), omegas.shape[0]
    res = _ResolventSquares(op, omegas, eta)
    rhs = b[:, None].expand(n, m)
    empty = torch.zeros((n, 0), dtype=b.dtype, device=dev)
    shifts = torch.zeros(m, dtype=b.dtype, device=dev)
    y = _DeflatedSolve.apply(res, 1.0, tol, maxiter, "cg", None, rhs,
                             shifts, empty, *res.parameters())
    return (float(eta) / math.pi) * layout_sum(
        vector_layout(op), (b.conj()[:, None] * y).sum(dim=0)).real
