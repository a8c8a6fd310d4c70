"""Spin-1/2 XXZ (Heisenberg) chain, the second quantum model family.

Counterpart of ``dominantsparseeigenad_tpu/models/heisenberg.py``: the
chain Hamiltonian (PBC)

    H = sum_i [ (J/2)(S+_i S-_{i+1} + S-_i S+_{i+1}) + Jz Sz_i Sz_{i+1} ]

applied matrix-free on the 2^n basis with the JAX package's
tensorization: the bits are split into groups of at most 7, every
exchange bond inside a group is one (2^m, 2^m) matrix contracted with
the group's axis, and the few bonds between groups (and the PBC wrap)
are 4 x 4 contractions on a pair of exposed bit axes.  Each contraction
is a matrix product through ``hmatmul`` (true fp32 on the card, never
TF32), the pin the JAX package's HIGHEST precision gives its own.

Differentiable in (J, Jz): the ground energy and its derivatives to any
order go through ``dominant_eigh``'s rules.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.eigh import dominant_eigh
from ..ops.operators import MatrixFreeOperator, hmatmul, resolve_device


def _bit_groups(n: int, max_bits: int = 7) -> list[int]:
    """Split n qubits into contiguous bit groups of <= max_bits (LSB
    first); the JAX ``models/tfim.py::_bit_groups``."""
    groups = []
    r = n
    while r > 0:
        s = min(max_bits, r)
        groups.append(s)
        r -= s
    return groups


def _zz_diagonal(n: int, dtype) -> np.ndarray:
    """sum_i Sz_i Sz_{i+1} (PBC) over the 2^n basis, Sz = diag(1,-1)/2."""
    dim = 1 << n
    idx = np.arange(dim, dtype=np.uint64)
    total = np.zeros(dim, dtype=np.float64)
    for i in range(n):
        bi = (idx >> np.uint64(i)) & np.uint64(1)
        bj = (idx >> np.uint64((i + 1) % n)) & np.uint64(1)
        total += 0.25 * (1.0 - 2.0 * bi.astype(np.float64)) * (
            1.0 - 2.0 * bj.astype(np.float64))
    return total.astype(np.dtype(dtype))


@lru_cache(maxsize=None)
def _exchange_group_matrix(m: int, bonds: tuple) -> np.ndarray:
    """(2^m, 2^m) matrix of sum over ``bonds`` (local bit pairs (i, j)) of
    the exchange term (S+_i S-_j + S-_i S+_j)/2 = half bit-pair swap."""
    dim = 1 << m
    mat = np.zeros((dim, dim), dtype=np.float64)
    s = np.arange(dim)
    for (i, j) in bonds:
        bi = (s >> i) & 1
        bj = (s >> j) & 1
        anti = bi != bj
        flipped = s ^ ((1 << i) | (1 << j))
        mat[flipped[anti], s[anti]] += 0.5
    return mat


_PAIR_EXCHANGE = np.zeros((2, 2, 2, 2))  # [I, J, i, j]: |IJ><ij| terms
_PAIR_EXCHANGE[0, 1, 1, 0] = 0.5
_PAIR_EXCHANGE[1, 0, 0, 1] = 0.5


def _contract(mat, x, axis):
    """``mat`` applied to axis ``axis`` of ``x`` (the JAX
    ``moveaxis(tensordot(mat, x, [[1], [axis]]), 0, axis)``), as one
    matrix product."""
    xm = torch.movedim(x, axis, 0)
    y = hmatmul(mat, xm.reshape(xm.shape[0], -1)).reshape(xm.shape)
    return torch.movedim(y, 0, axis)


def _apply_pair(x: torch.Tensor, n: int, p: int, q: int) -> torch.Tensor:
    """Apply the 4x4 exchange on global bits p < q of the 2^n state (the
    JAX ``einsum("IJij,aibjc->aIbJc")``)."""
    a = 1 << (n - 1 - q)
    b = 1 << (q - p - 1)
    c = 1 << p
    x5 = x.reshape(a, 2, b, 2, c).permute(1, 3, 0, 2, 4).reshape(4, -1)
    m4 = torch.as_tensor(_PAIR_EXCHANGE.reshape(4, 4), dtype=x.dtype,
                         device=x.device)
    y5 = hmatmul(m4, x5).reshape(2, 2, a, b, c).permute(2, 0, 3, 1, 4)
    return y5.reshape(-1)


def heisenberg_matvec(params, x: torch.Tensor) -> torch.Tensor:
    """y = H x for the XXZ chain; params = (j, jz, zz_diag, group_mats)."""
    j, jz, diag, group_mats = params
    n = diag.shape[0].bit_length() - 1
    groups = _bit_groups(n)
    y = (jz * diag).to(x.dtype) * x

    # Intra-group exchange: one matrix per bit group.
    shape = tuple(1 << s for s in reversed(groups))
    x3 = x.reshape(shape)
    acc = torch.zeros_like(x3)
    for axis, mat in zip(range(len(groups) - 1, -1, -1), group_mats):
        acc = acc + _contract(mat.to(x.dtype), x3, axis)
    y = y + j * acc.reshape(-1)

    # Boundary bonds: last bit of each group <-> first bit of the next,
    # plus the PBC wrap bond (n-1, 0) when n spans more than one group.
    starts = np.cumsum([0] + groups[:-1]).tolist()
    pair_acc = torch.zeros_like(x)
    for gi in range(len(groups) - 1):
        p = starts[gi] + groups[gi] - 1        # MSB of group gi
        q = starts[gi + 1]                     # LSB of group gi+1
        pair_acc = pair_acc + _apply_pair(x, n, p, q)
    if len(groups) > 1:
        pair_acc = pair_acc + _apply_pair(x, n, 0, n - 1)
    return y + j * pair_acc


def heisenberg_operator(n: int, j=1.0, jz=1.0, dtype=torch.float64,
                        device=None) -> MatrixFreeOperator:
    """Matrix-free XXZ chain Hamiltonian as a differentiable operator.

    ``j`` (transverse exchange) and ``jz`` (Ising anisotropy) are
    parameters (a tensor keeps its graph or tangent); ``jz = j`` gives
    the isotropic Heisenberg chain.
    """
    if n < 3:
        raise ValueError("need n >= 3 (PBC double-counts bonds at n=2)")
    dev = resolve_device(device)
    groups = _bit_groups(n)
    group_mats = []
    for m in groups:
        bonds = tuple((i, i + 1) for i in range(m - 1))
        # Single-group chains carry the PBC bond inside the matrix.
        if len(groups) == 1:
            bonds = bonds + ((0, m - 1),)
        group_mats.append(torch.tensor(_exchange_group_matrix(m, bonds),
                                       dtype=dtype, device=dev))
    diag = torch.as_tensor(_zz_diagonal(n, np.float64), dtype=dtype,
                           device=dev)
    params = (torch.as_tensor(j, dtype=dtype, device=dev),
              torch.as_tensor(jz, dtype=dtype, device=dev), diag,
              tuple(group_mats))
    return MatrixFreeOperator(heisenberg_matvec, params, dim=1 << n,
                              dtype=dtype)


def heisenberg_dense(n: int, j=1.0, jz=1.0, dtype=torch.float64,
                     device=None) -> torch.Tensor:
    """Dense XXZ Hamiltonian via Kronecker products (ED oracle, small n)."""
    dev = resolve_device(device)
    sp = np.array([[0.0, 1.0], [0.0, 0.0]])
    sm = sp.T
    sz = np.diag([0.5, -0.5])
    eye = np.eye(2)

    def site_op(op, i):
        mats = [eye] * n
        mats[i] = op
        full = mats[0]
        for m in mats[1:]:
            full = np.kron(full, m)
        return full

    h = np.zeros((1 << n, 1 << n))
    for i in range(n):
        ip = (i + 1) % n
        h += 0.5 * float(j) * (site_op(sp, i) @ site_op(sm, ip)
                               + site_op(sm, i) @ site_op(sp, ip))
        h += float(jz) * site_op(sz, i) @ site_op(sz, ip)
    return torch.as_tensor(h, dtype=dtype, device=dev)


def heisenberg_ground_energy(n: int, j=1.0, jz=1.0, *, k: int = 120,
                             tol: float = 1e-10, dtype=torch.float64,
                             device=None):
    """E0 of the XXZ chain through the eigensolver; differentiable in
    (j, jz) to any order, in either mode."""
    dev = resolve_device(device)
    op = heisenberg_operator(n, j, jz, dtype=dtype, device=dev)
    lam, _ = dominant_eigh(op, k=min(k, 1 << n), extreme="min", tol=tol,
                           device=dev)
    return lam
