"""Transverse-field Ising model (TFIM), the paper's flagship.

Counterpart of ``dominantsparseeigenad_tpu/models/tfim.py`` but its
sharded operator:
the 2^N-dimensional Hamiltonian

    H(g) = - sum_i sz_i sz_{i+1}  -  g * sum_i sx_i     (PBC)

matrix-free (a precomputed zz diagonal, and the transverse term as N
single-spin flips of the state), as a dense matrix for exact
diagonalization at small N, and the Jordan-Wigner closed forms for
validation where ED is impossible (N = 20: dim 2^20).  The observables go
through the eigensolver: E0 and its derivatives from ``dominant_eigh``
in either AD mode and to any order (d²E0/dg² by ``energy_curvature``, a
jvp of a jvp), χ_F from one forward-mode pass.

The JAX ``flip_sum`` contracts groups of up to 7 bits with hypercube
adjacency matrices, a device for the TPU's matrix unit; here each flip is
a reversed view, ``x.view(2**(n-1-i), 2, 2**i).flip(1)``, and a block of
m states (2^N, m) flips as a (2^(N-1-i), 2, 2^i, m) view: the operator's
``matmat`` is one pass over the block (what the JAX ``jax.vmap`` of the
matvec gives), not m matvecs.  No Pallas kernel is on this path, so none
is owed.

``tfim_observables_sweep`` is ``torch.func.vmap`` of one forward-mode
pass, as the JAX function, and ``tfim_energy_gap`` the block solver with
r = 2.  The 2D model on an lx × ly periodic square lattice
(``tfim2d_operator``) shares the transverse term; only its zz diagonal
differs.  ``tfim_sharded_operator`` splits the state over the ranks of a
process group (``parallel/``): the low spin flips stay on the rank's
segment, and each high-bit flip swaps whole segments with the XOR
partner rank (``parallel.collectives.ppermute``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.eigh import dominant_eigh, dominant_eigh_multi
from ..ops.observables import fidelity_susceptibility as _chi
from ..ops.operators import _BlockMatrixFreeOperator, hdot, resolve_device
from ..ops.spans import span
from ..parallel.collectives import ppermute
from ..parallel.mesh import SHARD_AXIS, make_mesh
from ..parallel.sharded import ShardedMatrixFreeOperator


def tfim_zz_diagonal(n: int, dtype=torch.float64, device=None):
    """Diagonal of -sum_i sz_i sz_{i+1} (PBC) over the 2^n basis.

    Basis state j has spin s_i = 1 - 2 bit_i(j); an anti-aligned pair
    adds +1, an aligned one -1.
    """
    if n < 3:
        # The JAX guard: the PBC ring visits its single (n=2) bond from
        # both ends, and n=1 bonds a site to itself.
        raise ValueError(f"need n >= 3 (PBC double-counts bonds at n=2, "
                         f"self-bonds at n=1); got n={n}")
    dev = resolve_device(device)
    idx = torch.arange(1 << n, dtype=torch.int64, device=dev)
    n_anti = torch.zeros(1 << n, dtype=dtype, device=dev)
    for i in range(n):
        bi = (idx >> i) & 1
        bj = (idx >> ((i + 1) % n)) & 1
        n_anti = n_anti + (bi ^ bj).to(dtype)
    # -sum sz sz = -((n - n_anti) - n_anti) = 2 n_anti - n
    return 2.0 * n_anti - n


def flip_sum(x: torch.Tensor, n: int) -> torch.Tensor:
    """sum_i flip_i(x): every single-spin flip of the 2^n state (or of
    each column of a (2^n, m) block), summed.  Flipping spin i maps basis
    index j to j XOR 2^i, which reverses the middle axis of the
    (2^(n-1-i), 2, 2^i[, m]) view; a block's columns get the same adds
    in the same order as one state's, bit for bit."""
    tail = tuple(x.shape[1:])
    out = torch.zeros_like(x)
    for i in range(n):
        out = out + x.reshape(1 << (n - 1 - i), 2, 1 << i, *tail).flip(1) \
            .reshape(x.shape)
    return out


def tfim_matvec(params, x: torch.Tensor) -> torch.Tensor:
    """y = H(g) x, matrix-free, for a state (2^n,) or a block (2^n, m).
    params = (g, zz_diagonal).  Each call is one ``tfim_matvec`` range
    while a profiler records, whichever solver makes the product."""
    g, diag = params
    n = diag.shape[0].bit_length() - 1
    with span("tfim_matvec"):
        d = diag.to(x.dtype)
        return (d if x.ndim == 1 else d[:, None]) * x - g * flip_sum(x, n)


def _coupling(g, dtype, dev):
    """``g`` as a scalar tensor of ``dtype`` on ``dev``, differentiably
    (a dual or requires-grad tensor keeps its tangent or graph)."""
    return torch.as_tensor(g, dtype=dtype, device=dev)


def tfim_operator(n: int, g, dtype=torch.float64,
                  device=None) -> _BlockMatrixFreeOperator:
    """Matrix-free TFIM Hamiltonian; its parameters are ``(g, diag)``, as
    in JAX, and derivatives in ``g`` go through ``tfim_matvec``.  Its
    ``matmat`` is one pass of ``tfim_matvec`` over the block."""
    dev = resolve_device(device)
    diag = tfim_zz_diagonal(n, dtype=dtype, device=dev)
    return _BlockMatrixFreeOperator(tfim_matvec,
                                    (_coupling(g, dtype, dev), diag),
                                    dim=1 << n, dtype=dtype)


def tfim_sharded_operator(n: int, g, group=None, *, dtype=torch.float64,
                          device=None,
                          vectors: str = "replicated"
                          ) -> ShardedMatrixFreeOperator:
    """TFIM Hamiltonian as a row-sharded matrix-free operator.

    The 2^n-dimensional state is split over the ``p = 2^d`` ranks of
    ``group`` (a :class:`~..parallel.mesh.ShardGroup`, default
    :func:`~..parallel.mesh.make_mesh`): a rank holds the amplitudes
    whose top ``d`` basis bits equal its index.  On the rank's segment,

    * the zz diagonal term and the ``m = n - d`` low-bit spin flips are
      local (:func:`flip_sum` of the segment);
    * each of the ``d`` high-bit flips swaps whole segments between XOR
      partner ranks, one :func:`~..parallel.collectives.ppermute` each.

    Its parameters are ``(g, the rank's rows of the zz diagonal)``;
    derivatives in ``g`` of any order, in either mode, go through the
    exchange.  ``vectors`` as in
    :class:`~..parallel.ShardedMatrixFreeOperator`: with "sharded" a
    product takes and gives the rank's segment, and no gather of the
    result is made.  The counterpart of the JAX
    ``tfim_sharded_operator``.
    """
    sg = make_mesh() if group is None else group
    p = sg.size
    d = p.bit_length() - 1
    if (1 << d) != p:
        raise ValueError(f"shard count {p} must be a power of two")
    if d > n:
        raise ValueError(f"cannot split 2^{n} states over 2^{d} shards")
    m = n - d   # local qubits
    dev = resolve_device(device)
    perms = [tuple((s, s ^ (1 << b)) for s in range(p)) for b in range(d)]

    def local_matvec(params, x_local):
        gg, diag_local = params
        dl = diag_local.to(x_local.dtype)
        y = (dl if x_local.ndim == 1 else dl[:, None]) * x_local
        flips = flip_sum(x_local, m)
        for perm in perms:   # high-bit flips: XOR-partner segment swaps
            flips = flips + ppermute(x_local, sg, perm)
        return y - gg * flips

    diag = tfim_zz_diagonal(n, dtype=dtype, device=dev)
    return ShardedMatrixFreeOperator(
        local_matvec, (_coupling(g, dtype, dev), diag), 1 << n, sg,
        dtype=dtype, param_specs=(None, SHARD_AXIS), vectors=vectors)


def tfim_dense_hamiltonian(n: int, g, dtype=torch.float64, device=None):
    """Full 2^n x 2^n TFIM matrix (exact diagonalization; small n only)."""
    dev = resolve_device(device)
    dim = 1 << n
    idx = np.arange(dim)
    hx = np.zeros((dim, dim))
    for i in range(n):
        hx[idx, idx ^ (1 << i)] += 1.0
    hx = torch.as_tensor(hx, dtype=dtype, device=dev)
    return (torch.diag(tfim_zz_diagonal(n, dtype=dtype, device=dev))
            - _coupling(g, dtype, dev) * hx)


def tfim2d_zz_diagonal(lx: int, ly: int, dtype=torch.float64, device=None):
    """Diagonal of -sum_<ij> sz_i sz_j on an lx x ly periodic square
    lattice (site (x, y) -> bit x + lx*y), over the 2^(lx*ly) basis."""
    if lx < 3 or ly < 3:
        # The JAX guard: a torus dimension below 3 double-counts its
        # wrapped bonds (and bonds a site to itself at length 1).
        raise ValueError("need lx, ly >= 3 (a torus dimension of 2 "
                         f"double-counts its wrapped bonds); got "
                         f"({lx}, {ly})")
    dev = resolve_device(device)
    n = lx * ly
    idx = torch.arange(1 << n, dtype=torch.int64, device=dev)
    n_anti = torch.zeros(1 << n, dtype=dtype, device=dev)
    for y in range(ly):
        for x in range(lx):
            p = x + lx * y
            for q in (((x + 1) % lx) + lx * y, x + lx * ((y + 1) % ly)):
                n_anti = n_anti + (((idx >> p) ^ (idx >> q)) & 1).to(dtype)
    # 2 bonds per site; -sum sz sz = 2 n_anti - n_bonds
    return 2.0 * n_anti - 2 * n


def tfim2d_operator(lx: int, ly: int, g, dtype=torch.float64,
                    device=None) -> _BlockMatrixFreeOperator:
    """Matrix-free 2D TFIM on an lx x ly periodic square lattice: the
    transverse term is site-local, so ``tfim_matvec`` (and its block
    pass) applies unchanged; only the zz diagonal differs."""
    dev = resolve_device(device)
    diag = tfim2d_zz_diagonal(lx, ly, dtype=dtype, device=dev)
    return _BlockMatrixFreeOperator(tfim_matvec,
                                    (_coupling(g, dtype, dev), diag),
                                    dim=1 << (lx * ly), dtype=dtype)


def tfim2d_dense_hamiltonian(lx: int, ly: int, g, dtype=torch.float64,
                             device=None):
    """Dense 2D TFIM (exact diagonalization; tiny lattices only)."""
    dev = resolve_device(device)
    n = lx * ly
    dim = 1 << n
    idx = np.arange(dim)
    hx = np.zeros((dim, dim))
    for i in range(n):
        hx[idx, idx ^ (1 << i)] += 1.0
    return (torch.diag(tfim2d_zz_diagonal(lx, ly, dtype=dtype, device=dev))
            - _coupling(g, dtype, dev) * torch.as_tensor(hx, dtype=dtype,
                                                         device=dev))


# ---------------------------------------------------------------------------
# Jordan-Wigner closed forms (even N, PBC)
# ---------------------------------------------------------------------------

def _jw_momenta(n: int) -> np.ndarray:
    """The ground state's momenta k = (2m + 1) π / N, m = 0..N-1 (the
    even-parity, antiperiodic sector)."""
    return (2 * np.arange(n) + 1) * np.pi / n


def tfim_exact_e0(n: int, g, device=None):
    """Exact finite-N ground energy, E0 = -Σ_k sqrt(1 + g² - 2 g cos k),
    as a tensor differentiable in ``g`` (a float becomes float64)."""
    dev = resolve_device(device)
    if not isinstance(g, torch.Tensor):
        g = torch.tensor(float(g), dtype=torch.float64)
    g = g.to(dev)
    cos_k = torch.as_tensor(np.cos(_jw_momenta(n)), dtype=g.dtype,
                            device=dev)
    return -torch.sum(torch.sqrt(1.0 + g * g - 2.0 * g * cos_k))


def tfim_exact_de0_dg(n: int, g: float) -> float:
    """dE0/dg of :func:`tfim_exact_e0` in numpy float64:
    -Σ_k (g - cos k) / ε_k, ε_k = sqrt(1 + g² - 2 g cos k)."""
    k = _jw_momenta(n)
    eps = np.sqrt(1.0 + g * g - 2.0 * g * np.cos(k))
    return float(-np.sum((g - np.cos(k)) / eps))


def tfim_exact_d2e0_dg2(n: int, g: float) -> float:
    """d²E0/dg² of :func:`tfim_exact_e0` in numpy float64:
    -Σ_k sin²k / ε_k³."""
    k = _jw_momenta(n)
    eps = np.sqrt(1.0 + g * g - 2.0 * g * np.cos(k))
    return float(-np.sum(np.sin(k) ** 2 / eps ** 3))


def tfim_exact_chi_f(n: int, g: float) -> float:
    """Fidelity susceptibility of the ground state in numpy float64:
    χ_F = ¼ Σ_{k ∈ (0, π)} sin²k / ε_k⁴ (equal to the ED χ_F of
    :func:`tfim_ed_observables`)."""
    k = _jw_momenta(n)
    k = k[k < np.pi]
    eps2 = 1.0 + g * g - 2.0 * g * np.cos(k)
    return float(0.25 * np.sum(np.sin(k) ** 2 / eps2 ** 2))


# ---------------------------------------------------------------------------
# Observables through the eigensolver
# ---------------------------------------------------------------------------

def tfim_ground_energy(n: int, g, *, k: int = 100, tol: float = 1e-10,
                       dtype=torch.float64, device=None):
    """E0(g) through the matrix-free Lanczos eigensolver, differentiable
    in ``g`` to any order in either mode (``create_graph=True``, or
    ``torch.func`` transforms nested at will)."""
    lam, _ = tfim_ground_state(n, g, k=k, tol=tol, dtype=dtype,
                               device=device)
    return lam


def tfim_ground_state(n: int, g, *, k: int = 100, tol: float = 1e-10,
                      dtype=torch.float64, device=None):
    """(E0, |ψ0>) through the eigensolver, differentiable to any order
    in either mode."""
    dev = resolve_device(device)
    return dominant_eigh(tfim_operator(n, g, dtype=dtype, device=dev),
                         k=min(k, 1 << n), extreme="min", tol=tol,
                         device=dev)


def fidelity_susceptibility(n: int, g, *, k: int = 100, tol: float = 1e-10,
                            dtype=torch.float64, device=None):
    """χ_F(g) of the TFIM ground state, by the generic
    :func:`~..ops.observables.fidelity_susceptibility` (one forward-mode
    pass)."""
    dev = resolve_device(device)
    return _chi(lambda gg: tfim_operator(n, gg, dtype=dtype, device=dev),
                _coupling(g, dtype, dev), k=min(k, 1 << n), tol=tol,
                device=dev)


def tfim_energy_gap(n: int, g, *, k: int = 100, tol: float = 1e-10,
                    dtype=torch.float64, device=None):
    """Many-body gap E1 - E0 by the block solver (r = 2), matrix-free and
    differentiable in ``g``; it closes at the critical point g = 1."""
    dev = resolve_device(device)
    lams, _ = dominant_eigh_multi(
        tfim_operator(n, g, dtype=dtype, device=dev), r=2,
        k=min(k, 1 << n), tol=tol, device=dev)
    return lams[1] - lams[0]


def tfim_observables_sweep(n: int, gs, *, k: int = 100, tol: float = 1e-10,
                           maxiter: int | None = None, dtype=torch.float64,
                           device=None, **eigh_kwargs):
    """(E0, dE0/dg, χ_F) over a sequence of couplings ``gs``, as the JAX
    function computes it: ``torch.func.vmap`` of one ``torch.func.jvp``
    pass through ``dominant_eigh`` (its IFT tangent gives dE0/dg and
    ∂ψ/∂g), χ_F = <∂ψ|∂ψ> - |<ψ|∂ψ>|².

    Returns a (len(gs), 3) tensor on the device, stacked there and read
    by nothing here.  Other keyword arguments go to
    :func:`~..ops.eigh.dominant_eigh` (e.g. ``basis_dtype=torch.bfloat16,
    reorth_chunks=8``).  ``restart_mode`` keeps ``dominant_eigh``'s
    default, "cond", where the JAX function sets "carry": the solver's
    ``vmap`` rule runs each lane's Lanczos on its own (the host reads of
    "cond" are allowed there, and no lane pays the other mode's per-step
    work), and on the H100 "carry" was the slower step in all four of
    PR 9's readings (launch-bound steps, ``PERF.md``).  The zz diagonal
    is built once for the whole sweep.
    """
    dev = resolve_device(device)
    diag = tfim_zz_diagonal(n, dtype=dtype, device=dev)
    gs = torch.as_tensor(gs, dtype=dtype).to(dev)
    kk = min(k, 1 << n)

    def one(g):
        def ground(gg):
            op = _BlockMatrixFreeOperator(tfim_matvec, (gg, diag),
                                          dim=1 << n, dtype=dtype)
            return dominant_eigh(op, k=kk, extreme="min", tol=tol,
                                 maxiter=maxiter, device=dev, **eigh_kwargs)

        (lam, v), (dlam, dv) = torch.func.jvp(ground, (g,),
                                              (torch.ones_like(g),))
        chi = hdot(dv, dv).real - hdot(v, dv).abs() ** 2
        return torch.stack([lam, dlam, chi])

    return torch.func.vmap(one)(gs)


def tfim_ed_observables(n: int, g, dtype=torch.float64, device=None):
    """Dense-ED oracle: (E0, dE0/dg, d²E0/dg², χ_F) from a full eigh, by
    the sum-over-states formulas

        dE0/dg   = <0| dH/dg |0>,
        d²E0/dg² = 2 Σ_{m>0} |<m|dH/dg|0>|² / (E0 - Em),
        χ_F      =   Σ_{m>0} |<m|dH/dg|0>|² / (E0 - Em)².
    """
    dev = resolve_device(device)
    h = tfim_dense_hamiltonian(n, g, dtype=dtype, device=dev)
    evals, evecs = torch.linalg.eigh(h)
    v0 = evecs[:, 0]
    dh_v0 = -flip_sum(v0, n)                  # dH/dg |0> = -Σ_i sx_i |0>
    de = torch.dot(v0, dh_v0)
    me = evecs[:, 1:].T @ dh_v0
    gaps = evals[0] - evals[1:]
    return (evals[0], de, 2.0 * torch.sum(me ** 2 / gaps),
            torch.sum(me ** 2 / gaps ** 2))
