"""The TFIM flagship of the port (``models/tfim.py``,
``ops/observables.py``) against the JAX package's ``models/tfim.py`` and
``ops/observables.py`` (CPU, f64, N <= 8 spins)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from dominantsparseeigenad_tpu import models as jm
from dominantsparseeigenad_tpu.models.tfim import flip_sum as jax_flip_sum
from dominantsparseeigenad_tpu.ops.observables import (
    fidelity_susceptibility as jax_chi)
from dominantsparseeigenad_tpu.ops.operators import DenseOperator as JaxDense

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

torch.set_num_threads(2)

G = 1.2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n", [3, 5, 8])
def test_zz_diagonal_equals_jax(n):
    d = models.tfim_zz_diagonal(n, device="cpu")
    assert d.dtype == torch.float64
    # Integers, from the same bit arithmetic.
    assert np.array_equal(d.numpy(), np.asarray(jm.tfim_zz_diagonal(n)))


@pytest.mark.parametrize("n", [3, 6, 8])
def test_flip_sum_matches_jax(n):
    x = np.random.default_rng(n).standard_normal(1 << n)
    y = models.flip_sum(torch.from_numpy(x), n)
    # JAX contracts bit groups with adjacency matrices: the same n terms
    # per entry, summed in another order.
    assert _rel(y, jax_flip_sum(jnp.asarray(x), n)) <= 1e-12


@pytest.mark.parametrize("n", [4, 8])
def test_matvec_and_operator_match_jax(n):
    x = np.random.default_rng(10 + n).standard_normal(1 << n)
    y_j = jm.tfim_matvec((jnp.asarray(G), jm.tfim_zz_diagonal(n)),
                         jnp.asarray(x))
    y = models.tfim_matvec((torch.tensor(G, dtype=torch.float64),
                            models.tfim_zz_diagonal(n, device="cpu")),
                           torch.from_numpy(x))
    assert _rel(y, y_j) <= 1e-12
    op = models.tfim_operator(n, G, device="cpu")
    assert op.dim == 1 << n and op.dtype == torch.float64
    assert len(op.parameters()) == 2
    assert _rel(op.matvec(torch.from_numpy(x)), y_j) <= 1e-12


@pytest.mark.parametrize("n", [3, 6])
def test_dense_hamiltonian_equals_jax(n):
    h = models.tfim_dense_hamiltonian(n, G, device="cpu")
    assert np.array_equal(h.numpy(),
                          np.asarray(jm.tfim_dense_hamiltonian(n, G)))
    # The matrix-free operator is the same matrix.
    eye = torch.eye(1 << n, dtype=torch.float64)
    op = models.tfim_operator(n, G, device="cpu")
    assert _rel(op.matmat(eye), h) <= 1e-14


@pytest.mark.parametrize("n", [1, 2])
def test_guard_below_three_spins(n):
    with pytest.raises(ValueError, match="n >= 3"):
        models.tfim_zz_diagonal(n, device="cpu")
    with pytest.raises(ValueError, match="n >= 3"):
        models.tfim_operator(n, G, device="cpu")


@pytest.mark.parametrize("n", [6, 8])
def test_closed_forms_match_jax_ed(n):
    e0, de, _, chi = (float(t) for t in jm.tfim_ed_observables(n, G))
    e0_port = models.tfim_exact_e0(n, G, device="cpu")
    assert abs(float(e0_port) - float(jm.tfim_exact_e0(n, G))) <= 1e-13
    # Jordan-Wigner against dense ED: float64 round-off.
    assert abs(float(e0_port) - e0) <= 1e-10 * abs(e0)
    assert abs(models.tfim_exact_de0_dg(n, G) - de) <= 1e-10 * abs(de)
    assert abs(models.tfim_exact_chi_f(n, G) - chi) <= 1e-10 * abs(chi)
    # The closed form of dE0/dg is the derivative of E0's.
    g = torch.tensor(G, dtype=torch.float64, requires_grad=True)
    (d,) = torch.autograd.grad(models.tfim_exact_e0(n, g, device="cpu"), g)
    assert abs(float(d) - models.tfim_exact_de0_dg(n, G)) <= 1e-12 * abs(de)


@pytest.mark.parametrize("n", [6, 8])
def test_ed_observables_match_jax(n):
    got = models.tfim_ed_observables(n, G, device="cpu")
    want = jm.tfim_ed_observables(n, G)
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= 1e-10 * abs(float(b))


@pytest.mark.parametrize("n", [6, 8])
def test_fidelity_susceptibility_matches_jax(n):
    chi = models.fidelity_susceptibility(n, G, k=1 << n, tol=1e-12,
                                         device="cpu")
    chi_j = jm.fidelity_susceptibility(n, G, k=1 << n, tol=1e-12)
    # Two CGs at 1e-12 residuals; ||dψ||² of them.
    assert abs(float(chi) - float(chi_j)) <= 1e-6 * abs(float(chi_j))


def test_generic_fidelity_susceptibility_matches_jax():
    rng = np.random.default_rng(4)
    a0, a1 = (rng.standard_normal((32, 32)) for _ in range(2))
    a0, a1 = (a0 + a0.T) / 2, (a1 + a1.T) / 2
    chi_j = jax_chi(lambda g: JaxDense(jnp.asarray(a0) + g * jnp.asarray(a1)),
                    jnp.asarray(0.3), k=32, tol=1e-12)
    chi = port.fidelity_susceptibility(
        lambda g: torch.from_numpy(a0) + g * torch.from_numpy(a1), 0.3, k=32,
        tol=1e-12, device="cpu")
    assert abs(float(chi) - float(chi_j)) <= 1e-6 * abs(float(chi_j))


def test_ground_energy_and_its_derivative_match_jax():
    n = 8
    e_j, de_j = jax.value_and_grad(
        lambda g: jm.tfim_ground_energy(n, g, k=1 << n, tol=1e-12))(
            jnp.asarray(G))
    g = torch.tensor(G, dtype=torch.float64, requires_grad=True)
    e = models.tfim_ground_energy(n, g, k=1 << n, tol=1e-12, device="cpu")
    (de,) = torch.autograd.grad(e, g)
    assert abs(float(e.detach()) - float(e_j)) <= 1e-10 * abs(float(e_j))
    assert abs(float(de) - float(de_j)) <= 1e-8 * abs(float(de_j))
    # Forward mode gives the same derivative.
    with fwAD.dual_level():
        gd = fwAD.make_dual(torch.tensor(G, dtype=torch.float64),
                            torch.tensor(1.0, dtype=torch.float64))
        lam, v = models.tfim_ground_state(n, gd, k=1 << n, tol=1e-12,
                                          device="cpu")
        de_fwd = float(fwAD.unpack_dual(lam).tangent)
    assert abs(de_fwd - float(de_j)) <= 1e-8 * abs(float(de_j))
    _, v_j = jm.tfim_ground_state(n, G, k=1 << n, tol=1e-12)
    assert np.abs(fwAD.unpack_dual(v).primal.numpy() - np.asarray(v_j)).max() \
        <= 1e-8


def test_headline_pass_float32_small():
    """The card's headline pass (f32, k = 60, one reorthogonalization
    pass, CG tol 1e-5 and 150 iterations) at N = 8, against the closed
    forms, with the card's tolerances."""
    n = 8
    with fwAD.dual_level():
        g = fwAD.make_dual(torch.tensor(G), torch.tensor(1.0))
        lam, v = port.dominant_eigh(
            models.tfim_operator(n, g, dtype=torch.float32, device="cpu"),
            k=60, tol=1e-5, maxiter=150, reorth_passes=1, device="cpu")
        e0, de0 = (float(t) for t in fwAD.unpack_dual(lam))
        psi, dpsi = fwAD.unpack_dual(v)
    chi = float(torch.dot(dpsi, dpsi) - torch.dot(psi, dpsi) ** 2)
    assert abs(e0 - float(jm.tfim_exact_e0(n, G))) <= 2e-5 * abs(e0)
    assert abs(de0 - models.tfim_exact_de0_dg(n, G)) <= 1e-3 * abs(de0)
    assert abs(chi - models.tfim_exact_chi_f(n, G)) <= 5e-3 * chi
