"""The port's XXZ chain (``models/heisenberg.py``) and 2D TFIM
(``models/tfim.py``) against the JAX package's (CPU, f64), after
``tests/test_heisenberg.py`` and ``tests/test_tfim.py:102-140``, at
n ≤ 256 (N ≤ 8 spins, the 3 x 3 torus); and the TFIM's block product,
one pass over an (2^N, m) block, against the column loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu import dominant_eigh as jax_eigh
from dominantsparseeigenad_tpu import models as jm

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models
from dominantsparseeigenad_tpu_torch.models.heisenberg import _zz_diagonal

torch.set_num_threads(2)

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("n,jz", [(5, 1.0), (8, 0.5), (8, -0.3)])
def test_matvec_matches_dense_and_jax(n, jz):
    op = models.heisenberg_operator(n, 1.0, jz, device="cpu")
    h = models.heisenberg_dense(n, 1.0, jz, device="cpu")
    np.testing.assert_array_equal(h.numpy(), np.asarray(
        jm.heisenberg_dense(n, 1.0, jz)))
    x = np.random.default_rng(n).standard_normal(1 << n)
    y = op.matvec(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), h.numpy() @ x, atol=1e-12)
    yj = jm.heisenberg_operator(n, 1.0, jz).matvec(jnp.asarray(x))
    assert _rel(y.numpy(), yj) <= 1e-12


def test_heisenberg_guard():
    with pytest.raises(ValueError, match="n >= 3"):
        models.heisenberg_operator(2, device="cpu")


@pytest.fixture(scope="module")
def jax_xxz8():
    """JAX's E0, dE0/djz and d²E0/djz² of the N = 8 chain at jz = 1."""
    def e0(jz):
        return jm.heisenberg_ground_energy(8, 1.0, jz, k=256)
    val, d1 = jax.jit(jax.value_and_grad(e0))(jnp.float64(1.0))
    d2 = jax.jit(jax.grad(jax.grad(e0)))(jnp.float64(1.0))
    return float(val), float(d1), float(d2)


def test_ground_energy_and_derivatives(jax_xxz8):
    """E0, dE0/djz (reverse) and d²E0/djz² (reverse over reverse)
    against JAX's (1e-10 / 1e-9 / 1e-7), dense ED, Hellmann-Feynman and
    the sum over states; dE0/dj by forward mode against the same ED."""
    n = 8
    jz = torch.tensor(1.0, dtype=F64, requires_grad=True)
    e0 = models.heisenberg_ground_energy(n, 1.0, jz, k=1 << n, device="cpu")
    (d1,) = torch.autograd.grad(e0, jz, create_graph=True)
    (d2,) = torch.autograd.grad(d1, jz)
    val_j, d1_j, d2_j = jax_xxz8
    assert _rel(float(e0), val_j) <= 1e-10
    assert _rel(float(d1), d1_j) <= 1e-9
    assert _rel(float(d2), d2_j) <= 1e-7
    evals, evecs = np.linalg.eigh(models.heisenberg_dense(
        n, device="cpu").numpy())
    np.testing.assert_allclose(float(e0), evals[0], rtol=1e-11)
    v0 = evecs[:, 0]
    dz = _zz_diagonal(n, np.float64)
    np.testing.assert_allclose(float(d1), np.sum(dz * v0 ** 2), rtol=1e-9)
    me = evecs[:, 1:].T @ (dz * v0)
    np.testing.assert_allclose(float(d2),
                               2 * np.sum(me ** 2 / (evals[0] - evals[1:])),
                               rtol=1e-7)
    one = torch.tensor(1.0, dtype=F64)
    _, dj = torch.func.jvp(lambda j: models.heisenberg_ground_energy(
        n, j, 1.0, k=1 << n, device="cpu"), (one,), (one,))
    # Euler: E0 is homogeneous of degree 1 in (j, jz).
    np.testing.assert_allclose(float(dj) + float(d1), evals[0], rtol=1e-9)


def test_isotropic_limit_value():
    """E0/N near 1/4 - ln 2 (Bethe) at N = 8, the JAX test's bar."""
    e = float(models.heisenberg_ground_energy(8, 1.0, 1.0, k=256,
                                              device="cpu")) / 8
    assert abs(e - (0.25 - np.log(2))) < 0.02


# -- the 2D TFIM (tests/test_tfim.py:102-140) ---------------------------------

def test_tfim2d_matches_ed_and_jax():
    """3 x 3 torus, g = 3: the zz diagonal equal to JAX's, the matvec
    and the dense H against JAX's, E0 (1e-10) and dE0/dg (1e-8) against
    JAX's and ED / Hellmann-Feynman."""
    lx, ly, g = 3, 3, 3.0
    n = lx * ly
    diag = models.tfim2d_zz_diagonal(lx, ly, device="cpu")
    np.testing.assert_array_equal(diag.numpy(),
                                  np.asarray(jm.tfim2d_zz_diagonal(lx, ly)))
    op = models.tfim2d_operator(lx, ly, g, device="cpu")
    h = models.tfim2d_dense_hamiltonian(lx, ly, g, device="cpu").numpy()
    np.testing.assert_allclose(h, np.asarray(
        jm.tfim2d_dense_hamiltonian(lx, ly, g)), atol=1e-15)
    x = np.random.default_rng(0).standard_normal(1 << n)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               h @ x, atol=1e-12)
    gt = torch.tensor(g, dtype=F64, requires_grad=True)
    e0, _ = port.dominant_eigh(models.tfim2d_operator(lx, ly, gt,
                                                      device="cpu"),
                               k=160, extreme="min", tol=1e-12,
                               device="cpu")
    (de,) = torch.autograd.grad(e0, gt)
    val, grad = jax.jit(jax.value_and_grad(lambda gg: jax_eigh(
        jm.tfim2d_operator(lx, ly, gg), k=160, extreme="min",
        tol=1e-12)[0]))(jnp.float64(g))
    assert _rel(float(e0), float(val)) <= 1e-10
    assert _rel(float(de), float(grad)) <= 1e-8
    evals, evecs = np.linalg.eigh(h)
    np.testing.assert_allclose(float(e0), evals[0], rtol=1e-12)
    v0 = torch.from_numpy(evecs[:, 0])
    hf = -float(torch.dot(v0, models.flip_sum(v0, n)))
    np.testing.assert_allclose(float(de), hf, rtol=1e-10)


@pytest.mark.parametrize("call,shape", [
    (models.tfim_operator, (1,)), (models.tfim_operator, (2,)),
    (models.tfim2d_operator, (2, 3)), (models.tfim2d_operator, (3, 1))])
def test_small_lattice_pbc_guards(call, shape):
    with pytest.raises(ValueError, match="double-counts"):
        call(*shape, 1.0, device="cpu")


# -- the TFIM's block product -------------------------------------------------

@pytest.mark.parametrize("model", ["1d", "2d"])
def test_tfim_block_product_is_one_pass(model):
    """``matmat`` of the matrix-free TFIM is one ``tfim_matvec`` pass over
    the block, equal bit for bit to the column loop, and so is
    ``torch.func.vmap`` of the matvec over the columns; the tangent block
    product too."""
    op = (models.tfim_operator(8, 1.1, device="cpu") if model == "1d"
          else models.tfim2d_operator(3, 3, 1.1, device="cpu"))
    X = torch.randn(op.dim, 5, dtype=F64,
                    generator=torch.Generator().manual_seed(1))
    calls = []
    fn = op.matvec_fn

    def counted(params, x):
        calls.append(tuple(x.shape))
        return fn(params, x)

    op.matvec_fn = counted
    Y = op.matmat(X)
    assert calls == [(op.dim, 5)]
    loop = torch.stack([op.matvec(X[:, j]) for j in range(5)], dim=1)
    assert torch.equal(Y, loop)
    assert torch.equal(torch.func.vmap(op.matvec, in_dims=1, out_dims=1)(X),
                       Y)
    dY = op.tangent_matmat(X, [torch.ones((), dtype=F64), None])
    assert torch.equal(dY, -models.flip_sum(X, op.dim.bit_length() - 1))
