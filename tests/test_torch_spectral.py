"""The port's resolvent spectral function (``ops/spectral.py``) against
the JAX package's (CPU, f64), after ``tests/test_spectral.py`` and
``tests/test_fuzz.py:615`` (fewer draws): values against dense ED and
JAX's ``vmap`` over ω, gradients in the operator, the probe and the
frequencies against ``jax.grad``, the batched solve (one CG over the
frequencies) against the per-ω loop, on the matrix-free TFIM through its
block product."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dominantsparseeigenad_tpu as jx
from dominantsparseeigenad_tpu import models as jm

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

torch.set_num_threads(2)

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _sym(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _lorentz_sum(a, b, omegas, eta):
    evals, evecs = np.linalg.eigh(a)
    w = (evecs.T @ b) ** 2
    return np.array([np.sum(w * eta / np.pi / ((o - evals) ** 2 + eta ** 2))
                     for o in omegas])


def test_spectral_function_vs_ed_and_jax():
    """15 frequencies: against the dense Lorentzian sum (1e-10) and
    JAX's (1e-10); the batched CG against the per-ω loop (1e-12)."""
    rng = np.random.default_rng(0)
    n = 48
    m = rng.standard_normal((n, n))
    a = (m + m.T) / 2
    b = rng.standard_normal(n)
    omegas = np.linspace(-8, 8, 15)
    eta = 0.4
    s = port.spectral_function(_t(a), _t(b), _t(omegas), eta, tol=1e-12,
                               device="cpu")
    np.testing.assert_allclose(s.numpy(), _lorentz_sum(a, b, omegas, eta),
                               rtol=1e-10)
    sj = jax.jit(lambda m, bb, om: jx.spectral_function(
        jx.DenseOperator(m), bb, om, eta, tol=1e-12))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(omegas))
    assert _rel(s.numpy(), sj) <= 1e-10
    loop = torch.cat([port.spectral_function(_t(a), _t(b), _t(omegas[i:i + 1]),
                                             eta, tol=1e-12, device="cpu")
                      for i in range(len(omegas))])
    assert _rel(s.numpy(), loop.numpy()) <= 1e-12


def test_spectral_gradients_in_operator_probe_and_omegas():
    """∂/∂g of Σ_ω A_b(ω) for A + g H1, and the gradients in b and in
    the ω grid, against ``jax.grad`` (1e-8) and a central difference in
    g (1e-6); the backward is one more batched CG."""
    rng = np.random.default_rng(1)
    n = 32
    a, h1 = _sym(n, 11), _sym(n, 12)
    b = rng.standard_normal(n)
    omegas = np.linspace(-3, 3, 4)

    def f(g, bb, om):
        return port.spectral_function(_t(a) + g * _t(h1), bb, om, 0.5,
                                      tol=1e-12, device="cpu").sum()

    g = torch.tensor(0.2, dtype=F64, requires_grad=True)
    bt = _t(b).requires_grad_()
    om = _t(omegas).requires_grad_()
    dg, db, dom = torch.autograd.grad(f(g, bt, om), (g, bt, om))

    def fj(gv, bb, oo):
        return jnp.sum(jx.spectral_function(
            jx.DenseOperator(jnp.asarray(a) + gv * jnp.asarray(h1)), bb, oo,
            0.5, tol=1e-12))

    gj = jax.jit(jax.grad(fj, argnums=(0, 1, 2)))(
        jnp.float64(0.2), jnp.asarray(b), jnp.asarray(omegas))
    assert _rel(float(dg), float(gj[0])) <= 1e-8
    assert _rel(db.numpy(), gj[1]) <= 1e-8
    assert _rel(dom.numpy(), gj[2]) <= 1e-8
    eps = 1e-6
    with torch.no_grad():
        num = (float(f(torch.tensor(0.2 + eps, dtype=F64), _t(b),
                       _t(omegas)))
               - float(f(torch.tensor(0.2 - eps, dtype=F64), _t(b),
                         _t(omegas)))) / (2 * eps)
    np.testing.assert_allclose(float(dg), num, rtol=1e-6)


def test_tfim_dynamic_structure_factor():
    """S(ω) for the probe Σ_i σˣ_i |ψ0> on the matrix-free TFIM (N = 8)
    against the dense spectral sum (1e-8); each CG iteration is two block
    products of the TFIM (one pass each over the 9-column block, never
    a column loop), and the batched result equals the per-ω loop at two
    frequencies (1e-12)."""
    n, g, eta = 8, 1.3, 0.3
    op = models.tfim_operator(n, g, device="cpu")
    _, psi0 = port.dominant_eigh(op, k=1 << n, extreme="min", tol=1e-12,
                                 device="cpu")
    probe = models.flip_sum(psi0, n)
    omegas = np.linspace(-16.0, -4.0, 9)
    calls = []
    fn = op.matvec_fn

    def counted(params, x):
        calls.append(tuple(x.shape))
        return fn(params, x)

    op.matvec_fn = counted
    s = port.spectral_function(op, probe, _t(omegas), eta, tol=1e-12,
                               device="cpu")
    assert calls and all(c == (1 << n, 9) for c in calls)
    h = models.tfim_dense_hamiltonian(n, g, device="cpu").numpy()
    np.testing.assert_allclose(s.numpy(),
                               _lorentz_sum(h, probe.numpy(), omegas, eta),
                               rtol=1e-8)
    two = torch.cat([port.spectral_function(op, probe, _t(omegas[i:i + 1]),
                                            eta, tol=1e-12, device="cpu")
                     for i in (0, 4)])
    assert _rel(two.numpy(), s.numpy()[[0, 4]]) <= 1e-12
    op_j = jm.tfim_operator(n, g)
    sj = jax.jit(lambda p: jx.spectral_function(op_j, p, jnp.asarray(omegas),
                                                eta, tol=1e-12))(
        jnp.asarray(probe.numpy()))
    assert _rel(s.numpy(), sj) <= 1e-10


def test_spectral_function_accepts_wider_omega_grid():
    """A float64 grid and probe against a float32 operator are pinned to
    float32 (the JAX regression)."""
    n = 24
    rng = np.random.default_rng(3)
    h = rng.standard_normal((n, n)).astype(np.float32)
    h = (h + h.T) / 2
    b = rng.standard_normal(n)
    out = port.spectral_function(_t(h), _t(b), np.linspace(-3.0, 3.0, 7),
                                 eta=0.3, tol=1e-5, device="cpu")
    assert out.shape == (7,) and out.dtype == torch.float32
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("seed", [0, 4])
def test_fuzz_spectral_function(seed):
    """``tests/test_fuzz.py:615`` at 2 of its 8 draws: the curve against
    the exact resolvent (1e-7) and the jvp of one frequency's response
    against a central difference (1e-6)."""
    n, eta = 48, 0.25
    omegas = np.linspace(-3.0, 3.0, 9)
    rng = np.random.default_rng(9300 + seed)
    a_np = (lambda m: (m + m.T) / 2)(rng.standard_normal((n, n)))
    b_np = rng.standard_normal(n)
    got = port.spectral_function(_t(a_np), _t(b_np), _t(omegas), eta,
                                 tol=1e-12, maxiter=3000, device="cpu")
    np.testing.assert_allclose(got.numpy(),
                               _lorentz_sum(a_np, b_np, omegas, eta),
                               rtol=1e-7, atol=1e-10)
    da_np = (lambda m: (m + m.T) / 2)(rng.standard_normal((n, n)))
    _, g = torch.func.jvp(lambda m: port.spectral_function(
        m, _t(b_np), _t(omegas[3:4]), eta, tol=1e-12, maxiter=3000,
        device="cpu")[0], (_t(a_np),), (_t(da_np),))
    eps = 1e-6
    num = (_lorentz_sum(a_np + eps * da_np, b_np, omegas[3:4], eta)[0]
           - _lorentz_sum(a_np - eps * da_np, b_np, omegas[3:4], eta)[0]) \
        / (2 * eps)
    np.testing.assert_allclose(float(g), num, rtol=1e-6, atol=1e-9)
