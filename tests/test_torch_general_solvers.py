"""The port's non-symmetric solvers (``bicgstab``, ``gmres``,
``solve_general``) and the Arnoldi helpers of the non-symmetric
eigensolver against the JAX package's (CPU, f64)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from dominantsparseeigenad_tpu.ops.eig import (
    _arnoldi_factorization as jax_factorization,
    _hessenberg_defect as jax_defect)
from dominantsparseeigenad_tpu.ops.lanczos import (
    arnoldi_step as jax_arnoldi_step)

import dominantsparseeigenad_tpu_torch as port

# The modules, not the functions of the same name that ops exports.
jcg = importlib.import_module("dominantsparseeigenad_tpu.ops.cg")
cg_mod = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
eig_mod = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.eig")

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _nonsymmetric(n, seed, shift=3.0):
    """``shift I + G / sqrt(n)``, G Gaussian: non-normal, eigenvalues in
    a disc of radius ~1 around ``shift``; plus a right-hand side and a
    start vector."""
    rng = np.random.default_rng(seed)
    a = shift * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    return a, rng.standard_normal(n), rng.standard_normal(n)


def _ill_conditioned(n, seed, cond=1e4):
    """Q diag(d) Q^T plus a non-symmetric part, κ ~ ``cond``."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.geomspace(1.0, cond, n)
    return (q * d) @ q.T + 0.05 * rng.standard_normal((n, n)), \
        rng.standard_normal(n)


_SOLVERS = {"bicgstab": (port.bicgstab, jcg.bicgstab),
            "gmres": (port.gmres, jcg.gmres)}


@pytest.mark.parametrize("start", ["zero", "x0"])
@pytest.mark.parametrize("name", sorted(_SOLVERS))
def test_solver_matches_jax_and_numpy(name, start):
    a, b, x0 = _nonsymmetric(64, 0)
    mine, ref = _SOLVERS[name]
    kw = dict(x0=torch.from_numpy(x0)) if start == "x0" else {}
    kw_j = dict(x0=jnp.asarray(x0)) if start == "x0" else {}
    at = torch.from_numpy(a)
    x = mine(lambda z: at @ z, torch.from_numpy(b), tol=1e-13, device="cpu",
             **kw)
    x_j = jax.jit(lambda m, rhs, **k: ref(lambda z: m @ z, rhs, tol=1e-13,
                                          **k))(jnp.asarray(a),
                                                jnp.asarray(b), **kw_j)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), rtol=0,
                               atol=1e-10)


def test_bicgstab_singular_system_stays_finite():
    """The JAX package's breakdown case (``tests/test_cg.py``): an exactly
    singular shift and a right-hand side with a null-space component; the
    eps-scaled guards freeze the iteration on a finite iterate."""
    rng = np.random.default_rng(40)
    s = rng.standard_normal((24, 24))
    a = (s + s.T) / 2
    w, v = np.linalg.eigh(a)
    m = a - w[0] * np.eye(24)
    b = rng.standard_normal(24) + v[:, 0]
    mt = torch.from_numpy(m)

    def both(maxiter):
        x = port.bicgstab(lambda y: mt @ y, torch.from_numpy(b), tol=1e-14,
                          maxiter=maxiter, device="cpu").numpy()
        x_j = np.asarray(jcg.bicgstab(lambda y: jnp.asarray(m) @ y,
                                      jnp.asarray(b), tol=1e-14,
                                      maxiter=maxiter))
        return x, x_j

    # The first steps are the JAX ones; later the iterate drifts along
    # the null vector, where round-off decides the path in either package.
    x, x_j = both(5)
    np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-10 * np.abs(x).max())
    x, x_j = both(500)
    for y in (x, x_j):
        assert np.isfinite(y).all()
        # A stagnation point, not garbage.
        assert np.linalg.norm(m @ y - b) <= 2 * np.linalg.norm(b)


def test_restarted_gmres_on_an_ill_conditioned_system():
    """GMRES(8) through ~90 restarts at κ ~ 1e3: the same iterate as the
    JAX package's after the same cycles, and the solution."""
    a, b = _ill_conditioned(48, 1, cond=1e3)
    at = torch.from_numpy(a)
    x, steps = cg_mod._gmres_loop(lambda z: at @ z, torch.from_numpy(b),
                                  1e-12, 2000, restart=8)
    x_j = jax.jit(lambda m, rhs: jcg.gmres(lambda z: m @ z, rhs, tol=1e-12,
                                           restart=8, maxiter=2000))(
        jnp.asarray(a), jnp.asarray(b))
    assert 8 * 50 < steps < 2000              # restarted, and converged
    exact = np.linalg.solve(a, b)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-10 * np.abs(exact).max())
    np.testing.assert_allclose(x.numpy(), exact, rtol=0,
                               atol=1e-10 * np.abs(exact).max())


def test_gmres_happy_breakdown_is_the_minimum_norm_step():
    """b in a 2-dimensional invariant subspace: the Arnoldi basis breaks
    down at step 2, every later Hessenberg column is zero, and the
    masked triangular solve gives the exact solution (a full-rank
    least-squares routine would give NaN)."""
    a = np.diag(np.arange(1.0, 13.0))
    a[0, 1] = 0.5
    b = np.zeros(12)
    b[:2] = [1.0, 2.0]
    at = torch.from_numpy(a)
    x = port.gmres(lambda z: at @ z, torch.from_numpy(b), tol=1e-13,
                   device="cpu")
    x_j = jcg.gmres(lambda z: jnp.asarray(a) @ z, jnp.asarray(b), tol=1e-13)
    assert bool(torch.isfinite(x).all())
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), atol=1e-14)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=1e-14)


@pytest.fixture(scope="module")
def general_case():
    """A non-symmetric system and the JAX package's gradient of
    ``sum(x^3)`` in (A, b) for each method."""
    a, b, _ = _nonsymmetric(20, 2)
    ref = {}
    for method in ("bicgstab", "cgnr", "gmres"):
        def loss(m, rhs, method=method):
            x = jcg.solve_general(lambda v: m @ v, lambda v: m.T @ v, rhs,
                                  tol=1e-13, method=method)
            return jnp.sum(x ** 3)
        ref[method] = [np.asarray(g) for g in jax.jit(jax.grad(
            loss, argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))]
    return a, b, ref


@pytest.mark.parametrize("method", ["bicgstab", "cgnr", "gmres"])
def test_solve_general_gradients_match_jax(method, general_case):
    a, b, ref = general_case
    at = torch.tensor(a, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    x = port.solve_general(at, bt, tol=1e-13, method=method, device="cpu")
    np.testing.assert_allclose(x.detach().numpy(), np.linalg.solve(a, b),
                               atol=1e-10)
    ga, gb = torch.autograd.grad((x ** 3).sum(), (at, bt))
    np.testing.assert_allclose(ga.numpy(), ref[method][0], rtol=0,
                               atol=1e-8 * np.abs(ref[method][0]).max())
    np.testing.assert_allclose(gb.numpy(), ref[method][1], rtol=0,
                               atol=1e-8 * np.abs(ref[method][1]).max())


@pytest.mark.parametrize("method", ["bicgstab", "cgnr", "gmres"])
def test_solve_general_gradcheck_and_gradgradcheck(method):
    a, b, _ = _nonsymmetric(6, 4)
    at = torch.tensor(a, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)

    def f(m, rhs):
        x = port.solve_general(port.DenseOperator(m), rhs, tol=1e-14,
                               method=method, device="cpu")
        return (x ** 3).sum()

    assert gradcheck(f, (at, bt), fast_mode=True)
    assert gradgradcheck(f, (at, bt), fast_mode=True)


def test_solve_general_refuses_a_bare_callable():
    a = torch.eye(4, dtype=torch.float64)
    with pytest.raises(TypeError, match="MatrixFreeOperator"):
        port.solve_general(lambda x: a @ x, torch.ones(4, dtype=a.dtype),
                           device="cpu")


def test_arnoldi_step_and_factorization_match_jax():
    a, _, q = _nonsymmetric(40, 5)
    q = q / np.linalg.norm(q)
    at = torch.from_numpy(a)
    basis, h = eig_mod._arnoldi_factorization(
        lambda x: at @ x, 40, 12, torch.from_numpy(q), torch.float64)
    basis_j, h_j = jax.jit(lambda m, q0: jax_factorization(
        lambda x: m @ x, 40, 12, q0, jnp.float64))(jnp.asarray(a),
                                                   jnp.asarray(q))
    np.testing.assert_allclose(basis.numpy(), np.asarray(basis_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=0,
                               atol=1e-12)
    # One public step from the same partial basis (rows > 5 zero): it
    # writes row 6 and column 5 again.
    part, hpart = basis.numpy().copy(), h.numpy().copy()
    part[6:] = 0.0
    hpart[:, 5:] = 0.0
    b2_j, h2_j = jax_arnoldi_step(lambda x: jnp.asarray(a) @ x,
                                  jnp.asarray(part), jnp.asarray(hpart), 5)
    # The port's step writes into the buffers it is given.
    b2, h2 = port.arnoldi_step(lambda x: at @ x, torch.from_numpy(part),
                               torch.from_numpy(hpart), 5)
    assert np.shares_memory(b2.numpy(), part)
    np.testing.assert_allclose(b2.numpy(), np.asarray(b2_j), atol=1e-12)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h2_j), atol=1e-12)
    np.testing.assert_allclose(b2[6].numpy(), basis[6].numpy(), atol=1e-12)
    # A V_k = V_{k+1} H.
    np.testing.assert_allclose(a @ basis[:12].numpy().T,
                               basis.numpy().T @ h.numpy(), atol=1e-12)


def test_arnoldi_happy_breakdown_leaves_a_zero_row():
    a = np.diag(np.arange(1.0, 9.0))
    q = np.zeros(8)
    q[2] = 1.0                     # an eigenvector: breaks down at once
    at = torch.from_numpy(a)
    basis, h = eig_mod._arnoldi_factorization(
        lambda x: at @ x, 8, 4, torch.from_numpy(q), torch.float64)
    assert torch.count_nonzero(basis[1:]) == 0
    assert float(h[0, 0]) == 3.0 and torch.count_nonzero(h) == 1


@pytest.mark.parametrize("which", ["perron", "rotation"])
def test_hessenberg_defect_matches_jax(which):
    """The squared block and σ₂/σ₁: ~0 for a Perron matrix's Hessenberg
    block, O(1) for one whose dominant pair is complex."""
    rng = np.random.default_rng(6)
    if which == "perron":
        a = rng.uniform(size=(30, 30)) + 0.1
    else:
        q, _ = np.linalg.qr(rng.standard_normal((30, 30)))
        blk = np.diag(np.concatenate([[0, 0], 0.3 * rng.random(28)]))
        blk[:2, :2] = 3.0 * np.array([[np.cos(0.9), -np.sin(0.9)],
                                      [np.sin(0.9), np.cos(0.9)]])
        a = q @ blk @ q.T
    q0 = rng.standard_normal(30)
    q0 /= np.linalg.norm(q0)
    at = torch.from_numpy(a)
    _, h = eig_mod._arnoldi_factorization(
        lambda x: at @ x, 30, 10, torch.from_numpy(q0), torch.float64)
    mp, defect = eig_mod._hessenberg_defect(h[:10, :10])
    mp_j, defect_j = jax.jit(lambda hk: jax_defect(hk, jnp.float64))(
        jnp.asarray(h[:10, :10].numpy()))
    np.testing.assert_allclose(mp.numpy(), np.asarray(mp_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(defect), float(defect_j), rtol=0,
                               atol=1e-10)
    if which == "perron":
        assert float(defect) < 1e-6
    else:
        assert float(defect) > 1e-2
