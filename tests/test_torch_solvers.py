"""The port's preconditioned CG, ``cg_info``, MINRES, ``solve_spd``,
``solve_symmetric`` and ``solve_deflated(method=, precond=)`` against
the JAX package's (CPU, f64)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from dominantsparseeigenad_tpu.ops.operators import DenseOperator as JaxDense
from dominantsparseeigenad_tpu.ops.precond import (
    jacobi_precond as jax_jacobi)

import dominantsparseeigenad_tpu_torch as port

# The modules, not the functions of the same name that ops exports.
jcg = importlib.import_module("dominantsparseeigenad_tpu.ops.cg")
cg_mod = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")

torch.set_num_threads(2)


def _spd(n, seed, cond=1e3):
    """Diagonally dominant SPD, its conditioning on the diagonal (as
    ``tests/test_precond.py::_ill_conditioned_spd``)."""
    rng = np.random.default_rng(seed)
    d = np.exp(rng.uniform(0.0, np.log(cond), n))
    s = rng.standard_normal((n, n)) * 0.05
    a = np.diag(d) + (s + s.T) / 2
    w = np.linalg.eigvalsh(a)[0]
    return a + max(0.0, 0.5 - w) * np.eye(n), rng.standard_normal(n)


def _indefinite(n, seed):
    """Symmetric with eigenvalues on both sides of 0, away from it."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([-np.linspace(1.0, 5.0, n // 2),
                        np.linspace(0.5, 40.0, n - n // 2)])
    a = (q * w) @ q.T
    return (a + a.T) / 2, rng.standard_normal(n)


def _jacobi_pair(a, shift=0.0):
    """The same Jacobi preconditioner in both packages."""
    return (port.jacobi_precond(torch.from_numpy(a), shift=shift),
            jax_jacobi(JaxDense(jnp.asarray(a)), shift=shift))


@pytest.mark.parametrize("variant", ["plain", "precond", "x0_atol"])
def test_cg_and_cg_info_match_jax(variant):
    # κ ~ 1e2: CG converges well inside n steps, so rounding does not
    # split the two packages' trajectories (at κ ~ 1e3 it runs past n
    # and their iteration counts part by one).
    a, b = _spd(96, 0, cond=1e2)
    x0 = np.random.default_rng(1).standard_normal(96)
    m, m_j = _jacobi_pair(a)
    kw, kw_j = {}, {}
    if variant == "precond":
        kw, kw_j = dict(precond=m), dict(precond=m_j)
    if variant == "x0_atol":
        kw = dict(x0=torch.from_numpy(x0), atol=1e-6)
        kw_j = dict(x0=jnp.asarray(x0), atol=1e-6)
    at = torch.from_numpy(a)
    x, its, res = port.cg_info(lambda z: at @ z, torch.from_numpy(b),
                               tol=1e-11, device="cpu", **kw)
    x_j, its_j, res_j = jcg.cg_info(lambda z: jnp.asarray(a) @ z,
                                    jnp.asarray(b), tol=1e-11, **kw_j)
    x_plain = port.cg(lambda z: at @ z, torch.from_numpy(b), tol=1e-11,
                      device="cpu", **kw)
    assert torch.equal(x, x_plain)
    # Both solved to a 1e-11 relative residual (atol 1e-6 of ||b|| ~ 10
    # stops earlier).
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j),
                               rtol=1e-6 if variant == "x0_atol" else 1e-7,
                               atol=1e-7)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b),
                               rtol=1e-6, atol=1e-6)
    # The port counts the products made: the host reads the residual
    # every CHECK_EVERY iterations and freezes in between.
    assert int(its_j) <= its < int(its_j) + cg_mod.CHECK_EVERY
    assert res <= max(1e-11, 1e-6 / np.linalg.norm(b)) * 1.01
    np.testing.assert_allclose(res, float(res_j), rtol=0.5)


def test_precond_cuts_cg_iterations():
    a, b = _spd(96, 0)
    m, _ = _jacobi_pair(a)
    at = torch.from_numpy(a)
    _, plain, _ = port.cg_info(lambda z: at @ z, torch.from_numpy(b),
                               tol=1e-10, device="cpu")
    _, pc, _ = port.cg_info(lambda z: at @ z, torch.from_numpy(b),
                            tol=1e-10, precond=m, device="cpu")
    assert 2 * pc <= plain


@pytest.mark.parametrize("with_precond", [False, True])
def test_minres_matches_jax_on_an_indefinite_system(with_precond):
    a, b = _indefinite(64, 2)
    m, m_j = _jacobi_pair(a)
    at = torch.from_numpy(a)
    x = port.minres(lambda z: at @ z, torch.from_numpy(b), tol=1e-12,
                    precond=m if with_precond else None, device="cpu")
    x_j = jcg.minres(lambda z: jnp.asarray(a) @ z, jnp.asarray(b),
                     tol=1e-12, precond=m_j if with_precond else None)
    want = np.linalg.solve(a, b)
    # κ = 80, residuals at 1e-12 (in the M^-1 norm with M).
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-9, atol=1e-9)


def test_minres_without_precond_is_the_plain_recurrence():
    a, b = _indefinite(32, 3)
    at = torch.from_numpy(a)
    one = port.minres(lambda z: at @ z, torch.from_numpy(b), tol=1e-10,
                      device="cpu")
    ident = port.minres(lambda z: at @ z, torch.from_numpy(b), tol=1e-10,
                        precond=lambda r: r, device="cpu")
    # M = I: beta = sqrt(r^T r) = ||r|| and the target tol ||b||.
    np.testing.assert_allclose(one.numpy(), ident.numpy(), rtol=1e-12,
                               atol=1e-14)


def _small(kind):
    rng = np.random.default_rng(4)
    s = rng.standard_normal((8, 8))
    if kind == "spd":
        a = s @ s.T + 8 * np.eye(8)
    else:
        a = (s + s.T) / 2 + np.diag([-3.0, -2.0, 2.5, 3.0, 4.0, -4.0, 5.0,
                                     6.0])
    return a, rng.standard_normal(8)


_SOLVERS = {"spd": (port.solve_spd, jcg.solve_spd),
            "symmetric": (port.solve_symmetric, jcg.solve_symmetric)}


def _port_solve(kind):
    solve = _SOLVERS[kind][0]
    return lambda a, b: solve(port.DenseOperator((a + a.T) / 2), b,
                              tol=1e-13, device="cpu")


@pytest.mark.parametrize("kind", ["spd", "symmetric"])
def test_solve_gradcheck_and_gradgradcheck(kind):
    """First and second derivatives in the matrix and the right-hand
    side against central differences (gradcheck's default tolerances)."""
    a, b = _small(kind)
    inputs = (torch.from_numpy(a).requires_grad_(True),
              torch.from_numpy(b).requires_grad_(True))
    assert gradcheck(_port_solve(kind), inputs)
    assert gradgradcheck(_port_solve(kind), inputs)


@functools.lru_cache(maxsize=None)
def _jax_solve_grads(kind):
    a, b = _small(kind)
    c = np.cos(np.arange(8.0))
    solve = _SOLVERS[kind][1]

    def loss(a, b):
        a = (a + a.T) / 2
        x = solve(lambda z: a @ z, b, tol=1e-13)
        return jnp.sum(jnp.asarray(c) * x)

    val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    return float(val), tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("kind", ["spd", "symmetric"])
def test_solve_value_and_gradients_match_jax(kind):
    a, b = _small(kind)
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    loss = (torch.cos(torch.arange(8.0, dtype=torch.float64))
            * _port_solve(kind)(at, bt)).sum()
    loss.backward()
    val_j, (ga_j, gb_j) = _jax_solve_grads(kind)
    # Solves at 1e-13 on κ ~ 10.
    np.testing.assert_allclose(float(loss.detach()), val_j, rtol=1e-10)
    np.testing.assert_allclose(at.grad.numpy(), ga_j, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(bt.grad.numpy(), gb_j, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("solve", [port.solve_spd, port.solve_symmetric])
def test_bare_callable_is_refused(solve):
    a = torch.eye(4, dtype=torch.float64)
    with pytest.raises(TypeError, match="MatrixFreeOperator"):
        solve(lambda z: a @ z, torch.ones(4, dtype=torch.float64),
              device="cpu")


def _deflated_inputs(method):
    """A 48 x 48 symmetric matrix and an eigenpair to deflate: interior
    (the fourth) for MINRES, the minimum for CG."""
    rng = np.random.default_rng(5)
    s = rng.standard_normal((48, 48))
    a = (s + s.T) / 2 + np.diag(np.linspace(0.0, 30.0, 48))
    evals, evecs = np.linalg.eigh(a)
    idx = 3 if method == "minres" else 0
    return a, evals[idx], evecs[:, idx], rng.standard_normal(48)


@functools.lru_cache(maxsize=None)
def _jax_deflated(method, with_precond):
    a, lam, v, b = _deflated_inputs(method)
    c = np.sin(np.arange(48.0))
    # A constant of the solve (JAX's constructor reads concrete values).
    m = (jax_jacobi(JaxDense(jnp.asarray(a)), shift=lam) if with_precond
         else None)

    def loss(a, lam, b):
        a = (a + a.T) / 2
        x = jcg.solve_deflated(JaxDense(a), lam, jnp.asarray(v), b,
                               tol=1e-13, method=method, precond=m)
        return jnp.sum(jnp.asarray(c) * x), x

    (val, x), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(a), jnp.asarray(lam), jnp.asarray(b))
    return float(val), np.asarray(x), tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("method, with_precond", [
    ("minres", False), ("minres", True), ("cg", True)])
def test_solve_deflated_method_and_precond_match_jax(method, with_precond):
    a, lam, v, b = _deflated_inputs(method)
    at = torch.from_numpy(a).requires_grad_(True)
    lt = torch.tensor(lam, requires_grad=True)
    bt = torch.from_numpy(b).requires_grad_(True)
    sym = (at + at.T) / 2
    m = (port.jacobi_precond(torch.from_numpy(a), shift=lam)
         if with_precond else None)
    x = port.solve_deflated(port.DenseOperator(sym), lt, torch.from_numpy(v),
                            bt, tol=1e-13, method=method, precond=m,
                            device="cpu")
    loss = (torch.sin(torch.arange(48.0, dtype=torch.float64)) * x).sum()
    loss.backward()
    val_j, x_j, (ga_j, gl_j, gb_j) = _jax_deflated(method, with_precond)
    # Solves at 1e-13 on a deflated system with κ ~ 1e2.
    np.testing.assert_allclose(x.detach().numpy(), x_j, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(float(loss.detach()), val_j, rtol=1e-9)
    np.testing.assert_allclose(at.grad.numpy(), ga_j, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(float(lt.grad), float(gl_j), rtol=1e-7)
    np.testing.assert_allclose(bt.grad.numpy(), gb_j, rtol=1e-7, atol=1e-9)
    # The unsigned deflated system holds on v⊥ (MINRES: indefinite).
    p = np.eye(48) - np.outer(v, v)
    np.testing.assert_allclose(p @ (a - lam * np.eye(48)) @ x.detach().numpy(),
                               p @ b, atol=1e-9)


def test_solve_deflated_info_with_precond():
    a, lam, v, b = _deflated_inputs("cg")
    m, m_j = _jacobi_pair(a, shift=lam)
    x, its, res = port.solve_deflated_info(
        torch.from_numpy(a), torch.tensor(lam), torch.from_numpy(v),
        torch.from_numpy(b), tol=1e-12, precond=m, device="cpu")
    x_j, its_j, res_j = jcg.solve_deflated_info(
        JaxDense(jnp.asarray(a)), jnp.asarray(lam), jnp.asarray(v),
        jnp.asarray(b), tol=1e-12, precond=m_j)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-8,
                               atol=1e-10)
    assert int(its_j) <= its < int(its_j) + cg_mod.CHECK_EVERY
    assert res <= 1e-12


def test_minres_freezes_once_converged():
    """The F5 input (``tests/test_torch_second_order.py::_solve_inputs``,
    vector form): a deflated system singular on span(v), solved by MINRES
    to 1e-13.  Steps past convergence would divide by round-off; the
    frozen loop returns the pseudo-inverse solution."""
    rng = np.random.default_rng(31)
    s = np.random.default_rng(32).standard_normal((12, 12))
    a = (s + s.T) / 2
    lam = np.linalg.eigvalsh(a)[0] - 1.0
    b, u = rng.standard_normal(12), rng.standard_normal(12)
    v = u / np.linalg.norm(u)
    p = np.eye(12) - np.outer(v, v)
    want = np.linalg.pinv(p @ (a - lam * np.eye(12)) @ p) @ (p @ b)
    x = port.solve_deflated(torch.from_numpy(a), torch.tensor(lam),
                            torch.from_numpy(v), torch.from_numpy(b),
                            tol=1e-13, method="minres", device="cpu")
    np.testing.assert_allclose(x.numpy(), want, atol=1e-12)


def test_method_is_validated():
    a = torch.eye(4, dtype=torch.float64)
    v = torch.zeros(4, dtype=torch.float64)
    v[0] = 1.0
    with pytest.raises(ValueError, match="method must be cg|minres"):
        port.solve_deflated(a, 0.5, v, v, method="gmres", device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
