"""The slice as a whole: the port's ``dominant_eigh`` and its IFT backward
against the JAX package's ``dominant_eigh`` and ``jax.grad`` (CPU, f64).

The sparse operator is the one of ``test_sparse.py::test_bell_eigh_gradient``
(n = 64, bs = 8, 3 blocks per row, k = 50), carried across with
``bell_operator_from_numpy``.  Forward eigenpairs are converged, so the
two packages' different start vectors do not matter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu import (
    BellOperator as JaxBell, DenseOperator as JaxDense,
    MatrixFreeOperator as JaxMF, dominant_eigh as jax_dominant_eigh,
    random_bell_operator)

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)

K = 50
EXTREMES = ["min", "max"]


@functools.lru_cache(maxsize=None)
def _jax_operator():
    op = random_bell_operator(jax.random.PRNGKey(1), n=64, bs=8,
                              blocks_per_row=3, dtype=jnp.float64,
                              use_pallas=False)
    c = np.random.default_rng(11).standard_normal(64)
    return np.asarray(op.vals), np.asarray(op.cols), c


def _port_bell(vals):
    _, cols, _ = _jax_operator()
    t = torch.tensor(vals, requires_grad=True)
    return t, port.bell_operator_from_numpy(vals, cols, 64, symmetric=True,
                                            device="cpu").with_vals(t)


def _jax_bell(vals):
    _, cols, _ = _jax_operator()
    return JaxBell(vals, jnp.asarray(cols), 64, symmetric=True,
                   use_pallas=False)


@functools.lru_cache(maxsize=None)
def _jax_results(extreme):
    """λ, v, ∂λ/∂vals and ∂(c^T v)^2/∂vals from the JAX package."""
    vals, _, c = _jax_operator()

    def lam_of(v):
        return jax_dominant_eigh(_jax_bell(v), k=K, extreme=extreme)[0]

    def loss(v):
        _, vec = jax_dominant_eigh(_jax_bell(v), k=K, extreme=extreme,
                                   tol=1e-12)
        return jnp.vdot(jnp.asarray(c), vec) ** 2

    lam, vec = jax_dominant_eigh(_jax_bell(jnp.asarray(vals)), k=K,
                                 extreme=extreme)
    return (float(lam), np.asarray(vec),
            np.asarray(jax.grad(lam_of)(jnp.asarray(vals))),
            np.asarray(jax.grad(loss)(jnp.asarray(vals))))


@pytest.mark.parametrize("extreme", EXTREMES)
def test_eigenpair_matches_jax(extreme):
    vals, _, _ = _jax_operator()
    lam_j, v_j, _, _ = _jax_results(extreme)
    _, op = _port_bell(vals)
    lam, v = port.dominant_eigh(op, k=K, extreme=extreme, device="cpu")
    # Converged f64 Lanczos on both sides; v after the sign gauge.
    assert abs(float(lam.detach()) - lam_j) <= 1e-10 * abs(lam_j)
    np.testing.assert_allclose(v.detach().numpy(), v_j, atol=1e-8)


@pytest.mark.parametrize("extreme", EXTREMES)
def test_eigenvalue_gradient_matches_jax(extreme):
    vals, _, _ = _jax_operator()
    _, _, g_j, _ = _jax_results(extreme)
    t, op = _port_bell(vals)
    lam, _ = port.dominant_eigh(op, k=K, extreme=extreme, device="cpu")
    lam.backward()
    # dλ/dvals = v v^T on the pattern: the same products of converged v.
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("extreme", EXTREMES)
def test_eigenvector_loss_gradient_matches_jax(extreme):
    vals, _, c = _jax_operator()
    _, _, _, g_j = _jax_results(extreme)
    t, op = _port_bell(vals)
    _, v = port.dominant_eigh(op, k=K, extreme=extreme, tol=1e-12,
                              device="cpu")
    (torch.dot(torch.from_numpy(c), v) ** 2).backward()
    # Goes through the deflated CG on both sides, each stopped at a 1e-12
    # relative residual: the two solutions differ by ~1e-12 times the
    # condition number of the deflated system.
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=1e-6, atol=1e-9)


def _dense_matrix():
    vals, cols, _ = _jax_operator()
    return np.array(_jax_bell(jnp.asarray(vals)).to_dense())


@pytest.mark.parametrize("extreme", EXTREMES)
def test_dense_operator_gradients_match_jax(extreme):
    a = _dense_matrix()
    c = _jax_operator()[2]

    def loss_j(m):
        lam, v = jax_dominant_eigh(JaxDense(m), k=K, extreme=extreme,
                                   tol=1e-12)
        return lam + jnp.vdot(jnp.asarray(c), v) ** 2

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(a)))
    at = torch.tensor(a, requires_grad=True)
    lam, v = port.dominant_eigh(port.DenseOperator(at), k=K, extreme=extreme,
                                tol=1e-12, device="cpu")
    (lam + torch.dot(torch.from_numpy(c), v) ** 2).backward()
    np.testing.assert_allclose(at.grad.numpy(), g_j, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("extreme", EXTREMES)
def test_matrix_free_scalar_parameter_gradient_matches_jax(extreme):
    a0 = _dense_matrix()
    rng = np.random.default_rng(12)
    a1 = rng.standard_normal((64, 64))
    a1 = (a1 + a1.T) / 2
    c = _jax_operator()[2]
    g0 = 0.3

    def loss_j(g):
        op = JaxMF(lambda p, x: jnp.asarray(a0) @ x
                   + p * (jnp.asarray(a1) @ x), g, 64, jnp.float64)
        lam, v = jax_dominant_eigh(op, k=K, extreme=extreme, tol=1e-12)
        return lam + jnp.vdot(jnp.asarray(c), v) ** 2

    g_j = float(jax.grad(loss_j)(jnp.asarray(g0)))
    a0t, a1t = torch.from_numpy(a0), torch.from_numpy(a1)
    gt = torch.tensor(g0, dtype=torch.float64, requires_grad=True)
    op = port.MatrixFreeOperator(lambda p, x: a0t @ x + p * (a1t @ x), gt,
                                 64, torch.float64)
    lam, v = port.dominant_eigh(op, k=K, extreme=extreme, tol=1e-12,
                                device="cpu")
    (lam + torch.dot(torch.from_numpy(c), v) ** 2).backward()
    assert abs(float(gt.grad) - g_j) <= 1e-6 * abs(g_j)


def test_gradient_is_not_accumulated_for_unused_inputs():
    vals, _, _ = _jax_operator()
    _, op = _port_bell(vals)
    frozen = op.with_vals(op.vals.detach())
    lam, v = port.dominant_eigh(frozen, k=K, device="cpu")
    assert not lam.requires_grad and not v.requires_grad


def test_rejects_bad_extreme():
    # "both" is supported since the second-order slice; an unknown name,
    # and "both" with with_info (as in JAX), are refused.
    with pytest.raises(ValueError):
        port.dominant_eigh(torch.eye(4, dtype=torch.float64), k=4,
                           extreme="middle", device="cpu")
    with pytest.raises(ValueError):
        port.dominant_eigh(torch.eye(4, dtype=torch.float64), k=4,
                           extreme="both", with_info=True, device="cpu")
