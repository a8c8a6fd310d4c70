"""The port's Lanczos (``ops/lanczos.py``) against the JAX package's, from
the same start vector (CPU, f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.ops.lanczos import lanczos as jax_lanczos
from dominantsparseeigenad_tpu.ops.operators import DenseOperator as JaxDense
from dominantsparseeigenad_tpu.ops.sparse import random_bell_operator

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)


def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


@pytest.mark.parametrize("reorth_passes", [1, 2])
def test_coefficients_match_jax(reorth_passes):
    n, k = 64, 20
    a = _sym(n, 0)
    v0 = np.random.default_rng(1).standard_normal(n)
    res_j = jax_lanczos(JaxDense(jnp.asarray(a)), k, v0=jnp.asarray(v0),
                        reorth_passes=reorth_passes)
    res = port.lanczos(port.dense_operator_from_numpy(a, device="cpu"), k,
                       v0=torch.from_numpy(v0), reorth_passes=reorth_passes,
                       device="cpu")
    # f64 recurrences that differ only in summation order.
    np.testing.assert_allclose(res.alphas.numpy(), np.asarray(res_j.alphas),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(res.betas.numpy(), np.asarray(res_j.betas),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(res.basis.numpy(), np.asarray(res_j.basis),
                               atol=1e-10)


def test_coefficients_match_jax_on_bell_operator():
    jop = random_bell_operator(__import__("jax").random.PRNGKey(2), 128, 16,
                               5, dtype=jnp.float64, use_pallas=False)
    op = port.bell_operator_from_numpy(np.asarray(jop.vals),
                                       np.asarray(jop.cols), 128,
                                       symmetric=True, device="cpu")
    v0 = np.random.default_rng(3).standard_normal(128)
    res_j = jax_lanczos(jop, 30, v0=jnp.asarray(v0))
    res = port.lanczos(op, 30, v0=torch.from_numpy(v0), device="cpu")
    np.testing.assert_allclose(res.alphas.numpy(), np.asarray(res_j.alphas),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(res.betas.numpy(), np.asarray(res_j.betas),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("extreme", ["min", "max", "both"])
def test_lanczos_eigh_matches_eigvalsh(extreme):
    n = 64
    a = _sym(n, 4)
    evals, evecs = np.linalg.eigh(a)
    out = port.lanczos_eigh(torch.from_numpy(a), n, extreme=extreme,
                            device="cpu")
    pairs = {"min": [(0, out)], "max": [(-1, out)],
             "both": [(0, out[:2]), (-1, out[2:])]}[extreme]
    for idx, (lam, v) in pairs:
        # Full reorthogonalization at k = n: converged to f64 round-off.
        assert abs(float(lam) - evals[idx]) <= 1e-10 * abs(evals[idx])
        ref = evecs[:, idx] * np.sign(evecs[np.argmax(np.abs(evecs[:, idx])),
                                            idx])
        np.testing.assert_allclose(v.numpy(), ref, atol=1e-8)


def test_breakdown_restarts_with_an_orthogonal_vector():
    # v0 spans an invariant subspace of dimension 2: beta vanishes at step
    # 2 and the run must go on with a fresh vector orthogonal to the basis.
    a = np.diag(np.arange(1.0, 9.0))
    v0 = np.zeros(8)
    v0[:2] = 1.0
    res = port.lanczos(torch.from_numpy(a), 8, v0=torch.from_numpy(v0),
                       device="cpu")
    assert float(res.betas[1]) == 0.0
    q = res.basis.numpy()
    np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-12)
    lam_min, _, lam_max, _ = port.lanczos_eigh(
        torch.from_numpy(a), 8, v0=torch.from_numpy(v0), device="cpu")
    assert abs(float(lam_min) - 1.0) < 1e-12
    assert abs(float(lam_max) - 8.0) < 1e-12


def test_rejects_bad_arguments():
    a = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        port.lanczos(a, 0, device="cpu")
    with pytest.raises(ValueError):
        port.lanczos_eigh(a, 4, extreme="middle", device="cpu")
