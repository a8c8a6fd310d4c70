"""The port's CG and deflated solve (``ops/cg.py``) against the JAX
package's (CPU, f64)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.ops.cg import (
    solve_deflated as jax_solve_deflated)
from dominantsparseeigenad_tpu.ops.operators import DenseOperator as JaxDense

import dominantsparseeigenad_tpu_torch as port

cg_mod = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")

torch.set_num_threads(2)


def _problem(n=48, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    evals, evecs = np.linalg.eigh(a)
    return a, evals, evecs, rng.standard_normal(n)


@pytest.mark.parametrize("extreme, sign", [("min", 1.0), ("max", -1.0)])
def test_solve_deflated_matches_jax(extreme, sign):
    a, evals, evecs, b = _problem()
    idx = 0 if extreme == "min" else -1
    lam, v = evals[idx], evecs[:, idx]
    x_j = jax_solve_deflated(JaxDense(jnp.asarray(a)), jnp.asarray(lam),
                             jnp.asarray(v), jnp.asarray(b),
                             definite_sign=sign, tol=1e-12)
    op = port.dense_operator_from_numpy(a, device="cpu")
    x = port.solve_deflated(op, torch.tensor(lam), torch.from_numpy(v),
                            torch.from_numpy(b), definite_sign=sign,
                            tol=1e-12, device="cpu")
    # Both solved to a 1e-12 relative residual on a system whose
    # condition number is (spread / gap) ~ 1e2.
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-8,
                               atol=1e-8)
    # And x solves the unsigned deflated system on v⊥.
    p = np.eye(len(b)) - np.outer(v, v)
    np.testing.assert_allclose(p @ (a - lam * np.eye(len(b))) @ x.numpy(),
                               p @ b, atol=1e-9)
    assert abs(float(torch.dot(x, torch.from_numpy(v)))) < 1e-13


def test_rhs_parallel_to_v_returns_zero():
    a, evals, evecs, _ = _problem(seed=1)
    v = torch.from_numpy(evecs[:, 0])
    x = port.solve_deflated(torch.from_numpy(a), torch.tensor(evals[0]), v,
                            3.0 * v, tol=1e-12, device="cpu")
    assert float(torch.linalg.vector_norm(x)) < 1e-12


def test_cg_solves_spd_system():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((40, 40))
    a = m @ m.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    at = torch.from_numpy(a)
    x = port.cg(lambda z: at @ z, torch.from_numpy(b), tol=1e-12,
                device="cpu")
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), rtol=1e-10,
                               atol=1e-12)


def test_residual_is_read_every_check_every_iterations():
    a, evals, evecs, b = _problem(seed=3)
    x, its, res = port.solve_deflated_info(
        torch.from_numpy(a), torch.tensor(evals[0]),
        torch.from_numpy(evecs[:, 0]), torch.from_numpy(b), tol=1e-10,
        device="cpu")
    assert its > 0 and its % cg_mod.CHECK_EVERY == 0
    assert res <= 1e-10
    _, its_capped, _ = port.solve_deflated_info(
        torch.from_numpy(a), torch.tensor(evals[0]),
        torch.from_numpy(evecs[:, 0]), torch.from_numpy(b), tol=1e-10,
        maxiter=7, device="cpu")
    assert its_capped == 7


def test_zero_rhs_takes_no_iteration():
    a, evals, evecs, _ = _problem(seed=4)
    x, its, res = port.solve_deflated_info(
        torch.from_numpy(a), torch.tensor(evals[-1]),
        torch.from_numpy(evecs[:, -1]), torch.zeros(48, dtype=torch.float64),
        definite_sign=-1.0, device="cpu")
    assert its == 0 and res == 0.0 and not x.any()
