"""The port's ``lobpcg_eigh`` (``ops/lobpcg.py``) against the JAX package's
(CPU, f64).

JAX draws its start block as ``jax.random.normal(key, (n, r))``; the test
draws the same block from JAX and hands it to the port as ``x0``, so both
run the same iteration from the same start.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu import DenseOperator as JaxDense
from dominantsparseeigenad_tpu import lobpcg_eigh as jax_lobpcg_eigh
from dominantsparseeigenad_tpu import random_bell_operator

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)

TOL = 1e-9
MAXITER = 400
CASES = ["dense", "bell"]
EXTREMES = ["min", "max"]


@functools.lru_cache(maxsize=None)
def _operators(case):
    """(JAX operator, port operator, r) for a dense matrix and for a
    banded ``BellOperator`` (``use_pallas=False``, as test_sparse does)."""
    if case == "dense":
        a = np.random.default_rng(1).standard_normal((96, 96))
        a = (a + a.T) / 2
        return (JaxDense(jnp.asarray(a)),
                port.dense_operator_from_numpy(a, device="cpu"), 3)
    op = random_bell_operator(jax.random.PRNGKey(17), n=256, bs=32,
                              blocks_per_row=5, dtype=jnp.float64,
                              use_pallas=False)
    return (op, port.bell_operator_from_numpy(
        np.array(op.vals), np.array(op.cols), 256, symmetric=True,
        device="cpu"), 4)


def _start_block(n, r, key=0):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(key), (n, r), jnp.float64)))


@functools.lru_cache(maxsize=None)
def _jax_result(case, extreme):
    op_j, _, r = _operators(case)
    lams, x, info = jax_lobpcg_eigh(op_j, r, extreme=extreme, tol=TOL,
                                    maxiter=MAXITER,
                                    key=jax.random.PRNGKey(0),
                                    with_info=True)
    return (np.asarray(lams), np.asarray(x),
            tuple(float(f) for f in info))


def _port_result(case, extreme):
    _, op, r = _operators(case)
    return port.lobpcg_eigh(op, r, extreme=extreme, tol=TOL,
                            maxiter=MAXITER, x0=_start_block(op.dim, r),
                            with_info=True, device="cpu")


@pytest.mark.parametrize("extreme", EXTREMES)
@pytest.mark.parametrize("case", CASES)
def test_pairs_match_jax(case, extreme):
    lams_j, x_j, _ = _jax_result(case, extreme)
    lams, x, _ = _port_result(case, extreme)
    # Both converged to a 1e-9 block residual from the same start block:
    # the eigenvalues agree to round-off (measured ~1e-15), the vectors to
    # the residual over the gap (measured ~1e-9), after the sign gauge.
    np.testing.assert_allclose(lams.numpy(), lams_j, rtol=1e-9)
    np.testing.assert_allclose(x.numpy(), x_j, atol=1e-6)
    np.testing.assert_allclose(x.T.numpy() @ x.numpy(), np.eye(x.shape[1]),
                               atol=1e-12)


@pytest.mark.parametrize("extreme", EXTREMES)
@pytest.mark.parametrize("case", CASES)
def test_info_matches_jax(case, extreme):
    _, _, (its_j, res_j, conv_j) = _jax_result(case, extreme)
    _, _, info = _port_result(case, extreme)
    assert isinstance(info, port.LobpcgInfo)
    assert conv_j == 1.0 and float(info.converged) == 1.0
    # Both stop at the first iteration whose residual passes; round-off
    # near the threshold may move that by one.
    assert abs(float(info.iterations) - its_j) <= 1
    assert float(info.residual) <= TOL and res_j <= TOL


def test_values_match_dense_eigh_from_the_default_generator():
    _, op, r = _operators("bell")
    ew = np.linalg.eigvalsh(op.to_dense().numpy())
    lams, x = port.lobpcg_eigh(op, r, tol=TOL, maxiter=MAXITER,
                               device="cpu")
    np.testing.assert_allclose(lams.numpy(), ew[:r], rtol=1e-9)
    lams, _ = port.lobpcg_eigh(op, r, extreme="max", tol=TOL,
                               maxiter=MAXITER, device="cpu")
    np.testing.assert_allclose(lams.numpy(), ew[::-1][:r], rtol=1e-9)


def test_block_preconditioner_is_applied():
    _, op, r = _operators("dense")
    calls = []

    def precond(R):
        calls.append(R.shape)
        return R

    _, _, info = port.lobpcg_eigh(op, r, tol=TOL, maxiter=MAXITER,
                                  x0=_start_block(op.dim, r),
                                  precond=precond, with_info=True,
                                  device="cpu")
    # The identity preconditioner leaves the iteration as it was.
    assert calls and all(s == (op.dim, r) for s in calls)
    assert len(calls) == int(float(info.iterations))


def test_dim_guard_and_bad_arguments():
    a = torch.eye(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="dim >= 3"):
        port.lobpcg_eigh(a, 4, device="cpu")
    with pytest.raises(ValueError, match="extreme"):
        port.lobpcg_eigh(a, 2, extreme="both", device="cpu")
    with pytest.raises(ValueError, match="x0 must be"):
        port.lobpcg_eigh(a, 2, x0=torch.zeros(8, 3, dtype=torch.float64),
                         device="cpu")
