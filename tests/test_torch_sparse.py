"""The port's ``BellOperator``, ``random_bell_operator`` and
``bell_operator_from_numpy`` against the JAX package's (CPU, f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.ops.sparse import (
    BellOperator as JaxBell, random_bell_operator as jax_random_bell)

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)


def _sparse(n, density, seed, symmetric=True):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    return (a + a.T) / 2 if symmetric else a


def test_from_dense_round_trip_and_layout():
    a = _sparse(128, 0.05, 1)
    op = port.BellOperator.from_dense(a, bs=16, device="cpu")
    jop = JaxBell.from_dense(a, bs=16, use_pallas=False)
    np.testing.assert_array_equal(op.to_dense().numpy(), a)
    np.testing.assert_array_equal(op.vals.numpy(), np.asarray(jop.vals))
    np.testing.assert_array_equal(op.cols.numpy(), np.asarray(jop.cols))
    assert op.cols.dtype == torch.int32
    assert (op.dim, op.block_size, op.nnz) == (128, 16, jop.nnz)


@pytest.mark.parametrize("symmetric", [True, False])
def test_matvec_rmatvec_match_jax(symmetric):
    a = _sparse(96, 0.1, 2, symmetric=symmetric)
    jop = JaxBell.from_dense(a, bs=16, symmetric=symmetric, use_pallas=False)
    op = port.bell_operator_from_numpy(np.asarray(jop.vals),
                                       np.asarray(jop.cols), 96,
                                       symmetric=symmetric, device="cpu")
    x = np.random.default_rng(3).standard_normal(96)
    xt = torch.from_numpy(x)
    # f64, the same products summed in another order.
    np.testing.assert_allclose(op.matvec(xt).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.rmatvec(xt).numpy(),
                               np.asarray(jop.rmatvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.rmatvec(xt).numpy(), a.T @ x,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n, bs, bpr", [(64, 8, 3), (128, 16, 5),
                                        (96, 32, 1), (256, 16, 9)])
def test_random_bell_operator_structure_matches_jax(n, bs, bpr):
    jop = jax_random_bell(jax.random.PRNGKey(0), n, bs, bpr,
                          dtype=jnp.float64, use_pallas=False)
    op = port.random_bell_operator(
        n, bs, bpr, generator=torch.Generator().manual_seed(0),
        dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(op.cols.numpy(), np.asarray(jop.cols))
    assert op.vals.shape == jop.vals.shape and op.symmetric
    dense = op.to_dense()
    assert torch.equal(dense, dense.T)          # symmetric exactly
    # The same scale: entry variance 1/(bpr*bs) off the diagonal blocks.
    scale2 = float(op.vals[:, 1:].square().mean()) if bpr > 1 else None
    if scale2 is not None:
        assert abs(scale2 * bpr * bs - 1.0) < 0.1


def test_random_bell_operator_bf16_values():
    op = port.random_bell_operator(64, 8, 3, vals_dtype=torch.bfloat16,
                                   device="cpu")
    assert op.vals.dtype == torch.bfloat16 and op.dtype == torch.float32
    x = torch.randn(64, generator=torch.Generator().manual_seed(1))
    ref = op.to_dense() @ x
    torch.testing.assert_close(op.matvec(x), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vals_dtype", ["float64", "bfloat16"])
def test_bell_operator_from_numpy_reproduces_jax_matvec(vals_dtype):
    jop = jax_random_bell(jax.random.PRNGKey(4), 128, 16, 5,
                          dtype=jnp.float64, use_pallas=False)
    x = np.random.default_rng(5).standard_normal(128)
    if vals_dtype == "bfloat16":
        jop = jop.astype_vals(jnp.bfloat16)
        jop = JaxBell(jop.vals, jop.cols, 128, symmetric=True,
                      use_pallas=False, compute_dtype=jnp.float32)
        x = x.astype(np.float32)
    op = port.bell_operator_from_numpy(np.asarray(jop.vals),
                                       np.asarray(jop.cols), 128,
                                       symmetric=True, device="cpu")
    assert str(op.vals.dtype) == f"torch.{vals_dtype}"
    y = op.matvec(torch.from_numpy(x)).numpy()
    y_jax = np.asarray(jop.matvec(jnp.asarray(x)))
    # f64: summation order; bf16 storage: the same upcast values, f32 sums.
    tol = 1e-12 if vals_dtype == "float64" else 1e-5
    np.testing.assert_allclose(y, y_jax, rtol=tol, atol=tol)


def test_with_vals_and_astype_keep_pattern():
    op = port.random_bell_operator(64, 8, 3, dtype=torch.float64,
                                   device="cpu")
    op2 = op.with_vals(2 * op.vals)
    assert op2.cols is op.cols and op2.symmetric
    torch.testing.assert_close(op2.to_dense(), 2 * op.to_dense())
    op3 = op.astype_vals(torch.float32)
    assert op3.vals.dtype == torch.float32 and op3.dtype == torch.float64
    assert op.parameters() == [op.vals] and op.device.type == "cpu"


@pytest.mark.parametrize("bad", ["negative", "too_large", "shape"])
def test_bell_operator_rejects_bad_cols(bad):
    vals = torch.zeros(4, 2, 8, 8)
    cols = torch.zeros(4, 2, dtype=torch.int32)
    if bad == "negative":
        cols[0, 0] = -1
    elif bad == "too_large":
        cols[1, 1] = 4
    else:
        cols = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        port.BellOperator(vals, cols, 32)
