"""The port's Lanczos options (``reorth_chunks``, ``restart_mode``),
``lanczos_adaptive`` and ``power_iteration`` against the JAX package's
(CPU, f64 unless stated), from the same start vector."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.ops.lanczos import lanczos as jax_lanczos
from dominantsparseeigenad_tpu.ops.lanczos import (
    lanczos_adaptive as jax_adaptive)
from dominantsparseeigenad_tpu.ops.lanczos import (
    power_iteration as jax_power)
from dominantsparseeigenad_tpu.ops.operators import DenseOperator as JaxDense

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

torch.set_num_threads(2)

N, K = 64, 24


def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


def _v0(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


def _breakdown_inputs():
    """diag(1..8) and a start vector in a 2-dim invariant subspace: β
    vanishes at step 2, and the run restarts once."""
    v0 = np.zeros(8)
    v0[:2] = 1.0
    return np.diag(np.arange(1.0, 9.0)), v0


@functools.lru_cache(maxsize=None)
def _jax_run(case, reorth_chunks, restart_mode):
    a, v0, k = ((_sym(N, 0), _v0(N), K) if case == "dense"
                else (*_breakdown_inputs(), 8))
    res = jax.jit(lambda m, v: jax_lanczos(
        JaxDense(m), k, v0=v, reorth_chunks=reorth_chunks,
        restart_mode=restart_mode))(jnp.asarray(a), jnp.asarray(v0))
    return tuple(np.asarray(t) for t in res)


def _port_run(case, **kw):
    a, v0, k = ((_sym(N, 0), _v0(N), K) if case == "dense"
                else (*_breakdown_inputs(), 8))
    return port.lanczos(torch.from_numpy(a), k, v0=torch.from_numpy(v0),
                        device="cpu", **kw)


@pytest.mark.parametrize("chunks", [0, 3, 4])
def test_reorth_chunks_give_the_unchunked_coefficients(chunks):
    res = _port_run("dense", reorth_chunks=chunks)
    plain = _port_run("dense")
    # The port projects against the written rows in either case: the
    # same sums in the same order.
    assert torch.equal(res.alphas, plain.alphas)
    assert torch.equal(res.betas, plain.betas)
    assert torch.equal(res.basis, plain.basis)
    alphas_j, betas_j, _ = _jax_run("dense", chunks, "cond")
    # f64 recurrences that differ in summation order only.
    np.testing.assert_allclose(res.alphas.numpy(), alphas_j, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(res.betas.numpy(), betas_j, rtol=1e-10,
                               atol=1e-10)


def test_carry_without_breakdown_matches_cond_and_jax():
    carry = _port_run("dense", restart_mode="carry")
    cond = _port_run("dense")
    # Without a breakdown the carried direction is never selected.
    assert torch.equal(carry.alphas, cond.alphas)
    assert torch.equal(carry.betas, cond.betas)
    alphas_j, betas_j, _ = _jax_run("dense", 0, "carry")
    np.testing.assert_allclose(carry.alphas.numpy(), alphas_j, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(carry.betas.numpy(), betas_j, rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("restart_mode", ["cond", "carry"])
def test_breakdown_restart_keeps_the_spectrum(restart_mode):
    """After the breakdown both packages restart from their own random
    direction, so α and β differ past it; T's eigenvalues (the whole
    spectrum, k = n) and the converged extremal pairs agree."""
    res = _port_run("breakdown", restart_mode=restart_mode)
    assert float(res.betas[1]) == 0.0
    q = res.basis.numpy()
    np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-12)
    evals = np.linalg.eigvalsh(np.diag(res.alphas.numpy())
                               + np.diag(res.betas.numpy(), 1)
                               + np.diag(res.betas.numpy(), -1))
    alphas_j, betas_j, _ = _jax_run("breakdown", 0, restart_mode)
    evals_j = np.linalg.eigvalsh(np.diag(alphas_j) + np.diag(betas_j, 1)
                                 + np.diag(betas_j, -1))
    np.testing.assert_allclose(evals, np.arange(1.0, 9.0), atol=1e-12)
    np.testing.assert_allclose(evals, evals_j, atol=1e-12)
    a, v0 = _breakdown_inputs()
    lmin, vmin, lmax, vmax = port.lanczos_eigh(
        torch.from_numpy(a), 8, v0=torch.from_numpy(v0),
        restart_mode=restart_mode, device="cpu")
    assert abs(float(lmin) - 1.0) < 1e-12 and abs(float(lmax) - 8.0) < 1e-12
    np.testing.assert_allclose(vmin.numpy(), np.eye(8)[0], atol=1e-10)
    np.testing.assert_allclose(vmax.numpy(), np.eye(8)[7], atol=1e-10)


def test_restart_mode_is_validated():
    a = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError) as err:
        port.lanczos(a, 2, restart_mode="lazy", device="cpu")
    with pytest.raises(ValueError) as err_j:
        jax_lanczos(JaxDense(jnp.eye(4)), 2, restart_mode="lazy")
    assert str(err.value) == str(err_j.value)
    with pytest.raises(ValueError, match="restart_mode"):
        port.dominant_eigh(a, k=2, restart_mode="lazy", device="cpu")


def _tfim_h():
    return models.tfim_dense_hamiltonian(6, 1.0, device="cpu").numpy()


@functools.lru_cache(maxsize=None)
def _jax_adaptive(extreme, k, tol, dtype):
    h = _tfim_h()
    out = jax.jit(lambda m, v: jax_adaptive(
        JaxDense(m), k, extreme=extreme, tol=tol, v0=v))(
        jnp.asarray(h, dtype), jnp.asarray(_v0(h.shape[0], 2), dtype))
    return tuple(np.asarray(t) for t in (out[0], out[1], *out[2]))


@pytest.mark.parametrize("extreme", ["min", "max"])
def test_adaptive_matches_jax(extreme):
    h = _tfim_h()
    lam, v, info = port.lanczos_adaptive(
        torch.from_numpy(h), 60, extreme=extreme, tol=1e-8,
        v0=torch.from_numpy(_v0(h.shape[0], 2)), device="cpu")
    lam_j, v_j, k_j, res_j, conv_j = _jax_adaptive(extreme, 60, 1e-8,
                                                   jnp.float64)
    e = np.linalg.eigvalsh(h)
    assert float(info.converged) == float(conv_j) == 1.0
    # The same checkpoints on the same recurrence: the same exit.
    assert float(info.effective_k) == float(k_j) < 60
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=1e-12)
    np.testing.assert_allclose(float(lam), e[0 if extreme == "min" else -1],
                               rtol=1e-10)
    # The estimate β_m |y_m| rests on a tiny eigenvector entry, whose
    # absolute (not relative) accuracy is eps ||T||.
    np.testing.assert_allclose(float(info.residual), float(res_j),
                               rtol=1e-4)
    np.testing.assert_allclose(v.numpy(), v_j, atol=1e-6)


def test_adaptive_flags_an_unconverged_run():
    h = _tfim_h()
    _, _, info = port.lanczos_adaptive(
        torch.from_numpy(h), 6, tol=1e-10,
        v0=torch.from_numpy(_v0(h.shape[0], 2)), device="cpu")
    _, _, k_j, res_j, conv_j = _jax_adaptive("min", 6, 1e-10, jnp.float64)
    assert float(info.converged) == float(conv_j) == 0.0
    assert float(info.effective_k) == float(k_j) == 6.0
    np.testing.assert_allclose(float(info.residual), float(res_j),
                               rtol=1e-8)


def test_adaptive_floors_the_tolerance_in_float32():
    """tol = 1e-10 is below float32's reach; floored (50 eps), the run
    still exits and reports converged, as the JAX one does."""
    h = _tfim_h().astype(np.float32)
    lam, _, info = port.lanczos_adaptive(
        torch.from_numpy(h), 60, tol=1e-10,
        v0=torch.from_numpy(_v0(h.shape[0], 2).astype(np.float32)),
        device="cpu")
    lam_j, _, k_j, _, conv_j = _jax_adaptive("min", 60, 1e-10, jnp.float32)
    assert float(info.converged) == float(conv_j) == 1.0
    assert float(info.effective_k) < 60 and float(k_j) < 60
    # float32 recurrences: agreement to float32 round-off.
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=1e-5)


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_power_iteration_matches_jax(shift):
    a = _sym(32, 5)
    v0 = _v0(32, 6)
    lam, v = port.power_iteration(torch.from_numpy(a), 200,
                                  v0=torch.from_numpy(v0), shift=shift,
                                  device="cpu")
    lam_j, v_j = jax.jit(lambda m, x: jax_power(
        JaxDense(m), 200, v0=x, shift=shift))(jnp.asarray(a),
                                                jnp.asarray(v0))
    # The same 200 normalized products in f64.
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=1e-10)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-10)


# -- the same options on sharded vectors at p = 1 --------------------------------

@pytest.fixture
def solo(tmp_path):
    """A one-rank gloo group in this process: the sharded-vector layout at
    p = 1, whose sums over the ranks are real one-rank all_reduces."""
    import torch.distributed as dist
    port.init_distributed("gloo", f"file://{tmp_path}/store", 0, 1)
    try:
        yield port.make_mesh()
    finally:
        dist.destroy_process_group()


def _sharded(a, sg):
    return port.RowShardedOperator(torch.from_numpy(a), sg,
                                   vectors="sharded")


@pytest.mark.parametrize("restart_mode", ["cond", "carry"])
def test_sharded_vectors_lanczos_matches_jax(solo, restart_mode):
    """Both restart modes on sharded vectors (p = 1) against JAX's run and
    the unsharded port's, without and with a breakdown."""
    a, v0 = _sym(N, 0), _v0(N)
    res = port.lanczos(_sharded(a, solo), K, v0=torch.from_numpy(v0),
                       restart_mode=restart_mode, device="cpu")
    plain = _port_run("dense", restart_mode=restart_mode)
    np.testing.assert_allclose(res.alphas.numpy(), plain.alphas.numpy(),
                               rtol=1e-12, atol=1e-12)
    alphas_j, betas_j, _ = _jax_run("dense", 0, restart_mode)
    np.testing.assert_allclose(res.alphas.numpy(), alphas_j, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(res.betas.numpy(), betas_j, rtol=1e-10,
                               atol=1e-10)
    a, v0 = _breakdown_inputs()
    res = port.lanczos(_sharded(a, solo), 8, v0=torch.from_numpy(v0),
                       restart_mode=restart_mode, device="cpu")
    assert float(res.betas[1]) == 0.0
    evals = np.linalg.eigvalsh(np.diag(res.alphas.numpy())
                               + np.diag(res.betas.numpy(), 1)
                               + np.diag(res.betas.numpy(), -1))
    np.testing.assert_allclose(evals, np.arange(1.0, 9.0), atol=1e-12)


def test_sharded_vectors_narrow_basis_matches_unsharded(solo):
    """A float32 basis of a float64 operator on sharded vectors (its
    projection coefficients summed over the ranks) against the unsharded
    port's and JAX's Ritz values."""
    a, v0 = _sym(N, 0), _v0(N)
    got = port.lanczos_eigh(_sharded(a, solo), K, extreme="min",
                            v0=torch.from_numpy(v0),
                            basis_dtype=torch.float32, device="cpu")
    want = port.lanczos_eigh(torch.from_numpy(a), K, extreme="min",
                             v0=torch.from_numpy(v0),
                             basis_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=1e-12)


@pytest.mark.parametrize("extreme", ["min", "max"])
def test_sharded_vectors_adaptive_matches_jax(solo, extreme):
    h = _tfim_h()
    lam, v, info = port.lanczos_adaptive(
        _sharded(h, solo), 60, extreme=extreme, tol=1e-8,
        v0=torch.from_numpy(_v0(h.shape[0], 2)), device="cpu")
    lam_j, v_j, k_j, res_j, conv_j = _jax_adaptive(extreme, 60, 1e-8,
                                                   jnp.float64)
    assert float(info.converged) == float(conv_j) == 1.0
    assert float(info.effective_k) == float(k_j) < 60
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=1e-12)
    np.testing.assert_allclose(v.numpy(), v_j, atol=1e-6)


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_sharded_vectors_power_iteration_matches_jax(solo, shift):
    a, v0 = _sym(32, 5), _v0(32, 6)
    lam, v = port.power_iteration(_sharded(a, solo), 200,
                                  v0=torch.from_numpy(v0), shift=shift,
                                  device="cpu")
    lam_j, v_j = jax.jit(lambda m, x: jax_power(
        JaxDense(m), 200, v0=x, shift=shift))(jnp.asarray(a),
                                                jnp.asarray(v0))
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=1e-10)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-10)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
