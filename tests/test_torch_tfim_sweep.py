"""The port's ``tfim_observables_sweep`` and ``tfim_energy_gap``
(``models/tfim.py``) against the JAX package's and against ED (CPU, f64)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.models import tfim_energy_gap as jax_gap
from dominantsparseeigenad_tpu.models import (
    tfim_observables_sweep as jax_sweep)

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

torch.set_num_threads(2)

N, K = 8, 60
GS = (0.6, 1.0, 1.35)


@functools.lru_cache(maxsize=None)
def _jax_sweep():
    return np.asarray(jax.jit(lambda z: jax_sweep(
        N, z, k=K, tol=1e-12, reorth_chunks=2))(jnp.asarray(GS)))


def test_sweep_matches_pointwise_passes_and_jax():
    """``tests/test_tfim.py:142-160``: the sweep reproduces the pointwise
    E0, dE0/dg and χ_F, and JAX's sweep (carry restart by default in
    both)."""
    out = models.tfim_observables_sweep(N, GS, k=K, tol=1e-12,
                                        reorth_chunks=2, device="cpu")
    assert out.shape == (3, 3) and out.dtype == torch.float64
    for i, g in enumerate(GS):
        e, de, _ = port.value_d1_d2(
            lambda gg: models.tfim_ground_energy(N, gg, k=K, tol=1e-12,
                                                 device="cpu"), g,
            device="cpu")
        chi = models.fidelity_susceptibility(N, g, k=K, tol=1e-12,
                                             device="cpu")
        # The JAX test's bars: the sweep changes no math.
        np.testing.assert_allclose(float(out[i, 0]), float(e), rtol=1e-10)
        np.testing.assert_allclose(float(out[i, 1]), float(de), rtol=1e-8)
        np.testing.assert_allclose(float(out[i, 2]), float(chi), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), _jax_sweep(), rtol=1e-6)
    # And ED at every point.
    ed = np.array([[float(t) for t in models.tfim_ed_observables(
        N, g, device="cpu")] for g in GS])
    np.testing.assert_allclose(out.numpy(), ed[:, [0, 1, 3]], rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_restart_sweep():
    return np.asarray(jax.jit(lambda z: jax_sweep(
        6, z, k=16, tol=1e-12, restart_cycles=2))(jnp.asarray([0.8, 1.3])))


def test_sweep_forwards_restart_cycles_to_their_refusal():
    """The sweep forwards ``restart_cycles`` to ``dominant_eigh`` (where
    it once met its refusal): with the thick-restart forward, each lane
    on its own under ``vmap``, (E0, dE0/dg, χ_F) equal JAX's sweep and
    ED's (the starts differ, the converged values do not)."""
    out = models.tfim_observables_sweep(6, [0.8, 1.3], k=16, tol=1e-12,
                                        restart_cycles=2, device="cpu")
    ed = np.array([[float(t) for t in models.tfim_ed_observables(
        6, g, device="cpu")] for g in (0.8, 1.3)])[:, [0, 1, 3]]
    np.testing.assert_allclose(out.numpy(), ed, rtol=1e-9)
    np.testing.assert_allclose(out.numpy(), _jax_restart_sweep(),
                               rtol=1e-9)


@functools.lru_cache(maxsize=None)
def _jax_gap(g):
    f = jax.jit(jax.value_and_grad(lambda gg: jax_gap(N, gg, k=1 << N)))
    val, d = f(jnp.float64(g))
    return float(val), float(d)


def test_energy_gap_matches_jax_and_ed():
    """``tests/test_tfim.py:84-100``: E1 - E0 by the block solver against
    dense ED, and its derivative against JAX's."""
    g = torch.tensor(1.4, dtype=torch.float64, requires_grad=True)
    gap = models.tfim_energy_gap(N, g, k=1 << N, device="cpu")
    (dgap,) = torch.autograd.grad(gap, g)
    evals = torch.linalg.eigvalsh(models.tfim_dense_hamiltonian(
        N, 1.4, device="cpu"))
    val_j, d_j = _jax_gap(1.4)
    np.testing.assert_allclose(float(gap.detach()),
                               float(evals[1] - evals[0]), rtol=1e-9)
    np.testing.assert_allclose(float(gap.detach()), val_j, rtol=1e-9)
    np.testing.assert_allclose(float(dgap), d_j, rtol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
