"""Config #4's transfer observables, ``transfer_spectral_gap`` and
``correlation_length``, against the JAX package's (CPU, f64): values and
d/dβ through the CTMRG environment and the non-symmetric solver, and the
correlation length against the dense ``eigvals`` of the same transfer
matrix, in the disordered (β = 0.35) and the ordered (β = 0.5) phase."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.models import (
    correlation_length as jax_xi, transfer_spectral_gap as jax_gap)

from dominantsparseeigenad_tpu_torch import models

torch.set_num_threads(2)

CHI, STEPS = 8, 12
BETAS = (0.35, 0.5)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def reference():
    """The JAX package's value and d/dβ of both observables at each β
    (one jitted value_and_grad per observable)."""
    fns = {"gap": jax_gap, "xi": jax_xi}
    out = {}
    for name, fn in fns.items():
        vg = jax.jit(jax.value_and_grad(
            lambda b, fn=fn: fn(b, chi=CHI, n_steps=STEPS)))
        for beta in BETAS:
            out[name, beta] = tuple(float(t) for t in vg(jnp.float64(beta)))
    return out


def _port(name, beta):
    fn = {"gap": models.transfer_spectral_gap,
          "xi": models.correlation_length}[name]
    b = torch.tensor(beta, dtype=torch.float64, requires_grad=True)
    value = fn(b, chi=CHI, n_steps=STEPS, device="cpu")
    (d,) = torch.autograd.grad(value, b)
    return float(value.detach()), float(d)


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("name", ["gap", "xi"])
def test_transfer_observable_and_beta_derivative_match_jax(name, beta,
                                                           reference):
    value, d = _port(name, beta)
    want, d_want = reference[name, beta]
    np.testing.assert_allclose(value, want, rtol=1e-8)
    np.testing.assert_allclose(d, d_want, rtol=1e-6)
    if name == "xi":
        assert d > 0                 # ξ grows towards β_c from both sides
    else:
        assert value > 0


@pytest.mark.parametrize("beta", BETAS)
def test_correlation_length_matches_dense_eigvals(beta):
    """ξ from the two leading moduli of ``eigvals`` of the same transfer
    matrix: at β = 0.35 to 1e-6, at β = 0.5 (the top pair quasi-degenerate,
    ξ > 100, which only the Arnoldi-seeded forward resolves) to 1e-4, the
    JAX package's bars (``tests/test_ising2d.py``)."""
    c, e, t = models.ctmrg_environment(beta, chi=CHI, n_steps=STEPS,
                                       device="cpu")
    m = models.transfer_operator(c, e, t, device="cpu").a.numpy()
    w = np.sort(np.abs(np.linalg.eigvals(m)))[::-1]
    xi_dense = 1.0 / math.log(w[0] / w[1])
    xi = float(models.correlation_length(beta, chi=CHI, n_steps=STEPS,
                                         device="cpu"))
    if beta > 0.44:
        assert xi > 100
    np.testing.assert_allclose(xi, xi_dense,
                               rtol=1e-6 if beta < 0.44 else 1e-4)
