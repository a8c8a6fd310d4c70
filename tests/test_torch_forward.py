"""Forward mode of the port's ``dominant_eigh`` (the JAX package's
``_pair_jvp``) through ``torch.autograd.forward_ad``, against ``jax.jvp``
of the JAX package's ``dominant_eigh`` (CPU, f64), on a dense, a
matrix-free TFIM and a blocked-ELL operator with its banded slot plan;
and the forward mode of the bare blocked-ELL products.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from dominantsparseeigenad_tpu import dominant_eigh as jax_dominant_eigh
from dominantsparseeigenad_tpu.models import tfim_operator as jax_tfim
from dominantsparseeigenad_tpu.ops.pallas_spmv import (
    bell_spmm as jax_bell_spmm, bell_spmv as jax_bell_spmv)
from dominantsparseeigenad_tpu.ops.sparse import (
    BellOperator as JaxBell, random_bell_operator as jax_random_bell)

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

torch.set_num_threads(2)

TOL = 1e-12          # the tangent's CG
N_SPINS, G = 8, 1.2
KINDS = ["dense", "tfim", "bell"]


@functools.lru_cache(maxsize=None)
def _inputs(kind):
    """(primal, tangent) numpy inputs of each operator family, and k."""
    rng = np.random.default_rng({"dense": 1, "tfim": 2, "bell": 3}[kind])
    if kind == "dense":
        a = rng.standard_normal((48, 48))
        da = rng.standard_normal((48, 48))
        return (a + a.T) / 2, (da + da.T) / 2, 48
    if kind == "tfim":
        return np.float64(G), np.float64(1.0), 1 << N_SPINS
    op = jax_random_bell(jax.random.PRNGKey(5), n=256, bs=32,
                         blocks_per_row=5, dtype=jnp.float64,
                         use_pallas=False)
    vals = np.array(op.vals)
    return vals, rng.standard_normal(vals.shape), 256


@functools.lru_cache(maxsize=None)
def _cols():
    return np.array(jax_random_bell(
        jax.random.PRNGKey(5), n=256, bs=32, blocks_per_row=5,
        dtype=jnp.float64, use_pallas=False).cols)


def _jax_op(kind, p):
    if kind == "dense":
        return p
    if kind == "tfim":
        return jax_tfim(N_SPINS, p)
    return JaxBell(p, jnp.asarray(_cols()), 256, symmetric=True,
                   use_pallas=True, interpret=True)


def _port_op(kind, p):
    if kind == "dense":
        return p
    if kind == "tfim":
        return models.tfim_operator(N_SPINS, p, device="cpu")
    return port.bell_operator_from_numpy(
        np.zeros(p.shape), _cols(), 256, symmetric=True,
        device="cpu").with_vals(p)


@functools.lru_cache(maxsize=None)
def _jax_tangents(kind, extreme):
    p, dp, k = _inputs(kind)
    (lam, v), (dlam, dv) = jax.jvp(
        lambda q: jax_dominant_eigh(_jax_op(kind, q), k=k, extreme=extreme,
                                    tol=TOL),
        (jnp.asarray(p),), (jnp.asarray(dp),))
    return float(lam), np.asarray(v), float(dlam), np.asarray(dv)


def _port_tangents(kind, extreme):
    p, dp, k = _inputs(kind)
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.as_tensor(p), torch.as_tensor(dp))
        lam, v = port.dominant_eigh(_port_op(kind, dual), k=k,
                                    extreme=extreme, tol=TOL, device="cpu")
        lam, dlam = fwAD.unpack_dual(lam)
        v, dv = fwAD.unpack_dual(v)
    return float(lam), v.numpy(), float(dlam), dv.numpy()


@pytest.mark.parametrize("extreme", ["min", "max"])
@pytest.mark.parametrize("kind", KINDS)
def test_tangents_match_jax_jvp(kind, extreme):
    lam_j, v_j, dlam_j, dv_j = _jax_tangents(kind, extreme)
    lam, v, dlam, dv = _port_tangents(kind, extreme)
    # Converged f64 eigenpairs, the same sign gauge.
    assert abs(lam - lam_j) <= 1e-10 * abs(lam_j)
    assert np.abs(v - v_j).max() <= 1e-8
    # dλ = v^T dA v: the same products.
    assert abs(dlam - dlam_j) <= 1e-8 * abs(dlam_j)
    # dv: two CGs to a 1e-12 residual, times the condition of the
    # deflated system.
    assert np.abs(dv - dv_j).max() <= 1e-6 * np.abs(dv_j).max()


@pytest.mark.parametrize("kind", KINDS)
def test_tangents_are_the_ift_rule(kind):
    """The forward-mode tangents are exactly dλ = v^T (dA v) and dv from
    one deflated solve of -(dA v - dλ v)."""
    p, dp, k = _inputs(kind)
    lam, v, dlam, dv = _port_tangents(kind, "min")
    lam_t = torch.tensor(lam, dtype=torch.float64)
    v_t = torch.from_numpy(v)
    op = port.as_operator(_port_op(kind, torch.as_tensor(p)))
    dav = op.tangent_matvec(v_t, [torch.as_tensor(dp)] +
                            [None] * (len(op.parameters()) - 1))
    dlam_rule = torch.dot(v_t, dav)
    dv_rule = port.solve_deflated(op, lam_t, v_t, -(dav - dlam_rule * v_t),
                                  definite_sign=1.0, tol=TOL, device="cpu")
    assert dlam == float(dlam_rule)
    assert np.array_equal(dv, dv_rule.numpy())


def test_lanczos_loop_carries_no_tangent():
    """Every matvec the forward-mode pass makes returns a tensor with no
    tangent (forward AD is off inside the Function), and the Lanczos
    steps are as many as in a plain forward."""
    seen = []
    a, da, _ = _inputs("dense")

    def mv(m, x):
        y = m @ x
        seen.append(fwAD.unpack_dual(y).tangent is None)
        return y

    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.from_numpy(a), torch.from_numpy(da))
        op = port.MatrixFreeOperator(mv, dual, 48, dtype=torch.float64)
        lam, _ = port.dominant_eigh(op, k=30, tol=TOL, maxiter=7,
                                    device="cpu")
        assert fwAD.unpack_dual(lam).tangent is not None
    assert seen and all(seen)
    n_fwd = len(seen)
    seen.clear()
    port.dominant_eigh(port.MatrixFreeOperator(mv, torch.from_numpy(a), 48,
                                               dtype=torch.float64),
                       k=30, device="cpu")
    # 30 Lanczos steps; forward mode adds one tangent product (a reverse
    # pass over one matvec) and the tangent CG's 7 (its cap).
    assert len(seen) == 30 and n_fwd == 30 + 1 + 7


def test_forward_mode_matches_reverse_mode():
    """<dvals, ∂λ/∂vals> from reverse mode equals the forward-mode dλ."""
    vals, dvals, k = _inputs("bell")
    t = torch.from_numpy(vals).requires_grad_(True)
    lam, _ = port.dominant_eigh(_port_op("bell", t), k=k, device="cpu")
    (g,) = torch.autograd.grad(lam, t)
    _, _, dlam, _ = _port_tangents("bell", "min")
    rev = float((g * torch.from_numpy(dvals)).sum())
    assert abs(dlam - rev) <= 1e-10 * abs(rev)


def test_bf16_values_tangent():
    vals, dvals, k = _inputs("bell")
    op = _port_op("bell", torch.from_numpy(vals)).astype_vals(torch.bfloat16)
    dv16 = torch.from_numpy(dvals).to(torch.bfloat16)
    with fwAD.dual_level():
        lam, v = port.dominant_eigh(
            op.with_vals(fwAD.make_dual(op.vals, dv16)), k=k, tol=TOL,
            device="cpu")
        dlam = float(fwAD.unpack_dual(lam).tangent)
        v = fwAD.unpack_dual(v).primal
    expect = float(torch.dot(v, port.bell_spmv(dv16, op.cols, v)))
    assert abs(dlam - expect) <= 1e-10 * abs(expect)


@pytest.mark.parametrize("r", [None, 3], ids=["spmv", "spmm_r3"])
@pytest.mark.parametrize("banded", [False, True], ids=["gather", "banded"])
def test_bare_product_jvp_matches_jax(r, banded):
    vals, dvals, _ = _inputs("bell")
    cols = _cols()
    rng = np.random.default_rng(9)
    shape = (256,) if r is None else (256, r)
    x, dx = rng.standard_normal(shape), rng.standard_normal(shape)
    plan = port.detect_slot_plan(cols, 8) if banded else None
    jfun = jax_bell_spmv if r is None else jax_bell_spmm
    _, dy_j = jax.jvp(lambda v, z: jfun(v, jnp.asarray(cols), z, True, plan),
                      (jnp.asarray(vals), jnp.asarray(x)),
                      (jnp.asarray(dvals), jnp.asarray(dx)))
    pfun = port.bell_spmv if r is None else port.bell_spmm
    with fwAD.dual_level():
        y = pfun(fwAD.make_dual(torch.from_numpy(vals),
                                torch.from_numpy(dvals)),
                 torch.from_numpy(cols),
                 fwAD.make_dual(torch.from_numpy(x), torch.from_numpy(dx)),
                 plan)
        dy = fwAD.unpack_dual(y).tangent
    # f64 sums in another order: dy = A(dvals) x + A(vals) dx.
    dy_j = np.asarray(dy_j)
    assert np.abs(dy.numpy() - dy_j).max() <= 1e-12 * np.abs(dy_j).max()


def test_no_tangent_gives_zero_tangents():
    """A dual start vector alone moves nothing: the eigenpair does not
    depend on where Lanczos starts."""
    a, _, _ = _inputs("dense")
    v0 = torch.ones(48, dtype=torch.float64)
    with fwAD.dual_level():
        lam, v = port.dominant_eigh(
            torch.from_numpy(a), k=48,
            v0=fwAD.make_dual(v0, torch.ones_like(v0)), device="cpu")
        assert float(fwAD.unpack_dual(lam).tangent) == 0.0
        assert not fwAD.unpack_dual(v).tangent.any()


def test_fidelity_susceptibility_cannot_nest_a_dual_level():
    with fwAD.dual_level():
        with pytest.raises(RuntimeError):
            port.fidelity_susceptibility(
                lambda g: models.tfim_operator(4, g, device="cpu"), 1.2,
                k=16, device="cpu")
