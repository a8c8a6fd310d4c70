"""Forward mode of the port's block solver ``dominant_eigh_multi`` (the
JAX package's ``_multi_pair_tangents``) through
``torch.autograd.forward_ad``, against ``jax.jvp`` of the JAX package's
``dominant_eigh_multi`` (CPU, f64), by Lanczos and by LOBPCG, on a dense
operator and on a blocked-ELL operator with its banded slot plan; and the
operators' ``tangent_matmat``.

Both sides start from the same vector (Lanczos) or block (LOBPCG), drawn
from JAX's key.  The tangent directions keep the operators symmetric.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from dominantsparseeigenad_tpu import BellOperator as JaxBell
from dominantsparseeigenad_tpu import DenseOperator as JaxDense
from dominantsparseeigenad_tpu import dominant_eigh_multi as jax_multi
from dominantsparseeigenad_tpu.ops.sparse import (
    random_bell_operator as jax_random_bell)

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)

R = 3
TOL = 1e-12                     # the tangent's batched CG
N = {"dense": 24, "bell": 256}
KINDS, METHODS = ["dense", "bell"], ["lanczos", "lobpcg"]
# Lanczos: k = N steps (exact); LOBPCG: an iteration cap it never meets.
K = {"lanczos": None, "lobpcg": 300}


@functools.lru_cache(maxsize=None)
def _bell(key):
    op = jax_random_bell(jax.random.PRNGKey(key), n=256, bs=16,
                         blocks_per_row=5, dtype=jnp.float64,
                         use_pallas=False)
    return np.array(op.vals), np.array(op.cols)


@functools.lru_cache(maxsize=None)
def _inputs(kind):
    """(primal, tangent): symmetric, and for the blocked-ELL operator two
    value sets on the same (banded) pattern."""
    if kind == "dense":
        rng = np.random.default_rng(11)
        a, da = rng.standard_normal((2, 24, 24))
        return (a + a.T) / 2, (da + da.T) / 2
    return _bell(5)[0], _bell(6)[0]


def _jax_op(kind, p):
    if kind == "dense":
        return JaxDense(p)
    return JaxBell(p, jnp.asarray(_bell(5)[1]), 256, symmetric=True,
                   use_pallas=False)


def _port_op(kind, p):
    if kind == "dense":
        return port.DenseOperator(p)
    return port.bell_operator_from_numpy(
        np.zeros(p.shape), _bell(5)[1], 256, symmetric=True,
        device="cpu").with_vals(p)


def _kw(kind, method, extreme):
    k = K[method] or N[kind]
    return dict(r=R, k=k, method=method, extreme=extreme, tol=TOL)


def _start(kind, method):
    """JAX's start draw for ``dominant_eigh_multi(seed=0)``."""
    shape = (N[kind],) if method == "lanczos" else (N[kind], R)
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), shape, jnp.float64)))
    return {"v0": x} if method == "lanczos" else {"x0": x}


@functools.lru_cache(maxsize=None)
def _jax_tangents(kind, method, extreme):
    p, dp = _inputs(kind)
    (lams, v), (dlams, dv) = jax.jit(lambda q, dq: jax.jvp(
        lambda y: jax_multi(_jax_op(kind, y), **_kw(kind, method, extreme)),
        (q,), (dq,)))(jnp.asarray(p), jnp.asarray(dp))
    return tuple(np.asarray(t) for t in (lams, v, dlams, dv))


def _port_tangents(kind, method, extreme, with_info=False):
    p, dp = _inputs(kind)
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.from_numpy(p), torch.from_numpy(dp))
        out = port.dominant_eigh_multi(
            _port_op(kind, dual), **_kw(kind, method, extreme),
            with_info=with_info, device="cpu", **_start(kind, method))
        lams, dlams = fwAD.unpack_dual(out[0])
        v, dv = fwAD.unpack_dual(out[1])
        info = [fwAD.unpack_dual(t).tangent for t in out[2]] \
            if with_info else None
    return lams.numpy(), v.numpy(), dlams.numpy(), dv.numpy(), info


@pytest.mark.parametrize("extreme", ["min", "max"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_block_tangents_match_jax_jvp(kind, method, extreme):
    lams_j, v_j, dlams_j, dv_j = _jax_tangents(kind, method, extreme)
    lams, v, dlams, dv, _ = _port_tangents(kind, method, extreme)
    # Converged f64 pairs, the same sign gauge.
    np.testing.assert_allclose(lams, lams_j, rtol=1e-9)
    assert np.abs(v - v_j).max() <= 1e-6
    # dλ = diag(V^T dA V): the same products.
    assert np.abs(dlams - dlams_j).max() <= 1e-8 * np.abs(dlams_j).max()
    # dV: batched CGs to a 1e-12 residual, times the condition of the
    # block-deflated systems.
    assert np.abs(dv - dv_j).max() <= 1e-6 * np.abs(dv_j).max()


@pytest.mark.parametrize("method", METHODS)
def test_block_tangents_are_the_ift_rule(method):
    """dλ and dV are exactly diag(M) and V (F∘M) + the batched deflated
    solve of -(dA V - V M), M = V^T dA V, with the same solver."""
    p, dp = _inputs("bell")
    lams, v, dlams, dv, _ = _port_tangents("bell", method, "min")
    lams, v = torch.from_numpy(lams), torch.from_numpy(v)
    op = _port_op("bell", torch.from_numpy(p))
    dav = op.tangent_matmat(v, [torch.from_numpy(dp)])
    m = v.T @ dav
    gap = lams[None, :] - lams[:, None]
    f = gap / (gap * gap + 1e-24) * (1.0 - torch.eye(R, dtype=gap.dtype))
    x = port.solve_deflated(op, lams, v, -(dav - v @ m), tol=TOL,
                            device="cpu")
    assert np.array_equal(dlams, torch.diagonal(m).numpy())
    np.testing.assert_allclose(dv, (v @ (f * m) + x).numpy(), rtol=0,
                               atol=1e-14 * np.abs(dv).max())


@pytest.mark.parametrize("method", METHODS)
def test_forward_mode_matches_reverse_mode(method):
    """<dvals, ∂Σλ/∂vals> from reverse mode equals the forward-mode
    Σ dλ (the identity the card's check uses)."""
    p, dp = _inputs("bell")
    t = torch.from_numpy(p).requires_grad_(True)
    lams, _ = port.dominant_eigh_multi(
        _port_op("bell", t), **_kw("bell", method, "min"), device="cpu",
        **_start("bell", method))
    (g,) = torch.autograd.grad(lams.sum(), t)
    _, _, dlams, _, _ = _port_tangents("bell", method, "min")
    rev = float((g * torch.from_numpy(dp)).sum())
    assert abs(dlams.sum() - rev) <= 1e-10 * abs(rev)


@pytest.mark.parametrize("method", METHODS)
def test_info_fields_carry_zero_tangents(method):
    lams, _, dlams, _, info = _port_tangents("dense", method, "min",
                                             with_info=True)
    lams_j, _, dlams_j, _ = _jax_tangents("dense", method, "min")
    np.testing.assert_allclose(dlams, dlams_j, rtol=1e-8)
    # JAX gives zero tangents; PyTorch gives a non-differentiable output
    # no tangent at all.  Either way nothing moves.
    assert all(t is None or not t.any() for t in info)


def test_no_tangent_gives_zero_block_tangents():
    p, _ = _inputs("dense")
    x0 = _start("dense", "lobpcg")["x0"]
    with fwAD.dual_level():
        lams, v = port.dominant_eigh_multi(
            torch.from_numpy(p), r=R, k=300, method="lobpcg",
            x0=fwAD.make_dual(x0, torch.ones_like(x0)), device="cpu")
        assert not fwAD.unpack_dual(lams).tangent.any()
        assert not fwAD.unpack_dual(v).tangent.any()


def _tfim_family(params, x):
    g, a = params
    return a @ x + g * x.flip(0)


@pytest.mark.parametrize("kind", ["dense", "matrix_free", "bell_gather",
                                  "bell_banded"])
def test_tangent_matmat_is_the_columns_tangent_matvec(kind):
    rng = np.random.default_rng(3)
    if kind == "dense":
        p, dp = _inputs("dense")
        op = port.DenseOperator(torch.from_numpy(p))
        dparams = [torch.from_numpy(dp)]
    elif kind == "matrix_free":
        p, dp = _inputs("dense")
        op = port.MatrixFreeOperator(
            _tfim_family, (torch.tensor(0.7, dtype=torch.float64),
                           torch.from_numpy(p)), 24, dtype=torch.float64)
        dparams = [torch.tensor(1.0, dtype=torch.float64),
                   torch.from_numpy(dp)]
    else:
        p, dp = _inputs("bell")
        op = port.bell_operator_from_numpy(
            p, _bell(5)[1], 256, symmetric=True, device="cpu")
        if kind == "bell_gather":
            op = port.BellOperator(op.vals, op.cols, 256, symmetric=True,
                                   slot_plan=None)
        assert (op.slot_plan is not None) == (kind == "bell_banded")
        dparams = [torch.from_numpy(dp)]
    X = torch.from_numpy(rng.standard_normal((op.dim, R)))
    got = op.tangent_matmat(X, dparams)
    want = torch.stack([op.tangent_matvec(X[:, j], dparams)
                        for j in range(R)], dim=1)
    # The same products; the SpMM sums in the SpMV's order, the
    # matrix-free JVP of matmat is the column loop's.
    assert got.shape == X.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-13 * float(want.abs().max()))


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
