"""Second-order derivatives of the port through its IFT rules, against
the JAX package (CPU, f64): the differentiable deflated solve of
``ops/cg.py``, the twice-differentiable blocked-ELL products, Hessians and
Hessian-vector products of ``dominant_eigh`` and ``dominant_eigh_multi``,
``value_d1_d2`` and ``energy_curvature``, the TFIM closed form of
d²E0/dg², ``extreme="both"`` and ``with_info``; that no derivative is
taken through a solver's iterations; and second order through a
row-sharded operator.

Every JAX reference is computed here, from the same numpy inputs; where
the JAX operator reaches the Pallas SpMV it takes its XLA route
(``use_pallas=False``).
"""

import functools
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.autograd import gradcheck, gradgradcheck

from dominantsparseeigenad_tpu import BellOperator as JaxBell
from dominantsparseeigenad_tpu import DenseOperator as JaxDense
from dominantsparseeigenad_tpu import MatrixFreeOperator as JaxMatrixFree
from dominantsparseeigenad_tpu import dominant_eigh as jax_eigh
from dominantsparseeigenad_tpu import dominant_eigh_multi as jax_multi
from dominantsparseeigenad_tpu import models as jm
from dominantsparseeigenad_tpu.ops.cg import solve_deflated as jax_solve
from dominantsparseeigenad_tpu.ops.observables import (
    energy_curvature as jax_curvature, value_d1_d2 as jax_value_d1_d2)
from dominantsparseeigenad_tpu.ops.sparse import (
    random_bell_operator as jax_random_bell)

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

torch.set_num_threads(2)

# The module, not the function of the same name that ops exports.
spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                               "bell_spmv")

TOL = 1e-13                 # every CG here (clamped to 50 eps = 1.1e-14)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _hvp(f, x, dx):
    """The Hessian-vector product of the scalar ``f`` at ``x`` along
    ``dx``, by two reverse passes (the second through the first's
    graph)."""
    x = x.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x, create_graph=True)
    (h,) = torch.autograd.grad(g, x, grad_outputs=dx)
    return h


def _jax_hvp(f, x, dx):
    """``jax.jvp`` of ``jax.grad``, jitted as one program (one compile)."""
    hvp = jax.jit(lambda y, dy: jax.jvp(jax.grad(f), (y,), (dy,))[1])
    return np.asarray(hvp(jnp.asarray(x), jnp.asarray(dx)))


# -- the differentiable deflated solve ---------------------------------------

N_SOLVE = 12


@functools.lru_cache(maxsize=None)
def _solve_inputs(form):
    """(b, λ, u, a): ``u`` normalized (vector form) or orthonormalized
    (batched form, (N, 2) with two shifts) gives V; λ sits below the
    spectrum of the symmetric ``a`` so the deflated system is definite."""
    rng = np.random.default_rng(31)
    a = _sym(N_SOLVE, 32)
    lam0 = np.linalg.eigvalsh(a)[0] - 1.0
    if form == "vector":
        return (rng.standard_normal(N_SOLVE), np.float64(lam0),
                rng.standard_normal(N_SOLVE), a)
    return (rng.standard_normal((N_SOLVE, 2)), np.array([lam0, lam0 - 0.5]),
            rng.standard_normal((N_SOLVE, 2)), a)


def _basis(u):
    return u / torch.linalg.vector_norm(u) if u.ndim == 1 \
        else torch.linalg.qr(u)[0]


def _port_solve(b, lam, u, a):
    return port.solve_deflated(port.DenseOperator((a + a.T) / 2), lam,
                               _basis(u), b, tol=TOL, device="cpu")


@pytest.mark.parametrize("form", ["vector", "batched"])
def test_solve_gradcheck_and_gradgradcheck(form):
    """First and second derivatives of the solve in rhs, λ, V (through
    its normalization) and the operator's values, against central
    differences (gradcheck's default tolerances, atol 1e-5, rtol 1e-3)."""
    inputs = tuple(_t(t).requires_grad_(True) for t in _solve_inputs(form))
    assert gradcheck(_port_solve, inputs)
    assert gradgradcheck(_port_solve, inputs)


@functools.lru_cache(maxsize=None)
def _jax_solve_grads(form):
    b, lam, u, a = _solve_inputs(form)
    c = np.cos(np.arange(b.size)).reshape(b.shape)

    def loss(b, lam, u, a):
        op = JaxDense((a + a.T) / 2)
        if b.ndim == 1:
            x = jax_solve(op, lam, u / jnp.linalg.norm(u), b, tol=TOL)
        else:
            v = jnp.linalg.qr(u)[0]
            x = jax.vmap(lambda l, bi: jax_solve(op, l, v, bi, tol=TOL),
                         in_axes=(0, 1), out_axes=1)(lam, b)
        return jnp.sum(jnp.asarray(c) * x)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(t) for t in (b, lam, u, a)))
    return c, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("form", ["vector", "batched"])
def test_solve_gradients_match_jax(form):
    c, grads_j = _jax_solve_grads(form)
    inputs = [_t(t).requires_grad_(True) for t in _solve_inputs(form)]
    x = _port_solve(*inputs)
    grads = torch.autograd.grad((_t(c) * x).sum(), inputs)
    # The same rule (custom_linear_solve's transpose) on the same
    # products; CGs to 1e-13 on a system of condition ~10.
    for g, g_j in zip(grads, grads_j):
        assert _rel(g, g_j) <= 1e-8


def test_zero_cotangent_costs_no_solve():
    """A zero cotangent's CG stops before its first product, so the
    solve's backward is the rule's one product; and the backward of λ
    alone (no eigenvector cotangent arrives) runs no solve at all, also
    under create_graph."""
    b, lam, u, a = (_t(t) for t in _solve_inputs("vector"))
    calls = []

    def mv(m, x):
        calls.append(1)
        return m @ x

    a = a.requires_grad_(True)
    op = port.MatrixFreeOperator(mv, a, N_SOLVE, dtype=torch.float64)
    x = port.solve_deflated(op, lam, _basis(u), b, tol=TOL, device="cpu")
    n0 = len(calls)
    torch.autograd.grad((0.0 * x).sum(), a)
    assert len(calls) - n0 == 1
    for create_graph in (False, True):
        lam_a, _ = port.dominant_eigh(op, k=N_SOLVE, tol=TOL, device="cpu")
        n0 = len(calls)
        torch.autograd.grad(lam_a, a, create_graph=create_graph)
        assert len(calls) - n0 == 1


# -- the blocked-ELL products, twice differentiable ---------------------------

@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("banded", [False, True], ids=["gather", "banded"])
def test_bell_product_gradgradcheck(banded, r):
    """The products' backward (plain PyTorch, as the JAX package routes
    its derivative products through XLA) is differentiable again:
    gradgradcheck in vals and x (its default tolerances)."""
    op = port.random_bell_operator(
        32, 8, 3, generator=torch.Generator().manual_seed(0),
        dtype=torch.float64, device="cpu")
    plan = op.slot_plan if banded else None
    assert (plan is not None) == banded
    x = torch.randn((32,) if r == 1 else (32, r), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    inputs = (op.vals.clone().requires_grad_(True), x.requires_grad_(True))

    def f(vals, z):
        return spmv._BellProduct.apply(vals, op.cols, z, plan)

    assert gradcheck(f, inputs)
    assert gradgradcheck(f, inputs)


# -- dominant_eigh -----------------------------------------------------------

def _port_lam(a):
    return port.dominant_eigh(port.DenseOperator((a + a.T) / 2), k=16,
                              tol=TOL, device="cpu")[0]


def test_eigenvalue_hessian_matches_jax():
    """The full 256 × 256 Hessian of λ_min in a 16 × 16 matrix (the
    setting of the JAX package's order-2 check) against jax.hessian."""
    a = _sym(16, 2)
    h_j = np.asarray(jax.jit(jax.hessian(lambda m: jax_eigh(
        JaxDense((m + m.T) / 2), k=16, tol=TOL)[0]))(jnp.asarray(a)))
    h = torch.autograd.functional.hessian(_port_lam, _t(a))
    # One deflated solve to 1e-13 per Hessian column on each side.
    assert _rel(h.numpy(), h_j) <= 1e-6


@functools.lru_cache(maxsize=None)
def _quartic_hvp_jax(extreme):
    a, da = _sym(24, 5), _sym(24, 6)

    def f(m):
        lam, v = jax_eigh(JaxDense((m + m.T) / 2), k=24, extreme=extreme,
                          tol=TOL)
        return lam + jnp.sum(v ** 4)

    return _jax_hvp(f, a, da)


@pytest.mark.parametrize("extreme", ["min", "max"])
def test_eigenvector_loss_hvp_matches_jax(extreme):
    """The HVP of λ + Σv⁴ (the setting of the JAX package's order-2
    check of the eigenvector) along a symmetric direction."""
    def f(m):
        lam, v = port.dominant_eigh(port.DenseOperator((m + m.T) / 2),
                                    k=24, extreme=extreme, tol=TOL,
                                    device="cpu")
        return lam + (v ** 4).sum()

    h = _hvp(f, _t(_sym(24, 5)), _t(_sym(24, 6)))
    # Two nested deflated solves to 1e-13, times their conditions.
    assert _rel(h, _quartic_hvp_jax(extreme)) <= 1e-6


@functools.lru_cache(maxsize=None)
def _coupling_family():
    """A(g) = A0 + g·B, n = 20, as in the JAX package's perturbation
    theory test."""
    return _sym(20, 8), _sym(20, 9)


def test_coupling_second_derivative_matches_jax_and_perturbation_theory():
    a0, b = _coupling_family()

    def jax_lam(g):
        op = JaxMatrixFree(lambda g, x: a0 @ x + g * (b @ x), g, dim=20,
                           dtype=jnp.float64)
        return jax_eigh(op, k=20, tol=TOL)[0]

    g0 = 0.3
    d2_j = float(jax.jit(jax.grad(jax.grad(jax_lam)))(jnp.asarray(g0)))
    evals, evecs = np.linalg.eigh(a0 + g0 * b)
    me = evecs[:, 1:].T @ (b @ evecs[:, 0])
    d2_pt = 2.0 * np.sum(me ** 2 / (evals[0] - evals[1:]))

    a0_t, b_t = _t(a0), _t(b)
    g = torch.tensor(g0, dtype=torch.float64, requires_grad=True)
    op = port.MatrixFreeOperator(lambda g, x: a0_t @ x + g * (b_t @ x), g,
                                 20, dtype=torch.float64)
    with warnings.catch_warnings():
        # No tensor that requires grad reaches a host read in the CG.
        warnings.simplefilter("error")
        lam, _ = port.dominant_eigh(op, k=20, tol=TOL, device="cpu")
        (d1,) = torch.autograd.grad(lam, g, create_graph=True)
        assert d1.requires_grad
        (d2,) = torch.autograd.grad(d1, g)
    # One deflated solve to 1e-13 on each side; perturbation theory is a
    # sum over the exact spectrum.
    assert abs(float(d2) - d2_j) <= 1e-8 * abs(d2_j)
    assert abs(float(d2) - d2_pt) <= 1e-8 * abs(d2_pt)


@functools.lru_cache(maxsize=None)
def _bell256(key):
    op = jax_random_bell(jax.random.PRNGKey(key), n=256, bs=16,
                         blocks_per_row=5, dtype=jnp.float64,
                         use_pallas=False)
    return np.array(op.vals), np.array(op.cols)


@functools.lru_cache(maxsize=None)
def _partners():
    """For each stored block (i, j), the slot (c, j') that holds its
    transpose's place, c = cols[i, j] and cols[c, j'] = i."""
    cols = _bell256(5)[1]
    rows = np.empty_like(cols)
    slots = np.empty_like(cols)
    for i in range(cols.shape[0]):
        for j, c in enumerate(cols[i]):
            (jj,) = np.nonzero(cols[c] == i)[0]
            rows[i, j], slots[i, j] = c, jj
    return rows, slots


def _symmetrized(vals, swap):
    """The values of (A + A^T) / 2 on A's pattern: a function of every
    stored entry whose operator is symmetric, so that its Hessian is one
    (the rules hold a symmetric operator's derivatives)."""
    rows, slots = _partners()
    return (vals + swap(vals[rows, slots])) / 2


def _jax_sym_bell(vals):
    return _jax_bell(_symmetrized(vals, lambda t: jnp.swapaxes(t, -1, -2)))


def _port_sym_bell(vals):
    return _port_bell(_symmetrized(vals, lambda t: t.transpose(-1, -2)))


def _jax_bell(vals):
    return JaxBell(vals, jnp.asarray(_bell256(5)[1]), 256, symmetric=True,
                   use_pallas=False)


def _port_bell(vals):
    op = port.bell_operator_from_numpy(
        np.zeros(vals.shape), _bell256(5)[1], 256, symmetric=True,
        device="cpu").with_vals(vals)
    assert op.slot_plan is not None        # every slot a ring band
    return op


def test_banded_bell_vals_hvp_matches_jax():
    """The HVP of λ + Σv⁴ in the values of a banded blocked-ELL operator
    (n = 256, bs = 16), symmetrized on its pattern as the dense tests
    symmetrize their matrix, along the values of another operator on the
    same pattern."""
    vals, dvals = _bell256(5)[0], _bell256(6)[0]

    def f_j(p):
        lam, v = jax_eigh(_jax_sym_bell(p), k=256, tol=TOL)
        return lam + jnp.sum(v ** 4)

    def f(p):
        lam, v = port.dominant_eigh(_port_sym_bell(p), k=256, tol=TOL,
                                    device="cpu")
        return lam + (v ** 4).sum()

    h = _hvp(f, _t(vals), _t(dvals))
    assert _rel(h, _jax_hvp(f_j, vals, dvals)) <= 1e-6


# -- dominant_eigh_multi -----------------------------------------------------

R = 3
C_LAM = np.array([1.0, -0.5, 2.0])
MULTI_K = {"lanczos": None, "lobpcg": 300}


def _multi_inputs(kind):
    if kind == "dense":
        return _sym(24, 12), _sym(24, 13)
    return _bell256(5)[0], _bell256(6)[0]


def _multi_start(n, method):
    """JAX's start draw for ``dominant_eigh_multi(seed=0)``."""
    shape = (n,) if method == "lanczos" else (n, R)
    x = _t(np.array(jax.random.normal(jax.random.PRNGKey(0), shape,
                                      jnp.float64)))
    return {"v0": x} if method == "lanczos" else {"x0": x}


@pytest.mark.parametrize("method", ["lanczos", "lobpcg"])
@pytest.mark.parametrize("kind", ["dense", "bell"])
def test_block_hvp_matches_jax(kind, method):
    """The HVP of Σ c_i λ_i + <C, V> through the block rule."""
    p, dp = _multi_inputs(kind)
    n = p.shape[0] if kind == "dense" else 256
    k = MULTI_K[method] or n
    cv = np.sin(np.arange(n * R)).reshape(n, R)
    kw = dict(r=R, k=k, method=method, tol=TOL)

    def f_j(q):
        op = JaxDense((q + q.T) / 2) if kind == "dense" \
            else _jax_sym_bell(q)
        lams, v = jax_multi(op, **kw)
        return jnp.sum(jnp.asarray(C_LAM) * lams) + jnp.sum(
            jnp.asarray(cv) * v)

    def f(q):
        op = port.DenseOperator((q + q.T) / 2) if kind == "dense" \
            else _port_sym_bell(q)
        lams, v = port.dominant_eigh_multi(op, device="cpu",
                                           **_multi_start(n, method), **kw)
        return (_t(C_LAM) * lams).sum() + (_t(cv) * v).sum()

    h = _hvp(f, _t(p), _t(dp))
    # Batched deflated CGs to 1e-13 nested twice, times their conditions.
    assert _rel(h, _jax_hvp(f_j, p, dp)) <= 1e-6


# -- value_d1_d2, energy_curvature and the TFIM closed form -------------------

N_SPINS, G = 8, 1.2


def test_value_d1_d2_matches_jax():
    def f_j(x):
        return jnp.sin(x) * x ** 3

    def f(x):
        return torch.sin(x) * x ** 3

    got = port.value_d1_d2(f, 0.7, device="cpu")
    want = jax.jit(lambda x: jax_value_d1_d2(f_j, x))(jnp.asarray(0.7))
    np.testing.assert_allclose([float(t) for t in got],
                               [float(t) for t in want], rtol=1e-12)
    # A linear f has no second derivative (and no graph to take it in).
    val, d1, d2 = port.value_d1_d2(lambda x: 3.0 * x, 2.0, device="cpu")
    assert (float(val), float(d1), float(d2)) == (6.0, 3.0, 0.0)


@functools.lru_cache(maxsize=None)
def _jax_tfim_curvature():
    return [float(t) for t in jax.jit(lambda g: jax_curvature(
        lambda gg: jm.tfim_operator(N_SPINS, gg), g, k=1 << N_SPINS,
        tol=1e-12))(jnp.asarray(G))]


def _port_tfim_curvature():
    return [float(t) for t in port.energy_curvature(
        lambda g: models.tfim_operator(N_SPINS, g, device="cpu"), G,
        k=1 << N_SPINS, tol=1e-12, device="cpu")]


def test_tfim_energy_curvature_matches_jax_and_ed():
    got = _port_tfim_curvature()
    want = _jax_tfim_curvature()
    # E0 from converged Lanczos on both sides; dE0/dg the same products;
    # d²E0/dg² one deflated solve to 1e-12 on each side.
    for a, b, tol in zip(got, want, (1e-10, 1e-8, 1e-6)):
        assert abs(a - b) <= tol * abs(b)
    ed = [float(t) for t in models.tfim_ed_observables(N_SPINS, G,
                                                       device="cpu")]
    for a, b in zip(got, ed[:3]):
        assert abs(a - b) <= 1e-6 * abs(b)


def test_bell_family_energy_curvature_matches_jax():
    """H(g) = A0 + g·A1 over two banded blocked-ELL operators (the card's
    config-#5 check, at n = 256): a matrix-free operator whose one
    parameter is g."""
    v0, v1 = _bell256(5)[0], _bell256(7)[0]
    a0, a1 = _jax_bell(jnp.asarray(v0)), _jax_bell(jnp.asarray(v1))
    want = [float(t) for t in jax.jit(lambda g0: jax_curvature(
        lambda g: JaxMatrixFree(lambda g, x: a0.matvec(x) + g * a1.matvec(x),
                                g, dim=256, dtype=jnp.float64),
        g0, k=256, tol=TOL))(jnp.asarray(0.4))]
    p0, p1 = _port_bell(_t(v0)), _port_bell(_t(v1))
    got = [float(t) for t in port.energy_curvature(
        lambda g: port.MatrixFreeOperator(
            lambda g, x: p0.matvec(x) + g * p1.matvec(x), g, 256,
            dtype=torch.float64),
        0.4, k=256, tol=TOL, device="cpu")]
    for a, b, tol in zip(got, want, (1e-10, 1e-8, 1e-6)):
        assert abs(a - b) <= tol * abs(b)


@pytest.mark.parametrize("n", [6, 8, 10, 20])
@pytest.mark.parametrize("g", [0.7, 1.2])
def test_exact_d2e0_dg2_matches_jax(n, g):
    want = float(jax.jit(jax.grad(jax.grad(
        lambda x: jm.tfim_exact_e0(n, x))))(jnp.asarray(g)))
    # Two float64 evaluations of one sum.
    assert abs(models.tfim_exact_d2e0_dg2(n, g) - want) <= 1e-10 * abs(want)


# -- no derivative through the iterations ------------------------------------

@pytest.mark.parametrize("method", ["eigh", "eigh_multi"])
def test_create_graph_backward_records_no_iteration(method):
    """A ``create_graph`` backward records a fixed number of products,
    whatever its CG's iteration count: only the rule's own product (and
    the solve's, none here), never one per iteration."""
    a = _sym(24, 14)
    recorded, total = [], []

    def mv(m, x):
        y = m @ x
        total.append(1)
        if y.requires_grad:
            recorded.append(1)
        return y

    def run(maxiter):
        recorded.clear()
        total.clear()
        t = _t(a).requires_grad_(True)
        op = port.MatrixFreeOperator(mv, t, 24, dtype=torch.float64)
        if method == "eigh":
            lam, v = port.dominant_eigh(op, k=24, tol=1e-30, maxiter=maxiter,
                                        device="cpu")
        else:
            lam, v = port.dominant_eigh_multi(op, r=2, k=24, tol=1e-30,
                                              maxiter=maxiter, device="cpu")
        loss = lam.sum() + (v ** 4).sum()
        n_fwd = len(total)
        torch.autograd.grad(loss, t, create_graph=True)
        return len(recorded), len(total) - n_fwd

    rec_few, all_few = run(3)
    rec_many, all_many = run(30)
    # The backward's CG ran (more products with the larger cap) ...
    assert all_many > all_few
    # ... but recorded the same products: the rule's one product
    # (a matmat: one per column) per pair.
    assert rec_few == rec_many <= 2


# -- extreme="both" and with_info --------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_both():
    a, da = _sym(24, 15), _sym(24, 16)

    def f(m):
        lmin, vmin, lmax, vmax = jax_eigh(JaxDense((m + m.T) / 2), k=24,
                                          extreme="both", tol=TOL)
        return lmin + 2.0 * lmax + jnp.sum(vmin ** 4) + jnp.sum(vmax ** 3)

    out = jax.jit(lambda m: jax_eigh(JaxDense(m), k=24, extreme="both",
                                     tol=TOL))(jnp.asarray(a))
    return [np.asarray(t) for t in out], _jax_hvp(f, a, da)


def test_both_pairs_and_their_hvp_match_jax():
    out_j, h_j = _jax_both()
    a, da = _sym(24, 15), _sym(24, 16)
    out = port.dominant_eigh(_t(a), k=24, extreme="both", tol=TOL,
                             device="cpu")
    for t, t_j in zip(out, out_j):
        assert _rel(t, t_j) <= 1e-8

    def f(m):
        lmin, vmin, lmax, vmax = port.dominant_eigh(
            port.DenseOperator((m + m.T) / 2), k=24, extreme="both",
            tol=TOL, device="cpu")
        return lmin + 2.0 * lmax + (vmin ** 4).sum() + (vmax ** 3).sum()

    assert _rel(_hvp(f, _t(a), _t(da)), h_j) <= 1e-6


def test_with_info_matches_jax_and_does_not_move_derivatives():
    a, da = _sym(24, 17), _sym(24, 18)
    lam_j, _, info_j = jax.jit(lambda m: jax_eigh(
        JaxDense(m), k=24, with_info=True, tol=TOL))(jnp.asarray(a))
    lam, v, info = port.dominant_eigh(_t(a), k=24, with_info=True, tol=TOL,
                                      device="cpu")
    assert isinstance(info, port.LanczosInfo)
    assert float(info.effective_k) == float(info_j.effective_k) == 24.0
    assert float(info.converged) == float(info_j.converged) == 1.0
    # Two Ritz residuals at round-off.
    assert float(info.residual) <= 1e-12 and float(info_j.residual) <= 1e-12
    assert not info.residual.requires_grad

    def f(m, with_info):
        out = port.dominant_eigh(port.DenseOperator((m + m.T) / 2), k=24,
                                 with_info=with_info, tol=TOL, device="cpu")
        return out[0] + (out[1] ** 4).sum()

    h = _hvp(lambda m: f(m, True), _t(a), _t(da))
    assert torch.equal(h, _hvp(lambda m: f(m, False), _t(a), _t(da)))
    assert abs(float(lam) - float(lam_j)) <= 1e-10 * abs(float(lam_j))


# -- second order through the row-sharded operators ---------------------------

def test_sharded_operator_refuses_create_graph(tmp_path):
    """One gloo rank: second order through the row-sharded operator, which
    refused ``create_graph`` until the collectives' backwards became
    differentiable.  d²λ/dt² of A + t B (B a second symmetric operator on
    A's pattern) by a ``create_graph`` backward and a second backward
    through the panel and the gather matches ``jax.grad(jax.grad(...))``
    of the JAX package's sharded operator from the same start vector
    (1e-7, the JAX test's bar, ``tests/test_sharded_sparse.py:98``)."""
    from dominantsparseeigenad_tpu.parallel import (
        RowShardedBellOperator as JaxRowShardedBell, make_mesh)

    def bell(seed):
        return port.random_bell_operator(
            64, 8, 3, generator=torch.Generator().manual_seed(seed),
            dtype=torch.float64, device="cpu")

    op, pert = bell(0), bell(1).vals
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64,),
                                      jnp.float64))
    port.init_distributed("gloo", f"file://{tmp_path}/store", 0, 1)
    try:
        sop = port.RowShardedBellOperator(op.vals, op.cols, 64,
                                          symmetric=True)
        t = torch.zeros((), dtype=torch.float64, requires_grad=True)
        lam, _ = port.dominant_eigh(sop.with_vals(sop.vals + t * pert),
                                    k=40, v0=torch.from_numpy(v0),
                                    device="cpu")
        (d1,) = torch.autograd.grad(lam, t, create_graph=True)
        (d2,) = torch.autograd.grad(d1, t)
    finally:
        dist.destroy_process_group()
    jsop = JaxRowShardedBell.from_bell(
        JaxBell(jnp.asarray(op.vals.numpy()), jnp.asarray(op.cols.numpy()),
                64, symmetric=True, use_pallas=False), make_mesh(n_shards=1))
    jvals, jpert = jnp.asarray(op.vals.numpy()), jnp.asarray(pert.numpy())

    def lam_j(tt):
        return jax_eigh(jsop.with_vals(jvals + tt * jpert), k=40,
                        extreme="min")[0]

    d2_j = jax.jit(jax.grad(jax.grad(lam_j)))(jnp.float64(0.0))
    assert _rel(float(d2), float(d2_j)) <= 1e-7


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
