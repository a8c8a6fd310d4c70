"""The port's non-symmetric dominant eigensolver (``dominant_eig``,
``dominant_eig_multi``) against the JAX package's (CPU, f64), on
non-symmetric positive matrices: values, reverse mode with cotangents on
λ, l and r apart, forward mode, second order, the Perron guard and the
Wielandt stages (after ``tests/test_eig.py``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.autograd import gradcheck, gradgradcheck

from dominantsparseeigenad_tpu.ops.eig import dominant_eig as jax_eig
from dominantsparseeigenad_tpu.ops.eig import (
    dominant_eig_multi as jax_eig_multi)

import dominantsparseeigenad_tpu_torch as port

eig_mod = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.eig")

torch.set_num_threads(2)

N = 12
TOL = 1e-13                       # the tangent solves'


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _positive(n, seed):
    """Uniform(0, 1) + 0.1: a simple, real, positive dominant eigenvalue
    (Perron-Frobenius) with l != r."""
    return np.random.default_rng(seed).uniform(size=(n, n)) + 0.1


def _functional(out, cl, cr, which):
    """The loss whose gradient is compared: λ, ⟨c_l, l⟩, ⟨c_r, r⟩ or
    their sum (numpy/JAX or torch arrays alike)."""
    lam, l, r = out[:3]
    parts = {"lam": lam, "l": (l * cl).sum(), "r": (r * cr).sum()}
    return sum(parts.values()) if which == "all" else parts[which]


def _complex_dominant(seed, dominant="pair"):
    """A complex pair of modulus 3 above a real 2 (``dominant="pair"``),
    or a real 3 above a complex pair of modulus 2 (``"real"``)."""
    rng = np.random.default_rng(seed)
    blk = np.zeros((30, 30))
    rot = np.array([[np.cos(0.9), -np.sin(0.9)], [np.sin(0.9), np.cos(0.9)]])
    if dominant == "pair":
        blk[:2, :2], blk[2, 2] = 3.0 * rot, 2.0
    else:
        blk[0, 0], blk[1:3, 1:3] = 3.0, 2.0 * rot
    blk[3:, 3:] = np.diag(0.3 * rng.random(27))
    q, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    return q @ blk @ q.T


@pytest.fixture(scope="module")
def reference():
    """The JAX package's triples, gradients (one VJP per solver, jitted
    once and applied to the cotangent of each functional), JVP and the
    inputs they share."""
    a = _positive(N, 1)
    rng = np.random.default_rng(2)
    cl, cr, da = (rng.standard_normal(N), rng.standard_normal(N),
                  rng.standard_normal((N, N)))
    ref = {"a": a, "cl": cl, "cr": cr, "da": da}
    zero_v = jnp.zeros(N)
    cts = {"lam": (jnp.float64(1.0), zero_v, zero_v),
           "l": (jnp.float64(0.0), jnp.asarray(cl), zero_v),
           "r": (jnp.float64(0.0), zero_v, jnp.asarray(cr)),
           "all": (jnp.float64(1.0), jnp.asarray(cl), jnp.asarray(cr))}
    for solver in ("bicgstab", "gmres", "cgnr"):
        def vjp(m, ct, solver=solver):
            out, pull = jax.vjp(lambda x: jax_eig(x, tol=TOL, solver=solver),
                                m)
            return out, pull(ct)[0]
        vjp = jax.jit(vjp)
        ref[solver] = {}
        for which, ct in cts.items():
            out, grad = vjp(jnp.asarray(a), ct)
            ref[solver][which] = np.asarray(grad)
        ref["power"] = [np.asarray(t) for t in out]
    ref["arnoldi"] = [np.asarray(t) for t in jax.jit(
        lambda m: jax_eig(m, method="arnoldi", tol=TOL))(jnp.asarray(a))]
    _, ref["jvp"] = jax.jit(lambda m, t: jax.jvp(
        lambda x: jax_eig(x, tol=TOL), (m,), (t,)))(jnp.asarray(a),
                                                    jnp.asarray(da))
    return ref


@pytest.mark.parametrize("method", ["power", "arnoldi"])
def test_forward_matches_jax_and_numpy(method, reference):
    a = reference["a"]
    lam, l, r = port.dominant_eig(torch.from_numpy(a), method=method,
                                  device="cpu")
    for got, want in zip((lam, l, r), reference[method]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    w = np.linalg.eigvals(a)
    np.testing.assert_allclose(float(lam), w.real.max(), rtol=1e-12)
    # The gauge: ||r|| = 1, the pivot entry positive, l^T r = 1.
    assert abs(float(torch.linalg.vector_norm(r)) - 1.0) < 1e-14
    assert float(r[torch.argmax(r.abs())]) > 0
    assert abs(float(l @ r) - 1.0) < 1e-13
    np.testing.assert_allclose(a @ r.numpy(), float(lam) * r.numpy(),
                               atol=1e-11)
    np.testing.assert_allclose(a.T @ l.numpy(), float(lam) * l.numpy(),
                               atol=1e-11)


def test_eigenvalue_gradient_is_l_r_transpose(reference):
    """dλ/dA = l r^T with l^T r = 1: the non-symmetric Hellmann-Feynman,
    no solve."""
    a = torch.tensor(reference["a"], requires_grad=True)
    lam, l, r = port.dominant_eig(a, device="cpu")
    (g,) = torch.autograd.grad(lam, a)
    np.testing.assert_allclose(g.numpy(), torch.outer(l, r).detach().numpy(),
                               atol=1e-14)


@pytest.mark.parametrize("which", ["lam", "l", "r", "all"])
@pytest.mark.parametrize("solver", ["bicgstab", "gmres", "cgnr"])
def test_gradient_matches_jax(solver, which, reference):
    """Each cotangent alone (a sign or a transposition wrong in g_l0, g_r
    or the swapped border vectors would survive on a symmetric input, not
    here), and together.  For l̄ alone the JAX package's BiCGStab breaks
    down on its first step (its right-hand side (c l; 0) is orthogonal to
    B (c l; 0)) and returns a gradient ~6e-4 off; the port removes that
    direction first, and its gradient is held against JAX's GMRES one."""
    a = torch.tensor(reference["a"], requires_grad=True)
    out = port.dominant_eig(a, tol=TOL, solver=solver, device="cpu")
    loss = _functional(out, torch.from_numpy(reference["cl"]),
                       torch.from_numpy(reference["cr"]), which)
    (g,) = torch.autograd.grad(loss, a)
    ref_solver = "gmres" if (solver, which) == ("bicgstab", "l") else solver
    want = reference[ref_solver][which]
    np.testing.assert_allclose(g.numpy(), want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


def test_forward_mode_matches_jax_jvp(reference):
    with fwAD.dual_level():
        a = fwAD.make_dual(torch.from_numpy(reference["a"]),
                           torch.from_numpy(reference["da"]))
        out = port.dominant_eig(a, tol=TOL, device="cpu")
        tangents = [fwAD.unpack_dual(t).tangent for t in out]
    for got, want in zip(tangents, reference["jvp"]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-8 * np.abs(want).max())


def test_hessian_matches_jax():
    """Second order of all three outputs, once, on one 6 x 6 matrix: the
    backward differentiated again (its bordered solves and products)."""
    a = _positive(6, 3)
    rng = np.random.default_rng(4)
    cl, cr = rng.standard_normal(6), rng.standard_normal(6)
    hess = torch.autograd.functional.hessian(
        lambda m: _functional(port.dominant_eig(m, tol=TOL, device="cpu"),
                              torch.from_numpy(cl), torch.from_numpy(cr),
                              "all"), torch.from_numpy(a))
    want = np.asarray(jax.jit(jax.hessian(
        lambda m: _functional(jax_eig(m, tol=TOL), cl, cr, "all")))(
            jnp.asarray(a)))
    np.testing.assert_allclose(hess.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_gradcheck_and_gradgradcheck():
    a = torch.tensor(_positive(6, 5), requires_grad=True)
    rng = np.random.default_rng(6)
    cl, cr = (torch.from_numpy(rng.standard_normal(6)) for _ in range(2))

    def f(m):
        return _functional(port.dominant_eig(m, tol=1e-14, device="cpu"),
                           cl, cr, "all")

    assert gradcheck(f, (a,), fast_mode=True)
    assert gradgradcheck(f, (a,), fast_mode=True)


def _matrix_free(base, pert, g):
    return port.MatrixFreeOperator(
        lambda p, x: base @ x + p * (pert @ x), g, base.shape[0],
        dtype=base.dtype, rmatvec_fn=lambda p, x: base.T @ x + p * (
            pert.T @ x), symmetric=False)


def test_matrix_free_matches_dense():
    """The same operator as a closure pair (matvec and rmatvec) and as a
    dense matrix: λ, dλ/dg and d²λ/dg² agree."""
    base = torch.from_numpy(_positive(16, 7))
    pert = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (16, 16)))
    out = []
    for dense in (True, False):
        g = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
        op = base + g * pert if dense else _matrix_free(base, pert, g)
        lam, _, _ = port.dominant_eig(op, tol=TOL, device="cpu")
        (d1,) = torch.autograd.grad(lam, g, create_graph=True)
        (d2,) = torch.autograd.grad(d1, g)
        out.append([float(lam), float(d1), float(d2)])
    np.testing.assert_allclose(out[0], out[1], rtol=1e-9)


def test_symmetric_case_agrees_with_eigh_gradient():
    """On a symmetric matrix l = r = v, and dλ/dA is v v^T, as the
    symmetric solver's rule gives."""
    a = _positive(14, 9)
    a = torch.from_numpy((a + a.T) / 2)
    x = a.clone().requires_grad_(True)
    lam, _, _ = port.dominant_eig((x + x.T) / 2, tol=TOL, device="cpu")
    (g,) = torch.autograd.grad(lam, x)
    y = a.clone().requires_grad_(True)
    lam_h, _ = port.dominant_eigh((y + y.T) / 2, k=14, extreme="max",
                                  device="cpu")
    (g_h,) = torch.autograd.grad(lam_h, y)
    np.testing.assert_allclose(float(lam), float(lam_h), rtol=1e-13)
    np.testing.assert_allclose(g.numpy(), g_h.numpy(), atol=1e-10)


def test_power_info_early_exit_and_starved_budget():
    """The loop stops on its residual, far inside the budget, and counts
    the steps it ran; a starved budget is reported, not silent; the info
    rides through forward mode with zero tangents."""
    a = _positive(40, 11)
    lam, _, r, info = port.dominant_eig(torch.from_numpy(a), num_iters=500,
                                        with_info=True, device="cpu")
    _, _, _, info_j = jax.jit(lambda m: jax_eig(m, num_iters=500,
                                                with_info=True))(
        jnp.asarray(a))
    assert float(info.converged) == float(info_j.converged) == 1.0
    assert float(info.iterations) < 80
    # Different start vectors, the same convergence rate (within a few
    # steps).
    assert abs(float(info.iterations) - float(info_j.iterations)) <= 5
    assert float(info.residual) <= 1e-12
    np.testing.assert_allclose(float(lam), np.linalg.eigvals(a).real.max(),
                               rtol=1e-11)
    assert np.linalg.norm(a @ r.numpy() - float(lam) * r.numpy()) < 1e-10
    *_, bad = port.dominant_eig(torch.from_numpy(a), num_iters=2,
                                with_info=True, power_tol=1e-14,
                                device="cpu")
    assert float(bad.converged) == 0.0 and float(bad.iterations) == 2.0
    with fwAD.dual_level():
        t = fwAD.make_dual(torch.zeros((), dtype=torch.float64),
                           torch.ones((), dtype=torch.float64))
        lam, _, _, info = port.dominant_eig(
            torch.from_numpy(a) + t * torch.eye(40, dtype=torch.float64),
            num_iters=300, with_info=True, device="cpu")
        dlam = fwAD.unpack_dual(lam).tangent
        dres = fwAD.unpack_dual(info.residual).tangent
    np.testing.assert_allclose(float(dlam), 1.0, rtol=1e-9)
    assert dres is None or float(dres) == 0.0


@pytest.mark.parametrize("method", ["power", "arnoldi"])
def test_rank1_defect_flags_a_complex_dominant_pair(method):
    """The Perron guard: O(1) with a complex dominant pair (and no
    convergence), as the JAX package reports on the same matrix; ~0 on a
    Perron matrix."""
    kw = dict(num_iters=150, with_info=True, method=method, arnoldi_k=20)
    a_bad = _complex_dominant(90)
    *_, info = port.dominant_eig(torch.from_numpy(a_bad), device="cpu", **kw)
    info_j = jax.jit(lambda m: jax_eig(m, **kw)[3])(jnp.asarray(a_bad))
    for rep in (info, info_j):
        assert float(rep.rank1_defect) > 1e-2
        assert float(rep.converged) == 0.0
    a_good = _positive(30, 91)
    lam, _, _, info = port.dominant_eig(torch.from_numpy(a_good),
                                        device="cpu", **{**kw,
                                                         "num_iters": 500})
    assert float(info.rank1_defect) < 1e-6
    assert float(info.converged) == 1.0
    np.testing.assert_allclose(float(lam),
                               np.linalg.eigvals(a_good).real.max(),
                               rtol=1e-9)


def _real_spectrum(n, seed):
    """Eigenvalues 5, 4, 3 above [0, 1), a small non-symmetric part."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([[5.0, 4.0, 3.0], rng.random(n - 3)])
    return q @ np.diag(d) @ q.T + 0.02 * rng.standard_normal((n, n))


@pytest.fixture(scope="module")
def multi_reference():
    """The JAX package's top-3 triples and their report, and one VJP,
    jitted once: the gradient of ``Σλ + ⟨c, L⟩ + ⟨c, R⟩`` and that of
    λ3 alone."""
    a = _real_spectrum(20, 81)
    c = np.random.default_rng(82).standard_normal((20, 3))

    def vjp(m, ct):
        out, pull, info = jax.vjp(
            lambda x: (lambda o: (o[:3], o[3]))(
                jax_eig_multi(x, m=3, with_info=True)), m, has_aux=True)
        return out, info, pull(ct)[0]

    vjp = jax.jit(vjp)
    cj = jnp.asarray(c)
    out, info, grad = vjp(jnp.asarray(a), (jnp.ones(3), cj, cj))
    e3 = jnp.zeros(3).at[2].set(1.0)
    zeros = jnp.zeros((20, 3))
    _, _, grad3 = vjp(jnp.asarray(a), (e3, zeros, zeros))
    return (a, c, [np.asarray(t) for t in out], info, np.asarray(grad),
            np.asarray(grad3))


def test_multi_values_and_gradients_match_jax(multi_reference):
    a, c, want, info_j, grad_j, _ = multi_reference
    x = torch.tensor(a, requires_grad=True)
    lams, ls, rs, info = port.dominant_eig_multi(x, m=3, with_info=True,
                                                 device="cpu")
    for got, ref in zip((lams, ls, rs), want):
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=1e-10)
    w = np.linalg.eigvals(a)
    np.testing.assert_allclose(lams.detach().numpy(),
                               w[np.argsort(-np.abs(w))][:3].real,
                               rtol=1e-10)
    assert info.converged.tolist() == [1.0, 1.0, 1.0]
    assert info.converged.tolist() == np.asarray(info_j.converged).tolist()
    loss = lams.sum() + (ls * torch.from_numpy(c)).sum() \
        + (rs * torch.from_numpy(c)).sum()
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(g.numpy(), grad_j, rtol=0,
                               atol=1e-8 * np.abs(grad_j).max())


def test_multi_flags_a_complex_subdominant_pair():
    """A complex pair below the real top eigenvalue cannot be one real
    triple: its stage reports no convergence, in both packages."""
    a = _complex_dominant(82, dominant="real")
    lams, _, _, info = port.dominant_eig_multi(
        torch.from_numpy(a), m=2, num_iters=120, with_info=True,
        device="cpu")
    info_j = jax.jit(lambda x: jax_eig_multi(x, m=2, num_iters=120,
                                             with_info=True)[3])(
        jnp.asarray(a))
    np.testing.assert_allclose(float(lams[0]), 3.0, rtol=1e-8)
    assert info.converged.tolist() == [1.0, 0.0]
    assert np.asarray(info_j.converged).tolist() == [1.0, 0.0]


def test_gradients_reach_the_inner_operator_through_two_deflated_stages(
        multi_reference):
    """The third stage's operator wraps the second's, which wraps a
    matrix-free operator A(g) = A0 + g P: its parameters are the inner
    ones too, dλ3/dg is the JAX package's ⟨∂λ3/∂A, P⟩, and d²λ3/dg²
    equals the one through the dense matrix."""
    a, _, _, _, _, grad3 = multi_reference
    base = torch.from_numpy(a)
    pert = torch.from_numpy(np.random.default_rng(84).standard_normal(
        (20, 20)))
    g = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    op = _matrix_free(base, pert, g)
    lam1, l1, r1 = port.dominant_eig(op, method="arnoldi", device="cpu")
    stage = port.MatrixFreeOperator(eig_mod._wielandt_deflate_mv,
                                    (lam1, l1, r1, op), 20,
                                    dtype=torch.float64, symmetric=False,
                                    rmatvec_fn=eig_mod._wielandt_deflate_rmv)
    assert len(stage.parameters()) == 4 and stage.parameters()[3] is g
    derivs = []
    for dense in (False, True):
        g = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
        op = base + g * pert if dense else _matrix_free(base, pert, g)
        lams, _, _ = port.dominant_eig_multi(op, m=3, device="cpu")
        (d1,) = torch.autograd.grad(lams[2], g, create_graph=True)
        (d2,) = torch.autograd.grad(d1, g)
        derivs.append((float(d1), float(d2)))
    np.testing.assert_allclose(derivs[0][0], float((grad3 * pert.numpy())
                                                   .sum()), rtol=1e-9)
    np.testing.assert_allclose(derivs[0], derivs[1], rtol=1e-9)
