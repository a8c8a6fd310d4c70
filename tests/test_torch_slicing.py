"""The port's spectrum slicing and kernel polynomial method
(``ops/slicing.py``) against the JAX package's (CPU, f64), after
``tests/test_slicing.py``, the spectral-slice half of
``tests/test_sparse.py:244``, ``tests/test_precond.py:356-396`` and the
item-12 fuzz tests of ``tests/test_fuzz.py`` (:388, :534, :711; fewer
draws), at n ≤ 256.

Shared draws: JAX's Lanczos start vector of ``spectral_bounds`` is handed
to the port as ``v0``, and JAX's Rademacher block reaches the KPM
estimators through ``ops/slicing._rademacher`` (monkeypatched), so the
moments, densities, traces and their gradients agree to round-off.  The
LOBPCG start block inside ``spectral_slice`` is not shared: the slices
are compared once converged (λ, the projector onto the inside pairs,
the derivatives), and held against dense eigendecompositions and central
differences, the JAX tests' own oracles."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dominantsparseeigenad_tpu as jx

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

jsl = importlib.import_module("dominantsparseeigenad_tpu.ops.slicing")
psl = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.slicing")

torch.set_num_threads(2)

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _sym(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _inside(lams, v, a, b):
    """The inside eigenvalues and the projector onto their vectors."""
    lams, v = np.asarray(lams), np.asarray(v)
    keep = (lams >= a) & (lams <= b)
    return lams[keep], v[:, keep] @ v[:, keep].conj().T


def _spectrum_matrix(rng, w):
    """Symmetric matrix with exactly the spectrum ``w`` in a random
    basis."""
    q, _ = np.linalg.qr(rng.standard_normal((len(w), len(w))))
    return q @ np.diag(w) @ q.T


# -- the filter's pieces and the enclosure ------------------------------------

def test_jackson_damping_coeffs_and_block_filter():
    """Jackson factors and indicator coefficients against JAX's (1e-14),
    and the filtered operator's block apply (one recurrence on 5
    columns) against JAX's per-column filter (1e-12)."""
    degree = 40
    g = psl._jackson_damping(degree, F64)
    assert _rel(g.numpy(), jsl._jackson_damping(degree, jnp.float64)) <= 1e-14
    c = psl._jackson_indicator_coeffs(torch.tensor(-0.3, dtype=F64),
                                      torch.tensor(0.45, dtype=F64), degree)
    cj = jsl._jackson_indicator_coeffs(jnp.float64(-0.3), jnp.float64(0.45),
                                       degree)
    assert _rel(c.numpy(), cj) <= 1e-14
    n = 64
    a = _sym(n, 8)
    x = np.random.default_rng(9).standard_normal((n, 5))
    lo, hi, lo_e, hi_e = -12.0, 11.0, -0.5, 1.5
    calls = []

    class Counted(port.DenseOperator):
        def matmat(self, X):
            calls.append(X.shape)
            return super().matmat(X)

    fop = psl._filtered_operator(
        Counted(_t(a)), torch.tensor(lo, dtype=F64),
        torch.tensor(hi, dtype=F64), torch.tensor(lo_e, dtype=F64),
        torch.tensor(hi_e, dtype=F64), degree)
    y = fop.matmat(_t(x))
    assert len(calls) == degree and all(s == (n, 5) for s in calls)
    center, half = (hi + lo) / 2, (hi - lo) / 2
    params = {"op": jx.DenseOperator(jnp.asarray(a)), "lo": jnp.float64(lo),
              "hi": jnp.float64(hi),
              "coeffs": jsl._jackson_indicator_coeffs(
                  jnp.float64((lo_e - center) / half),
                  jnp.float64((hi_e - center) / half), degree)}
    want = jax.jit(jax.vmap(lambda col: jsl._filtered_matvec(params, col),
                            in_axes=1, out_axes=1))(jnp.asarray(x))
    assert _rel(y.numpy(), want) <= 1e-12


def test_bounds_enclose_spectrum():
    """With JAX's start vector the enclosure is JAX's (1e-10); it
    contains the spectrum."""
    n = 200
    a = _sym(n)
    ew = np.linalg.eigvalsh(a)
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(1), (n,),
                                    jnp.float64))
    lo, hi = port.spectral_bounds(_t(a), k=30, v0=_t(v0), device="cpu")
    loj, hij = jax.jit(lambda m: jx.spectral_bounds(jx.DenseOperator(m),
                                                    k=30))(jnp.asarray(a))
    assert float(lo) < ew[0] and float(hi) > ew[-1]
    assert _rel([float(lo), float(hi)], [float(loj), float(hij)]) <= 1e-10


# -- spectral_slice -----------------------------------------------------------

@pytest.fixture(scope="module")
def dense_slice():
    """A 240 x 240 symmetric matrix, a window with 6 eigenvalues, and
    JAX's slice of it (r = 8, degree 100, maxiter 400)."""
    n = 240
    a = _sym(n)
    ew = np.linalg.eigvalsh(a)
    lo_e, hi_e = (ew[110] + ew[109]) / 2, (ew[116] + ew[115]) / 2
    lj, vj, ij = jax.jit(lambda m: jx.spectral_slice(
        jx.DenseOperator(m), lo_e, hi_e, r=8, degree=100, maxiter=400,
        tol=1e-8))(jnp.asarray(a))
    return a, ew, lo_e, hi_e, (np.asarray(lj), np.asarray(vj), ij)


def test_slice_matches_dense_eigh_and_jax(dense_slice):
    """The inside λ against dense ``eigh`` (1e-10) and JAX's (1e-8), the
    projector onto the inside pairs against JAX's (1e-6), the same
    ``n_inside``; an orthonormal block."""
    a, ew, lo_e, hi_e, (lj, vj, ij) = dense_slice
    lams, v, info = port.spectral_slice(_t(a), lo_e, hi_e, r=8, degree=100,
                                        maxiter=400, tol=1e-8, device="cpu")
    assert float(info.n_inside) == float(ij.n_inside) == 6.0
    l_in, p_in = _inside(lams, v, lo_e, hi_e)
    lj_in, pj_in = _inside(lj, vj, lo_e, hi_e)
    np.testing.assert_allclose(l_in, ew[110:116], rtol=1e-10)
    assert _rel(l_in, lj_in) <= 1e-8
    assert np.abs(p_in - pj_in).max() <= 1e-6
    assert float(info.residual) <= 1e-6
    np.testing.assert_allclose(v.T @ v, np.eye(8), atol=1e-8)


def test_slice_guards():
    op = port.DenseOperator(_t(_sym(64)))
    with pytest.raises(ValueError, match="a < b"):
        port.spectral_slice(op, 2.0, 1.0, device="cpu")
    with pytest.raises(ValueError, match="dim >= 3"):
        port.spectral_slice(_t(_sym(8)), 0.0, 1.0, r=4, device="cpu")
    with pytest.raises(ValueError, match="degree"):
        port.spectral_slice(op, 0.0, 1.0, r=3, degree=1, device="cpu")


N2 = 28


@pytest.fixture(scope="module")
def order2():
    """The JAX test's order-2 problem (n = 28, 3 eigenvalues inside, r =
    4, degree 56): a loss of the slice and JAX's jvp and jvp of a jvp of
    it along a symmetric direction."""
    a0 = _sym(N2, seed=2)
    ew = np.linalg.eigvalsh(a0)
    lo_e, hi_e = (ew[13] + ew[12]) / 2, (ew[16] + ew[15]) / 2
    d = _sym(N2, seed=3)

    def fj(mat):
        lams, v, _ = jx.spectral_slice(jx.DenseOperator((mat + mat.T) / 2),
                                       lo_e, hi_e, r=4, degree=56,
                                       maxiter=160, tol=1e-11)
        return jnp.sum(lams * jnp.asarray([0.0, 1.0, 2.0, 3.0])) \
            + jnp.sum(v[0] ** 2)

    dj = jnp.asarray(d)
    d1 = lambda m: jax.jvp(fj, (m,), (dj,))[1]   # noqa: E731
    ref = jax.jit(lambda m: (d1(m), jax.jvp(d1, (m,), (dj,))[1]))(
        jnp.asarray(a0))
    return a0, d, lo_e, hi_e, [float(t) for t in ref]


def _port_loss(lo_e, hi_e):
    def f(mat):
        lams, v, _ = port.spectral_slice((mat + mat.T) / 2, lo_e, hi_e, r=4,
                                         degree=56, maxiter=160, tol=1e-11,
                                         device="cpu")
        return (lams * torch.tensor([0.0, 1.0, 2.0, 3.0], dtype=F64)).sum() \
            + (v[0] ** 2).sum()
    return f


def test_slice_gradients_order2(order2):
    """The loss' first and second directional derivatives by the port's
    nested jvps against JAX's jvp of a jvp (1e-7 / 1e-6); reverse mode
    (⟨∇f, D⟩) and forward over reverse against them."""
    a0, d, lo_e, hi_e, (d1j, d2j) = order2
    f = _port_loss(lo_e, hi_e)
    a, dt = _t(a0), _t(d)

    def d1(m):
        return torch.func.jvp(f, (m,), (dt,))[1]

    first, second = d1(a), torch.func.jvp(d1, (a,), (dt,))[1]
    assert _rel(float(first), d1j) <= 1e-7
    assert _rel(float(second), d2j) <= 1e-6
    x = a.clone().requires_grad_()
    (g,) = torch.autograd.grad(f(x), x, create_graph=True)
    assert _rel(float((g * dt).sum()), d1j) <= 1e-7
    (h,) = torch.autograd.grad((g * dt).sum(), x)
    assert _rel(float((h * dt).sum()), d2j) <= 1e-6


def test_slice_backward_is_one_batched_minres(order2):
    """The backward of Σλ + ⟨C, V⟩ runs its r deflated systems as one
    batched MINRES: every block product it makes is of width r = 4, none
    a matvec."""
    a0, _, lo_e, hi_e, _ = order2
    a = _t((a0 + a0.T) / 2).requires_grad_()
    calls = []

    class Counted(port.DenseOperator):
        def matvec(self, x):
            calls.append(("matvec", tuple(x.shape)))
            return super().matvec(x)

        def matmat(self, X):
            calls.append(("matmat", tuple(X.shape)))
            return super().matmat(X)

        def with_parameters(self, tensors):
            return Counted(*tensors)

    lams, v, _ = port.spectral_slice(Counted(a), lo_e, hi_e, r=4, degree=56,
                                     maxiter=160, tol=1e-11, device="cpu")
    c = _t(np.random.default_rng(4).standard_normal((N2, 4)))
    calls.clear()
    torch.autograd.grad(lams.sum() + (c * v).sum(), a)
    assert len(calls) > 10
    assert all(kind == "matmat" and shape == (N2, 4)
               for kind, shape in calls), set(calls)


def test_slice_tfim_excited_band():
    """The single-flip band of the weak-field TFIM (N = 8, g = 0.3):
    n_inside and the band sum against dense ED, d(band sum)/dg against a
    central difference of ED (the JAX test's bar, 1e-6)."""
    n, g = 8, 0.3
    ew = np.linalg.eigvalsh(models.tfim_dense_hamiltonian(
        n, g, device="cpu").numpy())
    lo_e, hi_e = float((ew[1] + ew[2]) / 2), float((ew[9] + ew[10]) / 2)

    def band_sum(gv):
        op = models.tfim_operator(n, gv, device="cpu")
        lams, _, info = port.spectral_slice(op, lo_e, hi_e, r=12,
                                            degree=200, maxiter=150,
                                            tol=1e-9, device="cpu")
        inside = (lams >= lo_e) & (lams <= hi_e)
        return torch.where(inside, lams, torch.zeros_like(lams)).sum(), info

    gt = torch.tensor(g, dtype=F64, requires_grad=True)
    val, info = band_sum(gt)
    truth = ew[(ew >= lo_e) & (ew <= hi_e)]
    assert int(info.n_inside) == len(truth) == 8
    np.testing.assert_allclose(float(val), truth.sum(), rtol=1e-9)
    (d,) = torch.autograd.grad(val, gt)
    eps = 1e-5

    def oracle(gv):
        e = np.linalg.eigvalsh(models.tfim_dense_hamiltonian(
            n, gv, device="cpu").numpy())
        return e[(e >= lo_e) & (e <= hi_e)].sum()

    fd = (oracle(g + eps) - oracle(g - eps)) / (2 * eps)
    np.testing.assert_allclose(float(d), fd, rtol=1e-6)


def test_empty_slice_is_flagged_not_vacuous():
    n = 120
    a = _sym(n, seed=9)
    ew = np.linalg.eigvalsh(a)
    gap_i = int(np.argmax(np.diff(ew)))
    lo_e = float(ew[gap_i]) + 0.3 * (ew[gap_i + 1] - ew[gap_i])
    hi_e = float(ew[gap_i]) + 0.7 * (ew[gap_i + 1] - ew[gap_i])
    _, _, info = port.spectral_slice(_t(a), lo_e, hi_e, r=3, degree=60,
                                     maxiter=60, tol=1e-8, device="cpu")
    assert float(info.n_inside) == 0.0
    assert float(info.converged) == 0.0


def test_csr_spectral_slice():
    """``tests/test_sparse.py:244``'s slice half: a CSR operator's slice
    (3 inside) against the dense oracle (1e-7)."""
    n = 150
    rng = np.random.default_rng(13)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    a = (a + a.T) / 2
    ew = np.linalg.eigvalsh(a)
    lo_e, hi_e = (ew[70] + ew[69]) / 2, (ew[73] + ew[72]) / 2
    op = port.CSROperator.from_dense(a, device="cpu")
    sl, _, info = port.spectral_slice(op, float(lo_e), float(hi_e), r=5,
                                      degree=100, maxiter=250, tol=1e-8,
                                      device="cpu")
    sl = sl.numpy()
    assert float(info.n_inside) == 3.0
    np.testing.assert_allclose(np.sort(sl[(sl >= lo_e) & (sl <= hi_e)]),
                               ew[70:73], rtol=1e-7)


def test_spectral_slice_solve_precond():
    """``solve_precond=`` reaches the derivative MINRES: the value and
    dΣλ as the plain path's, and dΣλ against a central difference."""
    n, r = 48, 3
    rng = np.random.default_rng(41)
    d = np.sort(np.concatenate([np.linspace(-0.4, 0.4, r),
                                rng.uniform(0.7, 30.0, (n - r) // 2),
                                -rng.uniform(0.7, 30.0,
                                             n - r - (n - r) // 2)]))
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a_np = q @ np.diag(d) @ q.T
    da_np = rng.standard_normal((n, n))
    da_np = (da_np + da_np.T) / 2
    m = port.jacobi_precond(port.DenseOperator(_t(a_np)), shift=0.0)

    def s_with(precond):
        return torch.func.jvp(lambda t: port.spectral_slice(
            _t(a_np) + t * _t(da_np), -0.5, 0.5, r=r, degree=90,
            maxiter=200, tol=1e-9, solve_precond=precond,
            device="cpu")[0].sum(), (torch.tensor(0.0, dtype=F64),),
            (torch.tensor(1.0, dtype=F64),))

    v0, g0 = s_with(None)
    v1, g1 = s_with(m)
    np.testing.assert_allclose(float(v1), float(v0), rtol=1e-9)
    np.testing.assert_allclose(float(g1), float(g0), rtol=1e-7)
    eps = 1e-6

    def s_at(mat):
        w = np.linalg.eigvalsh(mat)
        return w[(w >= -0.5) & (w <= 0.5)].sum()

    num = (s_at(a_np + eps * da_np) - s_at(a_np - eps * da_np)) / (2 * eps)
    np.testing.assert_allclose(float(g1), num, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("seed", [1, 3, 6])
def test_fuzz_spectral_slice(seed):
    """``tests/test_fuzz.py:388`` at 3 of its 8 draws: inside counts,
    values and vectors against the dense oracle, the FD gradient of the
    slice sum when the window is full (seed 3: m = r), and an exact
    triplet on the window's edge (seed 6): finite, and every pair
    reported converged a true eigenpair."""
    n, r = 48, 4
    a_edge, b_edge = -0.5, 0.5
    rng = np.random.default_rng(9000 + seed)
    cluster_at_edge = seed >= 6
    if cluster_at_edge:
        m = 2
        inside = rng.uniform(-0.4, 0.35, m)
        outside = np.concatenate([rng.uniform(-4, -0.65, (n - m - 3) // 2),
                                  rng.uniform(0.65, 4, n - m - 3
                                              - (n - m - 3) // 2)])
        w = np.sort(np.concatenate([inside, [b_edge] * 3, outside]))
    else:
        m = 2 + seed % 3
        inside = np.linspace(-0.38, 0.38, m) + rng.uniform(-0.02, 0.02, m)
        outside = np.concatenate([rng.uniform(-4, -0.62, (n - m) // 2),
                                  rng.uniform(0.62, 4, n - m - (n - m) // 2)])
        w = np.sort(np.concatenate([inside, outside]))
    a_np = _spectrum_matrix(rng, w)
    kw = dict(r=r, degree=90, maxiter=200, tol=1e-9, device="cpu")
    lams, v, info = port.spectral_slice(_t(a_np), a_edge, b_edge, **kw)
    lams_np, v_np = lams.numpy(), v.numpy()
    assert np.all(np.isfinite(lams_np)) and np.all(np.isfinite(v_np))
    if cluster_at_edge:
        resids = info.residuals.numpy()
        for j in range(r):
            if resids[j] < 1e-8:
                assert np.min(np.abs(w - lams_np[j])) < 1e-7
        return
    got = np.sort(lams_np[(lams_np >= a_edge) & (lams_np <= b_edge)])
    assert int(info.n_inside) == m
    assert float(info.converged) == 1.0
    np.testing.assert_allclose(got, w[(w >= a_edge) & (w <= b_edge)],
                               rtol=1e-8, atol=1e-9)
    for j in range(r):
        if a_edge <= lams_np[j] <= b_edge:
            assert np.linalg.norm(a_np @ v_np[:, j]
                                  - lams_np[j] * v_np[:, j]) < 1e-7
    if m == r:
        da_np = rng.standard_normal((n, n))
        da_np = (da_np + da_np.T) / 2
        _, g = torch.func.jvp(lambda mat: port.spectral_slice(
            mat, a_edge, b_edge, **kw)[0].sum(), (_t(a_np),), (_t(da_np),))
        eps = 1e-6

        def s_at(mat):
            ww = np.linalg.eigvalsh(mat)
            return ww[(ww >= a_edge) & (ww <= b_edge)].sum()

        num = (s_at(a_np + eps * da_np) - s_at(a_np - eps * da_np)) \
            / (2 * eps)
        np.testing.assert_allclose(float(g), num, rtol=1e-6, atol=1e-7)


def _slice_fn(n=12, seed=81):
    """A symmetrized matrix -> (λ, V ⊙ V) of a 2-pair window (r = 3)."""
    a = _sym(n, seed)
    w = np.linalg.eigvalsh(a)
    lo_e, hi_e = (w[4] + w[5]) / 2, (w[6] + w[7]) / 2

    def fn(m):
        lams, v, _ = port.spectral_slice((m + m.T) / 2, lo_e, hi_e, r=3,
                                         degree=40, maxiter=200, tol=1e-13,
                                         device="cpu")
        return lams, v * v
    return _t(a), fn


@pytest.mark.parametrize("transform", ["grad_jvp", "vmap"])
def test_slice_torch_func(transform):
    """``torch.func.grad`` against the jvp (1e-10), ``vmap`` over two
    matrices against the loop (bit for bit)."""
    a, fn = _slice_fn()
    if transform == "grad_jvp":
        def loss(m):
            lams, vv = fn(m)
            return lams.sum() + vv[0].sum()
        g = torch.func.grad(loss)(a)
        d = _t(_sym(12, 82))
        _, jv = torch.func.jvp(loss, (a,), (d,))
        assert abs(float((g * d).sum()) - float(jv)) <= 1e-10 * abs(float(jv))
    else:
        mats = torch.stack([a, a + 0.01 * _t(_sym(12, 83))])
        got = torch.func.vmap(fn)(mats)
        for i, m in enumerate(mats):
            for g_, w_ in zip(got, fn(m)):
                assert torch.equal(g_[i], w_)


# -- the kernel polynomial method ---------------------------------------------

def _jax_draws(monkeypatch, key):
    """Make the port's estimators draw what JAX's draw from ``key``: the
    enclosure's Lanczos start from ``fold_in(key, 1)`` and the Rademacher
    block from ``fold_in(key, 2)``."""
    bounds = psl.spectral_bounds

    def jax_bounds(op, k, **kw):
        v0 = np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                        (op.dim,), jnp.float64))
        return bounds(op, k, v0=_t(v0), device=kw.get("device"))

    def jax_probes(shape, generator, dtype, device):
        return _t(np.array(jax.random.rademacher(
            jax.random.fold_in(key, 2), shape, dtype=jnp.float64)))

    monkeypatch.setattr(psl, "spectral_bounds", jax_bounds)
    monkeypatch.setattr(psl, "_rademacher", jax_probes)


def test_chebyshev_moments_with_jax_probes():
    """The moments from JAX's probe block and enclosure against JAX's
    (1e-12), auto-bounds included."""
    n = 96
    a = _sym(n, 21)
    key = jax.random.PRNGKey(5)
    mj, cj, hj = jax.jit(lambda m: jsl._chebyshev_moments(
        jx.DenseOperator(m), 30, 6, key, None, 20))(jnp.asarray(a))
    z = np.array(jax.random.rademacher(jax.random.fold_in(key, 2), (n, 6),
                                       dtype=jnp.float64))
    lo, hi = float(cj - hj), float(cj + hj)
    mus, c, h = psl._chebyshev_moments(port.DenseOperator(_t(a)), 30, _t(z),
                                       torch.tensor(lo, dtype=F64),
                                       torch.tensor(hi, dtype=F64))
    assert abs(float(mus[0]) - 1.0) <= 1e-14
    assert _rel(mus.numpy(), mj) <= 1e-12
    assert _rel([float(c), float(h)], [float(cj), float(hj)]) <= 1e-12


def test_spectral_density_matches_exact_moments_and_jax(monkeypatch):
    """KPM DOS against the same Jackson kernel on exact moments (only
    trace noise differs, the JAX test's 0.03), integrating to ~1; and
    with JAX's probes against JAX's density (1e-12)."""
    rng = np.random.default_rng(1)
    n = 256
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    a = (a + a.T) / np.sqrt(2)
    op = port.DenseOperator(_t(a))
    lo, hi = (float(t) for t in port.spectral_bounds(op, k=40, device="cpu"))
    es = np.linspace(lo * 0.9, hi * 0.9, 41)
    degree, s = 100, 64
    rho = port.spectral_density(op, _t(es), degree=degree, n_probe=s,
                                bounds=(lo, hi), device="cpu").numpy()
    ew = np.linalg.eigvalsh(a)
    e_hat = (ew - (hi + lo) / 2) / ((hi - lo) / 2)
    j = np.arange(degree + 1)
    mus = np.cos(np.outer(j, np.arccos(np.clip(e_hat, -1, 1)))).mean(axis=1)
    g = psl._jackson_damping(degree, F64).numpy()
    x_hat = (es - (hi + lo) / 2) / ((hi - lo) / 2)
    tj = np.cos(np.outer(j, np.arccos(np.clip(x_hat, -1, 1))))
    w = np.where(j == 0, 1.0, 2.0) * g * mus
    rho_exact = (w @ tj) / (np.pi * np.sqrt(1 - x_hat ** 2)) / ((hi - lo) / 2)
    np.testing.assert_allclose(rho, rho_exact, atol=0.03)
    es_full = np.linspace(lo + 1e-3, hi - 1e-3, 400)
    rho_full = port.spectral_density(op, _t(es_full), degree=degree,
                                     n_probe=s, bounds=(lo, hi),
                                     device="cpu").numpy()
    assert abs(np.trapezoid(rho_full, es_full) - 1.0) < 0.05
    key = jax.random.PRNGKey(3)
    _jax_draws(monkeypatch, key)
    got = port.spectral_density(op, _t(es), degree=degree, n_probe=8,
                                device="cpu")
    want = jax.jit(lambda m, e: jx.spectral_density(
        jx.DenseOperator(m), e, degree=degree, n_probe=8, key=key))(
            jnp.asarray(a), jnp.asarray(es))
    assert _rel(got.numpy(), want) <= 1e-12


def test_spectral_density_differentiable(monkeypatch):
    """d/dg of the TFIM density near E = 0 (N = 8, degree 40, 8 probes,
    bounds ±16) with JAX's probes against ``jax.grad`` (1e-8) and a
    central difference of the estimator (1e-6)."""
    from dominantsparseeigenad_tpu import models as jm
    n, g0 = 8, 1.1
    es = np.linspace(-12.0, 12.0, 9)
    key = jax.random.PRNGKey(7)
    _jax_draws(monkeypatch, key)

    def weight(gv):
        return port.spectral_density(models.tfim_operator(n, gv,
                                                          device="cpu"),
                                     _t(es), degree=40, n_probe=8,
                                     bounds=(-16.0, 16.0), device="cpu")[4]

    g = torch.tensor(g0, dtype=F64, requires_grad=True)
    (d,) = torch.autograd.grad(weight(g), g)
    dj = jax.jit(jax.grad(lambda gv: jx.spectral_density(
        jm.tfim_operator(n, gv), jnp.asarray(es), degree=40, n_probe=8,
        key=key, bounds=(-16.0, 16.0))[4]))(jnp.float64(g0))
    assert _rel(float(d), float(dj)) <= 1e-8
    eps = 1e-5
    with torch.no_grad():
        fd = (float(weight(torch.tensor(g0 + eps, dtype=F64)))
              - float(weight(torch.tensor(g0 - eps, dtype=F64)))) / (2 * eps)
    np.testing.assert_allclose(float(d), fd, rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def spd256():
    rng = np.random.default_rng(3)
    n = 256
    c = rng.standard_normal((n, n)) / np.sqrt(n)
    return c @ c.T + 2.0 * np.eye(n)


def test_trace_function_and_logdet(spd256):
    """Tr exp(-0.3 A) within 5% and logdet within 2% of the truth (the
    JAX test's bars); the gradient of the estimator in β against its own
    central difference (1e-7)."""
    spd = spd256
    op = port.DenseOperator(_t(spd))
    ew = np.linalg.eigvalsh(spd)
    t_est = float(port.trace_function(op, lambda x: torch.exp(-0.3 * x),
                                      degree=80, n_probe=32, jackson=False,
                                      device="cpu"))
    assert abs(t_est / np.exp(-0.3 * ew).sum() - 1) < 0.05
    ld = float(port.logdet(op, degree=160, n_probe=32, device="cpu"))
    assert abs(ld / np.linalg.slogdet(spd)[1] - 1) < 0.02

    def z(beta):
        return port.trace_function(op, lambda x: torch.exp(-beta * x),
                                   degree=80, n_probe=16, jackson=False,
                                   generator=torch.Generator().manual_seed(3),
                                   device="cpu")

    beta = torch.tensor(0.3, dtype=F64, requires_grad=True)
    (d,) = torch.autograd.grad(z(beta), beta)
    eps = 1e-5
    with torch.no_grad():
        fd = (float(z(torch.tensor(0.3 + eps, dtype=F64)))
              - float(z(torch.tensor(0.3 - eps, dtype=F64)))) / (2 * eps)
    np.testing.assert_allclose(float(d), fd, rtol=1e-7)


def test_trace_and_logdet_with_jax_probes(spd256, monkeypatch):
    """With JAX's probes: Tr exp(-0.3 A) (Jackson on, its Lanczos
    enclosure) against JAX's (1e-12), and logdet with its auto-bounds
    (two ``dominant_eigh`` runs) and its gradient in the matrix against
    JAX's value (1e-10) and ``jax.grad`` (1e-8); the gradients of the
    other estimators are held in the tests above."""
    spd = spd256
    key = jax.random.PRNGKey(11)
    _jax_draws(monkeypatch, key)
    a = _t(spd).requires_grad_()
    tr = port.trace_function(a, lambda x: torch.exp(-0.3 * x), degree=60,
                             n_probe=8, device="cpu")
    ld = port.logdet(a, degree=80, n_probe=8, device="cpu")
    g_ld, = torch.autograd.grad(ld, a)
    trj, (ldj, gldj) = jax.jit(lambda m: (
        jx.trace_function(m, lambda x: jnp.exp(-0.3 * x), degree=60,
                          n_probe=8, key=key),
        jax.value_and_grad(lambda x: jx.logdet(x, degree=80, n_probe=8,
                                               key=key))(m)))(
            jnp.asarray(spd))
    assert _rel(float(tr), float(trj)) <= 1e-12
    assert _rel(float(ld), float(ldj)) <= 1e-10
    assert _rel(g_ld.numpy(), gldj) <= 1e-8


# -- slicing and KPM on sharded vectors at p = 1 ------------------------------

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


def test_sharded_vectors_trace_and_logdet_with_jax_probes(spd256, solo,
                                                          monkeypatch):
    """``test_trace_and_logdet_with_jax_probes`` on sharded vectors (the
    moments summed over the ranks, the probes the rank's rows of JAX's):
    the same bars against JAX."""
    spd = spd256
    key = jax.random.PRNGKey(11)
    _jax_draws(monkeypatch, key)
    a = _t(spd).requires_grad_()
    op = port.RowShardedOperator(a, solo, vectors="sharded")
    tr = port.trace_function(op, lambda x: torch.exp(-0.3 * x), degree=60,
                             n_probe=8, device="cpu")
    ld = port.logdet(op, degree=80, n_probe=8, device="cpu")
    g_ld, = torch.autograd.grad(ld, a)
    trj, (ldj, gldj) = jax.jit(lambda m: (
        jx.trace_function(m, lambda x: jnp.exp(-0.3 * x), degree=60,
                          n_probe=8, key=key),
        jax.value_and_grad(lambda x: jx.logdet(x, degree=80, n_probe=8,
                                               key=key))(m)))(
            jnp.asarray(spd))
    assert _rel(float(tr), float(trj)) <= 1e-12
    assert _rel(float(ld), float(ldj)) <= 1e-10
    assert _rel(g_ld.numpy(), gldj) <= 1e-8


def test_sharded_vectors_density_with_jax_probes(solo, monkeypatch):
    """The density of ``test_spectral_density_matches_exact_moments_and_jax``
    on sharded vectors with JAX's draws against JAX's (1e-12)."""
    rng = np.random.default_rng(1)
    n = 256
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    a = (a + a.T) / np.sqrt(2)
    es = np.linspace(-1.8, 1.8, 41)
    key = jax.random.PRNGKey(3)
    _jax_draws(monkeypatch, key)
    got = port.spectral_density(
        port.RowShardedOperator(_t(a), solo, vectors="sharded"), _t(es),
        degree=100, n_probe=8, device="cpu")
    want = jax.jit(lambda m, e: jx.spectral_density(
        jx.DenseOperator(m), e, degree=100, n_probe=8, key=key))(
            jnp.asarray(a), jnp.asarray(es))
    assert _rel(got.numpy(), want) <= 1e-12


def test_sharded_vectors_slice_matches_dense_eigh_and_jax(dense_slice, solo):
    """``test_slice_matches_dense_eigh_and_jax`` on sharded vectors: the
    filtered operator carries the layout into LOBPCG, and the
    Rayleigh-Ritz matrix and the residuals sum over the ranks."""
    a, ew, lo_e, hi_e, (lj, vj, ij) = dense_slice
    lams, v, info = port.spectral_slice(
        port.RowShardedOperator(_t(a), solo, vectors="sharded"), lo_e, hi_e,
        r=8, degree=100, maxiter=400, tol=1e-8, device="cpu")
    assert float(info.n_inside) == float(ij.n_inside) == 6.0
    l_in, p_in = _inside(lams, v, lo_e, hi_e)
    lj_in, pj_in = _inside(lj, vj, lo_e, hi_e)
    np.testing.assert_allclose(l_in, ew[110:116], rtol=1e-10)
    assert _rel(l_in, lj_in) <= 1e-8
    assert np.abs(p_in - pj_in).max() <= 1e-6


def test_logdet_tight_bounds_interpolation_exact():
    """With the certified auto-bounds the only logdet error is trace
    noise: within 3 ||ln A||_F sqrt(2 / 64) of the truth."""
    rng = np.random.default_rng(2)
    n = 256
    c = rng.standard_normal((n, n)) / np.sqrt(n)
    spd = c @ c.T + 0.3 * np.eye(n)
    ew = np.linalg.eigvalsh(spd)
    noise = np.sqrt(2.0 / 64) * np.linalg.norm(np.log(ew))
    ld = float(port.logdet(_t(spd), degree=160, n_probe=64, device="cpu"))
    assert abs(ld - np.log(ew).sum()) < 3.0 * noise


@pytest.mark.parametrize("seed", [0, 5])
def test_fuzz_kpm_density_trace_logdet(seed):
    """``tests/test_fuzz.py:534`` at 2 of its 8 draws (its bars): the
    density against the same kernel on exact moments, Tr A³, logdet, and
    the estimator's jvp against its own central difference."""
    n, degree, n_probe = 48, 100, 256
    bounds = (0.4, 4.2)
    energies = np.linspace(0.6, 4.0, 25)
    rng = np.random.default_rng(9200 + seed)
    w = np.sort(rng.uniform(0.5, 4.0, n))
    a_np = _spectrum_matrix(rng, w)
    a = _t(a_np)

    def gen():
        return torch.Generator().manual_seed(100 + seed)

    rho = port.spectral_density(a, _t(energies), degree=degree,
                                n_probe=n_probe, generator=gen(),
                                bounds=bounds, device="cpu").numpy()
    center, half = 0.5 * (bounds[0] + bounds[1]), 0.5 * (bounds[1] - bounds[0])
    j = np.arange(degree + 1)
    mus = np.cos(j[:, None] * np.arccos((w - center) / half)[None, :]) \
        .mean(axis=1)
    g_j = psl._jackson_damping(degree, F64).numpy()
    e_hat = (energies - center) / half
    tj = np.cos(np.arccos(e_hat)[None, :] * j[:, None])
    rho_ref = ((np.where(j == 0, 1.0, 2.0) * g_j * mus) @ tj) \
        / (np.pi * np.sqrt(1 - e_hat ** 2)) / half
    assert np.abs(rho - rho_ref).max() < 0.15 * np.abs(rho_ref).max()
    tr3 = float(port.trace_function(a, lambda x: x ** 3, degree=degree,
                                    n_probe=n_probe, generator=gen(),
                                    bounds=bounds, jackson=False,
                                    device="cpu"))
    assert abs(tr3 / np.sum(w ** 3) - 1) < 0.05

    def est(mat):
        return port.logdet(mat, degree=degree, n_probe=n_probe,
                           generator=gen(), bounds=bounds, device="cpu")

    assert abs(float(est(a)) / np.sum(np.log(w)) - 1) < 0.05
    da_np = rng.standard_normal((n, n))
    da_np = (da_np + da_np.T) / 8
    _, g = torch.func.jvp(est, (a,), (_t(da_np),))
    eps = 1e-5
    num = (float(est(_t(a_np + eps * da_np)))
           - float(est(_t(a_np - eps * da_np)))) / (2 * eps)
    np.testing.assert_allclose(float(g), num, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_fuzz_trace_function_exp(seed):
    """``tests/test_fuzz.py:711`` at 2 of its 8 draws: Tr exp(A), Jackson
    off, within 8% of the eigenvalue sum, and the estimator's jvp against
    its own central difference."""
    n, degree, n_probe = 48, 60, 256
    bounds = (-3.5, 3.5)
    rng = np.random.default_rng(9500 + seed)
    w = np.sort(rng.uniform(-3.0, 3.0, n))
    a_np = _spectrum_matrix(rng, w)

    def est(mat):
        return port.trace_function(
            mat, torch.exp, degree=degree, n_probe=n_probe,
            generator=torch.Generator().manual_seed(200 + seed),
            bounds=bounds, jackson=False, device="cpu")

    assert abs(float(est(_t(a_np))) / np.sum(np.exp(w)) - 1) < 0.08
    da_np = rng.standard_normal((n, n))
    da_np = (da_np + da_np.T) / 8
    _, g = torch.func.jvp(est, (_t(a_np),), (_t(da_np),))
    eps = 1e-5
    num = (float(est(_t(a_np + eps * da_np)))
           - float(est(_t(a_np - eps * da_np)))) / (2 * eps)
    np.testing.assert_allclose(float(g), num, rtol=1e-4, atol=1e-6)
