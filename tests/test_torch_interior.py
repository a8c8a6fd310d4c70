"""The port's shift-invert interior solver (``ops/interior.py``) against
the JAX package's (CPU, f64), after ``tests/test_interior.py``, the
interior half of ``tests/test_precond.py:314-396`` and
``tests/test_fuzz.py:478`` (fewer draws); and the batched deflated
MINRES of ``ops/cg.py`` that the spectral slice's rule runs, against
the per-lane solve and JAX's ``vmap`` of its solve.

Both packages start the shift-inverted Lanczos from the same vector: JAX
draws it as ``normal(PRNGKey(seed), (n,))`` and the port is handed that
draw as ``v0``.  Other oracles: dense eigendecompositions, sums over
states and central differences."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

import dominantsparseeigenad_tpu as jx

import dominantsparseeigenad_tpu_torch as port

jcg = importlib.import_module("dominantsparseeigenad_tpu.ops.cg")

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


def _jax_v0(n, dtype=jnp.float64, seed=0):
    """The start vector JAX's Lanczos draws for ``seed``."""
    return _t(np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                         dtype)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- tests/test_interior.py ---------------------------------------------------

def test_interior_value_and_residual():
    """The eigenvalue nearest σ against dense ``eigvalsh`` (1e-11) and its
    residual (λ and v against JAX's are held in the next test)."""
    n = 64
    a = _sym(n, 1)
    evals = np.linalg.eigvalsh(a)
    sigma = float((evals[30] + evals[31]) / 2 + 0.013)
    target = evals[np.argmin(np.abs(evals - sigma))]
    lam, v = port.interior_eigh(_t(a), sigma, k=40, v0=_jax_v0(n),
                                device="cpu")
    np.testing.assert_allclose(float(lam), target, rtol=1e-11)
    assert float(torch.linalg.vector_norm(_t(a) @ v - lam * v)) < 1e-9


@pytest.fixture(scope="module")
def pencil40():
    """``h0 + g h1`` (n = 40), σ next to the middle eigenvalue, and JAX's
    λ, dλ/dg, d²λ/dg² and the jvp of v at g = 0."""
    n = 40
    h0, h1 = _sym(n, 2), _sym(n, 3)
    sigma = float(np.linalg.eigvalsh(h0)[n // 2] + 0.005)
    j0, j1 = jnp.asarray(h0), jnp.asarray(h1)

    def pair(g):
        op = jx.MatrixFreeOperator(lambda gg, x: j0 @ x + gg * (j1 @ x), g,
                                   dim=n, dtype=j0.dtype)
        return jx.interior_eigh(op, sigma, k=36, tol=1e-11)

    lam = lambda g: pair(g)[0]   # noqa: E731
    g0 = jnp.float64(0.0)
    ref = jax.jit(lambda g: (jax.value_and_grad(lam)(g),
                             jax.grad(jax.grad(lam))(g),
                             jax.jvp(lambda s: pair(s)[1], (g,),
                                     (jnp.float64(1.0),))))(g0)
    (val, d1), d2, (v, dv) = ref
    return h0, h1, sigma, {"lam": float(val), "d1": float(d1),
                           "d2": float(d2), "v": np.asarray(v),
                           "dv": np.asarray(dv)}


def _port_pair(h0, h1, sigma, g):
    a0, a1 = _t(h0), _t(h1)
    op = port.MatrixFreeOperator(lambda gg, x: a0 @ x + gg * (a1 @ x), g,
                                 dim=h0.shape[0], dtype=F64)
    return port.interior_eigh(op, sigma, k=36, tol=1e-11,
                              v0=_jax_v0(h0.shape[0]), device="cpu")


def test_interior_derivatives(pencil40):
    """λ, dλ/dg (reverse), d²λ/dg² (reverse over reverse) and the jvp of
    v against JAX (1e-10 / 1e-8 / 1e-6 / 1e-8), and against the dense
    Hellmann-Feynman and sum-over-states values."""
    h0, h1, sigma, ref = pencil40
    g = torch.tensor(0.0, dtype=F64, requires_grad=True)
    lam, v = _port_pair(h0, h1, sigma, g)
    (d1,) = torch.autograd.grad(lam, g, create_graph=True)
    (d2,) = torch.autograd.grad(d1, g)
    one = torch.tensor(1.0, dtype=F64)
    _, dv = torch.func.jvp(lambda s: _port_pair(h0, h1, sigma, s)[1],
                           (g.detach(),), (one,))
    assert _rel(float(lam), ref["lam"]) <= 1e-10
    assert _rel(float(d1), ref["d1"]) <= 1e-8
    assert _rel(float(d2), ref["d2"]) <= 1e-6
    assert _rel(v.detach().numpy(), ref["v"]) <= 1e-8
    assert _rel(dv.numpy(), ref["dv"]) <= 1e-8
    evs, evc = np.linalg.eigh(h0)
    i = np.argmin(np.abs(evs - sigma))
    v0 = evc[:, i]
    np.testing.assert_allclose(float(d1), v0 @ h1 @ v0, rtol=1e-8)
    me = np.delete(evc, i, axis=1).T @ (h1 @ v0)
    gaps = evs[i] - np.delete(evs, i)
    np.testing.assert_allclose(float(d2), 2 * np.sum(me ** 2 / gaps),
                               rtol=1e-6)


def test_operator_algebra_through_eigensolver():
    n = 32
    a, b = _t(_sym(n, 4)), _t(_sym(n, 5))
    op = port.DenseOperator(a) + 0.5 * port.DenseOperator(b)
    lam, _ = port.dominant_eigh(op, k=n, extreme="max", device="cpu")
    np.testing.assert_allclose(float(lam),
                               np.linalg.eigvalsh((a + 0.5 * b).numpy())[-1],
                               rtol=1e-10)
    comp = port.DenseOperator(a) @ port.DenseOperator(a)
    lam2, _ = port.dominant_eigh(comp, k=n, extreme="max", device="cpu")
    evs = np.linalg.eigvalsh(a.numpy())
    np.testing.assert_allclose(float(lam2), max(evs[0] ** 2, evs[-1] ** 2),
                               rtol=1e-9)


def test_interior_complex_phase_gauge_gradient():
    """d/dt of Re<probe, v> for a complex Hermitian h0 + t h1: the
    pivot-phase projection of the rule, against JAX's gradient (1e-8; a
    real parameter, so no conjugation) and a central difference."""
    n = 24
    rng = np.random.default_rng(11)
    h0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h0 = (h0 + h0.conj().T) / 2
    h1 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h1 = (h1 + h1.conj().T) / 2
    w = np.linalg.eigvalsh(h0)
    sigma = float((w[n // 2] + w[n // 2 + 1]) / 2 + 0.01)
    probe = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v0 = _jax_v0(n, jnp.complex128)

    def f(t):
        _, v = port.interior_eigh(_t(h0) + t * _t(h1), sigma, k=n, v0=v0,
                                  device="cpu")
        return torch.vdot(_t(probe), v).real

    def fj(t):
        _, v = jx.interior_eigh(jnp.asarray(h0) + t * jnp.asarray(h1), sigma,
                                k=n)
        return jnp.real(jnp.vdot(jnp.asarray(probe), v))

    t0 = torch.tensor(0.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(f(t0), t0)
    gj = float(jax.jit(jax.grad(fj))(jnp.float64(0.0)))
    eps = 1e-6
    with torch.no_grad():
        num = (float(f(torch.tensor(eps, dtype=F64)))
               - float(f(torch.tensor(-eps, dtype=F64)))) / (2 * eps)
    assert _rel(float(g), gj) <= 1e-8
    np.testing.assert_allclose(float(g), num, rtol=1e-5)


# -- tests/test_precond.py:314-352 ---------------------------------------------

def test_interior_eigh_precond():
    """``precond=`` reaches the inner and the derivative MINRES: λ and v
    as the plain path's, and the jvp against a central difference of
    dense eigenvalues (the JAX test's bars)."""
    n = 64
    rng = np.random.default_rng(29)
    d = np.exp(rng.uniform(0, np.log(300), n))
    s = rng.standard_normal((n, n)) * 0.05
    a_np = np.diag(d) + (s + s.T) / 2
    w = np.linalg.eigvalsh(a_np)
    sigma = float(0.5 * (w[n // 2] + w[n // 2 + 1]) + 0.3 * (
        w[n // 2] - 0.5 * (w[n // 2] + w[n // 2 + 1])))
    da_np = rng.standard_normal((n, n))
    da_np = (da_np + da_np.T) / 2
    m = port.jacobi_precond(diag=_t(d), shift=sigma)
    kw = dict(k=40, inner_tol=1e-12, inner_maxiter=4000, tol=1e-10,
              v0=_jax_v0(n), device="cpu")
    lam0, v0 = port.interior_eigh(_t(a_np), sigma, **kw)
    lam1, v1 = port.interior_eigh(_t(a_np), sigma, precond=m, **kw)
    want = w[np.argmin(np.abs(w - sigma))]
    np.testing.assert_allclose(float(lam1), want, rtol=1e-9)
    np.testing.assert_allclose(float(lam1), float(lam0), rtol=1e-9)
    np.testing.assert_allclose(v1.abs().numpy(), v0.abs().numpy(), atol=1e-6)
    _, g = torch.func.jvp(lambda mat: port.interior_eigh(
        mat, sigma, precond=m, **kw)[0], (_t(a_np),), (_t(da_np),))
    eps = 1e-7

    def lam_at(mat):
        ww = np.linalg.eigvalsh(mat)
        return ww[np.argmin(np.abs(ww - sigma))]

    num = (lam_at(a_np + eps * da_np) - lam_at(a_np - eps * da_np)) \
        / (2 * eps)
    np.testing.assert_allclose(float(g), num, rtol=1e-5, atol=1e-7)


# -- tests/test_fuzz.py:478 (3 of its 8 draws) --------------------------------

def _spectrum_matrix(rng, w):
    q, _ = np.linalg.qr(rng.standard_normal((len(w), len(w))))
    return q @ np.diag(w) @ q.T


FUZZ_KW = dict(k=40, inner_tol=1e-12, inner_maxiter=4000, tol=1e-9)


@pytest.fixture(scope="module")
def jax_fuzz_jvp():
    """JAX's jvp of λ (σ = 0.3, the fuzz test's settings), jitted once."""
    return jax.jit(lambda a, da: jax.jvp(lambda mat: jx.interior_eigh(
        mat, 0.3, **FUZZ_KW)[0], (a,), (da,)))


@pytest.mark.parametrize("seed,delta", [(0, 0.12), (5, -1e-2), (6, 1e-3)])
def test_fuzz_interior_eigh(jax_fuzz_jvp, seed, delta):
    """The nearest eigenvalue at a swept distance from σ (down to 1e-3 of
    the spread): λ against σ + δ, the residual, the directional
    derivative against JAX's jvp (1e-8) and a central difference."""
    n, sigma = 48, 0.3
    rng = np.random.default_rng(9100 + seed)
    others = np.concatenate([
        sigma - 0.15 - np.cumsum(rng.uniform(0.05, 0.2, (n - 1) // 2)),
        sigma + 0.15 + np.cumsum(rng.uniform(0.05, 0.2,
                                             n - 1 - (n - 1) // 2))])
    w = np.sort(np.concatenate([[sigma + delta], others]))
    a_np = _spectrum_matrix(rng, w)
    da_np = rng.standard_normal((n, n))
    da_np = (da_np + da_np.T) / 2
    kw = FUZZ_KW
    (lam, v), (_, g) = (
        port.interior_eigh(_t(a_np), sigma, v0=_jax_v0(n), device="cpu",
                           **kw),
        torch.func.jvp(lambda mat: port.interior_eigh(
            mat, sigma, v0=_jax_v0(n), device="cpu", **kw)[0],
            (_t(a_np),), (_t(da_np),)))
    np.testing.assert_allclose(float(lam), sigma + delta, rtol=1e-9,
                               atol=1e-11)
    assert float(torch.linalg.vector_norm(_t(a_np) @ v - lam * v)) < 1e-7
    _, gj = jax_fuzz_jvp(jnp.asarray(a_np), jnp.asarray(da_np))
    assert _rel(float(g), float(gj)) <= 1e-8
    eps = 1e-7

    def lam_at(mat):
        ww = np.linalg.eigvalsh(mat)
        return ww[np.argmin(np.abs(ww - sigma))]

    num = (lam_at(a_np + eps * da_np) - lam_at(a_np - eps * da_np)) \
        / (2 * eps)
    np.testing.assert_allclose(float(g), num, rtol=1e-5, atol=1e-6)


# -- the Function's autograd checks and torch.func ---------------------------

def _interior_fn(n=10, seed=41):
    """A symmetrized matrix -> (λ, v ⊙ v) of the pair nearest σ."""
    a = _sym(n, seed)
    w = np.linalg.eigvalsh(a)
    sigma = float(w[n // 2] + 0.1 * (w[n // 2 + 1] - w[n // 2]))

    def fn(m):
        lam, v = port.interior_eigh((m + m.T) / 2, sigma, k=n,
                                    inner_tol=1e-13, tol=1e-13,
                                    v0=torch.ones(n, dtype=F64),
                                    device="cpu")
        return lam, v * v
    return _t(a), fn


@pytest.mark.parametrize("transform", ["grad_jvp", "vmap"])
def test_interior_torch_func(transform):
    """``torch.func.grad`` of Σλ-like losses equals the jvp along each
    probe direction (1e-10), and ``vmap`` over two matrices equals the
    loop bit for bit."""
    a, fn = _interior_fn()
    if transform == "grad_jvp":
        def loss(m):
            lam, vv = fn(m)
            return lam + vv[0]
        g = torch.func.grad(loss)(a)
        d = _t(_sym(10, 42))
        _, jv = torch.func.jvp(loss, (a,), (d,))
        assert abs(float((g * d).sum()) - float(jv)) <= 1e-10 * abs(float(jv))
    else:
        mats = torch.stack([a, a + 0.01 * _t(_sym(10, 43))])
        got = torch.func.vmap(fn)(mats)
        for i, m in enumerate(mats):
            for g_, w_ in zip(got, fn(m)):
                assert torch.equal(g_[i], w_)


# -- ops/cg.py: the batched deflated MINRES ----------------------------------

@pytest.fixture(scope="module")
def block_system():
    """A symmetric matrix, 4 interior eigenvectors as V, their λ as the
    shifts, 4 right-hand sides, and JAX's vmap of its deflated MINRES."""
    n = 40
    a = _sym(n, 1)
    w, vec = np.linalg.eigh(a)
    V, lams = vec[:, 18:22], w[18:22]
    b = np.random.default_rng(3).standard_normal((n, 4))
    dinv = 1.0 / (np.abs(np.diag(a) - lams.mean()) + 1.0)
    ref = jax.jit(lambda lam, bb, pre: jax.vmap(
        lambda l_, b_: jcg.solve_deflated(
            jx.DenseOperator(jnp.asarray(a)), l_, jnp.asarray(V), b_,
            method="minres", tol=1e-12,
            precond=None if pre is None else (lambda r: pre * r)),
        in_axes=(0, 1), out_axes=1)(lam, bb))
    return a, V, lams, b, dinv, ref


@pytest.mark.parametrize("kind", ["real", "precond", "complex"])
def test_batched_minres_matches_per_lane_and_jax(block_system, kind):
    """One batched MINRES over the columns against the per-lane solves
    and JAX's ``vmap`` (1e-10 each): real, Jacobi-preconditioned and
    complex Hermitian; one matmat per iteration."""
    a, V, lams, b, dinv, ref = block_system
    pre = None
    if kind == "complex":
        rng = np.random.default_rng(7)
        n = a.shape[0]
        c = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        a = (c + c.conj().T) / 2
        w, vec = np.linalg.eigh(a)
        V, lams = vec[:, 18:22], w[18:22]
        b = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
    elif kind == "precond":
        pre = _t(dinv)
    calls = []

    class Counted(port.DenseOperator):
        def matmat(self, X):
            calls.append(X.shape)
            return super().matmat(X)

    prec = None if pre is None else (lambda r: pre * r)
    x = port.solve_deflated(Counted(_t(a)), _t(lams), _t(V), _t(b),
                            method="minres", tol=1e-12, precond=prec,
                            device="cpu")
    assert calls and all(s == (a.shape[0], 4) for s in calls)
    loop = torch.stack([port.solve_deflated(
        _t(a), float(lam), _t(V), _t(b[:, i]), method="minres", tol=1e-12,
        precond=prec, device="cpu") for i, lam in enumerate(lams)], 1)
    assert _rel(x.numpy(), loop.numpy()) <= 1e-10
    if kind == "complex":
        want = jax.jit(jax.vmap(lambda l_, b_: jcg.solve_deflated(
            jx.DenseOperator(jnp.asarray(a)), l_, jnp.asarray(V), b_,
            method="minres", tol=1e-12), in_axes=(0, 1), out_axes=1))(
                jnp.asarray(lams), jnp.asarray(b))
    else:
        want = ref(jnp.asarray(lams), jnp.asarray(b),
                   None if pre is None else jnp.asarray(dinv))
    assert _rel(x.numpy(), want) <= 1e-10


def test_vmap_of_minres_solve_is_one_block_solve(block_system):
    """``torch.func.vmap`` of the MINRES solve over right-hand sides and
    shifts is one batched MINRES (block products of width 4 only), equal
    to the block call (1e-13) and JAX's vmap (1e-10)."""
    a, V, lams, b, _, ref = block_system
    calls = []

    class Counted(port.DenseOperator):
        def matvec(self, x):
            calls.append(("matvec", tuple(x.shape)))
            return super().matvec(x)

        def matmat(self, X):
            calls.append(("matmat", tuple(X.shape)))
            return super().matmat(X)

    op = Counted(_t(a))
    got = torch.func.vmap(lambda bb, lam: port.solve_deflated(
        op, lam, _t(V), bb, method="minres", tol=1e-12, device="cpu"),
        in_dims=(1, 0), out_dims=1)(_t(b), _t(lams))
    assert calls and all(c == ("matmat", (a.shape[0], 4)) for c in calls)
    block = port.solve_deflated(_t(a), _t(lams), _t(V), _t(b),
                                method="minres", tol=1e-12, device="cpu")
    assert _rel(got.numpy(), block.numpy()) <= 1e-13
    assert _rel(got.numpy(), ref(jnp.asarray(lams), jnp.asarray(b), None)) \
        <= 1e-10


def test_batched_minres_gradcheck():
    """``gradcheck`` (forward AD on) and ``gradgradcheck`` through
    ``_DeflatedSolve``'s batched MINRES: indefinite shifts inside the
    spectrum, V from the unperturbed matrix."""
    n = 10
    a0 = _sym(n, 72)
    w0, vec0 = np.linalg.eigh(a0)
    V = _t(vec0[:, 4:6])

    def fn(m, lam, b):
        return port.solve_deflated((m + m.T) / 2, _t(w0[4:6]) + lam, V, b,
                                   method="minres", tol=1e-13, device="cpu")

    rng = np.random.default_rng(73)
    inputs = (_t(a0).requires_grad_(),
              _t(rng.standard_normal(2) * 0.01).requires_grad_(),
              _t(rng.standard_normal((n, 2))).requires_grad_())
    assert gradcheck(fn, inputs, check_forward_ad=True,
                     check_batched_grad=False, fast_mode=True)
    assert gradgradcheck(fn, inputs, check_fwd_over_rev=True, fast_mode=True)
