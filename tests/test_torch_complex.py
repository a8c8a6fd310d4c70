"""Complex operators in the port against the JAX package (CPU, f64):
complex Hermitian operators through Lanczos, LOBPCG, CG, MINRES, the
deflated solve and both IFT rules (values, first and second derivatives,
forward mode, phase-sensitive eigenvector gradients), the observables on
a complex pencil, the Hermitian embedding of ``dominant_svd``, the
complex SVD rules, and complex non-symmetric operators through
``dominant_eig`` and the general solvers (after ``tests/test_complex.py``,
``tests/test_observables.py:67-110``, the complex cases of
``tests/test_fuzz.py``, ``tests/test_svd.py:31``,
``tests/test_ising2d.py:318`` and ``tests/test_eigh.py:288-294``).

PyTorch's gradient of a complex tensor is the conjugate of JAX's
cotangent, so a gradient with respect to a complex leaf is held against
``np.conj`` of JAX's; a gradient with respect to a real parameter is the
same number in both.  Forward-mode tangents follow the plain JVP in both.
Every entry point that refused complex input before is held against the
JAX package on complex input (``test_complex_input_matches_jax``).  JAX
references are jitted once where they are reused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.autograd import gradcheck, gradgradcheck

import dominantsparseeigenad_tpu as jx
from dominantsparseeigenad_tpu.ops import decomp as jd
from dominantsparseeigenad_tpu.ops.lanczos import lanczos as jax_lanczos

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)

C128 = torch.complex128
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _herm(n, seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (b + b.conj().T) / 2


def _cvec(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _cnonsym(n, seed, scale=0.05, second=None):
    """A complex non-symmetric matrix with an isolated dominant eigenvalue
    3 + 0.7i (and, with ``second``, that one next)."""
    rng = np.random.default_rng(seed)
    head = [3.0 + 0.7j] + ([] if second is None else [second])
    d = np.concatenate([head, 0.4 * (rng.standard_normal(n - len(head))
                                     + 1j * rng.standard_normal(
                                         n - len(head)))])
    return np.diag(d) + scale * (rng.standard_normal((n, n))
                                 + 1j * rng.standard_normal((n, n)))


def _t(x):
    return torch.tensor(np.asarray(x))


def _s(x):
    """A float64 scalar tensor."""
    return torch.tensor(float(x), dtype=F64)


def _err(got, want):
    """Largest absolute difference relative to the largest |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _grad_and_jvp(f, t0=0.0):
    """The port's df/dt at t0 by reverse mode and by forward mode."""
    t = _s(t0).requires_grad_(True)
    (g,) = torch.autograd.grad(f(t), t)
    with fwAD.dual_level():
        jv = fwAD.unpack_dual(f(fwAD.make_dual(_s(t0), _s(1.0)))).tangent
    return float(g), float(jv)


def _fd(f, t0=0.0, eps=1e-6):
    return (float(f(_s(t0 + eps))) - float(f(_s(t0 - eps)))) / (2 * eps)


# -- complex Hermitian operators --------------------------------------------

def test_complex_lanczos_forward():
    """Lanczos from the same start vector: the real α and β of T and the
    basis equal JAX's to round-off, and the extremal pair equals JAX's and
    numpy's with the pivot entry real and positive."""
    n = 24
    h, v0 = _herm(n, 0), _cvec(n, 1)
    res = port.lanczos(_t(h), 8, v0=_t(v0), device="cpu")
    ref, (lam_j, v_j) = jax.jit(lambda a, v: (
        jax_lanczos(jx.DenseOperator(a), 8, v0=v),
        jx.lanczos_eigh(jx.DenseOperator(a), k=n, extreme="min", v0=v)))(
        jnp.asarray(h), jnp.asarray(v0))
    assert res.alphas.dtype == F64 and res.betas.dtype == F64
    for got, want in zip(res, ref):
        assert _err(got, want) <= 1e-12
    lam, v = port.lanczos_eigh(_t(h), k=n, extreme="min", v0=_t(v0),
                               device="cpu")
    assert abs(float(lam) - float(lam_j)) <= 1e-12
    assert abs(float(lam) - np.linalg.eigvalsh(h)[0]) <= 1e-12
    assert _err(v, v_j) <= 1e-10
    pivot = complex(v[torch.argmax(v.abs())])
    assert abs(pivot.imag) < 1e-14 and pivot.real > 0


def test_complex_solves():
    """CG on a Hermitian positive definite system and MINRES on an
    indefinite Hermitian one: the solutions equal JAX's to 1e-9."""
    n = 24
    h = _herm(n, 2)
    spd = h @ h.conj().T + n * np.eye(n)
    b = _cvec(n, 3)
    x = port.cg(lambda v: _t(spd) @ v, _t(b), tol=1e-12, device="cpu")
    x_j, x2_j = jax.jit(lambda a, m, r: (
        jx.cg(lambda v: a @ v, r, tol=1e-12),
        jx.minres(lambda v: m @ v, r, tol=1e-12, maxiter=400)))(
        jnp.asarray(spd), jnp.asarray(h), jnp.asarray(b))
    assert _err(x, x_j) <= 1e-9
    assert np.linalg.norm(spd @ x.numpy() - b) < 1e-8
    x2 = port.minres(lambda v: _t(h) @ v, _t(b), tol=1e-12, maxiter=400,
                     device="cpu")
    assert _err(x2, x2_j) <= 1e-8
    assert np.linalg.norm(h @ x2.numpy() - b) < 1e-7


def _pencil_e0(h0, h1, pkg):
    """E0(g) of the matrix-free pencil h0 + g h1 in ``pkg``."""
    n = h0.shape[0]
    if pkg is jx:
        def e0(g):
            op = jx.MatrixFreeOperator(lambda gg, x: h0 @ x + gg * (h1 @ x),
                                       g, dim=n, dtype=h0.dtype)
            return jx.dominant_eigh(op, k=n, tol=1e-12)[0]
        return e0

    def e0_port(g):
        op = port.MatrixFreeOperator(lambda gg, x: h0 @ x + gg * (h1 @ x),
                                     g, dim=n, dtype=C128)
        return port.dominant_eigh(op, k=n, tol=1e-12, device="cpu")[0]
    return e0_port


def test_complex_first_and_second_derivatives():
    """dE0/dg and d²E0/dg² of a complex Hermitian pencil, reverse over
    reverse (the second backward runs the deflated solve), against JAX's
    grad and grad of grad and the sum over states, to 1e-9 and 1e-7."""
    n = 24
    h0, h1 = _herm(n, 4), _herm(n, 5)
    e0 = _pencil_e0(_t(h0), _t(h1), port)
    _, d1, d2 = port.value_d1_d2(e0, 0.3, device="cpu")
    e0_j = _pencil_e0(jnp.asarray(h0), jnp.asarray(h1), jx)
    d1_j, d2_j = jax.jit(lambda g: (jax.grad(e0_j)(g),
                                    jax.grad(jax.grad(e0_j))(g)))(
        jnp.float64(0.3))
    evals, evecs = np.linalg.eigh(h0 + 0.3 * h1)
    v0 = evecs[:, 0]
    me = evecs[:, 1:].conj().T @ (h1 @ v0)
    d2_exact = 2 * np.sum(np.abs(me) ** 2 / (evals[0] - evals[1:]))
    assert abs(float(d1) - float(d1_j)) <= 1e-9 * abs(float(d1_j))
    assert abs(float(d2) - float(d2_j)) <= 1e-7 * abs(float(d2_j))
    assert abs(float(d1) - np.real(v0.conj() @ (h1 @ v0))) <= 1e-9
    assert abs(float(d2) - d2_exact) <= 1e-7 * abs(d2_exact)


def test_complex_eigenvector_gradient():
    """The gradient of |<w, v>|², reverse mode through the deflated
    solve with the phase-projected cotangent, against JAX's gradient and
    a central difference."""
    n = 24
    h0, h1, w = _herm(n, 6), _herm(n, 7), _cvec(n, 8)

    def overlap(pkg, h0, h1, w):
        def f(g):
            if pkg is jx:
                op = jx.MatrixFreeOperator(
                    lambda gg, x: h0 @ x + gg * (h1 @ x), g, dim=n,
                    dtype=h0.dtype)
                v = jx.dominant_eigh(op, k=n, tol=1e-12)[1]
                return jnp.abs(jnp.vdot(w, v)) ** 2
            op = port.MatrixFreeOperator(
                lambda gg, x: h0 @ x + gg * (h1 @ x), g, dim=n, dtype=C128)
            v = port.dominant_eigh(op, k=n, tol=1e-12, device="cpu")[1]
            return torch.vdot(w, v).abs() ** 2
        return f

    f = overlap(port, _t(h0), _t(h1), _t(w))
    g, jv = _grad_and_jvp(f, 0.2)
    g_j = jax.jit(jax.grad(overlap(jx, *(jnp.asarray(x) for x in
                                         (h0, h1, w)))))(jnp.float64(0.2))
    assert abs(g - float(g_j)) <= 1e-9 * abs(float(g_j))
    assert abs(jv - g) <= 1e-9 * abs(g)
    assert abs(g - _fd(f, 0.2)) <= 1e-5 * abs(g)


@pytest.mark.parametrize("method", ["lanczos", "lobpcg"])
def test_complex_multi(method):
    """The block solver on a complex Hermitian matrix: the r smallest
    eigenvalues against numpy and JAX, V orthonormal, the projectors
    V Vᴴ against JAX's, and d Σλ / dg = r for a shift g I, by reverse and
    by forward mode."""
    n, r = 24, 3
    h = _herm(n, 10)
    kw = dict(r=r, k=n if method == "lanczos" else 300, method=method,
              tol=1e-12)
    lams, v = port.dominant_eigh_multi(_t(h), device="cpu", **kw)
    lams_j, v_j = jax.jit(lambda a: jx.dominant_eigh_multi(
        jx.DenseOperator(a), **kw))(jnp.asarray(h))
    assert _err(lams, np.linalg.eigvalsh(h)[:r]) <= 1e-10
    assert _err(lams, lams_j) <= 1e-10
    assert _err(v.mH @ v, np.eye(r)) <= 1e-12
    vj = np.asarray(v_j)
    assert _err(v @ v.mH, vj @ vj.conj().T) <= 1e-8

    def loss(g):
        op = port.MatrixFreeOperator(lambda gg, x: _t(h) @ x + gg * x, g,
                                     dim=n, dtype=C128)
        return port.dominant_eigh_multi(op, device="cpu", **kw)[0].sum()

    g, jv = _grad_and_jvp(loss)
    assert abs(g - r) <= 1e-10 and abs(jv - r) <= 1e-10


def test_complex_deflated_solve():
    """The deflated solve of a complex Hermitian system against JAX's:
    x ⊥ v and the deflated residual vanishes."""
    n = 24
    h = _herm(n, 11)
    evals, evecs = np.linalg.eigh(h)
    lam, v, b = evals[0], evecs[:, 0], _cvec(n, 12)
    x = port.solve_deflated(_t(h), _s(lam), _t(v), _t(b), tol=1e-12,
                            device="cpu")
    x_j = jax.jit(lambda a, s_, w_, r: jx.solve_deflated(
        jx.DenseOperator(a), s_, w_, r, tol=1e-12))(
        jnp.asarray(h), jnp.float64(lam), jnp.asarray(v), jnp.asarray(b))
    assert _err(x, x_j) <= 1e-9
    pb = b - v * np.vdot(v, b)
    assert np.linalg.norm(h @ x.numpy() - lam * x.numpy() - pb) < 1e-8
    assert abs(np.vdot(v, x.numpy())) < 1e-10


@pytest.mark.parametrize("which", ["single", "multi"])
def test_complex_phase_sensitive_eigenvector_gradients(which):
    """Re/Im of single eigenvector components: without the pivot-phase
    projection these gradients are ~11% off (the JAX package's test).
    Reverse and forward mode against JAX's gradient (1e-8) and a central
    difference (2e-5)."""
    rng = np.random.default_rng(4)
    n = 24
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (h + h.conj().T) / 2 + np.diag(np.arange(1.0, n + 1))
    p = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    p = (p + p.conj().T) / 2

    def make(pkg, a, p):
        if which == "single":
            def f(t):
                if pkg is jx:
                    v = jx.dominant_eigh(jx.DenseOperator(a + t * p), k=n,
                                         tol=1e-12)[1]
                else:
                    v = port.dominant_eigh(a + t * p, k=n, tol=1e-12,
                                           device="cpu")[1]
                return v[5].imag + v[3].real
            return f

        def f(t):
            if pkg is jx:
                v = jx.dominant_eigh_multi(jx.DenseOperator(a + t * p), r=2,
                                           k=n, tol=1e-12)[1]
            else:
                v = port.dominant_eigh_multi(a + t * p, r=2, k=n, tol=1e-12,
                                             device="cpu")[1]
            return v[5, 0].imag + v[7, 1].real
        return f

    f = make(port, _t(a), _t(p))
    g, jv = _grad_and_jvp(f)
    g_j = jax.jit(jax.grad(make(jx, jnp.asarray(a), jnp.asarray(p))))(
        jnp.float64(0.0))
    assert abs(g - float(g_j)) <= 1e-8 * abs(float(g_j))
    assert abs(jv - g) <= 1e-8 * abs(g)
    assert abs(g - _fd(f, eps=1e-5)) <= 2e-5 * abs(g)


def test_power_iteration_complex_pivot_gauge():
    """``power_iteration`` gauges with conj(sgn(pivot)): the pivot entry
    real and positive, the pair JAX's from the same start."""
    n = 24
    h = _herm(n, 21) + np.diag(np.arange(1.0, n + 1))
    v0 = _cvec(n, 22)
    lam, v = port.power_iteration(_t(h), num_iters=800, v0=_t(v0),
                                  device="cpu")
    lam_j, v_j = jax.jit(lambda a, q: jx.power_iteration(
        jx.DenseOperator(a), num_iters=800, v0=q))(jnp.asarray(h),
                                                   jnp.asarray(v0))
    assert abs(complex(lam) - complex(lam_j)) <= 1e-10 * abs(complex(lam_j))
    assert abs(float(lam.real) - np.linalg.eigvalsh(h)[-1]) <= 1e-8 * n
    assert _err(v, v_j) <= 1e-9
    pivot = complex(v[torch.argmax(v.abs())])
    assert abs(pivot.imag) < 1e-12 and pivot.real > 0


# -- observables on a complex pencil (tests/test_observables.py:67-110) ------

def _pencil(n, seed):
    return _herm(n, seed) + np.diag(np.arange(1.0, n + 1)), _herm(n, seed + 1)


def _sum_over_states(h0, h1, g):
    evals, evecs = np.linalg.eigh(h0 + g * h1)
    v0 = evecs[:, 0]
    me = evecs[:, 1:].conj().T @ (h1 @ v0)
    gaps = evals[0] - evals[1:]
    return (evals[0], np.real(v0.conj() @ (h1 @ v0)),
            2.0 * np.sum(np.abs(me) ** 2 / gaps),
            np.sum(np.abs(me) ** 2 / gaps ** 2))


@pytest.mark.parametrize("kind", ["dense", "matrix_free"])
def test_fidelity_susceptibility_complex_gauge(kind):
    """χ_F = <∂ψ|∂ψ> - |<ψ|∂ψ>|² on a complex pencil: <∂ψ|∂ψ> alone is
    ~1.7% off here (the JAX package's finding).  Against JAX and the sum
    over states, to 1e-10."""
    n = 24
    h0, h1 = _pencil(n, 30)

    def make(pkg, h0, h1):
        if kind == "dense":
            if pkg is jx:
                return lambda g: jx.DenseOperator(h0 + g * h1)
            return lambda g: port.DenseOperator(h0 + g * h1)
        if pkg is jx:
            return lambda g: jx.MatrixFreeOperator(
                lambda gg, x: h0 @ x + gg * (h1 @ x), g, dim=n,
                dtype=h0.dtype)
        return lambda g: port.MatrixFreeOperator(
            lambda gg, x: h0 @ x + gg * (h1 @ x), g, dim=n, dtype=C128)

    chi = port.fidelity_susceptibility(make(port, _t(h0), _t(h1)), 0.37,
                                       k=n, tol=1e-13, device="cpu")
    chi_j = jax.jit(lambda a, b, g: jx.fidelity_susceptibility(
        make(jx, a, b), g, k=n, tol=1e-13))(
        jnp.asarray(h0), jnp.asarray(h1), jnp.float64(0.37))
    chi_x = _sum_over_states(h0, h1, 0.37)[3]
    assert abs(float(chi) - float(chi_j)) <= 1e-10 * chi_x
    assert abs(float(chi) - chi_x) <= 1e-10 * chi_x


def test_energy_curvature_complex():
    """E, dE/dg and d²E/dg² on the complex pencil against JAX's (nested
    forward mode there, reverse over reverse here) and the sum over
    states."""
    n = 24
    h0, h1 = _pencil(n, 50)
    got = port.energy_curvature(
        lambda g: port.DenseOperator(_t(h0) + g * _t(h1)), 0.23, k=n,
        tol=1e-13, device="cpu")
    want = jax.jit(lambda a, b, g: jx.energy_curvature(
        lambda t: jx.DenseOperator(a + t * b), g, k=n, tol=1e-13))(
        jnp.asarray(h0), jnp.asarray(h1), jnp.float64(0.23))
    exact = _sum_over_states(h0, h1, 0.23)[:3]
    for g_, w_, x_, tol in zip(got, want, exact, (1e-12, 1e-10, 1e-8)):
        assert abs(float(g_) - float(w_)) <= tol * abs(x_)
        assert abs(float(g_) - x_) <= tol * abs(x_)


# -- the complex fuzz cases (tests/test_fuzz.py:32, :248) --------------------

FUZZ_N = 16


@pytest.fixture(scope="module")
def fuzz_reference():
    """JAX's extremal values, first directional derivative (jvp) and
    second (jvp of jvp) on Hermitian rays, jitted once for all seeds."""
    def lam(a, extreme):
        return jx.dominant_eigh(a, k=FUZZ_N, extreme=extreme)[0]

    def run(a, da):
        def along(t):
            return lam(a + t * da, "min")

        def d1(t):
            return jax.jvp(along, (t,), (jnp.ones_like(t),))

        (_, g1), (_, g2) = jax.jvp(d1, (jnp.float64(0.0),),
                                   (jnp.float64(1.0),))
        return lam(a, "min"), lam(a, "max"), g1, g2
    return jax.jit(run)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_complex_values_and_derivatives(seed, fuzz_reference):
    """A random complex Hermitian corpus: λmin and λmax against numpy and
    JAX, dλmin along a random Hermitian direction by forward and reverse
    mode, and its second derivative (reverse over reverse here, a jvp of
    a jvp in JAX) against JAX and the sum over states."""
    rng = np.random.default_rng(1000 + seed)
    n = FUZZ_N

    def sym():
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return (a + a.conj().T) / 2

    a, da = sym(), sym()
    w, vec = np.linalg.eigh(a)
    lmin_j, lmax_j, d1_j, d2_j = fuzz_reference(jnp.asarray(a),
                                                jnp.asarray(da))
    lmin = port.dominant_eigh(_t(a), k=n, device="cpu")[0]
    lmax = port.dominant_eigh(_t(a), k=n, extreme="max", device="cpu")[0]
    for got, want, exact in ((lmin, lmin_j, w[0]), (lmax, lmax_j, w[-1])):
        assert abs(float(got) - float(want)) <= 1e-12 * abs(exact)
        assert abs(float(got) - exact) <= 1e-9 * abs(exact)
    assert w[1] - w[0] > 1e-2          # the seeds' gaps (checked)

    def along(t):
        return port.dominant_eigh(_t(a) + t * _t(da), k=n, device="cpu")[0]

    _, d1, d2 = port.value_d1_d2(along, 0.0, device="cpu")
    _, jv = _grad_and_jvp(along)
    me = vec[:, 1:].conj().T @ (da @ vec[:, 0])
    d1_x = float(np.real(vec[:, 0].conj() @ (da @ vec[:, 0])))
    d2_x = float(2.0 * np.sum(np.abs(me) ** 2 / (w[0] - w[1:])))
    assert abs(float(d1) - float(d1_j)) <= 1e-8 * abs(d1_x) + 1e-10
    assert abs(jv - float(d1)) <= 1e-10 * abs(d1_x) + 1e-12
    assert abs(float(d1) - d1_x) <= 1e-8 * abs(d1_x) + 1e-10
    assert abs(float(d2) - float(d2_j)) <= 1e-6 * abs(d2_x) + 1e-8
    assert abs(float(d2) - d2_x) <= 1e-6 * abs(d2_x) + 1e-8


# -- decompositions and the embedding ----------------------------------------

def test_svd_safe_complex_tangents():
    """The complex SVD rules carry Im<u_i, dA v_i> / σ_i, the relative
    phase of (u_i, v_i) (without it the tangent of a functional mixing u
    and v is O(||dA||) wrong): the reconstruction's tangent by forward
    and by reverse mode against JAX's jvp (1e-10) and a central
    difference (1e-6), for both rules (tests/test_ising2d.py:318)."""
    rng = np.random.default_rng(9)
    n = 8
    a0, da, probe = (rng.standard_normal((n, n))
                     + 1j * rng.standard_normal((n, n)) for _ in range(3))
    omega = np.array(jax.random.normal(jax.random.PRNGKey(0x5eed), (n, n),
                                       jnp.complex128))

    def recon(pkg, full):
        def f(t):
            if pkg is jd:
                out = (jd.svd_safe(a0 + t * da) if full else
                       jd.svd_safe_truncated(a0 + t * da, 4, 1e-12, n, 2))
                u, s, vt = out
                return jnp.real(jnp.sum(probe * (u @ jnp.diag(
                    s.astype(u.dtype)) @ vt)))
            x = _t(a0) + t * _t(da)
            u, s, vt = (port.svd_safe(x, device="cpu") if full else
                        port.svd_safe_truncated(x, 4, 1e-12, n, 2,
                                                omega=omega, device="cpu"))
            return ((u * s.to(u.dtype)[None, :]) @ vt * _t(probe)).sum().real
        return f

    want = jax.jit(lambda t: [jax.jvp(recon(jd, full), (t,), (1.0,))[1]
                              for full in (True, False)])(0.0)
    for full, want in zip((True, False), want):
        f = recon(port, full)
        g, jv = _grad_and_jvp(f)
        assert abs(jv - float(want)) <= 1e-10 * abs(float(want))
        assert abs(g - jv) <= 1e-10 * abs(jv)
        assert abs(g - _fd(f, eps=1e-7)) <= 1e-6 * abs(g)


def test_complex_basis_dtype_guards():
    """A complex basis cannot be narrowed (no complex bfloat16), and the
    operator's own dtype is a no-op (tests/test_eigh.py:288-294)."""
    cop = torch.eye(8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="real"):
        port.lanczos(cop, 4, basis_dtype=torch.bfloat16, device="cpu")
    res = port.lanczos(cop, 4, basis_dtype=torch.complex64, device="cpu")
    assert res.basis.dtype == torch.complex64
    assert res.alphas.dtype == torch.float32


def test_dense_operator_from_numpy_complex_round_trip():
    """A JAX complex DenseOperator's array crosses as the same complex
    dtype, bit for bit, and both operators apply it alike."""
    for dtype in (np.complex64, np.complex128):
        a = _cnonsym(12, 23).astype(dtype)
        j_op = jx.DenseOperator(jnp.asarray(a))
        op = port.dense_operator_from_numpy(np.asarray(j_op.a), device="cpu")
        assert op.dtype == (torch.complex64 if dtype == np.complex64
                            else C128)
        np.testing.assert_array_equal(op.a.numpy(), np.asarray(j_op.a))
        x = _cvec(12, 24).astype(dtype)
        tol = 1e-5 if dtype == np.complex64 else 1e-13
        assert _err(op.matvec(_t(x)), j_op.matvec(jnp.asarray(x))) <= tol
        assert _err(op.rmatvec(_t(x)), j_op.rmatvec(jnp.asarray(x))) <= tol


# -- gradcheck in complex128 -------------------------------------------------

def test_gradcheck_dominant_eigh_complex128():
    """PyTorch's own check of the Wirtinger convention: first and second
    derivatives of (λ, v) of a complex Hermitian matrix (taken as
    (A + Aᴴ)/2), v in the pivot gauge."""
    n = 4
    h = _herm(n, 3) + np.diag(np.arange(n) * 1.0)

    def f(a):
        lam, v = port.dominant_eigh((a + a.mH) / 2, k=n, tol=1e-13,
                                    device="cpu")
        return lam, v

    a = _t(h).requires_grad_(True)
    assert gradcheck(f, (a,), fast_mode=True)
    assert gradgradcheck(f, (a,), fast_mode=True)


def test_gradcheck_solve_deflated_complex128():
    """The deflated solve of a complex Hermitian system, differentiated
    in the matrix, the right-hand side and λ (first and second order)."""
    n = 4
    h = _herm(n, 13) + np.diag(np.arange(n) * 1.0)
    ev, evec = np.linalg.eigh(h)

    def f(a, b, lam):
        return port.solve_deflated((a + a.mH) / 2, lam, _t(evec[:, 0]), b,
                                   tol=1e-13, device="cpu")

    args = (_t(h).requires_grad_(True), _t(_cvec(n, 14)).requires_grad_(True),
            _s(ev[0]).requires_grad_(True))
    assert gradcheck(f, args, fast_mode=True)
    assert gradgradcheck(f, args, fast_mode=True)


# -- complex non-symmetric operators -----------------------------------------

def test_complex_nonsymmetric_dominant_eig():
    """``dominant_eig`` on a complex non-symmetric matrix: the complex
    dominant triple equals JAX's and numpy's, with the BILINEAR l^T r = 1
    (a conjugating pairing would change λ and every tangent)."""
    n = 24
    a0 = _cnonsym(n, 20)
    lam, l, r = port.dominant_eig(_t(a0), num_iters=1000, power_tol=1e-12,
                                  device="cpu")
    want = jax.jit(lambda a: jx.dominant_eig(a, num_iters=1000,
                                             power_tol=1e-12))(
        jnp.asarray(a0))
    for got, w_ in zip((lam, l, r), want):
        assert _err(got, w_) <= 1e-9
    w = np.linalg.eigvals(a0)
    assert abs(complex(lam) - w[np.argmax(np.abs(w))]) <= 1e-9 * 3
    assert abs(complex((l * r).sum()) - 1.0) <= 1e-12
    assert np.linalg.norm(a0 @ r.numpy() - complex(lam) * r.numpy()) < 1e-8
    assert np.linalg.norm(a0.T @ l.numpy() - complex(lam) * l.numpy()) < 1e-7


@pytest.fixture(scope="module")
def nonsym_reference():
    """JAX's gradients and tangents (BiCGStab) of |λ|² and of |<w, r>|² +
    |<w, l>|² along a complex direction, jitted once."""
    n = 20
    rng = np.random.default_rng(21)
    a0 = _cnonsym(n, 21)
    a1 = 0.5 * (rng.standard_normal((n, n))
                + 1j * rng.standard_normal((n, n)))
    wv = _cvec(n, 25)

    def fs(t):
        lam, l, v = jx.dominant_eig(jnp.asarray(a0) + t * jnp.asarray(a1),
                                    num_iters=1000, power_tol=1e-12)
        wj = jnp.asarray(wv)
        return jnp.stack([jnp.abs(lam) ** 2,
                          jnp.abs(jnp.sum(wj * v)) ** 2
                          + jnp.abs(jnp.sum(wj * l)) ** 2])

    jac = jax.jit(jax.jacrev(fs))(jnp.float64(0.0))
    _, tan = jax.jit(lambda t: jax.jvp(fs, (t,), (jnp.float64(1.0),)))(
        jnp.float64(0.0))
    return a0, a1, wv, np.asarray(jac), np.asarray(tan)


@pytest.mark.parametrize("solver", ["bicgstab", "gmres", "cgnr"])
@pytest.mark.parametrize("which", ["lam", "vec"])
def test_complex_nonsymmetric_grads(solver, which, nonsym_reference):
    """Reverse and forward mode of ``dominant_eig`` on a complex
    non-symmetric matrix, each tangent solver, against JAX's BiCGStab
    derivatives (1e-8; CGNR, at κ², 1e-6) and a central difference
    (2e-5).  Reverse mode runs the conjugated transposed bordered system;
    CGNR needs the adjoint AᴴA."""
    a0, a1, wv, jac, tan = nonsym_reference
    i = 0 if which == "lam" else 1

    def f(t):
        lam, l, v = port.dominant_eig(_t(a0) + t * _t(a1), num_iters=1000,
                                      power_tol=1e-12, solver=solver,
                                      device="cpu")
        if which == "lam":
            return lam.abs() ** 2
        return ((_t(wv) * v).sum().abs() ** 2
                + (_t(wv) * l).sum().abs() ** 2)

    g, jv = _grad_and_jvp(f)
    tol = 1e-6 if solver == "cgnr" else 1e-8
    assert abs(g - jac[i]) <= tol * abs(jac[i])
    assert abs(jv - tan[i]) <= tol * abs(tan[i])
    assert abs(g - _fd(f)) <= 2e-5 * abs(g)


@pytest.mark.parametrize("method", ["bicgstab", "gmres", "cgnr"])
def test_gradcheck_solve_general_complex128(method):
    """``solve_general`` on a complex non-symmetric matrix, differentiated
    in the matrix and the right-hand side: its backward is the transposed
    solve between two conjugations (first and second order)."""
    a = _t(_cnonsym(4, 27)).requires_grad_(True)
    b = _t(_cvec(4, 28)).requires_grad_(True)

    def f(m, r):
        return port.solve_general(m, r, tol=1e-13, method=method,
                                  device="cpu")

    assert gradcheck(f, (a, b), fast_mode=True)
    assert gradgradcheck(f, (a, b), fast_mode=True)


def test_gradcheck_dominant_eig_complex128():
    """First and second derivatives of (λ, l, r) of a complex
    non-symmetric matrix (GMRES tangent solves; BiCGStab and CGNR are
    held against JAX above)."""
    n = 4
    a = _t(_cnonsym(n, 26)).requires_grad_(True)

    def f(x):
        return port.dominant_eig(x, method="arnoldi", power_tol=1e-15,
                                 tol=1e-13, solver="gmres", device="cpu")

    assert gradcheck(f, (a,), fast_mode=True)
    assert gradgradcheck(f, (a,), fast_mode=True)


# -- every entry point that used to refuse complex input ----------------------

ENTRY_N = 16


def _inputs():
    """The entry points' inputs, numpy arrays only (JAX's calls are
    jitted with them as arguments)."""
    n = ENTRY_N
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(n, n, dtype=C128, generator=gen)
    h = ((a + a.conj().T) / 2).numpy()
    ev, evec = np.linalg.eigh(h)
    rng = np.random.default_rng(27)
    s = rng.standard_normal((n, n))
    s = (s + s.T) / 2 + n * np.eye(n)
    return {"h": h, "spd": h @ h.conj().T + n * np.eye(n),
            "b": _cvec(n, 28), "x": _cvec(n, 29),
            "X": _cvec(2 * n, 30).reshape(n, 2), "lam": ev[0],
            "v": evec[:, 0], "real_spd": s, "c": _cnonsym(n, 31),
            "c2": _cnonsym(n, 32, second=-2.0 + 0.5j),
            "real_ns": np.random.default_rng(33).uniform(size=(n, n)) + 0.1,
            "rect": _cnonsym(n, 34)[:, :10]}


def _mf(pkg, a):
    """A complex non-symmetric matrix-free operator with its transpose."""
    n = a.shape[0]
    return pkg.MatrixFreeOperator(lambda p, x: p @ x, a, dim=n,
                                  dtype=a.dtype, rmatvec_fn=lambda p, x:
                                  p.T @ x, symmetric=False)


def _pencil_tangent(pkg, h, x):
    """(dA/dg) x of the pencil h + g h at g = 0.5 (a MatrixFreeOperator's
    tangent product)."""
    n = h.shape[0]
    if pkg is jx:
        op = jx.MatrixFreeOperator(lambda g, y: h @ y + g * (h @ y),
                                   jnp.float64(0.5), dim=n, dtype=h.dtype)
        return jax.jvp(lambda o: o.matvec(x), (op,),
                       (jax.tree_util.tree_map(jnp.ones_like, op),))[1]
    op = port.MatrixFreeOperator(lambda g, y: h @ y + g * (h @ y), _s(0.5),
                                 dim=n, dtype=C128)
    return op.tangent_matvec(x, [_s(1.0)])


def _svd_pairs(out):
    u, s, v = out
    return [s, u[:, None, :] * v.conj()[None, :, :]]


def _eigh_projectors(out):
    w, v = out
    return [w, v[:, None, :] * v.conj()[None, :, :]]


def _usv_pairs(out):
    u, s, vt = out
    return [s, u[:, None, :] * vt.T[None, :, :]]


def _entry_points():
    """name -> (port call, JAX call, tolerance): each takes the inputs of
    :func:`_inputs` (numpy) and returns a list of arrays to compare."""
    def solve_kw(pkg):
        return {} if pkg is jx else {"device": "cpu"}

    def omega(n, k):
        return np.array(jax.random.normal(jax.random.PRNGKey(0x5eed), (n, k),
                                          jnp.complex128))

    def both(fn):
        """One function of (pkg, wrap) for both packages."""
        return (lambda d: fn(port, _t, d), lambda d: fn(jx, jnp.asarray, d))

    cases = {
        "as_operator": (both(lambda pkg, w, d: [
            pkg.as_operator(w(d["h"])).matvec(w(d["x"])),
            pkg.as_operator(w(d["c"])).rmatvec(w(d["x"]))]), 1e-14),
        "as_operator of an operator": (both(lambda pkg, w, d: [
            pkg.as_operator(_mf(pkg, w(d["c"]))).rmatmat(w(d["X"]))]),
            1e-14),
        "DenseOperator": (both(lambda pkg, w, d: [
            pkg.DenseOperator(w(d["c"])).matmat(w(d["X"])),
            pkg.DenseOperator(w(d["c"])).rmatmat(w(d["X"]))]), 1e-14),
        "MatrixFreeOperator": (both(lambda pkg, w, d: [
            _mf(pkg, w(d["c"])).rmatvec(w(d["x"])),
            _pencil_tangent(pkg, w(d["h"]), w(d["x"]))]), 1e-14),
        "dominant_eigh": (both(lambda pkg, w, d: list(pkg.dominant_eigh(
            w(d["h"]), k=ENTRY_N, **solve_kw(pkg)))), 1e-9),
        "dominant_eigh_multi": (both(lambda pkg, w, d: _eigh_projectors(
            pkg.dominant_eigh_multi(w(d["h"]), r=3, k=ENTRY_N,
                                    **solve_kw(pkg)))), 1e-9),
        "lanczos": (both(lambda pkg, w, d: list(pkg.lanczos(
            w(d["h"]), 6, v0=w(d["x"]), **solve_kw(pkg)))), 1e-12),
        "cg": (both(lambda pkg, w, d: [pkg.cg(
            lambda y: w(d["spd"]) @ y, w(d["b"]), tol=1e-12,
            **solve_kw(pkg))]), 1e-9),
        "solve_deflated": (both(lambda pkg, w, d: [pkg.solve_deflated(
            pkg.DenseOperator(w(d["h"])), w(d["lam"]),
            w(d["v"]), w(d["b"]), tol=1e-12, **solve_kw(pkg))]), 1e-9),
        "solve_deflated complex b": (both(lambda pkg, w, d: [
            pkg.solve_deflated(pkg.DenseOperator(w(d["real_spd"])),
                               w(np.float64(0.0)),
                               w(np.eye(ENTRY_N)[:, 0]), w(d["b"]),
                               tol=1e-12, **solve_kw(pkg))]), 1e-9),
        "eigh_safe": (both(lambda pkg, w, d: _eigh_projectors(
            (pkg if pkg is port else jd).eigh_safe(
                w(d["h"]), **solve_kw(pkg)))), 1e-10),
        "eigh_safe_truncated": (both(lambda pkg, w, d: _eigh_projectors(
            (pkg if pkg is port else jd).eigh_safe_truncated(
                w(d["h"]), 3, **solve_kw(pkg)))), 1e-10),
        "svd_safe": (both(lambda pkg, w, d: _usv_pairs(
            (pkg if pkg is port else jd).svd_safe(
                w(d["c"]), **solve_kw(pkg)))), 1e-10),
        "svd_safe_truncated": (both(lambda pkg, w, d: _usv_pairs(
            port.svd_safe_truncated(w(d["c"]), 3, omega=omega(ENTRY_N,
                                                              ENTRY_N),
                                    device="cpu") if pkg is port else
            jd.svd_safe_truncated(w(d["c"]), 3))), 1e-10),
        "dominant_svd": (both(lambda pkg, w, d: _svd_pairs(
            pkg.dominant_svd(w(d["c"]), r=3, k=2 * ENTRY_N, tol=1e-12,
                             **solve_kw(pkg)))), 1e-8),
        "dominant_svd rectangular": (both(lambda pkg, w, d: _svd_pairs(
            pkg.dominant_svd(w(d["rect"]), r=3, k=26, tol=1e-12,
                             **solve_kw(pkg)))), 1e-8),
        "dominant_eig": (both(lambda pkg, w, d: list(pkg.dominant_eig(
            w(d["c"]), method="arnoldi", **solve_kw(pkg)))), 1e-9),
        "dominant_eig_multi": (both(lambda pkg, w, d: list(
            pkg.dominant_eig_multi(w(d["c2"]), m=2, num_iters=2000,
                                   **solve_kw(pkg)))), 1e-8),
        "solve_general": (both(lambda pkg, w, d: [pkg.solve_general(
            w(d["c"]), w(d["b"]), tol=1e-12, **solve_kw(pkg))
            if pkg is port else pkg.solve_general(
                lambda y: w(d["c"]) @ y, lambda y: w(d["c"]).T @ y,
                w(d["b"]), tol=1e-12)]), 1e-9),
        "solve_general complex b": (both(lambda pkg, w, d: [
            pkg.solve_general(w(d["real_ns"]), w(d["b"]), tol=1e-12,
                              method="gmres", **solve_kw(pkg))
            if pkg is port else pkg.solve_general(
                lambda y: w(d["real_ns"]) @ y,
                lambda y: w(d["real_ns"]).T @ y, w(d["b"]), tol=1e-12,
                method="gmres")]), 1e-9),
        "bicgstab": (both(lambda pkg, w, d: [pkg.bicgstab(
            lambda y: w(d["c"]) @ y, w(d["b"]), tol=1e-12,
            **solve_kw(pkg))]), 1e-9),
        "gmres": (both(lambda pkg, w, d: [pkg.gmres(
            lambda y: w(d["c"]) @ y, w(d["b"]), tol=1e-12,
            **solve_kw(pkg))]), 1e-9),
    }
    return cases


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_complex_input_matches_jax(name):
    """Each entry point that refused complex input before this slice,
    on complex input, against the JAX package's same call: operator
    products exactly (1e-14), iterative solves to 1e-9 (their tolerance
    is 1e-12), eigenpairs through their gauge (pivot phase) or their
    projectors."""
    (port_call, jax_call), tol = _entry_points()[name]
    d = _inputs()
    got = port_call(d)
    want = jax.jit(jax_call)(d)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_complex() or not np.iscomplexobj(np.asarray(w)), name
        assert _err(g, w) <= tol, name
