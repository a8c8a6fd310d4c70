"""Forward mode to any order in the port: ``torch.func.jvp`` nested in
``torch.func.jvp``, ``torch.func.hessian`` and ``grad∘jacfwd`` through
the port's IFT rules and solves, against the JAX package's ``jax.jvp``
of a ``jax.jvp``, ``jax.hessian`` and ``jax.grad∘jax.jacfwd`` on the same
inputs (CPU, f64), and against the closed-form oracles (sum over states,
dense ED).  After ``tests/test_fuzz.py:250-265``,
``tests/test_eig.py:585-597``, ``tests/test_eigh.py:121``,
``tests/test_ising2d.py:312`` and ``tests/test_observables.py``.

Every JAX reference is jitted once (module-scoped fixtures) and JAX's
caches are cleared when the module is done.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dominantsparseeigenad_tpu as jx
from dominantsparseeigenad_tpu import models as jm

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

# The modules, not the functions of the same names that ops exports.
jcg = importlib.import_module("dominantsparseeigenad_tpu.ops.cg")
port_cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")

torch.set_num_threads(2)

F64 = torch.float64
N = 24            # dense cases
TOL = 1e-13       # every solve's relative tolerance


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _herm(n, seed, complex_):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, n))
    if complex_:
        b = b + 1j * rng.standard_normal((n, n))
    return (b + b.conj().T) / 2


def _positive(n, seed):
    """A Perron matrix (simple, real, positive dominant eigenvalue)."""
    return np.random.default_rng(seed).uniform(size=(n, n)) + 0.1


def _d1_d2(f):
    """The port's (f(0), f'(0), f''(0)) by ``value_d1_d2``: a
    ``torch.func.jvp`` of a ``torch.func.jvp``."""
    return port.value_d1_d2(f, torch.zeros((), dtype=F64), device="cpu")


def _jax_d1_d2(f):
    """JAX's ``jax.jvp`` of a ``jax.jvp`` at t = 0, jitted."""
    def g(t):
        return jax.jvp(f, (t,), (jnp.ones_like(t),))

    @jax.jit
    def run(t):
        (val, d1), (_, d2) = jax.jvp(g, (t,), (jnp.ones_like(t),))
        return val, d1, d2

    return [float(x) for x in run(jnp.float64(0.0))]


# -- dominant_eigh: real and complex Hermitian ------------------------------

@pytest.fixture(scope="module")
def eigh_refs():
    """JAX's (λ, d1, d2) along a Hermitian ray, for each case."""
    out = {}
    for complex_ in (False, True):
        for seed in (0, 1):
            a, da = (_herm(N, 6000 + seed, complex_),
                     _herm(N, 6100 + seed, complex_))
            out[complex_, seed] = (a, da, _jax_d1_d2(
                lambda t, a=a, da=da: jx.dominant_eigh(
                    jx.DenseOperator(jnp.asarray(a) + t * jnp.asarray(da)),
                    k=N, extreme="min", tol=TOL)[0]))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_nested_jvp_dominant_eigh(eigh_refs, complex_, seed):
    """d/dt and d²/dt² of the extremal eigenvalue along a Hermitian ray
    by forward over forward: JAX's jvp of a jvp within 1e-9, the
    sum-over-states oracle within 1e-8."""
    a, da, want = eigh_refs[complex_, seed]
    at, dat = torch.from_numpy(a), torch.from_numpy(da)
    got = _d1_d2(lambda t: port.dominant_eigh(
        at + t * dat, k=N, extreme="min", tol=TOL, device="cpu")[0])
    w, vec = np.linalg.eigh(a)
    m = vec.conj().T @ da @ vec
    oracle = (w[0], m[0, 0].real,
              2.0 * np.sum(np.abs(m[1:, 0]) ** 2 / (w[0] - w[1:])))
    for g, j, o in zip(got, want, oracle):
        assert abs(float(g) - j) <= 1e-9 * max(abs(j), 1.0)
        assert abs(float(g) - o) <= 1e-8 * max(abs(o), 1.0)


@pytest.mark.parametrize("method", ["lanczos", "lobpcg"])
def test_nested_jvp_dominant_eigh_multi(method):
    """d/dt, d²/dt² of Σλ over the 3 lowest pairs by forward over
    forward, against JAX's jvp of a jvp (1e-8) and the block
    sum-over-states oracle (1e-7)."""
    r = 3
    a, da = _herm(N, 11, False), _herm(N, 12, False)
    kw = dict(r=r, k=N if method == "lanczos" else 300, tol=TOL,
              method=method)
    want = _jax_d1_d2(lambda t: jnp.sum(jx.dominant_eigh_multi(
        jx.DenseOperator(jnp.asarray(a) + t * jnp.asarray(da)), **kw)[0]))
    at, dat = torch.from_numpy(a), torch.from_numpy(da)
    got = _d1_d2(lambda t: port.dominant_eigh_multi(
        at + t * dat, device="cpu", **kw)[0].sum())
    w, vec = np.linalg.eigh(a)
    m = vec.T @ da @ vec
    d2 = sum(2.0 * np.sum(m[r:, i] ** 2 / (w[i] - w[r:])) for i in range(r))
    oracle = (w[:r].sum(), np.trace(m[:r, :r]), d2)
    for g, j, o in zip(got, want, oracle):
        assert abs(float(g) - j) <= 1e-8 * max(abs(j), 1.0)
        assert abs(float(g) - o) <= 1e-7 * max(abs(o), 1.0)


@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
def test_nested_jvp_dominant_eig(solver):
    """The non-symmetric solver's dominant λ along a ray, forward over
    forward, against JAX's jvp of a jvp (1e-8) and the dense
    eigenvalue's central differences (1e-5)."""
    n = 20
    a, da = _positive(n, 21), 0.1 * _positive(n, 22)
    kw = dict(num_iters=800, tol=TOL, power_tol=1e-14, solver=solver)
    want = _jax_d1_d2(lambda t: jx.dominant_eig(
        jx.DenseOperator(jnp.asarray(a) + t * jnp.asarray(da)), **kw)[0])
    at, dat = torch.from_numpy(a), torch.from_numpy(da)
    got = _d1_d2(lambda t: port.dominant_eig(at + t * dat, device="cpu",
                                             **kw)[0])
    for g, j in zip(got, want):
        assert abs(float(g) - j) <= 1e-8 * max(abs(j), 1.0)

    def lam(t):
        return np.max(np.linalg.eigvals(a + t * da).real)

    h = 1e-3
    fd2 = (lam(h) - 2 * lam(0.0) + lam(-h)) / h ** 2
    assert abs(float(got[2]) - fd2) <= 1e-5 * max(abs(fd2), 1.0)


# -- observables on the TFIM --------------------------------------------------

@pytest.mark.parametrize("g", [0.7, 1.2])
def test_energy_curvature_tfim_matches_jax_and_ed(g):
    """``energy_curvature`` (forward over forward) on TFIM N = 8 against
    the JAX package's (1e-9) and the dense ED oracle (1e-8); and
    ``value_d1_d2`` of the Jordan-Wigner closed form against its
    derivatives (1e-10)."""
    n = 8
    kw = dict(k=1 << n, tol=TOL)
    got = port.energy_curvature(
        lambda gg: models.tfim_operator(n, gg, device="cpu"), g,
        device="cpu", **kw)
    want = jax.jit(lambda gg: jx.energy_curvature(
        lambda x: jm.tfim_operator(n, x), gg, **kw))(jnp.float64(g))
    ed = models.tfim_ed_observables(n, g, device="cpu")[:3]
    for a, b, c in zip(got, want, ed):
        assert abs(float(a) - float(b)) <= 1e-9 * max(abs(float(b)), 1.0)
        assert abs(float(a) - float(c)) <= 1e-8 * max(abs(float(c)), 1.0)
    jw = port.value_d1_d2(lambda x: models.tfim_exact_e0(n, x, device="cpu"),
                          g, device="cpu")
    exact = (float(models.tfim_exact_e0(n, g, device="cpu")),
             models.tfim_exact_de0_dg(n, g), models.tfim_exact_d2e0_dg2(n, g))
    assert _rel([float(t) for t in jw], exact) <= 1e-10


def test_fidelity_susceptibility_nests_in_a_jvp():
    """χ_F is one ``torch.func.jvp``, so it nests: its own derivative in
    g by an outer jvp against central differences of χ_F (1e-5), and χ_F
    against ED (1e-8)."""
    n, g = 6, 0.9

    def chi(gg):
        return port.fidelity_susceptibility(
            lambda x: models.tfim_operator(n, x, device="cpu"), gg,
            k=1 << n, tol=TOL, device="cpu")

    gt = torch.tensor(g, dtype=F64)
    val, dchi = torch.func.jvp(chi, (gt,), (torch.ones_like(gt),))
    ed = float(models.tfim_ed_observables(n, g, device="cpu")[3])
    assert abs(float(val) - ed) <= 1e-8 * ed
    h = 1e-4
    fd = (float(chi(g + h)) - float(chi(g - h))) / (2 * h)
    assert abs(float(dchi) - fd) <= 1e-5 * abs(fd)


# -- hessian and grad∘jacfwd --------------------------------------------------

def test_hessian_matches_jax():
    """``torch.func.hessian`` of λ_min of A0 + θ0 B0 + θ1 B1 (a
    matrix-free operator) against ``jax.hessian`` (1e-9), second-order
    perturbation theory (1e-8), and the same Hessian by forward over
    reverse and reverse over reverse (1e-10)."""
    n = 20
    a0, b0, b1 = (_herm(n, s, False) for s in (81, 82, 83))
    theta = np.array([0.3, -0.2])

    def jax_lam(th):
        op = jx.MatrixFreeOperator(
            lambda p, x: (jnp.asarray(a0) @ x + p[0] * (jnp.asarray(b0) @ x)
                          + p[1] * (jnp.asarray(b1) @ x)), th, dim=n,
            dtype=jnp.float64)
        return jx.dominant_eigh(op, k=n, extreme="min", tol=TOL)[0]

    want = np.asarray(jax.jit(jax.hessian(jax_lam))(jnp.asarray(theta)))
    ta0, tb0, tb1 = (torch.from_numpy(m) for m in (a0, b0, b1))

    def lam(th):
        op = port.MatrixFreeOperator(
            lambda p, x: ta0 @ x + p[0] * (tb0 @ x) + p[1] * (tb1 @ x), th,
            dim=n, dtype=F64)
        return port.dominant_eigh(op, k=n, extreme="min", tol=TOL,
                                  device="cpu")[0]

    th = torch.from_numpy(theta)
    got = torch.func.hessian(lam)(th).numpy()
    assert _rel(got, want) <= 1e-9
    w, vec = np.linalg.eigh(a0 + theta[0] * b0 + theta[1] * b1)
    ms = [vec.T @ b @ vec for b in (b0, b1)]
    oracle = np.array([[2.0 * np.sum(mi[1:, 0] * mj[1:, 0] / (w[0] - w[1:]))
                        for mj in ms] for mi in ms])
    assert _rel(got, oracle) <= 1e-8
    for other in (torch.func.jacfwd(torch.func.jacrev(lam)),
                  torch.func.jacrev(torch.func.jacrev(lam))):
        assert _rel(other(th).numpy(), got) <= 1e-10


def test_grad_jacfwd_through_trg_matches_jax():
    """``grad∘jacfwd`` of the TRG free energy at chi = 4 (the quantity of
    ``tests/test_ising2d.py:312``) against JAX's (1e-8), and against the
    port's reverse over reverse and forward over forward (1e-6, the JAX
    test's bar between its routes)."""
    beta, chi, steps = 0.44, 4, 6
    want = float(jax.jit(jax.grad(jax.jacfwd(
        lambda b: jm.trg_free_energy(b, chi=chi, n_steps=steps))))(
        jnp.float64(beta)))

    def f(b):
        return models.trg_free_energy(b, chi=chi, n_steps=steps,
                                      device="cpu")

    b = torch.tensor(beta, dtype=F64)
    got = float(torch.func.grad(torch.func.jacfwd(f))(b))
    assert abs(got - want) <= 1e-8 * abs(want)
    rev = float(torch.func.grad(torch.func.grad(f))(b))
    fwd = float(port.value_d1_d2(f, b, device="cpu")[2])
    assert abs(rev - got) <= 1e-6 * abs(got)
    assert abs(fwd - got) <= 1e-6 * abs(got)


# -- the solves' jvps ---------------------------------------------------------

def _solve_case(n=20, seed=31):
    rng = np.random.default_rng(seed)
    a, da = _herm(n, seed, False), _herm(n, seed + 1, False)
    w, vec = np.linalg.eigh(a)
    v = vec[:, 0]
    dv = rng.standard_normal(n)
    dv -= v * (v @ dv)
    return (a, da, w[0] - 0.5, 0.3, v, 0.1 * dv, rng.standard_normal(n),
            rng.standard_normal(n))


@pytest.mark.parametrize("method", ["cg", "minres"])
def test_deflated_solve_jvp_matches_jax(method):
    """``solve_deflated``'s forward mode, tangents in A, λ, V and b at
    once, first and second order, against ``jax.jvp`` (and its jvp) of
    the JAX package's solve (1e-9)."""
    a, da, lam, dlam, v, dv, b, db = _solve_case()

    def jax_x(t):
        return jcg.solve_deflated(
            jx.DenseOperator(jnp.asarray(a) + t * jnp.asarray(da)),
            lam + t * dlam, jnp.asarray(v) + t * jnp.asarray(dv),
            jnp.asarray(b) + t * jnp.asarray(db), tol=TOL, method=method)

    @jax.jit
    def jax_tangents(t):
        def first(s):
            return jax.jvp(jax_x, (s,), (jnp.ones_like(s),))
        (x, dx), (_, ddx) = jax.jvp(first, (t,), (jnp.ones_like(t),))
        return x, dx, ddx

    want = jax_tangents(jnp.float64(0.0))
    at, dat, vt, dvt, bt, dbt = (torch.from_numpy(x)
                                 for x in (a, da, v, dv, b, db))

    def x_of(t):
        return port.solve_deflated(at + t * dat, lam + t * dlam, vt + t * dvt,
                                   bt + t * dbt, tol=TOL, method=method,
                                   device="cpu")

    t = torch.zeros((), dtype=F64)
    one = torch.ones_like(t)
    (x, dx), (_, ddx) = torch.func.jvp(
        lambda s: torch.func.jvp(x_of, (s,), (one,)), (t,), (one,))
    for got, w in zip((x, dx, ddx), want):
        assert _rel(got.numpy(), w) <= 1e-9


@pytest.mark.parametrize("method", ["bicgstab", "gmres", "cgnr"])
def test_general_solve_jvp_matches_jax(method):
    """``solve_general``'s forward mode, tangents in A and b, first and
    second order, against ``jax.jvp`` (and its jvp) of the JAX package's
    solve (1e-9); and the bordered solve of the non-symmetric rule,
    tangents in λ, U and W too, against the dense bordered system's
    exact tangent (1e-9)."""
    n = 20
    rng = np.random.default_rng(41)
    a = 3.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    da, b, db = (rng.standard_normal(s) for s in ((n, n), n, n))

    def jax_x(t):
        m = jnp.asarray(a) + t * jnp.asarray(da)
        return jcg.solve_general(lambda x: m @ x, lambda x: m.T @ x,
                                 jnp.asarray(b) + t * jnp.asarray(db),
                                 tol=TOL, method=method)

    @jax.jit
    def jax_tangents(t):
        def first(s):
            return jax.jvp(jax_x, (s,), (jnp.ones_like(s),))
        (x, dx), (_, ddx) = jax.jvp(first, (t,), (jnp.ones_like(t),))
        return x, dx, ddx

    want = jax_tangents(jnp.float64(0.0))
    at, dat, bt, dbt = (torch.from_numpy(x) for x in (a, da, b, db))
    t = torch.zeros((), dtype=F64)
    one = torch.ones_like(t)

    def x_of(s):
        return port.solve_general(at + s * dat, bt + s * dbt, tol=TOL,
                                  method=method, device="cpu")

    (x, dx), (_, ddx) = torch.func.jvp(
        lambda s: torch.func.jvp(x_of, (s,), (one,)), (t,), (one,))
    for got, w in zip((x, dx, ddx), want):
        assert _rel(got.numpy(), w) <= 1e-9

    # The bordered system [[A - λ, u], [w^T, 0]] with every input moving.
    u, w, du, dw = (rng.standard_normal(n) for _ in range(4))
    lam, dlam = 0.7, -0.2
    rhs, drhs = rng.standard_normal(n + 1), rng.standard_normal(n + 1)

    tu, tw, tdu, tdw, trhs, tdrhs = (torch.from_numpy(x) for x in
                                     (u, w, du, dw, rhs, drhs))

    def bordered(s):
        op = port.DenseOperator(at + s * dat)
        return port_cg._GeneralSolve.apply(
            op, False, TOL, None, method, trhs + s * tdrhs,
            lam + s * dlam, (tu + s * tdu)[:, None], (tw + s * tdw)[:, None],
            *op.parameters())

    _, dz = torch.func.jvp(bordered, (t,), (one,))

    def dense(s):
        m = np.block([[a + s * da - (lam + s * dlam) * np.eye(n),
                       (u + s * du)[:, None]],
                      [(w + s * dw)[None, :], np.zeros((1, 1))]])
        return np.linalg.solve(m, rhs + s * drhs)

    mat = dense(0.0)
    big = np.block([[a - lam * np.eye(n), u[:, None]],
                    [w[None, :], np.zeros((1, 1))]])
    dbig = np.block([[da - dlam * np.eye(n), du[:, None]],
                     [dw[None, :], np.zeros((1, 1))]])
    exact = np.linalg.solve(big, drhs - dbig @ mat)
    assert _rel(dz.numpy(), exact) <= 1e-9
