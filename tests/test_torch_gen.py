"""The port's generalized pencil solver (``ops/gen.py``,
``lobpcg_eigh_general``) against the JAX package's (CPU, f64), after
``tests/test_gen.py``, the ``lobpcg_eigh_general`` half of
``tests/test_lobpcg.py:138-164`` and ``examples/vibrational_modes.py``;
and ``dominant_eigh_multi(reorth_chunks=...)``.

Both packages start LOBPCG from the same block: JAX draws it as
``normal(PRNGKey(seed), (n, r))``, and the port is handed that block as
``x0``.  Oracles besides JAX: ``scipy.linalg.eigh(a, b)`` and central
differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from torch.autograd import gradcheck, gradgradcheck

from dominantsparseeigenad_tpu.ops.eigh import (
    dominant_eigh_multi as jax_multi)
from dominantsparseeigenad_tpu.ops.gen import dominant_eigh_gen as jax_gen
from dominantsparseeigenad_tpu.ops.gen import (
    solve_deflated_pencil as jax_pencil_solve)
from dominantsparseeigenad_tpu.ops.lobpcg import (
    lobpcg_eigh_general as jax_lobpcg_general)
from dominantsparseeigenad_tpu.ops.operators import DenseOperator as JaxDense

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _pencil(n, seed=0, diag_scale=2.0, noise=0.3):
    rng = np.random.default_rng(seed)
    a = np.diag(np.arange(1.0, n + 1) * diag_scale)
    s = rng.standard_normal((n, n))
    a = a + noise * (s + s.T) / 2
    c = rng.standard_normal((n, n)) / np.sqrt(4 * n)
    b = c @ c.T + np.eye(n)
    return a, b


def _jax_x0(n, r, seed=0):
    """The start block JAX's LOBPCG draws for ``seed``."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), (n, r), jnp.float64)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- tests/test_gen.py --------------------------------------------------------

def test_forward_matches_scipy_min_and_max():
    n, r = 120, 3
    a, b = _pencil(n, seed=0)
    ew = scipy.linalg.eigh(a, b, eigvals_only=True)
    dinv = 1.0 / (np.diag(a) + 1.0)
    at, bt, dt = _t(a), _t(b), _t(dinv)
    x0 = _jax_x0(n, r)

    lams, v, info = port.lobpcg_eigh_general(
        at, bt, r, tol=1e-11, maxiter=300, precond=lambda R: dt[:, None] * R,
        x0=x0, with_info=True, device="cpu")
    lmax, vmax = port.lobpcg_eigh_general(at, bt, r, extreme="max",
                                          tol=1e-10, maxiter=500, x0=x0,
                                          device="cpu")
    assert float(info.converged) == 1.0
    np.testing.assert_allclose(lams.numpy(), ew[:r], rtol=1e-10)
    np.testing.assert_allclose(v.numpy().T @ b @ v.numpy(), np.eye(r),
                               atol=1e-10)
    np.testing.assert_allclose(lmax.numpy(), ew[::-1][:r], rtol=1e-8)

    @jax.jit
    def ref(am, bm, d):
        lo = jax_lobpcg_general(am, bm, r, tol=1e-11, maxiter=300,
                                precond=lambda R: d[:, None] * R,
                                with_info=True)
        hi = jax_lobpcg_general(am, bm, r, extreme="max", tol=1e-10,
                                maxiter=500)
        return lo, hi

    (lj, vj, ij), (lmj, vmj) = ref(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(dinv))
    np.testing.assert_allclose(lams.numpy(), np.asarray(lj), rtol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), atol=1e-10)
    assert float(info.iterations) == float(ij.iterations)
    np.testing.assert_allclose(lmax.numpy(), np.asarray(lmj), rtol=1e-10)
    np.testing.assert_allclose(vmax.numpy(), np.asarray(vmj), atol=1e-8)


def test_identity_b_matches_standard():
    n, r = 80, 3
    a, _ = _pencil(n, seed=1)
    at, x0 = _t(a), _jax_x0(n, r)
    l0, v0 = port.lobpcg_eigh(at, r, tol=1e-10, maxiter=250, x0=x0,
                              device="cpu")
    l1, v1 = port.lobpcg_eigh_general(at, torch.eye(n, dtype=F64), r,
                                      tol=1e-10, maxiter=250, x0=x0,
                                      device="cpu")
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-12)
    np.testing.assert_allclose(v1.numpy(), v0.numpy(), atol=1e-12)


def _weighted_loss(ls, vv, r):
    return (ls * torch.arange(1.0, r + 1.0, dtype=F64)).sum() \
        + (vv[0] ** 2).sum()


def test_gradients_both_operators_match_jax_and_fd():
    n, r = 100, 3
    a, b = _pencil(n, seed=1)
    dinv = 1.0 / (np.diag(a) + 2.0)
    dt = _t(dinv)
    x0 = _jax_x0(n, r)

    def f(am, bm):
        ls, vv = port.dominant_eigh_gen(
            port.DenseOperator((am + am.T) / 2),
            port.DenseOperator((bm + bm.T) / 2), r=r, maxiter=300, tol=1e-12,
            precond=lambda v: dt * v, x0=x0, device="cpu")
        return _weighted_loss(ls, vv, r)

    at = _t(a).requires_grad_(True)
    bt = _t(b).requires_grad_(True)
    ga, gb = torch.autograd.grad(f(at, bt), (at, bt))

    def fj(am, bm):
        ls, vv = jax_gen(JaxDense((am + am.T) / 2), JaxDense((bm + bm.T) / 2),
                         r=r, maxiter=300, tol=1e-12,
                         precond=lambda v: jnp.asarray(dinv) * v)
        return jnp.sum(ls * jnp.arange(1.0, r + 1.0)) + jnp.sum(vv[0] ** 2)

    ga_j, gb_j = jax.jit(jax.grad(fj, argnums=(0, 1)))(jnp.asarray(a),
                                                       jnp.asarray(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ga_j), rtol=0,
                               atol=1e-8 * np.abs(ga_j).max())
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), rtol=0,
                               atol=1e-8 * np.abs(gb_j).max())
    eps = 1e-6
    with torch.no_grad():
        for (i, j) in [(3, 7), (0, 0)]:
            e = torch.zeros(n, n, dtype=F64)
            e[i, j] = eps
            a0, b0 = at.detach(), bt.detach()
            fd_a = (f(a0 + e, b0) - f(a0 - e, b0)) / (2 * eps)
            fd_b = (f(a0, b0 + e) - f(a0, b0 - e)) / (2 * eps)
            np.testing.assert_allclose(float(ga[i, j]), float(fd_a),
                                       rtol=1e-5, atol=1e-12)
            np.testing.assert_allclose(float(gb[i, j]), float(fd_b),
                                       rtol=1e-5, atol=1e-12)


def test_order2_matches_jax():
    """Second derivatives along a direction of A and of B: the port's jvp
    of a jvp and its reverse over reverse against JAX's jvp of a jvp
    (``tests/test_gen.py::test_order2_grads``' pencil)."""
    n, r = 24, 2
    a, b = _pencil(n, seed=2, diag_scale=1.0, noise=0.2)
    dinv = 1.0 / (np.diag(a) + 1.0)
    rng = np.random.default_rng(9)
    da, db = rng.standard_normal((2, n, n))
    da, db = (da + da.T) / 2, 0.1 * (db + db.T) / 2
    dt = _t(dinv)
    x0 = _jax_x0(n, r)

    def fa(s, sb):
        ls, vv = port.dominant_eigh_gen(
            port.DenseOperator(_t(a) + s * _t(da)),
            port.DenseOperator(_t(b) + sb * _t(db)), r=r, maxiter=250,
            tol=1e-13, precond=lambda v: dt * v, x0=x0, device="cpu")
        return ls.sum() + (vv[0] ** 2).sum()

    zero, one = torch.zeros((), dtype=F64), torch.ones((), dtype=F64)
    d2 = []
    for f in (lambda s: fa(s, zero), lambda s: fa(zero, s)):
        fwd = torch.func.jvp(lambda s: torch.func.jvp(f, (s,), (one,))[1],
                             (zero,), (one,))[1]
        rev = torch.func.grad(torch.func.grad(f))(zero)
        np.testing.assert_allclose(float(rev), float(fwd), rtol=1e-7)
        d2.append(float(fwd))

    def fj(s, sb):
        ls, vv = jax_gen(JaxDense(jnp.asarray(a) + s * jnp.asarray(da)),
                         JaxDense(jnp.asarray(b) + sb * jnp.asarray(db)),
                         r=r, maxiter=250, tol=1e-13,
                         precond=lambda v: jnp.asarray(dinv) * v)
        return jnp.sum(ls) + jnp.sum(vv[0] ** 2)

    def jj(f):
        return jax.jvp(lambda s: jax.jvp(f, (s,), (1.0,))[1], (0.0,),
                       (1.0,))[1]

    d2_j = jax.jit(lambda: (jj(lambda s: fj(s, 0.0)),
                            jj(lambda s: fj(0.0, s))))()
    np.testing.assert_allclose(d2, [float(t) for t in d2_j], rtol=1e-7)


def test_with_info_flags_starved_budget():
    n, r = 90, 3
    a, b = _pencil(n, seed=3)
    _, _, info = port.dominant_eigh_gen(_t(a), _t(b), r=r, maxiter=5,
                                        tol=1e-12, with_info=True,
                                        device="cpu")
    assert float(info.converged) == 0.0
    assert float(info.effective_k) == 5.0


def test_guards_raise_the_jax_errors():
    a, b = _pencil(30)
    cases = [
        (lambda: port.dominant_eigh_gen(_t(a), _t(b), extreme="mid",
                                        device="cpu"),
         lambda: jax_gen(JaxDense(jnp.asarray(a)), JaxDense(jnp.asarray(b)),
                         extreme="mid")),
        (lambda: port.lobpcg_eigh_general(_t(a), torch.eye(10, dtype=F64),
                                          2, device="cpu"),
         lambda: jax_lobpcg_general(jnp.asarray(a), jnp.eye(10), 2)),
        (lambda: port.lobpcg_eigh_general(_t(a[:5, :5]), _t(b[:5, :5]), 2,
                                          device="cpu"),
         lambda: jax_lobpcg_general(jnp.asarray(a[:5, :5]),
                                    jnp.asarray(b[:5, :5]), 2)),
    ]
    for mine, theirs in cases:
        with pytest.raises(ValueError) as err:
            mine()
        with pytest.raises(ValueError) as err_j:
            theirs()
        assert str(err.value) == str(err_j.value)


def _complex_pencil(n, seed=4):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (h + h.conj().T) / 2 + np.diag(np.arange(1.0, n + 1))
    c = rng.standard_normal((n, n)) / np.sqrt(4 * n)
    return a, (c @ c.T + np.eye(n)).astype(np.complex128), rng


def test_complex_hermitian_pencil():
    """Complex Hermitian A with a real SPD B (as complex): values against
    scipy and JAX from JAX's start block, B-orthonormality in the
    complex inner product."""
    n, r = 80, 2
    a, b, _ = _complex_pencil(n)
    ew = scipy.linalg.eigh(a, b, eigvals_only=True)
    dinv = (1.0 / (np.arange(1.0, n + 1) + 1.0)).astype(np.complex128)
    dt = _t(dinv)
    lams, v, info = port.lobpcg_eigh_general(
        _t(a), _t(b), r, tol=1e-10, maxiter=400,
        precond=lambda R: dt[:, None] * R, x0=_jax_x0(n, r),
        with_info=True, device="cpu")
    assert lams.dtype == F64 and float(info.converged) == 1.0
    np.testing.assert_allclose(lams.numpy(), ew[:r], rtol=1e-9)
    gram = v.numpy().conj().T @ b @ v.numpy()
    np.testing.assert_allclose(gram, np.eye(r), atol=1e-9)
    lj, vj = jax.jit(lambda am, bm, d: jax_lobpcg_general(
        am, bm, r, tol=1e-10, maxiter=400,
        precond=lambda R: d[:, None] * R))(jnp.asarray(a), jnp.asarray(b),
                                            jnp.asarray(dinv))
    np.testing.assert_allclose(lams.numpy(), np.asarray(lj), rtol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), atol=1e-9)


def test_complex_pencil_phase_sensitive_gradient():
    """d Im v[5, 0] / dt along a Hermitian perturbation of A: the port's
    gradient against a central difference and JAX's (the pivot-phase
    projection of the tangent)."""
    n = 32
    a, b, rng = _complex_pencil(n)
    pert = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    pert = (pert + pert.conj().T) / 2
    x0 = _jax_x0(n, 2)

    def f(t):
        _, v = port.dominant_eigh_gen(
            port.DenseOperator(_t(a) + t * _t(pert)), _t(b), r=2,
            maxiter=400, tol=1e-12, x0=x0, device="cpu")
        return v[5, 0].imag

    t0 = torch.zeros((), dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(f(t0), t0)
    eps = 1e-5
    with torch.no_grad():
        fd = (float(f(torch.tensor(eps, dtype=F64)))
              - float(f(torch.tensor(-eps, dtype=F64)))) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=2e-5)

    def fj(t):
        _, v = jax_gen(JaxDense(jnp.asarray(a) + t * jnp.asarray(pert)),
                       JaxDense(jnp.asarray(b)), r=2, maxiter=400, tol=1e-12)
        return jnp.imag(v[5, 0])

    g_j = jax.jit(jax.grad(fj))(jnp.float64(0.0))
    np.testing.assert_allclose(float(g), float(g_j), rtol=1e-8)


# -- tests/test_lobpcg.py:138-164, the generalized half ----------------------

def test_lobpcg_general_conditioned_spectrum_matches_jax():
    """A conditioned spectrum (1 .. 1e4) against B = Q diag(1 .. 3) Q^T:
    the block-correct conjugate directions converge in a few hundred
    iterations; λ and X are JAX's from its own start block (X to the
    accuracy the stopping residual leaves)."""
    n, r = 256, 4
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = q @ np.diag(np.linspace(1, 1e4, n)) @ q.T
    b = q @ np.diag(np.linspace(1.0, 3.0, n)) @ q.T
    lg, xg, ig = port.lobpcg_eigh_general(_t(a), _t(b), r=r, maxiter=2000,
                                          tol=1e-8, x0=_jax_x0(n, r),
                                          with_info=True, device="cpu")
    assert float(ig.converged) == 1.0
    assert float(ig.iterations) < 500, float(ig.iterations)
    ref = scipy.linalg.eigh(a, b, eigvals_only=True)[:r]
    np.testing.assert_allclose(lg.numpy(), ref, rtol=1e-7)
    lj, xj, ij = jax.jit(lambda am, bm: jax_lobpcg_general(
        am, bm, r=r, maxiter=2000, tol=1e-8, with_info=True))(
            jnp.asarray(a), jnp.asarray(b))
    # At κ = 1e4 the two packages' round-off (another summation order in
    # the Gram products) moves the stopping iteration by a few (138 and
    # 136 here); both blocks meet the 1e-8 residual, so X agrees to what
    # that residual leaves (3e-10 measured), λ to its square.
    assert abs(float(ig.iterations) - float(ij.iterations)) <= 5
    np.testing.assert_allclose(lg.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(xg.numpy(), np.asarray(xj), atol=1e-9)


# -- the pencil solve ----------------------------------------------------------

def _pencil_solve_inputs(n=40, r=2, m=3):
    a, b = _pencil(n, seed=6)
    ew, ev = scipy.linalg.eigh(a, b)
    v = ev[:, :r]
    rng = np.random.default_rng(8)
    return a, b, ew[:r], v, b @ v, rng.standard_normal((n, m))


def test_solve_deflated_pencil_matches_jax_and_vmap():
    """x of the B-deflated pencil solve (one shift per column) against
    JAX's vmapped solve; it is B-orthogonal to V and solves the
    projected system; ``torch.func.vmap`` over the columns is the block
    solve."""
    a, b, lams, v, bv, rhs = _pencil_solve_inputs()
    args = (_t(a), _t(b))
    x = port.solve_deflated_pencil(*args, _t(lams[[0, 1, 1]]), _t(v),
                                   _t(bv), _t(rhs), tol=1e-13,
                                   device="cpu")
    x_j = jax.jit(jax.vmap(lambda lam, col: jax_pencil_solve(
        JaxDense(jnp.asarray(a)), JaxDense(jnp.asarray(b)), lam,
        jnp.asarray(v), jnp.asarray(bv), col, tol=1e-13),
        in_axes=(0, 1), out_axes=1))(jnp.asarray(lams[[0, 1, 1]]),
                                     jnp.asarray(rhs))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=1e-10)
    np.testing.assert_allclose(bv.T @ x.numpy(), 0.0, atol=1e-12)
    vm = torch.func.vmap(lambda lam, col: port.solve_deflated_pencil(
        *args, lam, _t(v), _t(bv), col, tol=1e-13, device="cpu"),
        in_dims=(0, 1), out_dims=1)(_t(lams[[0, 1, 1]]), _t(rhs))
    np.testing.assert_allclose(vm.numpy(), x.numpy(), atol=1e-12)


def test_gradcheck_pencil_solve_and_dominant_eigh_gen():
    """``gradcheck`` and ``gradgradcheck`` (fast mode) of both Functions:
    the pencil solve in rhs, λ, V (through its B-normalization) and both
    operators, and the eigensolver in both operators."""
    a, b, lams, v, _, rhs = _pencil_solve_inputs(n=16, r=2, m=2)
    # Shifts below the pencil's spectrum (a definite system), and V
    # B-orthonormalized from u inside, so every perturbation keeps the
    # problem one the solve is for (as the standard solve's test does).
    shifts = lams[0] - np.array([1.0, 1.5])
    u = v + 0.1 * np.random.default_rng(3).standard_normal(v.shape)

    def solve(rhs_, lam, uu, am, bm):
        bsym = (bm + bm.T) / 2
        chol = torch.linalg.cholesky(uu.T @ bsym @ uu)
        vv = torch.linalg.solve_triangular(chol, uu.T, upper=False).T
        return port.solve_deflated_pencil(
            port.DenseOperator((am + am.T) / 2), port.DenseOperator(bsym),
            lam, vv, bsym @ vv, rhs_, tol=1e-13, device="cpu")

    inputs = tuple(_t(t).requires_grad_(True)
                   for t in (rhs, shifts, u, a, b))
    assert gradcheck(solve, inputs, fast_mode=True)
    assert gradgradcheck(solve, inputs, fast_mode=True)

    def eig(am, bm):
        ls, vv = port.dominant_eigh_gen(
            port.DenseOperator((am + am.T) / 2),
            port.DenseOperator((bm + bm.T) / 2), r=2, maxiter=300,
            tol=1e-13, x0=_jax_x0(16, 2), device="cpu")
        return ls, vv.abs()

    ab = tuple(_t(t).requires_grad_(True) for t in (a, b))
    assert gradcheck(eig, ab, fast_mode=True, atol=1e-6)
    assert gradgradcheck(eig, ab, fast_mode=True, atol=1e-5)


# -- examples/vibrational_modes.py --------------------------------------------

def test_vibrational_modes_chain():
    """The example's chain (n = 150, r = 3, f64, a K^{-1} preconditioner):
    ω² against ``scipy.linalg.eigh(K, M)`` and d(ω0²)/dm against a central
    difference at its largest-magnitude site."""
    n, r = 150, 3
    rng = np.random.default_rng(0)
    ks = 1.0 + rng.random(n + 1)
    kmat = (np.diag(ks[:-1] + ks[1:]) - np.diag(ks[1:-1], 1)
            - np.diag(ks[1:-1], -1))
    masses = 0.5 + rng.random(n)
    kinv = _t(np.linalg.inv(kmat))
    m = _t(masses).requires_grad_(True)
    mass = port.MatrixFreeOperator(lambda w, x: w * x, m, n, dtype=F64)
    lams, _, info = port.dominant_eigh_gen(
        _t(kmat), mass, r=r, maxiter=100, tol=1e-12,
        precond=lambda v: kinv @ v, with_info=True, device="cpu")
    assert float(info.converged) == 1.0
    ew = scipy.linalg.eigh(kmat, np.diag(masses), eigvals_only=True)
    np.testing.assert_allclose(lams.detach().numpy(), ew[:r], rtol=1e-9)
    (grad,) = torch.autograd.grad(lams[0], m)
    j = int(torch.argmin(grad))
    eps = 1e-4
    mp, mm = masses.copy(), masses.copy()
    mp[j] += eps
    mm[j] -= eps
    fd = (scipy.linalg.eigh(kmat, np.diag(mp), eigvals_only=True)[0]
          - scipy.linalg.eigh(kmat, np.diag(mm), eigvals_only=True)[0]) \
        / (2 * eps)
    np.testing.assert_allclose(float(grad[j]), fd, rtol=1e-5)
    # Hellmann-Feynman for a diagonal B: dλ/dm_i = -λ x_i².
    _, x = port.dominant_eigh_gen(_t(kmat), _t(np.diag(masses)), r=r,
                                  maxiter=100, tol=1e-12,
                                  precond=lambda v: kinv @ v, device="cpu")
    np.testing.assert_allclose(grad.numpy(), -ew[0] * x[:, 0].numpy() ** 2,
                               rtol=0, atol=1e-8 * float(grad.abs().max()))


# -- dominant_eigh_multi(reorth_chunks=...) ---------------------------------

def test_multi_reorth_chunks_matches_unchunked_and_jax():
    """``reorth_chunks`` reaches the Lanczos sweep of the block solver:
    the port's chunked run is its unchunked one exactly (the projections
    read the written rows either way), and JAX's chunked run from the
    same start vector to 1e-10."""
    rng = np.random.default_rng(12)
    s = rng.standard_normal((128, 128))
    a = (s + s.T) / 2
    v0 = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (128,), jnp.float64)))
    kw = dict(r=3, k=60, v0=v0, device="cpu")
    l4, v4 = port.dominant_eigh_multi(_t(a), reorth_chunks=4, **kw)
    l0, v0_ = port.dominant_eigh_multi(_t(a), **kw)
    assert torch.equal(l4, l0) and torch.equal(v4, v0_)
    lj, vj = jax.jit(lambda m: jax_multi(JaxDense(m), r=3, k=60,
                                         reorth_chunks=4))(jnp.asarray(a))
    np.testing.assert_allclose(l4.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(v4.numpy(), np.asarray(vj), atol=1e-10)
