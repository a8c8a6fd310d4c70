"""The port's preconditioners (``ops/precond.py``) and the ``precond``
option of both eigensolvers against the JAX package's (CPU, f64)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.ops.eigh import dominant_eigh as jax_eigh
from dominantsparseeigenad_tpu.ops.eigh import (
    dominant_eigh_multi as jax_multi)
from dominantsparseeigenad_tpu.ops.operators import DenseOperator as JaxDense
from dominantsparseeigenad_tpu.ops.precond import (
    block_jacobi_precond as jax_block_jacobi)
from dominantsparseeigenad_tpu.ops.precond import (
    jacobi_precond as jax_jacobi)
from dominantsparseeigenad_tpu.ops.precond import (
    operator_diagonal as jax_diagonal)
from dominantsparseeigenad_tpu.ops.sparse import random_bell_operator

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)

BELL = (128, 16, 5)                     # n, bs, blocks per row


def _ill_conditioned_spd(rng, n, cond=1e4, coupling=0.05):
    """``tests/test_precond.py::_ill_conditioned_spd``: diagonally
    dominant SPD with its conditioning (~cond) on the diagonal."""
    d = np.exp(rng.uniform(0.0, np.log(cond), n))
    d[0], d[-1] = 1.0, cond
    s = rng.standard_normal((n, n)) * coupling
    a = np.diag(d) + (s + s.T) / 2
    w = np.linalg.eigvalsh(a)
    if w[0] <= 0.5:
        a += (0.5 - w[0]) * np.eye(n)
    return a


@functools.lru_cache(maxsize=None)
def _jax_bell():
    return random_bell_operator(jax.random.PRNGKey(3), *BELL,
                                dtype=jnp.float64, use_pallas=False)


def _port_bell(layout):
    jop = _jax_bell()
    op = port.bell_operator_from_numpy(
        np.asarray(jop.vals), np.asarray(jop.cols), BELL[0], symmetric=True,
        slot_plan="auto" if layout == "banded" else None, device="cpu")
    assert (op.slot_plan is not None) == (layout == "banded")
    return op


def _dense():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64)) * (rng.random((64, 64)) < 0.3)
    a = (a + a.T) / 2
    np.fill_diagonal(a, rng.standard_normal(64))
    return a


@pytest.mark.parametrize("layout", ["dense", "gather", "banded"])
def test_operator_diagonal_matches_jax(layout):
    if layout == "dense":
        a = _dense()
        d = port.operator_diagonal(torch.from_numpy(a))
        want = np.asarray(jax_diagonal(JaxDense(jnp.asarray(a))))
    else:
        d = port.operator_diagonal(_port_bell(layout))
        want = np.asarray(jax_diagonal(_jax_bell()))
    # Read out of the stored values: no arithmetic.
    np.testing.assert_array_equal(d.numpy(), want)


def test_matrix_free_operator_has_no_diagonal():
    op = port.MatrixFreeOperator(lambda p, x: 2.0 * x, None, 8,
                                 dtype=torch.float64, device="cpu")
    with pytest.raises(TypeError, match="diag="):
        port.operator_diagonal(op)
    with pytest.raises(TypeError, match="no structural diagonal blocks for "
                       "MatrixFreeOperator; pass explicit blocks="):
        port.block_jacobi_precond(op)
    # JAX refuses both with the same TypeErrors.
    from dominantsparseeigenad_tpu.ops.operators import MatrixFreeOperator
    jop = MatrixFreeOperator(lambda p, x: 2.0 * x, None, 8)
    with pytest.raises(TypeError, match="diag="):
        jax_diagonal(jop)
    with pytest.raises(TypeError, match="pass explicit blocks="):
        jax_block_jacobi(jop)


def _preconds(kind, shift):
    """(port, JAX) preconditioners of one kind on the same operator."""
    if kind == "jacobi_bell":
        return (port.jacobi_precond(_port_bell("banded"), shift=shift),
                jax_jacobi(_jax_bell(), shift=shift))
    if kind == "block_bell":
        return (port.block_jacobi_precond(_port_bell("gather"), shift=shift),
                jax_block_jacobi(_jax_bell(), shift=shift))
    a = _dense()[:48, :48]
    if kind == "jacobi_dense":
        return (port.jacobi_precond(torch.from_numpy(a), shift=shift),
                jax_jacobi(JaxDense(jnp.asarray(a)), shift=shift))
    return (port.block_jacobi_precond(torch.from_numpy(a), bs=8,
                                      shift=shift),
            jax_block_jacobi(JaxDense(jnp.asarray(a)), bs=8, shift=shift))


KINDS = ["jacobi_dense", "jacobi_bell", "block_dense", "block_bell"]


@pytest.mark.parametrize("kind", KINDS)
def test_applies_match_jax(kind):
    m, m_j = _preconds(kind, shift=0.3)
    n = 48 if "dense" in kind else BELL[0]
    rng = np.random.default_rng(1)
    for shape in ((n,), (n, 3)):
        r = rng.standard_normal(shape)
        # Elementwise products, or one batched eigh and (bs, bs) products
        # on each side.
        np.testing.assert_allclose(m(torch.from_numpy(r)).numpy(),
                                   np.asarray(m_j(jnp.asarray(r))),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_spd_under_an_indefinite_shift(kind):
    """A shift inside the spectrum makes A - shift indefinite; the
    preconditioner stays symmetric positive definite (the CG contract)."""
    n = 48 if "dense" in kind else BELL[0]
    m, _ = _preconds(kind, shift=0.05)
    mat = m(torch.eye(n, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(mat, mat.T, atol=1e-12)
    assert np.linalg.eigvalsh(mat)[0] > 0


def test_zero_diagonal_gives_the_identity():
    a = torch.ones(8, 8, dtype=torch.float64) - torch.eye(8,
                                                          dtype=torch.float64)
    r = torch.arange(1.0, 9.0, dtype=torch.float64)
    for m in (port.jacobi_precond(a),
              port.block_jacobi_precond(a * 0.0, bs=4)):
        z = m(r)
        assert bool(torch.isfinite(z).all())
        np.testing.assert_allclose(z.numpy(), r.numpy(), rtol=1e-12)


def _eigh_problem():
    rng = np.random.default_rng(5)
    a = _ill_conditioned_spd(rng, 96, cond=1e3)
    da = rng.standard_normal((96, 96))
    return a, (da + da.T) / 2


def _eigh_loss(lam, v, da):
    """λ + vᵀ dA v: the eigenvector term makes the backward run its
    deflated CG (λ alone brings no solve)."""
    return lam + (v * (da @ v)).sum()


@functools.lru_cache(maxsize=None)
def _jax_eigh_grad():
    a, da = _eigh_problem()
    m = jax_jacobi(JaxDense(jnp.asarray(a)))

    def loss(t):
        lam, v = jax_eigh(JaxDense(jnp.asarray(a) + t * jnp.asarray(da)),
                          k=96, extreme="min", tol=1e-11, precond=m)
        return _eigh_loss(lam, v, jnp.asarray(da))

    val, g = jax.jit(jax.value_and_grad(loss))(jnp.float64(0.0))
    return float(val), float(g)


def test_dominant_eigh_precond_gradient_matches_jax():
    """Preconditioning the derivative solves changes no derivative
    (``tests/test_precond.py:196-224``)."""
    a, da = _eigh_problem()
    m = port.jacobi_precond(torch.from_numpy(a))
    out = []
    for precond in (None, m):
        t = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
        lam, v = port.dominant_eigh(
            torch.from_numpy(a) + t * torch.from_numpy(da), k=96, tol=1e-11,
            precond=precond, device="cpu")
        loss = _eigh_loss(lam, v, torch.from_numpy(da))
        (g,) = torch.autograd.grad(loss, t)
        out.append((float(loss.detach()), float(g)))
    val_j, g_j = _jax_eigh_grad()
    # Solves at 1e-11 on κ ~ 1e3.
    np.testing.assert_allclose(out[1][0], val_j, rtol=1e-12)
    np.testing.assert_allclose(out[1][1], g_j, rtol=1e-8)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-8)


@functools.lru_cache(maxsize=None)
def _jax_multi_grads():
    a, da = _eigh_problem()
    d = np.diag(np.linspace(-1.0, 1.0, 96))
    m = jax_jacobi(JaxDense(jnp.asarray(a)))

    def loss(t):
        lams, v = jax_multi(JaxDense(jnp.asarray(a) + t * jnp.asarray(da)),
                            r=2, k=600, method="lobpcg", tol=1e-10,
                            precond=m)
        return jnp.sum(lams) + jnp.sum(v * (jnp.asarray(d) @ v)), lams

    (val, lams), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.float64(0.0))
    return float(val), np.asarray(lams), float(g)


def test_dominant_eigh_multi_precond_matches_jax():
    """λ and the gradient of Σλ + Σ v_iᵀ D v_i (its backward runs the
    batched deflated CG) with Jacobi in LOBPCG and in that CG, against
    JAX, and against the unpreconditioned Lanczos path (LOBPCG without a
    preconditioner does not converge here in 600 iterations)."""
    a, da = _eigh_problem()
    d = torch.diag(torch.linspace(-1.0, 1.0, 96, dtype=torch.float64))
    m = port.jacobi_precond(torch.from_numpy(a))
    out = {}
    for name, method, k, precond in (("lobpcg", "lobpcg", 600, m),
                                     ("lanczos", "lanczos", 96, m),
                                     ("plain", "lanczos", 96, None)):
        t = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
        lams, v, info = port.dominant_eigh_multi(
            torch.from_numpy(a) + t * torch.from_numpy(da), r=2, k=k,
            method=method, tol=1e-10, precond=precond, with_info=True,
            device="cpu")
        assert float(info.converged) == 1.0, name
        loss = lams.sum() + (v * (d @ v)).sum()
        (g,) = torch.autograd.grad(loss, t)
        out[name] = (lams.detach().numpy(), float(g))
    val_j, lams_j, g_j = _jax_multi_grads()
    lams, g = out["lobpcg"]
    # LOBPCG at 1e-10 and block CGs at 1e-10 on κ ~ 1e3.
    np.testing.assert_allclose(lams, lams_j, rtol=1e-10)
    np.testing.assert_allclose(lams, np.linalg.eigvalsh(a)[:2], rtol=1e-10)
    np.testing.assert_allclose(g, g_j, rtol=1e-8)
    for name in ("lanczos", "plain"):
        np.testing.assert_allclose(out[name][1], g, rtol=1e-8)


def test_jacobi_cuts_lobpcg_iterations():
    """``tests/test_precond.py:177-194``: at least half the iterations
    for the same target on the ill-conditioned family."""
    a = _ill_conditioned_spd(np.random.default_rng(11), 256)
    its = []
    for precond in (None, port.jacobi_precond(torch.from_numpy(a))):
        lams, _, info = port.dominant_eigh_multi(
            torch.from_numpy(a), r=2, k=600, method="lobpcg", tol=1e-9,
            precond=precond, with_info=True, device="cpu")
        its.append(float(info.effective_k))
    np.testing.assert_allclose(lams.numpy(), np.linalg.eigvalsh(a)[:2],
                               rtol=1e-7)
    assert float(info.converged) == 1.0
    assert 2 * its[1] <= its[0], its


# -- the preconditioners on sharded vectors at p = 1 ---------------------------

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


def _sharded(a, sg):
    return port.RowShardedOperator(a, sg, vectors="sharded")


@pytest.mark.parametrize("kind", ["jacobi_dense", "block_dense"])
def test_sharded_vectors_applies_match_jax(solo, kind):
    """A row-sharded operator has no structural diagonal: the whole
    ``diag=`` or ``blocks=`` builds the rank's rows of the JAX
    preconditioner (same applies, 1e-10)."""
    a = _dense()[:48, :48]
    op = _sharded(torch.from_numpy(a), solo)
    _, m_j = _preconds(kind, shift=0.3)
    if kind == "jacobi_dense":
        m = port.jacobi_precond(op, diag=torch.from_numpy(np.diag(a).copy()),
                                shift=0.3)
    else:
        blocks = np.stack([a[i:i + 8, i:i + 8] for i in range(0, 48, 8)])
        m = port.block_jacobi_precond(op, blocks=torch.from_numpy(blocks),
                                      shift=0.3)
    r = np.random.default_rng(1).standard_normal((48, 3))
    for x in (r[:, 0], r):
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(),
                                   np.asarray(m_j(jnp.asarray(x))),
                                   rtol=1e-10, atol=1e-12)


def test_sharded_vectors_dominant_eigh_precond_matches_jax(solo):
    """``test_dominant_eigh_precond_gradient_matches_jax`` on sharded
    vectors: the preconditioned derivative solve sums its dots over the
    ranks and applies Jacobi to the rank's rows."""
    a, da = _eigh_problem()
    t = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    op = _sharded(torch.from_numpy(a) + t * torch.from_numpy(da), solo)
    m = port.jacobi_precond(op, diag=torch.from_numpy(np.diag(a).copy()))
    lam, v = port.dominant_eigh(op, k=96, tol=1e-11, precond=m,
                                device="cpu")
    loss = _eigh_loss(lam, v, torch.from_numpy(da))
    (g,) = torch.autograd.grad(loss, t)
    val_j, g_j = _jax_eigh_grad()
    np.testing.assert_allclose(float(loss.detach()), val_j, rtol=1e-12)
    np.testing.assert_allclose(float(g), g_j, rtol=1e-8)


def test_sharded_vectors_multi_precond_matches_jax(solo):
    """``test_dominant_eigh_multi_precond_matches_jax``'s LOBPCG case on
    sharded vectors: Jacobi in LOBPCG and in the batched deflated CG."""
    a, da = _eigh_problem()
    d = torch.diag(torch.linspace(-1.0, 1.0, 96, dtype=torch.float64))
    t = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    op = _sharded(torch.from_numpy(a) + t * torch.from_numpy(da), solo)
    m = port.jacobi_precond(op, diag=torch.from_numpy(np.diag(a).copy()))
    lams, v, info = port.dominant_eigh_multi(
        op, r=2, k=600, method="lobpcg", tol=1e-10, precond=m,
        with_info=True, device="cpu")
    assert float(info.converged) == 1.0
    loss = lams.sum() + (v * (d @ v)).sum()
    (g,) = torch.autograd.grad(loss, t)
    val_j, lams_j, g_j = _jax_multi_grads()
    np.testing.assert_allclose(lams.detach().numpy(), lams_j, rtol=1e-10)
    np.testing.assert_allclose(float(g), g_j, rtol=1e-8)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
