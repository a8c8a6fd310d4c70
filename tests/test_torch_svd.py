"""The port's ``dominant_svd`` (``ops/svd.py``: the block eigensolver on
the symmetric embedding [[0, A], [Aᵀ, 0]]) against the JAX package's
(CPU, f64): singular values, the gauge-free pairs u_i v_iᵀ, and first-
and second-order derivatives, on a square matrix, on tall and wide
rectangular ones, and on a matrix-free operator; both forward methods.

The embedding's start vector (Lanczos) or block (LOBPCG) is JAX's draw
for ``seed=0``, handed to the port as ``v0``/``x0``, and the Lanczos
sweeps span the whole embedding, so both solve the same problem.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu import MatrixFreeOperator as JaxMatrixFree
from dominantsparseeigenad_tpu.ops.observables import (
    value_d1_d2 as jax_value_d1_d2)
from dominantsparseeigenad_tpu.ops.svd import dominant_svd as jax_svd

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)

R = 3
TOL = 1e-12                 # the backward's CG (clamped to 50 eps)
SHAPES = {"square": (12, 12), "tall": (14, 9), "wide": (9, 14)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _matrix(shape, seed=0):
    """A matrix with well separated top singular values."""
    rng = np.random.default_rng(seed)
    m, n = shape
    q1, _ = np.linalg.qr(rng.standard_normal((m, m)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 3.0 * 0.7 ** np.arange(min(m, n))
    return (q1[:, :s.size] * s[None, :]) @ q2[:, :s.size].T


def _start(method, dim):
    """JAX's start draw for ``dominant_svd(seed=0)``: the embedding's
    Lanczos vector, or LOBPCG's (dim, r) block."""
    shape = (dim,) if method == "lanczos" else (dim, R)
    x = _t(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float64))
    return {"v0": x} if method == "lanczos" else {"x0": x}


def _k(method, dim):
    return dim if method == "lanczos" else 200


def _probe(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape)


def _loss(u, s, v, c, p):
    """Σ c_i s_i + Σ_i u_iᵀ P v_i: invariant under the pairs' signs."""
    return (c * s).sum() + ((u.T @ p) * v.T).sum()


@functools.lru_cache(maxsize=None)
def _jax_refs(kind, method):
    a = _matrix(SHAPES[kind])
    k = _k(method, sum(a.shape))
    c, p = np.arange(1.0, R + 1.0), _probe(a.shape)
    da = _probe(a.shape, seed=2)

    def run(x):
        return jax_svd(x, r=R, k=k, tol=TOL, method=method)

    def loss(x):
        return _loss(*run(x), jnp.asarray(c), jnp.asarray(p))

    u, s, v = jax.jit(run)(jnp.asarray(a))
    grad = jax.jit(jax.grad(loss))(jnp.asarray(a))
    hvp = jax.jit(lambda x, dx: jax.jvp(jax.grad(loss), (x,), (dx,))[1])(
        jnp.asarray(a), jnp.asarray(da))
    pairs = np.asarray(u)[:, None, :] * np.asarray(v)[None, :, :]
    return a, c, p, da, {"s": np.asarray(s), "pairs": pairs,
                         "grad": np.asarray(grad), "hvp": np.asarray(hvp)}


def _port_svd(x, method):
    dim = sum(x.shape)
    return port.dominant_svd(x, r=R, k=_k(method, dim), tol=TOL,
                             method=method, device="cpu",
                             **_start(method, dim))


CASES = [("square", "lanczos"), ("tall", "lanczos"), ("wide", "lanczos"),
         ("square", "lobpcg")]


@pytest.mark.parametrize("kind,method", CASES)
def test_values_and_pairs_match_jax(kind, method):
    a, _, _, _, ref = _jax_refs(kind, method)
    u, s, v = _port_svd(_t(a), method)
    assert _rel(s, ref["s"]) <= 1e-10
    assert _rel(u[:, None, :] * v[None, :, :], ref["pairs"]) <= 1e-8
    assert _rel(_t(a) @ v, u * s[None, :]) <= 1e-8          # A v = s u
    assert _rel(s, np.linalg.svd(a, compute_uv=False)[:R]) <= 1e-10


@pytest.mark.parametrize("kind,method", CASES)
def test_gradient_matches_jax(kind, method):
    a, c, p, _, ref = _jax_refs(kind, method)
    x = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(_loss(*_port_svd(x, method), _t(c), _t(p)),
                               x)
    # The block IFT rule's solves run to 1e-12; the condition of the
    # deflated embedding (σ_i ± σ_j gaps ~ 0.3) is ~10.
    assert _rel(g, ref["grad"]) <= 1e-8


@pytest.mark.parametrize("kind,method", CASES)
def test_hessian_vector_product_matches_jax(kind, method):
    """Reverse over reverse through the block IFT rule (its deflated
    solve differentiated again) against ``jax.jvp(jax.grad)``."""
    a, c, p, da, ref = _jax_refs(kind, method)
    x = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(_loss(*_port_svd(x, method), _t(c), _t(p)),
                               x, create_graph=True)
    (h,) = torch.autograd.grad(g, x, grad_outputs=_t(da))
    assert _rel(h, ref["hvp"]) <= 1e-6


N_MF = 10


def _mf_parts():
    a0 = _matrix((N_MF, N_MF), seed=5)
    b = _probe((N_MF, N_MF), seed=6)
    return a0, b


@functools.lru_cache(maxsize=None)
def _jax_mf():
    """(Σ c_i s_i)(g) of A(g) = A0 + g B as a JAX matrix-free operator:
    value, first and second derivative by nested forward mode."""
    a0, b = (jnp.asarray(x) for x in _mf_parts())
    c = jnp.arange(1.0, R + 1.0)

    def f(g):
        op = JaxMatrixFree(lambda gg, x: (a0 + gg * b) @ x, g, N_MF,
                           dtype=jnp.float64,
                           rmatvec_fn=lambda gg, x: (a0 + gg * b).T @ x,
                           symmetric=False)
        _, s, _ = jax_svd(op, r=R, k=2 * N_MF, tol=TOL)
        return jnp.sum(c * s)

    return [float(t) for t in jax.jit(lambda g: jax_value_d1_d2(f, g))(
        jnp.float64(0.3))]


def test_matrix_free_operator_matches_jax_to_second_order():
    a0, b = (_t(x) for x in _mf_parts())
    c = torch.arange(1.0, R + 1.0, dtype=torch.float64)

    def f(g):
        op = port.MatrixFreeOperator(
            lambda gg, x: (a0 + gg * b) @ x, g, N_MF, dtype=torch.float64,
            rmatvec_fn=lambda gg, x: (a0 + gg * b).T @ x, symmetric=False)
        _, s, _ = port.dominant_svd(op, r=R, k=2 * N_MF, tol=TOL,
                                    device="cpu",
                                    **_start("lanczos", 2 * N_MF))
        return (c * s).sum()

    got = port.value_d1_d2(f, 0.3, device="cpu")
    want = _jax_mf()
    assert _rel(got[0], want[0]) <= 1e-12
    assert _rel(got[1], want[1]) <= 1e-8
    assert _rel(got[2], want[2]) <= 1e-6


def test_with_info_and_rank_deficient_columns():
    """``with_info`` appends the block's residual report; columns past
    the rank are unit vectors with s clamped at 0."""
    a = _matrix((8, 8))
    a[:, 5:] = 0.0                      # rank 5
    u, s, v, info = port.dominant_svd(
        _t(a), r=7, k=16, with_info=True, device="cpu",
        **_start("lanczos", 16))
    assert float(info.residual) <= 1e-10
    assert torch.all(s >= 0)
    assert _rel(s[:5], np.linalg.svd(a, compute_uv=False)[:5]) <= 1e-10
    assert torch.allclose(torch.linalg.vector_norm(u, dim=0),
                          torch.ones(7, dtype=torch.float64))
    assert torch.allclose(torch.linalg.vector_norm(v, dim=0),
                          torch.ones(7, dtype=torch.float64))


def test_bad_inputs_are_refused():
    with pytest.raises(ValueError, match="expected a matrix"):
        port.dominant_svd(torch.zeros(4, dtype=torch.float64), device="cpu")
    with pytest.raises(TypeError, match="LinearOperator or a tensor"):
        port.dominant_svd(np.eye(4), device="cpu")


def _complex_matrix(shape, seed=5):
    """A complex matrix with well separated top singular values."""
    rng = np.random.default_rng(seed)
    m, n = shape
    q1, _ = np.linalg.qr(rng.standard_normal((m, m))
                         + 1j * rng.standard_normal((m, m)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n))
                         + 1j * rng.standard_normal((n, n)))
    s = 3.0 * 0.7 ** np.arange(min(m, n))
    return (q1[:, :s.size] * s[None, :]) @ q2[:, :s.size].conj().T


def test_complex_matches_jax():
    """A complex tall matrix, once refused: the embedding is the Hermitian
    [[0, A], [Aᴴ, 0]] (with Aᵀ the singular values come out wrong), so
    s, the pairs u_i v_iᴴ and the gradient of Σ c_i s_i + Re Σ u_iᴴ P v_i
    (PyTorch's the conjugate of JAX's) match the JAX package's, from
    JAX's complex start draw, to 1e-8 relative (s to 1e-10)."""
    a = _complex_matrix(SHAPES["tall"])
    dim = sum(a.shape)
    c = np.arange(1.0, R + 1.0)
    p = _probe(a.shape) + 1j * _probe(a.shape, seed=3)

    def loss(u, s, v, c, p):
        return (c * s).sum() + ((u.conj().T @ p) * v.T).sum().real

    def run(x):
        return jax_svd(x, r=R, k=dim, tol=TOL)

    u_j, s_j, v_j = jax.jit(run)(jnp.asarray(a))
    grad = jax.jit(jax.grad(lambda x: loss(*run(x), jnp.asarray(c),
                                           jnp.asarray(p))))(jnp.asarray(a))
    v0 = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (dim,), jnp.complex128)))
    x = torch.tensor(a, requires_grad=True)
    u, s, v = port.dominant_svd(x, r=R, k=dim, tol=TOL, v0=v0,
                                device="cpu")
    assert _rel(s.detach(), s_j) <= 1e-10
    assert _rel(s.detach(), np.linalg.svd(a, compute_uv=False)[:R]) <= 1e-10
    pairs = (u[:, None, :] * v.conj()[None, :, :]).detach().numpy()
    want = np.asarray(u_j)[:, None, :] * np.conj(np.asarray(v_j))[None, :, :]
    assert np.abs(pairs - want).max() / np.abs(want).max() <= 1e-8
    (g,) = torch.autograd.grad(loss(u, s, v, torch.tensor(c),
                                    torch.tensor(p)), x)
    want = np.conj(np.asarray(grad))
    assert np.abs(g.numpy() - want).max() / np.abs(want).max() <= 1e-8


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
