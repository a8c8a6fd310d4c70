"""The port's block eigensolver ``dominant_eigh_multi`` and its IFT
backward, and the batched block-deflated solve of ``ops/cg.py``, against
the JAX package's ``dominant_eigh_multi``, ``jax.grad`` and
``solve_deflated`` (CPU, f64).

The start vector (Lanczos) or block (LOBPCG) is drawn from JAX's key and
handed to the port as ``v0``/``x0``, so both run from the same start.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu import BellOperator as JaxBell
from dominantsparseeigenad_tpu import DenseOperator as JaxDense
from dominantsparseeigenad_tpu import dominant_eigh_multi as jax_multi
from dominantsparseeigenad_tpu import random_bell_operator
from dominantsparseeigenad_tpu.ops.cg import (
    solve_deflated as jax_solve_deflated,
    solve_deflated_info as jax_solve_deflated_info)

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)

N, R = 64, 3
METHODS = ["lanczos", "lobpcg"]
# Lanczos: k = N steps (exact); LOBPCG: an iteration cap it never meets.
K = {"lanczos": N, "lobpcg": 300}


@functools.lru_cache(maxsize=None)
def _bell():
    op = random_bell_operator(jax.random.PRNGKey(1), n=N, bs=8,
                              blocks_per_row=3, dtype=jnp.float64,
                              use_pallas=False)
    return np.array(op.vals), np.array(op.cols)


def _jax_bell(vals):
    return JaxBell(vals, jnp.asarray(_bell()[1]), N, symmetric=True,
                   use_pallas=False)


def _port_bell(vals):
    t = torch.tensor(vals, requires_grad=True)
    op = port.bell_operator_from_numpy(vals, _bell()[1], N, symmetric=True,
                                       device="cpu").with_vals(t)
    return t, op


def _start(method, n=N, r=R, seed=0):
    """JAX's start draw for ``dominant_eigh_multi(seed=seed)``."""
    shape = (n,) if method == "lanczos" else (n, r)
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), shape, jnp.float64)))
    return {"v0": x} if method == "lanczos" else {"x0": x}


def _port_multi(op, method, **kw):
    return port.dominant_eigh_multi(op, r=R, k=K[method], method=method,
                                    device="cpu", **_start(method, op.dim),
                                    **kw)


C = np.arange(1.0, R + 1.0)


@functools.lru_cache(maxsize=None)
def _jax_results(method, extreme):
    """λ, V, ∂(Σ c_i λ_i)/∂vals and ∂(Σ V⁴ + Σ λ²)/∂vals from JAX."""
    vals, _ = _bell()
    kw = dict(r=R, k=K[method], method=method, extreme=extreme)

    def lin(v):
        return jnp.sum(jnp.asarray(C) * jax_multi(_jax_bell(v), **kw)[0])

    def quartic(v):
        lams, vec = jax_multi(_jax_bell(v), tol=1e-12, **kw)
        return jnp.sum(vec ** 4) + jnp.sum(lams ** 2)

    lams, vec = jax_multi(_jax_bell(jnp.asarray(vals)), **kw)
    return (np.asarray(lams), np.asarray(vec),
            np.asarray(jax.grad(lin)(jnp.asarray(vals))),
            np.asarray(jax.grad(quartic)(jnp.asarray(vals))))


@pytest.mark.parametrize("extreme", ["min", "max"])
@pytest.mark.parametrize("method", METHODS)
def test_pairs_match_jax(method, extreme):
    lams_j, v_j, _, _ = _jax_results(method, extreme)
    _, op = _port_bell(_bell()[0])
    lams, v = _port_multi(op, method, extreme=extreme)
    # Converged f64 pairs from the same start; V after the sign gauge.
    np.testing.assert_allclose(lams.detach().numpy(), lams_j, rtol=1e-9)
    np.testing.assert_allclose(v.detach().numpy(), v_j, atol=1e-6)


@pytest.mark.parametrize("extreme", ["min", "max"])
@pytest.mark.parametrize("method", METHODS)
def test_eigenvalue_gradient_matches_jax(method, extreme):
    _, _, g_j, _ = _jax_results(method, extreme)
    t, op = _port_bell(_bell()[0])
    lams, _ = _port_multi(op, method, extreme=extreme)
    (torch.from_numpy(C) * lams).sum().backward()
    # Σ c_i v_i⊗v_i on the pattern: products of converged vectors.
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("extreme", ["min", "max"])
@pytest.mark.parametrize("method", METHODS)
def test_eigenvector_loss_gradient_matches_jax(method, extreme):
    _, _, _, g_j = _jax_results(method, extreme)
    t, op = _port_bell(_bell()[0])
    lams, v = _port_multi(op, method, extreme=extreme, tol=1e-12)
    ((v ** 4).sum() + (lams ** 2).sum()).backward()
    # Through the batched deflated CG here and the vmapped one in JAX,
    # each stopped at a 1e-12 relative residual, times the condition
    # number of the deflated systems.
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("method", METHODS)
def test_dense_operator_gradient_matches_jax(method):
    a = np.array(_jax_bell(jnp.asarray(_bell()[0])).to_dense())

    def loss_j(m):
        lams, v = jax_multi(JaxDense(m), r=R, k=K[method], method=method,
                            tol=1e-12)
        return jnp.sum(v ** 4) + jnp.sum(lams ** 2)

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(a)))
    at = torch.tensor(a, requires_grad=True)
    lams, v = _port_multi(port.DenseOperator(at), method, tol=1e-12)
    ((v ** 4).sum() + (lams ** 2).sum()).backward()
    np.testing.assert_allclose(at.grad.numpy(), g_j, rtol=1e-6, atol=1e-9)


def test_degenerate_pair_gradient_is_finite_and_matches_jax():
    """The exactly 2-fold degenerate lowest pair of
    ``test_eigh_multi.py::test_multi_degenerate_block_finite``: the
    gauge-invariant loss (λ sum + projector) has a finite gradient, equal
    to JAX's whichever basis of the pair each forward returns."""
    d = np.diag([1.0, 1.0, 2.0, 3.0, 4.0, 5.0])
    q, _ = np.linalg.qr(np.random.default_rng(4).standard_normal((6, 6)))
    a = q @ d @ q.T

    def loss_j(m):
        lams, v = jax_multi(JaxDense(m), r=2, k=6)
        p = v @ v.T
        return jnp.sum(lams) + jnp.sum(p * p)

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(a)))
    at = torch.tensor(a, requires_grad=True)
    lams, v = port.dominant_eigh_multi(port.DenseOperator(at), r=2, k=6,
                                       device="cpu",
                                       **_start("lanczos", 6))
    p = v @ v.T
    (lams.sum() + (p * p).sum()).backward()
    assert np.all(np.isfinite(at.grad.numpy()))
    # At an exact degeneracy the computed gap is round-off (~1e-15), so
    # the broadened inverse F ~ gap / gap_eps² is ~1e9, and it multiplies
    # off-diagonal entries of V^T V̄ that are round-off (~1e-16) for this
    # loss: the two packages differ by ~1e-7 there (measured 1.0e-7).
    np.testing.assert_allclose(at.grad.numpy(), g_j, atol=1e-6)


@pytest.mark.parametrize("method", METHODS)
def test_with_info_matches_jax_and_is_not_differentiable(method):
    vals, _ = _bell()
    kw = dict(r=R, k=K[method], method=method, tol=1e-10)
    _, _, info_j = jax_multi(_jax_bell(jnp.asarray(vals)), with_info=True,
                             **kw)
    t, op = _port_bell(vals)
    lams, v, info = _port_multi(op, method, tol=1e-10, with_info=True)
    assert isinstance(info, port.LanczosInfo)
    assert not any(f.requires_grad for f in info)
    assert float(info.converged) == float(info_j.converged) == 1.0
    assert abs(float(info.effective_k) - float(info_j.effective_k)) <= 1
    assert float(info.residual) <= 1e-10
    lams.sum().backward()
    assert np.all(np.isfinite(t.grad.numpy()))


def test_argument_errors():
    a = torch.eye(8, dtype=torch.float64)
    # precond is accepted (it raised NotImplementedError before it was
    # ported): with the identity, the pairs are the unpreconditioned ones.
    lams, _ = port.dominant_eigh_multi(a, r=2, k=8, precond=lambda x: x,
                                       device="cpu")
    assert torch.equal(lams, port.dominant_eigh_multi(a, r=2, k=8,
                                                      device="cpu")[0])
    with pytest.raises(ValueError, match="k >= r"):
        port.dominant_eigh_multi(a, r=4, k=3, device="cpu")
    with pytest.raises(ValueError, match="x0"):
        port.dominant_eigh_multi(a, r=2, k=8, x0=torch.zeros(8, 2),
                                 device="cpu")
    with pytest.raises(ValueError, match="method"):
        port.dominant_eigh_multi(a, r=2, k=8, method="arnoldi",
                                 device="cpu")


def _deflated_problem(extreme, n=48, r=3, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    evals, evecs = np.linalg.eigh(a)
    idx = slice(0, r) if extreme == "min" else slice(n - r, n)
    return a, evals[idx], evecs[:, idx], rng.standard_normal((n, r))


@pytest.mark.parametrize("extreme, sign", [("min", 1.0), ("max", -1.0)])
def test_batched_block_deflated_solve_matches_jax_column_loop(extreme, sign):
    a, lams, V, B = _deflated_problem(extreme)
    op_j = JaxDense(jnp.asarray(a))
    cols = [jax_solve_deflated_info(op_j, jnp.asarray(lams[i]),
                                    jnp.asarray(V), jnp.asarray(B[:, i]),
                                    definite_sign=sign, tol=1e-12)
            for i in range(B.shape[1])]
    x_j = np.stack([np.asarray(c[0]) for c in cols], axis=1)
    x_j2 = np.stack([np.asarray(jax_solve_deflated(
        op_j, jnp.asarray(lams[i]), jnp.asarray(V), jnp.asarray(B[:, i]),
        definite_sign=sign, tol=1e-12)) for i in range(B.shape[1])], axis=1)
    op = port.dense_operator_from_numpy(a, device="cpu")
    args = (op, torch.from_numpy(lams), torch.from_numpy(V),
            torch.from_numpy(B))
    x = port.solve_deflated(*args, definite_sign=sign, tol=1e-12,
                            device="cpu")
    # Each column solved to a 1e-12 residual on a system of condition
    # number ~1e2.
    np.testing.assert_allclose(x.numpy(), x_j, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(x.numpy(), x_j2, rtol=1e-8, atol=1e-8)
    assert np.abs(V.T @ x.numpy()).max() < 1e-13
    x_i, its, res = port.solve_deflated_info(*args, definite_sign=sign,
                                             tol=1e-12, device="cpu")
    np.testing.assert_allclose(x_i.numpy(), x.numpy(), atol=1e-14)
    # Each column stops at its own first passing iteration, as a vmapped
    # while_loop lane does; round-off may move that by one.
    for (_, its_j, _), it in zip(cols, its):
        assert abs(int(its_j) - it) <= 1
    assert max(res) <= 1e-12


class _CountingDense(port.DenseOperator):
    def __init__(self, a):
        super().__init__(a)
        self.matmats, self.matvecs = [], 0

    def matmat(self, X):
        self.matmats.append(X.shape[1])
        return super().matmat(X)

    def matvec(self, x):
        self.matvecs += 1
        return super().matvec(x)


def test_batched_solve_is_one_matmat_per_iteration():
    cg_mod = __import__("dominantsparseeigenad_tpu_torch.ops.cg",
                        fromlist=["CHECK_EVERY"])
    a, lams, V, B = _deflated_problem("min")
    op = _CountingDense(torch.from_numpy(a))
    # A zero column is frozen from the start and takes no iteration.
    B[:, 1] = 0.0
    _, its, _ = port.solve_deflated_info(
        op, torch.from_numpy(lams), torch.from_numpy(V),
        torch.from_numpy(B), tol=1e-10, device="cpu")
    assert op.matvecs == 0 and its[1] == 0
    loop = len(op.matmats) - 1          # the last one is the residual
    assert all(m == B.shape[1] for m in op.matmats)
    ce = cg_mod.CHECK_EVERY
    assert loop == -(-max(its) // ce) * ce


def test_backward_solves_in_one_batched_loop():
    """The backward runs the r deflated solves as one batched CG: every
    operator application is a matmat of width r, and the gradient's own
    product is one more."""
    a = np.array(_jax_bell(jnp.asarray(_bell()[0])).to_dense())
    at = torch.tensor(a, requires_grad=True)
    op = _CountingDense(at)
    lams, v = port.dominant_eigh_multi(op, r=R, k=K["lobpcg"],
                                       method="lobpcg", tol=1e-10,
                                       device="cpu", **_start("lobpcg"))
    fwd = list(op.matmats)
    assert op.matvecs == 0 and all(m == R for m in fwd)
    op.matmats.clear()
    ((v ** 4).sum() + lams.sum()).backward()
    assert op.matvecs == 0 and len(op.matmats) > 1
    assert all(m == R for m in op.matmats)
