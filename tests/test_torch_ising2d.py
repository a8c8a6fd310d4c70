"""The port's 2D Ising TRG/CTMRG flows (``models/ising2d.py``, BASELINE
config #4) against the JAX package's (CPU, f64): the vertex tensor,
Onsager's free energy and its derivatives, ``trg_free_energy`` for every
split method, ``ctmrg_free_energy`` for every corner solver,
``transfer_operator``, ``ising_observables`` (the port's c_v by two
reverse passes against JAX's nested forward mode), and the port against
Onsager at the JAX tests' own settings and tolerances.

Every JAX reference is jitted once and computed here.  The sketch of the
``subspace`` split is JAX's Ω where the test says so (the port's default
draw elsewhere), and the ``lanczos`` split runs at chi = 4, where every
Krylov sweep spans the whole embedding, so both packages solve the same
problems.  The flows' gauges (signs, rotations within multiplets) may
differ between the packages; ln Z and its derivatives do not depend on
them.
"""

import functools
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu import models as jm
from dominantsparseeigenad_tpu.ops.observables import (
    value_d1_d2 as jax_value_d1_d2)

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models
from dominantsparseeigenad_tpu_torch.ops import decomp

torch.set_num_threads(2)

BETA = 0.45
BETA_C = float(np.log(1 + np.sqrt(2)) / 2)
SPLITS = ["gram", "subspace", "lanczos", "full"]
SOLVERS = ["truncated", "lanczos", "full"]


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _jax_omega(m, k, dtype, device):
    """JAX's sketch draw, as the port's default-Ω hook."""
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    return torch.tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(0x5eed), (m, k), jdtype)), device=device)


@pytest.fixture
def jax_sketch(monkeypatch):
    """The ``subspace`` split sketches with JAX's Ω."""
    monkeypatch.setattr(decomp, "_default_omega", _jax_omega)


def _port_d(f, beta=BETA):
    return port.value_d1_d2(f, beta, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_d(name, **kw):
    """JAX's (value, d1, d2) of ``jm.<name>(beta, **kw)`` by nested
    forward mode, jitted once."""
    f = getattr(jm, name)
    out = jax.jit(lambda b: jax_value_d1_d2(lambda x: f(x, **kw), b))(
        jnp.float64(BETA))
    return [float(t) for t in out]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vertex_tensor_matches_jax(dtype):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    for beta in (0.1, BETA, 1.3):
        got = models.ising_vertex_tensor(beta, dtype=dtype, device="cpu")
        want = np.asarray(jm.ising_vertex_tensor(beta, dtype=jdtype))
        assert got.dtype == dtype and got.shape == (2, 2, 2, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4 * np.finfo(want.dtype).eps
                                   * np.abs(want).max())


@pytest.mark.parametrize("n_quad", [64, 128])
def test_onsager_value_and_derivatives_match_jax(n_quad):
    got = _port_d(lambda b: models.onsager_free_energy(
        b, n_quad=n_quad, device="cpu"), 0.5)
    f = lambda b: jm.onsager_free_energy(b, n_quad=n_quad)  # noqa: E731
    b = jnp.float64(0.5)
    want = jax.jit(lambda x: (f(x), jax.grad(f)(x),
                              jax.grad(jax.grad(f))(x)))(b)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12


def test_onsager_anchors():
    """The JAX test's anchors: ln 2 at β → 0, ln(2)/2 + 2G/π at β_c."""
    assert _rel(models.onsager_free_energy(1e-9, device="cpu"),
                np.log(2)) <= 1e-8
    catalan = 0.915965594177219015
    assert _rel(models.onsager_free_energy(BETA_C, n_quad=512, device="cpu"),
                np.log(2) / 2 + 2 * catalan / np.pi) <= 2e-5


@functools.lru_cache(maxsize=None)
def _jax_trg_value(method):
    return float(jax.jit(lambda b: jm.trg_free_energy(
        b, chi=8, n_steps=8, split_method=method))(jnp.float64(BETA)))


@pytest.mark.parametrize("method", SPLITS)
def test_trg_free_energy_matches_jax(method, jax_sketch):
    """chi = 8, 8 steps: the splits truncate from the third step on."""
    got = models.trg_free_energy(BETA, chi=8, n_steps=8, split_method=method,
                                 device="cpu")
    assert _rel(got, _jax_trg_value(method)) <= 1e-10


@pytest.mark.parametrize("method", SPLITS)
def test_trg_derivatives_match_jax(method, jax_sketch):
    """d lnZ/dβ and d² lnZ/dβ² through every split, at chi = 4 (the
    lanczos split's sweeps span the embedding; at chi = 8 the sketch's
    derivative moves 6e-10 for a 1e-15 change of Ω, so the packages'
    round-off alone would exceed these bars)."""
    kw = dict(chi=4, n_steps=8, split_method=method)
    got = _port_d(lambda b: models.trg_free_energy(b, device="cpu", **kw))
    want = _jax_d("trg_free_energy", **kw)
    assert _rel(got[0], want[0]) <= 1e-10
    assert _rel(got[1], want[1]) <= 1e-10
    assert _rel(got[2], want[2]) <= 1e-8


def test_trg_subspace_default_sketch_is_within_the_sketch_error():
    """The port's own Ω: ln Z to round-off, and d lnZ/dβ within the JAX
    test's bar for the sketch against the exact split (1e-4)."""
    kw = dict(chi=8, n_steps=8, split_method="subspace")
    got = _port_d(lambda b: models.trg_free_energy(b, device="cpu", **kw))
    want = _jax_d("trg_free_energy", **kw)
    assert _rel(got[0], want[0]) <= 1e-10
    assert _rel(got[1], want[1]) <= 1e-6


@pytest.mark.parametrize("solver", SOLVERS)
def test_ctmrg_matches_jax(solver):
    kw = dict(chi=8, n_steps=12, eigh_solver=solver)
    got = _port_d(lambda b: models.ctmrg_free_energy(b, device="cpu", **kw))
    want = _jax_d("ctmrg_free_energy", **kw)
    assert _rel(got[0], want[0]) <= 1e-12
    assert _rel(got[1], want[1]) <= 1e-10
    assert _rel(got[2], want[2]) <= 1e-8


@functools.lru_cache(maxsize=None)
def _jax_environment():
    c, e, t = jax.jit(lambda b: jm.ctmrg_environment(b, chi=6, n_steps=10))(
        jnp.float64(0.35))
    m = jm.transfer_operator(c, e, t).to_dense()
    return [np.asarray(x) for x in (c, e, t, m)]


def test_transfer_operator_matches_jax():
    """On JAX's environment, the same matrix; on the port's own, the
    same corner spectrum and the same transfer spectrum (gauge-free)."""
    c, e, t, m = _jax_environment()
    op = models.transfer_operator(*(torch.from_numpy(x) for x in (c, e, t)),
                                  device="cpu")
    assert isinstance(op, port.DenseOperator) and op.dim == m.shape[0]
    np.testing.assert_allclose(op.a.numpy(), m, rtol=0,
                               atol=1e-14 * np.abs(m).max())
    pc, pe, pt = models.ctmrg_environment(0.35, chi=6, n_steps=10,
                                          device="cpu")
    np.testing.assert_allclose(torch.diagonal(pc).numpy(), np.diag(c),
                               rtol=1e-12)
    w = np.sort(np.abs(np.linalg.eigvals(models.transfer_operator(
        pc, pe, pt, device="cpu").a.numpy())))[::-1]
    w_jax = np.sort(np.abs(np.linalg.eigvals(m)))[::-1]
    np.testing.assert_allclose(w[:4], w_jax[:4], rtol=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_observables(method, chi, n_steps):
    return [float(t) for t in jax.jit(lambda b: jm.ising_observables(
        b, method=method, chi=chi, n_steps=n_steps))(jnp.float64(0.5))]


@pytest.mark.parametrize("method,chi,n_steps", [("trg", 8, 8),
                                                ("ctmrg", 8, 12)])
def test_ising_observables_match_jax(method, chi, n_steps):
    """(ln Z, u, c_v): the port's c_v from two reverse passes through the
    whole flow, JAX's from two nested forward passes."""
    got = models.ising_observables(0.5, method=method, chi=chi,
                                   n_steps=n_steps, device="cpu")
    want = _jax_observables(method, chi, n_steps)
    assert _rel(got[0], want[0]) <= 1e-9
    assert _rel(got[1], want[1]) <= 1e-9
    assert _rel(got[2], want[2]) <= 1e-6


def _onsager(beta, order=0):
    out = _port_d(lambda b: models.onsager_free_energy(
        b, n_quad=128, device="cpu"), beta)
    return float(out[order])


@pytest.mark.parametrize("beta,chi,n_steps,rtol", [
    (0.3, 14, 16, 5e-5), (BETA_C, 20, 18, 2e-5), (0.6, 14, 16, 5e-5)])
def test_trg_free_energy_against_onsager(beta, chi, n_steps, rtol):
    """``tests/test_ising2d.py::test_trg_free_energy``'s settings."""
    got = models.trg_free_energy(beta, chi=chi, n_steps=n_steps,
                                 device="cpu")
    assert _rel(got, _onsager(beta)) <= rtol


@pytest.mark.parametrize("beta", [0.35, 0.55])
def test_ctmrg_free_energy_against_onsager(beta):
    got = models.ctmrg_free_energy(beta, chi=16, n_steps=30, device="cpu")
    assert _rel(got, _onsager(beta)) <= 1e-9


@pytest.mark.parametrize("method,chi,n_steps,rtols", [
    ("trg", 12, 14, (None, 1e-4, 1e-3)),
    ("ctmrg", 16, 25, (1e-5, 1e-4, 1e-2))])
def test_observables_against_onsager(method, chi, n_steps, rtols):
    """``test_observables_through_trg`` and ``_ctmrg``'s settings and
    bars (the TRG test does not bound ln Z)."""
    lnz, u, cv = models.ising_observables(0.5, method=method, chi=chi,
                                          n_steps=n_steps, device="cpu")
    exact = (_onsager(0.5), -_onsager(0.5, 1), 0.25 * _onsager(0.5, 2))
    for got, want, rtol in zip((lnz, u, cv), exact, rtols):
        if rtol is not None:
            assert _rel(got, want) <= rtol


_PYTORCH_RULE = re.compile(r"Linalg(Eigh|Eig|Svd|Qr)Backward")


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("flow", [f"trg-{m}" for m in SPLITS]
                         + [f"ctmrg-{s}" for s in SOLVERS])
def test_no_flow_reaches_pytorch_own_decomposition_rule(flow):
    """The graph of d lnZ/dβ, which c_v differentiates, holds the port's
    safe rules and none of PyTorch's eigh/svd/qr derivatives."""
    kind, how = flow.split("-")
    b = torch.tensor(BETA, dtype=torch.float64, requires_grad=True)
    if kind == "trg":
        lnz = models.trg_free_energy(b, chi=4, n_steps=5, split_method=how,
                                     device="cpu")
    else:
        lnz = models.ctmrg_free_energy(b, chi=4, n_steps=6, eigh_solver=how,
                                       device="cpu")
    (d1,) = torch.autograd.grad(lnz, b, create_graph=True)
    names = _graph_nodes(d1)
    assert not {n for n in names if _PYTORCH_RULE.match(n)}, names
    assert any(n.startswith(("_EighSafe", "_SvdSafe", "_DominantEighMulti"))
               for n in names)


def test_options_and_refusals():
    f64 = dict(chi=6, n_steps=6, device="cpu")
    assert torch.equal(
        models.trg_free_energy(BETA, unroll=True, **f64),
        models.trg_free_energy(BETA, **f64))
    assert torch.equal(
        models.trg_free_energy(BETA, split_method="auto", **f64),
        models.trg_free_energy(BETA, split_method="gram", **f64))
    f32 = dict(f64, dtype=torch.float32)
    auto32 = models.trg_free_energy(BETA, split_method="auto", **f32)
    assert auto32.dtype == torch.float32
    assert torch.equal(auto32, models.trg_free_energy(
        BETA, split_method="subspace", **f32))
    with pytest.raises(ValueError, match="split_method"):
        models.trg_free_energy(BETA, split_method="qr", **f64)
    with pytest.raises(ValueError, match="eigh_solver"):
        models.ctmrg_free_energy(BETA, eigh_solver="qr", chi=4, n_steps=2,
                                 device="cpu")
    with pytest.raises(TypeError, match="real weights"):
        models.trg_free_energy(BETA, dtype=torch.complex128, **f64)


def test_lanczos_split_cg_cap_reaches_every_backward_solve(monkeypatch):
    """``lanczos_maxiter`` bounds the batched CG of every lanczos split's
    backward; the forward does not change, and u stays near the gram
    split's."""
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    loop, caps = cg._cg_columns_loop, []

    def record(matmat, b, tol, maxiter):
        caps.append(maxiter)
        return loop(matmat, b, tol, maxiter)

    monkeypatch.setattr(cg, "_cg_columns_loop", record)
    kw = dict(chi=8, n_steps=6, split_method="lanczos", device="cpu")
    b = torch.tensor(BETA, dtype=torch.float64, requires_grad=True)
    lnz = models.trg_free_energy(b, lanczos_maxiter=40, **kw)
    (d1,) = torch.autograd.grad(lnz, b)
    assert caps and set(caps) == {40}
    assert torch.equal(lnz.detach(), models.trg_free_energy(BETA, **kw))
    gram = _port_d(lambda x: models.trg_free_energy(
        x, chi=8, n_steps=6, device="cpu"))
    assert _rel(d1, gram[1]) <= 1e-8


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
