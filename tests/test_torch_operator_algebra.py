"""The port's operator algebra (``ops/operators.py``: the transposed,
shifted, deflated, sum, scaled and composed operators and the operator
arithmetic) against the JAX package's (CPU, f64): the four products, the
gradients in ``shift``, ``c`` and ``V``, the tangent products against
``jax.jvp``, ``tests/test_fuzz.py:806``'s composites through
``dominant_eigh``, ``operator_diagonal`` after
``tests/test_precond.py:41-82``, a parameter that appears twice, one SpMM
per block product over a blocked-ELL child, and ``vmap``."""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dominantsparseeigenad_tpu.ops.operators as jops
from dominantsparseeigenad_tpu.ops.eigh import dominant_eigh as jax_eigh
from dominantsparseeigenad_tpu.ops.precond import (
    operator_diagonal as jax_diagonal)
from dominantsparseeigenad_tpu.ops.sparse import CSROperator as JaxCSR

import dominantsparseeigenad_tpu_torch as port

# The module, not the function of the same name that ops exports.
spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.bell_spmv")

torch.set_num_threads(2)

F64 = torch.float64
N = 12

JAX = types.SimpleNamespace(**{name: getattr(jops, name) for name in (
    "DenseOperator", "TransposedOperator", "ShiftedOperator",
    "DeflatedOperator", "SumOperator", "ScaledOperator",
    "ComposedOperator")})


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _inputs(seed=0):
    """Two non-symmetric matrices, a shift, a scale, an orthonormal
    (N, 2) V, a unit vector u, and the tangents of each (numpy, f64)."""
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal((2, N, N))
    v, _ = np.linalg.qr(rng.standard_normal((N, 3)))
    prim = {"a": a, "b": b, "s": np.float64(0.7), "c": np.float64(-1.3),
            "V": v[:, :2], "u": v[:, 2]}
    tan = {"a": rng.standard_normal((N, N)), "b": rng.standard_normal((N, N)),
           "s": np.float64(0.4), "c": np.float64(0.9),
           "V": rng.standard_normal((N, 2)), "u": rng.standard_normal(N)}
    return prim, tan


# Each builds a composite from (namespace, a, b, s, c, V); the dunders
# with Python numbers, which are constants.
KINDS = {
    "transposed": lambda ns, a, b, s, c, V, u: ns.TransposedOperator(
        ns.DenseOperator(a)),
    "dot_T": lambda ns, a, b, s, c, V, u: ns.DenseOperator(a).T,
    "shifted": lambda ns, a, b, s, c, V, u: ns.ShiftedOperator(
        ns.DenseOperator(a), s),
    "deflated_rank1": lambda ns, a, b, s, c, V, u: ns.DeflatedOperator(
        ns.DenseOperator(a), u),
    "deflated_rank2": lambda ns, a, b, s, c, V, u: ns.DeflatedOperator(
        ns.DenseOperator(a), V),
    "sum": lambda ns, a, b, s, c, V, u: ns.SumOperator(
        ns.DenseOperator(a), ns.DenseOperator(b)),
    "add": lambda ns, a, b, s, c, V, u: ns.DenseOperator(a)
    + ns.DenseOperator(b),
    "sub": lambda ns, a, b, s, c, V, u: ns.DenseOperator(a)
    - ns.DenseOperator(b),
    "neg": lambda ns, a, b, s, c, V, u: -ns.DenseOperator(a),
    "scaled": lambda ns, a, b, s, c, V, u: ns.ScaledOperator(
        ns.DenseOperator(a), c),
    "rmul": lambda ns, a, b, s, c, V, u: 2.5 * ns.DenseOperator(a),
    "mul": lambda ns, a, b, s, c, V, u: ns.DenseOperator(a) * 2.5,
    "composed": lambda ns, a, b, s, c, V, u: ns.ComposedOperator(
        ns.DenseOperator(a), ns.DenseOperator(b)),
    "matmul": lambda ns, a, b, s, c, V, u: ns.DenseOperator(a)
    @ ns.DenseOperator(b),
    "nested": lambda ns, a, b, s, c, V, u: ns.ShiftedOperator(
        ns.DeflatedOperator(ns.SumOperator(
            ns.DenseOperator(a), ns.ScaledOperator(
                ns.ComposedOperator(ns.DenseOperator(a),
                                    ns.DenseOperator(b)).T, c)), V), s),
}
ARGS = ("a", "b", "s", "c", "V", "u")


def _jax_op(kind, p):
    return KINDS[kind](JAX, *(jnp.asarray(p[k]) for k in ARGS))


def _port_op(kind, tensors):
    return KINDS[kind](port, *(tensors[k] for k in ARGS))


def _tensors(p):
    return {k: torch.tensor(p[k], dtype=F64) for k in ARGS}


@jax.jit
def _jax_products(op, x, X):
    return op.matvec(x), op.rmatvec(x), op.matmat(X), op.rmatmat(X)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_products_match_jax(kind):
    prim, _ = _inputs()
    rng = np.random.default_rng(1)
    x, X = rng.standard_normal(N), rng.standard_normal((N, 3))
    op = _port_op(kind, _tensors(prim))
    want = _jax_products(_jax_op(kind, prim), jnp.asarray(x), jnp.asarray(X))
    xt, Xt = torch.from_numpy(x), torch.from_numpy(X)
    got = (op.matvec(xt), op.rmatvec(xt), op.matmat(Xt), op.rmatmat(Xt))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-12
    # ``@`` dispatches on the operand; to_dense is A @ I.
    np.testing.assert_array_equal((op @ xt).numpy(), got[0].numpy())
    np.testing.assert_array_equal((op @ Xt).numpy(), got[2].numpy())
    assert _rel(op.to_dense().numpy(),
                np.asarray(_jax_op(kind, prim).to_dense())) <= 1e-12
    assert op.dim == N and op.dtype == F64 and op.device.type == "cpu"


def test_complex_scale_of_a_real_operator_matches_jax():
    """A complex ``c`` makes a real operator's products complex, as in
    JAX; ``rmatvec`` stays the bilinear ``c A^T x``."""
    prim, _ = _inputs()
    c = np.complex128(0.3 - 1.1j)
    op = port.ScaledOperator(port.DenseOperator(torch.from_numpy(prim["a"])),
                             torch.tensor(c))
    jop = JAX.ScaledOperator(JAX.DenseOperator(jnp.asarray(prim["a"])),
                             jnp.asarray(c))
    x = np.random.default_rng(2).standard_normal(N)
    assert op.dtype == torch.complex128
    for g, w in ((op.matvec(torch.from_numpy(x)), jop.matvec(x)),
                 (op.rmatvec(torch.from_numpy(x)), jop.rmatvec(x))):
        assert _rel(g.numpy(), w) <= 1e-12


def test_deflated_transpose_is_bilinear_for_a_complex_v():
    """With a complex V the transpose products are those of (P A P)^T,
    P^T = I - conj(V) V^T (the port's bilinear ``rmatvec``; the JAX
    operator applies P itself, which agrees for a real V only: see
    ``ROADMAP.md``'s notes on the JAX design), and so is their tangent."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    v, _ = np.linalg.qr(rng.standard_normal((N, 2))
                        + 1j * rng.standard_normal((N, 2)))
    dv = rng.standard_normal((N, 2)) + 1j * rng.standard_normal((N, 2))
    x = rng.standard_normal((N, 3)) + 1j * rng.standard_normal((N, 3))
    at, vt, xt = (torch.from_numpy(t) for t in (a, v, x))

    def op(V):
        return port.DeflatedOperator(port.DenseOperator(at), V)

    p = np.eye(N) - v @ v.conj().T
    want = (p @ a @ p).T
    assert _rel(op(vt).rmatvec(xt[:, 0]).numpy(), want @ x[:, 0]) <= 1e-12
    assert _rel(op(vt).rmatmat(xt).numpy(), want @ x) <= 1e-12
    _, dwant = torch.func.jvp(lambda V: op(V).to_dense().T @ xt[:, 0],
                              (vt,), (torch.from_numpy(dv),))
    got = op(vt).tangent_rmatvec(xt[:, 0], [None, torch.from_numpy(dv)])
    assert _rel(got.numpy(), dwant.numpy()) <= 1e-12


@pytest.mark.parametrize("kind", ["shifted", "scaled", "deflated_rank1",
                                  "deflated_rank2", "nested"])
def test_product_gradients_match_jax(kind):
    """The gradient of <w, A x> + <w', A^T X> in a, b, shift, c, V and u
    against ``jax.grad``: the composite's products are differentiable
    PyTorch."""
    prim, _ = _inputs()
    rng = np.random.default_rng(3)
    x, X = rng.standard_normal(N), rng.standard_normal((N, 2))
    w, W = rng.standard_normal(N), rng.standard_normal((N, 2))

    def loss_jax(*args):
        op = KINDS[kind](JAX, *args)
        return jnp.sum(w * op.matvec(x)) + jnp.sum(W * op.rmatmat(X))

    want = jax.jit(jax.grad(loss_jax, argnums=tuple(range(len(ARGS)))))(
        *(jnp.asarray(prim[k]) for k in ARGS))
    ts = {k: t.requires_grad_(True) for k, t in _tensors(prim).items()}
    op = _port_op(kind, ts)
    loss = (torch.from_numpy(w) * op.matvec(torch.from_numpy(x))).sum() \
        + (torch.from_numpy(W) * op.rmatmat(torch.from_numpy(X))).sum()
    got = torch.autograd.grad(loss, [ts[k] for k in ARGS], allow_unused=True)
    for k, g, wg in zip(ARGS, got, want):
        if g is None:
            assert not np.asarray(wg).any(), k
        else:
            assert _rel(g.numpy(), wg) <= 1e-12, k


def _dparams(op, tensors, tangents, moving):
    """One tangent per entry of ``op.parameters()``: a parameter's
    tangent where its name is in ``moving``, else None."""
    by_id = {id(t): k for k, t in tensors.items()}
    return [tangents[by_id[id(p)]] if by_id[id(p)] in moving else None
            for p in op.parameters()]


@pytest.mark.parametrize("moving", ["all", "own"])
@pytest.mark.parametrize("kind", ["transposed", "shifted", "deflated_rank1",
                                  "deflated_rank2", "sum", "scaled",
                                  "composed", "nested"])
def test_tangent_products_match_jax_jvp(kind, moving):
    """``tangent_matvec``, ``tangent_matmat`` and ``tangent_rmatvec``
    against ``jax.jvp`` of the JAX composite's products; with "own" only
    the composite's shift, c and V move (the matrices' tangents None)."""
    prim, tan = _inputs()
    names = set(ARGS) if moving == "all" else {"s", "c", "V", "u"}
    rng = np.random.default_rng(4)
    x, X = rng.standard_normal(N), rng.standard_normal((N, 3))
    ts = _tensors(prim)
    op = _port_op(kind, ts)
    dparams = _dparams(op, ts, _tensors(tan), names)
    prims = tuple(jnp.asarray(prim[k]) for k in ARGS)
    tans = tuple(jnp.asarray(tan[k]) if k in names
                 else jnp.zeros_like(prims[i]) for i, k in enumerate(ARGS))
    for method, arg in (("matvec", x), ("matmat", X), ("rmatvec", x)):
        _, want = jax.jvp(
            lambda *args, m=method, z=arg: getattr(
                KINDS[kind](JAX, *args), m)(z), prims, tans)
        got = getattr(op, "tangent_" + method)(torch.from_numpy(arg),
                                                dparams)
        assert _rel(got.numpy(), want) <= 1e-12, method


def _fuzz_inputs(seed, n=40):
    """``tests/test_fuzz.py:806``'s inputs: a dense symmetric a, a sparse
    symmetric b (a pattern fixed across seeds, so one JAX compile serves
    all), a shift and a scale."""
    mask = np.random.default_rng(9700).random((n, n)) < 0.3
    mask = mask | mask.T
    rng = np.random.default_rng(9700 + seed)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    return ((a + a.T) / 2, np.where(mask, (b + b.T) / 2, 0.0),
            float(rng.standard_normal()), float(rng.standard_normal() + 2.0))


@jax.jit
def _jax_fuzz(a, indptr, indices, data, shift, scale, t):
    def lam(t):
        comp = JAX.ShiftedOperator(JAX.SumOperator(
            JAX.DenseOperator(a), JAX.ScaledOperator(
                JaxCSR(indptr, indices, data, a.shape[0]), t * scale)),
            shift)
        return jax_eigh(comp, k=a.shape[0], extreme="min")[0]
    return jax.value_and_grad(lam)(t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_composites_through_dominant_eigh(seed):
    """ShiftedOperator(SumOperator(Dense, ScaledOperator(CSR, t s)), σ):
    λ against numpy's, and dλ/dt against JAX's (both autograd and
    ``torch.func.grad``, which rebuilds the composite on its own
    tensors)."""
    a, b, shift, scale = _fuzz_inputs(seed)
    n = a.shape[0]
    csr = sp.csr_matrix(b)
    lam_j, g_j = _jax_fuzz(jnp.asarray(a), jnp.asarray(csr.indptr, jnp.int32),
                           jnp.asarray(csr.indices, jnp.int32),
                           jnp.asarray(csr.data), shift, scale, 1.0)
    bop = port.CSROperator.from_scipy(csr, device="cpu")

    def lam(t):
        comp = port.ShiftedOperator(
            port.SumOperator(port.DenseOperator(torch.from_numpy(a)),
                             port.ScaledOperator(bop, t * scale)),
            torch.tensor(shift, dtype=F64))
        return port.dominant_eigh(comp, k=n, device="cpu")[0]

    t = torch.tensor(1.0, dtype=F64, requires_grad=True)
    val = lam(t)
    (g,) = torch.autograd.grad(val, t)
    w = np.linalg.eigvalsh(a + scale * b - shift * np.eye(n))
    val = float(val.detach())
    np.testing.assert_allclose(val, w[0], rtol=1e-9)
    np.testing.assert_allclose(val, float(lam_j), rtol=1e-10)
    np.testing.assert_allclose(float(g), float(g_j), rtol=1e-8)
    g_func = torch.func.grad(lam)(torch.tensor(1.0, dtype=F64))
    np.testing.assert_allclose(float(g_func), float(g_j), rtol=1e-8)


@jax.jit
def _jax_param_grads(a, s, c, V):
    def loss(s, c, V):
        sh = JAX.ShiftedOperator(JAX.ScaledOperator(JAX.DenseOperator(a), c),
                                 s)
        lam, v = jax_eigh(sh, k=a.shape[0], extreme="min")
        lam_d, v_d = jax_eigh(JAX.DeflatedOperator(JAX.DenseOperator(a), V),
                              k=a.shape[0], extreme="max")
        return lam + jnp.sum(v ** 4) + lam_d + jnp.sum(v_d ** 4)
    return jax.grad(loss, argnums=(0, 1, 2))(s, c, V)


def test_eigh_gradients_in_shift_scale_and_vectors_match_jax():
    """∂/∂(shift, c, V) of λ + Σv⁴ of ``dominant_eigh`` on
    Shifted(Scaled(A, c), shift) and on Deflated(A, V) against
    ``jax.grad``: the composite's own tensors are parameters of the
    solver's derivative rule."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((24, 24))
    a = (a + a.T) / 2
    V, _ = np.linalg.qr(rng.standard_normal((24, 2)))
    want = _jax_param_grads(jnp.asarray(a), 0.3, 1.7, jnp.asarray(V))
    s, c, Vt = (torch.tensor(x, dtype=F64, requires_grad=True)
                for x in (0.3, 1.7, V))
    A = port.DenseOperator(torch.from_numpy(a))
    lam, v = port.dominant_eigh(port.ShiftedOperator(
        port.ScaledOperator(A, c), s), k=24, device="cpu")
    lam_d, v_d = port.dominant_eigh(port.DeflatedOperator(A, Vt), k=24,
                                    extreme="max", device="cpu")
    loss = lam + (v ** 4).sum() + lam_d + (v_d ** 4).sum()
    got = torch.autograd.grad(loss, [s, c, Vt])
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-8


def _diag_inputs():
    """``tests/test_precond.py:41-82``'s matrix."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64)) * (rng.random((64, 64)) < 0.3)
    a = (a + a.T) / 2
    np.fill_diagonal(a, rng.standard_normal(64))
    return a


@pytest.mark.parametrize("kind", ["shifted", "scaled", "sum", "nested_csr"])
def test_operator_diagonal_of_composites_matches_jax(kind):
    """Shifted is A - shift I, as the operator's own product on basis
    vectors shows; every branch is the JAX one's arithmetic, so equal."""
    a = _diag_inputs()
    csr = sp.csr_matrix(a)

    def build(ns, dense, csr_op, num):
        base = ns.DenseOperator(dense)
        return {"shifted": lambda: ns.ShiftedOperator(base, num(2.5)),
                "scaled": lambda: ns.ScaledOperator(base, num(-3.0)),
                "sum": lambda: ns.SumOperator(
                    base, ns.ScaledOperator(base, num(-3.0))),
                "nested_csr": lambda: ns.ShiftedOperator(ns.SumOperator(
                    ns.ScaledOperator(csr_op, num(0.5)), base), num(1.25)),
                }[kind]()

    op = build(port, torch.from_numpy(a),
               port.CSROperator.from_scipy(csr, device="cpu"),
               lambda x: torch.tensor(x, dtype=F64))
    jop = build(JAX, jnp.asarray(a),
                JaxCSR(jnp.asarray(csr.indptr, jnp.int32),
                       jnp.asarray(csr.indices, jnp.int32),
                       jnp.asarray(csr.data), 64), jnp.float64)
    got = port.operator_diagonal(op).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_diagonal(jop)))
    probe = op.matvec(torch.eye(64, dtype=F64)[0]).numpy()
    np.testing.assert_allclose(got[0], probe[0], rtol=1e-12)


def test_matrix_free_composite_has_no_diagonal():
    mf = port.MatrixFreeOperator(lambda p, x: 2.0 * x, None, 8,
                                 dtype=F64, device="cpu")
    with pytest.raises(TypeError, match="diag="):
        port.operator_diagonal(port.ShiftedOperator(mf, 1.0))


@jax.jit
def _jax_duplicate_grads(a, b):
    def lam(a, b):
        A, B = JAX.DenseOperator(a), JAX.DenseOperator(b)
        one = jax_eigh(A + 2.0 * A, k=a.shape[0], extreme="min")
        two = jax_eigh(B + (A - A), k=a.shape[0], extreme="min")
        return one[0] + jnp.sum(one[1] ** 4) + two[0] + jnp.sum(two[1] ** 4)
    return jax.grad(lam, argnums=(0, 1))(a, b)


def test_a_parameter_twice_sums_its_gradients():
    """``A + 2 A`` and ``B + (A - A)`` hold the same tensor twice in
    ``parameters()``: the rule's partial derivatives (one proxy per
    entry) must sum, in autograd, in ``torch.func.grad`` (which rebuilds
    the operator, ``rebind``) and in forward mode."""
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((2, 16, 16))
    a, b = (a + a.T) / 2, (b + b.T) / 2
    want = _jax_duplicate_grads(jnp.asarray(a), jnp.asarray(b))

    def loss(at, bt):
        A, B = port.DenseOperator(at), port.DenseOperator(bt)
        one = port.dominant_eigh(A + 2.0 * A, k=16, device="cpu")
        two = port.dominant_eigh(B + (A - A), k=16, device="cpu")
        return one[0] + (one[1] ** 4).sum() + two[0] + (two[1] ** 4).sum()

    at, bt = (torch.tensor(x, requires_grad=True) for x in (a, b))
    assert len((port.DenseOperator(at) + 2.0 * port.DenseOperator(at))
               .parameters()) == 2
    got = torch.autograd.grad(loss(at, bt), [at, bt])
    func = torch.func.grad(loss, argnums=(0, 1))(torch.from_numpy(a),
                                                 torch.from_numpy(b))
    da = rng.standard_normal((16, 16))
    da = torch.from_numpy((da + da.T) / 2)
    _, fwd = torch.func.jvp(lambda x: loss(x, torch.from_numpy(b)),
                            (torch.from_numpy(a),), (da,))
    for g, h, w in zip(got, func, want):
        assert _rel(g.numpy(), w) <= 1e-8
        assert _rel(h.numpy(), w) <= 1e-8
    np.testing.assert_allclose(float(fwd), float((got[0] * da).sum()),
                               rtol=1e-8)


@pytest.fixture(scope="module")
def bell():
    """A symmetric banded blocked-ELL operator (n = 128, bs = 16)."""
    return port.random_bell_operator(128, 16, 5, dtype=F64, device="cpu",
                                     generator=torch.Generator()
                                     .manual_seed(3))


BELL_KINDS = {
    "shifted": (lambda A: port.ShiftedOperator(A, 0.5), 1),
    "scaled": (lambda A: port.ScaledOperator(A, torch.tensor(-2.0,
                                                             dtype=F64)), 1),
    "deflated": (lambda A: port.DeflatedOperator(
        A, torch.nn.functional.normalize(torch.ones(A.dim, dtype=F64),
                                         dim=0)), 1),
    "transposed": (lambda A: A.T, 1),
    "sum": (lambda A: A + 3.0 * A, 2),
    "composed": (lambda A: A @ A, 2),
}


def _counting_products(monkeypatch):
    """Record the shape of every product ``_BellProduct`` runs."""
    calls = []
    product = spmv._product

    def counted(vals, cols, x, plan):
        calls.append(tuple(x.shape))
        return product(vals, cols, x, plan)

    monkeypatch.setattr(spmv, "_product", counted)
    return calls


@pytest.mark.parametrize("kind", sorted(BELL_KINDS))
def test_block_product_over_a_bell_child_is_one_spmm(kind, bell,
                                                     monkeypatch):
    """A composite's ``matmat`` and ``rmatmat`` call the blocked-ELL
    child's block product once per appearance of the child (on the card,
    one K3/K4b SpMM launch), never one SpMV per column; its
    ``tangent_matmat`` likewise."""
    build, per_call = BELL_KINDS[kind]
    op = build(bell)
    X = torch.randn(128, 4, dtype=F64, generator=torch.Generator()
                    .manual_seed(7))
    want = op.to_dense() @ X
    calls = _counting_products(monkeypatch)
    got = op.matmat(X)
    assert calls == [(128, 4)] * per_call
    assert _rel(got.numpy(), want.numpy()) <= 1e-12
    calls.clear()
    op.rmatmat(X)
    assert calls == [(128, 4)] * per_call
    calls.clear()
    dparams = [torch.ones_like(p) for p in op.parameters()]
    op.tangent_matmat(X, dparams)
    assert calls and all(shape == (128, 4) for shape in calls)


@pytest.mark.parametrize("backing", ["bell", "csr"])
def test_vmap_of_a_composite_matvec_is_the_loop(backing, bell):
    """``torch.func.vmap`` of a composite's matvec over 5 vectors against
    the loop (a Bell child batches as one SpMM, a CSR child through
    ``index_add``'s batching rule)."""
    child = bell if backing == "bell" else port.CSROperator.from_dense(
        bell.to_dense(), device="cpu")
    V = torch.nn.functional.normalize(torch.ones(128, dtype=F64), dim=0)
    op = port.DeflatedOperator(
        port.ShiftedOperator(child + (-0.5) * child.T,
                             torch.tensor(0.25, dtype=F64)), V)
    X = torch.randn(5, 128, dtype=F64, generator=torch.Generator()
                    .manual_seed(8))
    got = torch.func.vmap(op.matvec)(X)
    want = torch.stack([op.matvec(x) for x in X])
    assert _rel(got.numpy(), want.numpy()) <= 1e-14
