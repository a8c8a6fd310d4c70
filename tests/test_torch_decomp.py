"""The port's degeneracy-safe decompositions (``ops/decomp.py``) against the
JAX package's (CPU, f64): forwards on invariants, forward mode against
``jax.jvp``, backward against ``jax.vjp``, derivatives at exact multiplets
(finite, equal to JAX's, where PyTorch's own derivative is not), second
derivatives (gradgradcheck, Hessian-vector products against
``jax.jvp(jax.grad)``), the float32 broadening floor, the sketch's Ω, and
that no derivative reaches PyTorch's own ``eigh``/``svd``/``qr`` rule.

Every JAX reference is jitted once and computed here from the same numpy
inputs.  Eigenvectors and singular vectors carry a sign (and, in a
multiplet, a rotation) gauge, so the comparisons are of invariants:
eigenvalues, singular values, the projectors ``v vᵀ`` and ``u vᵀ`` and
their tangents, and the gradients of gauge-invariant losses.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.autograd import gradcheck, gradgradcheck

from dominantsparseeigenad_tpu.ops import decomp as jd

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch.ops import decomp as pd

torch.set_num_threads(2)

N, R = 8, 4                 # square inputs; kept pairs of the truncated forms
RECT, R_RECT = (30, 20), 4  # the truncated SVD's rectangular input
CASES = ["eigh", "eigh_truncated", "svd", "svd_truncated"]
# The gradient at a multiplet: bit-exact pairs give JAX's to round-off;
# the sketch's pairs differ by ~1e-16, which the rule divides by eps².
MULTIPLET_RTOL = {"eigh": 1e-10, "eigh_truncated": 1e-10, "svd": 1e-10,
                  "svd_truncated": 1e-6}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _jax_omega(m, k, dtype=jnp.float64):
    """JAX's sketch draw for an (., m) input and a window of k."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0x5eed), (m, k),
                                      dtype))


def _decaying_rect(seed, shape=RECT, double=False):
    """A rectangular matrix with singular values exp(-0.4 i), or, with
    ``double``, kron(I2, C): every singular value exactly twice."""
    rng = np.random.default_rng(seed)
    n, m = (shape[0] // 2, shape[1] // 2) if double else shape
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((m, m)))
    c = (q1[:, :m] * np.exp(-0.4 * np.arange(m))[None, :]) @ q2.T
    return np.kron(np.eye(2), c) if double else c


def _inputs(case, multiplet=False):
    """The case's input matrix.  With ``multiplet``, an exact multiplet,
    bit for bit in both packages' decompositions: for eigh, a symmetric B
    beside 10 I2 (the top pair; the tridiagonal reduction leaves the
    zero coupling exact), for svd kron(I2, B) (every singular value
    twice)."""
    rng = np.random.default_rng(CASES.index(case))
    if case == "svd_truncated":
        return _decaying_rect(7, double=multiplet)
    if case.startswith("eigh"):
        n = N - 2 if multiplet else N
        b = rng.standard_normal((n, n))
        b = (b + b.T) / 2
        if multiplet:
            b = np.block([[b, np.zeros((n, 2))],
                          [np.zeros((2, n)), 10.0 * np.eye(2)]])
        return b
    n = N // 2 if multiplet else N
    b = rng.standard_normal((n, n))
    return np.kron(np.eye(2), b) if multiplet else b


def _call(mod, case, a, **kw):
    """The decomposition of ``case`` in ``mod`` (the JAX or the port
    module); the truncated SVD takes ``omega`` in the port only."""
    if case == "eigh":
        return mod.eigh_safe(a, **kw)
    if case == "eigh_truncated":
        return mod.eigh_safe_truncated(a, R, **kw)
    if case == "svd":
        return mod.svd_safe(a, **kw)
    return mod.svd_safe_truncated(a, R_RECT, **kw)


def _port(case, a):
    kw = {"device": "cpu"}
    if case == "svd_truncated":
        kw["omega"] = _jax_omega(a.shape[1], min(R_RECT + 16, *a.shape))
    return _call(pd, case, a, **kw)


def _invariants(case, out):
    """Gauge-free views of the outputs: the values and the projectors
    v_i v_iᵀ (eigh) or u_i v_iᵀ (svd), one per pair."""
    if case.startswith("eigh"):
        w, v = out
        return w, v[:, None, :] * v[None, :, :]
    u, s, vt = out
    return s, u[:, None, :] * vt.T[None, :, :]


def _probes(case, a):
    rng = np.random.default_rng(100 + CASES.index(case))
    n, m = a.shape
    return rng.standard_normal((n, m)), rng.standard_normal((n, n))


def _loss(case, out, p, q, multiplet=False):
    """A gauge-invariant scalar of the outputs (also under rotations
    within a pair of a multiplet when ``multiplet``): powers of the
    values plus probed projectors onto the top two pairs, and, for
    simple spectra, column-wise fourth powers."""
    if case.startswith("eigh"):
        w, v = out
        top = v[:, -2:] if case == "eigh" else v[:, :2]
        val = (w ** 3).sum() + ((top @ top.T) * q).sum()
        return val if multiplet else val + (v ** 4).sum()
    u, s, vt = out
    val = ((s ** 3).sum() + (((u[:, :2] * s[:2]) @ vt[:2]) * p).sum()
           + ((u[:, :2] @ u[:, :2].T) * q).sum())
    return val if multiplet else val + (u ** 4).sum() + (vt ** 4).sum()


def _port_loss(case, multiplet=False):
    p, q = (_t(x) for x in _probes(case, _inputs(case, multiplet)))
    return lambda a: _loss(case, _port(case, a), p, q, multiplet)


@functools.lru_cache(maxsize=None)
def _jax_refs(case, multiplet=False):
    """JAX's forward invariants, gradient of the loss, output tangents'
    invariants and HVP, each jitted once."""
    a = _inputs(case, multiplet)
    p, q = (jnp.asarray(x) for x in _probes(case, a))
    da = np.random.default_rng(200 + CASES.index(case)).standard_normal(
        a.shape)

    def dec(x):
        return _call(jd, case, x)

    def loss(x):
        return _loss(case, dec(x), p, q, multiplet)

    def tangents(x, dx):
        out, dout = jax.jvp(dec, (x,), (dx,))
        return _jvp_invariants(case, out, dout)

    refs = {
        "fwd": jax.jit(lambda x: _invariants(case, dec(x)))(jnp.asarray(a)),
        "grad": jax.jit(jax.grad(loss))(jnp.asarray(a)),
        "jvp": jax.jit(tangents)(jnp.asarray(a), jnp.asarray(da)),
        "hvp": jax.jit(lambda x, dx: jax.jvp(jax.grad(loss), (x,), (dx,))[1])(
            jnp.asarray(a), jnp.asarray(da)),
    }
    return a, da, jax.tree_util.tree_map(np.asarray, refs)


def _jvp_invariants(case, out, dout):
    """Tangents of the values and of the projectors."""
    if case.startswith("eigh"):
        (_, v), (dw, dv) = out, dout
        return dw, (dv[:, None, :] * v[None, :, :]
                    + v[:, None, :] * dv[None, :, :])
    (u, _, vt), (du, ds, dvt) = out, dout
    return ds, (du[:, None, :] * vt.T[None, :, :]
                + u[:, None, :] * dvt.T[None, :, :])


@pytest.mark.parametrize("case", CASES)
def test_forward_invariants_match_jax(case):
    a, _, refs = _jax_refs(case)
    got = _invariants(case, _port(case, _t(a)))
    for g, want in zip(got, refs["fwd"]):
        assert _rel(g, want) <= 1e-12


@pytest.mark.parametrize("case", CASES)
def test_forward_mode_matches_jax_jvp(case):
    a, da, refs = _jax_refs(case)
    with fwAD.dual_level():
        out = _port(case, fwAD.make_dual(_t(a), _t(da)))
        prim = [fwAD.unpack_dual(o).primal for o in out]
        tang = [fwAD.unpack_dual(o).tangent for o in out]
    for g, want in zip(_jvp_invariants(case, prim, tang), refs["jvp"]):
        assert _rel(g, want) <= 1e-10


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_jax_vjp(case):
    a, _, refs = _jax_refs(case)
    x = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(_port_loss(case)(x), x)
    assert _rel(g, refs["grad"]) <= 1e-10


def _hvp(f, a, da):
    x = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x, create_graph=True)
    (h,) = torch.autograd.grad(g, x, grad_outputs=_t(da))
    return h


@pytest.mark.parametrize("case", CASES)
def test_hessian_vector_product_matches_jax(case):
    """Reverse over reverse through the backward (built on the saved
    outputs, or on the safe decomposition of the saved input) against
    ``jax.jvp(jax.grad)``."""
    a, da, refs = _jax_refs(case)
    assert _rel(_hvp(_port_loss(case), a, da), refs["hvp"]) <= 1e-8


@pytest.mark.parametrize("case", CASES)
def test_exact_multiplet_derivatives_are_finite_and_match_jax(case):
    """At an exact multiplet (a pair of equal eigenvalues or singular
    values; the sketch of the truncated SVD resolves kron(I2, C)'s pairs
    to round-off) the gradient of a loss invariant under rotations within
    the pairs is finite and equals JAX's, and a second derivative is
    finite too.  (Its value there is not compared: the Lorentzian's slope
    1/eps² at a zero gap multiplies round-off.)"""
    a, da, refs = _jax_refs(case, multiplet=True)
    vals = _invariants(case, _port(case, _t(a)))[0]
    gaps = (vals[:-1] - vals[1:]).abs()
    if case == "svd_truncated":
        assert gaps.min() <= 1e-14 * vals.max()
    else:
        assert torch.any(gaps == 0)                  # bit for bit
    f = _port_loss(case, multiplet=True)
    x = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x)
    assert torch.isfinite(g).all()
    assert _rel(g, refs["grad"]) <= MULTIPLET_RTOL[case]
    assert torch.isfinite(_hvp(f, a, da)).all()


@pytest.mark.parametrize("case", ["eigh", "svd"])
def test_pytorch_own_rule_fails_at_the_multiplet(case):
    """What the safe rules guard: PyTorch's own ``eigh``/``svd`` backward
    on the same multiplet and loss is not finite."""
    a = _t(_inputs(case, multiplet=True)).requires_grad_(True)
    p, q = (_t(x) for x in _probes(case, a))
    out = (torch.linalg.eigh(a) if case == "eigh"
           else torch.linalg.svd(a, full_matrices=False))
    (g,) = torch.autograd.grad(_loss(case, out, p, q, True), a)
    assert not torch.isfinite(g).all()


@pytest.mark.parametrize("case", CASES)
def test_gradcheck_and_gradgradcheck(case):
    """First and second derivatives against central differences
    (gradcheck's default tolerances) on a simple spectrum."""
    a = _t(_inputs(case)[:6, :6] if case != "svd_truncated"
           else _decaying_rect(3, (12, 9))).requires_grad_(True)

    def f(x):
        if case == "svd_truncated":
            return pd.svd_safe_truncated(
                x, 3, omega=_jax_omega(9, 9), device="cpu")
        return _call(pd, case, x, device="cpu")

    assert gradcheck(f, (a,))
    assert gradgradcheck(f, (a,))


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


@pytest.mark.parametrize("case", CASES)
def test_no_derivative_reaches_pytorch_own_decomposition_rule(case):
    """The first derivative's graph (what the second derivative
    differentiates) holds no node of PyTorch's eigh/svd/qr rules."""
    a = _inputs(case)
    x = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(_port_loss(case)(x), x, create_graph=True)
    names = _graph_nodes(g)
    assert any(n.startswith(("_EighSafe", "_SvdSafe")) for n in names)
    assert not {n for n in names if _PYTORCH_RULE.match(n)}, names


def _hvp32(case, multiplet):
    a = _inputs(case, multiplet)
    da = np.random.default_rng(5).standard_normal(a.shape)
    p, q = (torch.from_numpy(x).float() for x in _probes(case, a))
    x = torch.from_numpy(a).float().requires_grad_(True)
    kw = {"device": "cpu"}
    if case == "svd_truncated":
        kw["omega"] = _jax_omega(a.shape[1], min(R_RECT + 16, *a.shape))
    (g,) = torch.autograd.grad(
        _loss(case, _call(pd, case, x, **kw), p, q, multiplet), x,
        create_graph=True)
    (h,) = torch.autograd.grad(g, x, torch.from_numpy(da).float())
    return h, a, da


@pytest.mark.parametrize("case", CASES)
def test_float32_second_derivatives_are_finite(case):
    """float32 floors the broadening at 8 eps ≈ 9.5e-7 (``_eps_floor``;
    the float64 scale 1e-12 would make the Lorentzian's slope 1/eps² =
    1e24, and the JAX package's nested forward form underflows there):
    the float32 HVP is finite and near the float64 one on a simple
    spectrum, and finite at an exact multiplet."""
    assert pd._eps_floor(1e-12, torch.float32) == pytest.approx(
        8 * np.finfo(np.float32).eps)
    assert pd._eps_floor(1e-12, torch.float64) == 1e-12
    h32, a, da = _hvp32(case, False)
    assert torch.isfinite(h32).all()
    # The sketch case's singular values fall to 5e-4: its squared gaps
    # (~3e-7) sit at float32's resolution of s_1² (~1e-7).
    rtol = 5e-2 if case == "svd_truncated" else 1e-3
    assert _rel(h32, _hvp(_port_loss(case), a, da)) <= rtol
    assert torch.isfinite(_hvp32(case, True)[0]).all()


def test_truncated_svd_default_sketch_is_within_the_sketch_error():
    """The port's own Ω (a seeded torch draw, not JAX's) gives the same
    top triplets and gradient to the sketch's accuracy on a decaying
    spectrum; JAX's Ω (the other tests) gives JAX's numbers."""
    a, _, refs = _jax_refs("svd_truncated")
    out = pd.svd_safe_truncated(_t(a), R_RECT, device="cpu")
    for g, want in zip(_invariants("svd_truncated", out), refs["fwd"]):
        assert _rel(g, want) <= 1e-10
    p, q = (_t(x) for x in _probes("svd_truncated", a))
    x = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(_loss(
        "svd_truncated", pd.svd_safe_truncated(x, R_RECT, device="cpu"),
        p, q), x)
    assert _rel(g, refs["grad"]) <= 1e-8
    again = pd.svd_safe_truncated(_t(a), R_RECT, device="cpu")
    assert all(torch.equal(s, t) for s, t in zip(out, again))
    with pytest.raises(ValueError, match="omega must have shape"):
        pd.svd_safe_truncated(_t(a), R_RECT, omega=np.zeros((3, 3)),
                              device="cpu")


def test_truncated_forms_are_the_top_of_the_full_ones():
    a = _inputs("eigh")
    w, v = port.eigh_safe(_t(a), device="cpu")
    wt, vt = port.eigh_safe_truncated(_t(a), R, device="cpu")
    assert torch.equal(wt, torch.flip(w, (0,))[:R])
    assert torch.equal(vt, torch.flip(v, (1,))[:, :R])
    u, s, vh = port.svd_safe(_t(_inputs("svd")), device="cpu")
    assert torch.all(s[:-1] >= s[1:])
    assert _rel(u @ torch.diag(s) @ vh, _inputs("svd")) <= 1e-13
    with pytest.raises(ValueError, match="square"):
        port.svd_safe(_t(_inputs("svd_truncated")), device="cpu")


def _crel(a, b):
    """``_rel`` for complex arrays (imaginary parts compared too)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _complex_input(case):
    """A complex128 input: Hermitian for eigh, square or (for the
    truncated SVD) rectangular otherwise."""
    rng = np.random.default_rng(300 + CASES.index(case))
    shape = RECT if case == "svd_truncated" else (N, N)
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return (b + b.conj().T) / 2 if case.startswith("eigh") else b


def _complex_invariants(case, out):
    """The values and the projectors v_i v_iᴴ (eigh) or u_i v_iᴴ (svd)."""
    if case.startswith("eigh"):
        w, v = out
        return w, v[:, None, :] * v.conj()[None, :, :]
    u, s, vt = out
    return s, u[:, None, :] * vt.T[None, :, :]


def _complex_loss(case, out, p, q):
    """A real loss of the outputs, invariant under each pair's phase."""
    if case.startswith("eigh"):
        w, v = out
        top = v[:, -2:] if case == "eigh" else v[:, :2]
        return ((w ** 3).sum() + ((top @ top.conj().T) * q).sum().real
                + (abs(v) ** 4).sum())
    u, s, vt = out
    u2 = u[:, :2]
    return ((s ** 3).sum() + (((u2 * s[:2]) @ vt[:2]) * p).sum().real
            + ((u2 @ u2.conj().T) * q).sum().real + (abs(u) ** 4).sum()
            + (abs(vt) ** 4).sum())


@pytest.mark.parametrize("case", CASES)
def test_complex_input_matches_jax(case):
    """Complex input, once refused: the forward's invariants, the
    gradient of a real phase-invariant loss (PyTorch's is the conjugate
    of JAX's) and the forward-mode tangents of the invariants, against
    the JAX rules (Hermitian throughout), to 1e-10 relative."""
    a = _complex_input(case)
    rng = np.random.default_rng(400 + CASES.index(case))
    n, m = a.shape
    p = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    q = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    da = rng.standard_normal(a.shape) + 1j * rng.standard_normal(a.shape)
    kw = {}
    if case == "svd_truncated":
        kw["omega"] = _jax_omega(m, min(R_RECT + 16, n, m), jnp.complex128)

    def dec(x):
        return _call(jd, case, x)

    fwd, grad, (_, jvp) = jax.jit(lambda x, dx: (
        _complex_invariants(case, dec(x)),
        jax.grad(lambda y: _complex_loss(case, dec(y), p, q))(x),
        jax.jvp(lambda y: _complex_invariants(case, dec(y)), (x,),
                (dx,))))(jnp.asarray(a), jnp.asarray(da))

    def dec_port(x):
        return _call(pd, case, x, device="cpu", **kw)

    x = torch.tensor(a, requires_grad=True)
    got = _complex_invariants(case, dec_port(x))
    for g, w in zip(got, fwd):
        assert _crel(g.detach().numpy(), w) <= 1e-10
    (g,) = torch.autograd.grad(
        _complex_loss(case, dec_port(x), torch.tensor(p), torch.tensor(q)),
        x)
    assert _crel(g.numpy(), np.conj(np.asarray(grad))) <= 1e-10
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(a), torch.tensor(da))
        tangents = [fwAD.unpack_dual(t).tangent
                    for t in _complex_invariants(case, dec_port(dual))]
    for g, w in zip(tangents, jvp):
        assert _crel(g.numpy(), w) <= 1e-10


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
