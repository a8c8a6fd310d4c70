"""Complex blocked-ELL values in the port against the JAX package's
``BellOperator(..., use_pallas=False)`` (its XLA path, the only one that
multiplies complex blocks), on the CPU in complex128.

Inputs, from numpy seeds: a complex Hermitian and a complex
non-Hermitian block-sparse matrix through ``BellOperator.from_dense`` on
both sides (``symmetric=False``: a Hermitian operator is not A^T = A),
and the JAX ``random_bell_operator`` in complex128 (complex symmetric,
every slot a ring band: the banded slot plan).  Products at 1e-12;
eigenpairs, first and second derivatives, forward mode and the block
solvers at PR 11's bars.  PyTorch's gradient with respect to a complex
leaf is the conjugate of JAX's cotangent.  Each JAX reference is jitted
once; JAX's caches are cleared when the module is done.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

import dominantsparseeigenad_tpu as jx
from dominantsparseeigenad_tpu.ops.sparse import BellOperator as JaxBell

import dominantsparseeigenad_tpu_torch as port

spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.bell_spmv")

torch.set_num_threads(2)

C128 = torch.complex128
N_H, BS_H = 64, 8            # the Hermitian and non-Hermitian inputs
N_B, BS_B, BPR_B = 128, 8, 5  # the JAX random operator
CG_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _gauss(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _block_mask(rng, n, bs, density):
    """A dense (n, n) 0/1 mask of whole (bs, bs) blocks, diagonal blocks
    kept, symmetric in the blocks."""
    nb = n // bs
    keep = rng.random((nb, nb)) < density
    keep = keep | keep.T | np.eye(nb, dtype=bool)
    return np.kron(keep, np.ones((bs, bs)))


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(19)
    mask = _block_mask(rng, N_H, BS_H, 0.3)
    a = _gauss(rng, N_H, N_H) * mask
    herm = (a + a.conj().T) / 2
    d = _gauss(rng, N_H, N_H) * mask
    dherm = (d + d.conj().T) / 2                  # a Hermitian direction
    diag = np.concatenate([[3.0 + 0.7j], 0.4 * _gauss(rng, N_H - 1)])
    nonherm = np.diag(diag) + 0.05 * _gauss(rng, N_H, N_H) * mask
    jop = jx.random_bell_operator(jax.random.PRNGKey(5), N_B, BS_B, BPR_B,
                                  dtype=jnp.complex128, use_pallas=False)
    return {"herm": herm, "dherm": dherm, "nonherm": nonherm,
            "band_vals": np.asarray(jop.vals),
            "band_cols": np.asarray(jop.cols),
            "band_plan": jop.slot_plan,
            "x64": _gauss(rng, N_H), "X64": _gauss(rng, N_H, 8),
            "x128": _gauss(rng, N_B), "X128": _gauss(rng, N_B, 8),
            "w": _gauss(rng, N_H),
            "v0": np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                               (N_H,), jnp.complex128))}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_op(case):
    """The JAX operator of ``case`` (vals, cols, n, symmetric)."""
    d = _inputs()
    if case == "band":
        return JaxBell(jnp.asarray(d["band_vals"]),
                       jnp.asarray(d["band_cols"]), N_B, symmetric=True,
                       use_pallas=False)
    return JaxBell.from_dense(d[case], bs=BS_H, use_pallas=False)


def _port_op(case, **kw):
    d = _inputs()
    if case == "band":
        return port.bell_operator_from_numpy(d["band_vals"], d["band_cols"],
                                             N_B, symmetric=True,
                                             device="cpu", **kw)
    return port.BellOperator.from_dense(d[case], bs=BS_H, device="cpu")


def _vectors(case):
    d = _inputs()
    return (d["x128"], d["X128"]) if case == "band" else (d["x64"], d["X64"])


PRODUCTS = ("matvec", "matmat1", "matmat3", "matmat8", "rmatvec", "rmatmat3")


def _apply(op, name, x, X):
    if name == "matvec":
        return op.matvec(x)
    if name == "rmatvec":
        return op.rmatvec(x)
    if name.startswith("matmat"):
        return op.matmat(X[:, :int(name[6:])])
    return op.rmatmat(X[:, :int(name[7:])])


@functools.lru_cache(maxsize=None)
def _jax_products(case):
    x, X = _vectors(case)
    jop = _jax_op(case)

    def run(vals, x, X):
        o = jop.with_vals(vals)
        return {name: _apply(o, name, x, X) for name in PRODUCTS}

    out = jax.jit(run)(jop.vals, jnp.asarray(x), jnp.asarray(X))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", PRODUCTS)
@pytest.mark.parametrize("case", ["herm", "nonherm", "band"])
def test_products_match_jax(case, name):
    """A x, A X (r = 1, 3, 8) and the bilinear A^T x, A^T X of a complex
    operator (banded plan for ``band``)."""
    x, X = _vectors(case)
    op = _port_op(case)
    assert op.vals.dtype == C128 and op.dtype == C128
    assert (op.slot_plan is not None) == (case == "band")
    got = _apply(op, name, _t(x), _t(X))
    # complex128 sums of a few blocks in another order.
    assert _rel(got, _jax_products(case)[name]) <= 1e-12


@pytest.mark.parametrize("product", ["matvec", "matmat"])
def test_banded_plan_equals_gather(product):
    """The banded plan and the gather plan give the same bits."""
    x, X = _vectors("band")
    banded, gather = _port_op("band"), _port_op("band", slot_plan=None)
    assert banded.slot_plan is not None and gather.slot_plan is None
    arg = _t(x) if product == "matvec" else _t(X)
    assert torch.equal(getattr(banded, product)(arg),
                       getattr(gather, product)(arg))


@pytest.mark.parametrize("name", ["matvec", "matmat3", "rmatvec"])
def test_real_values_with_complex_compute_dtype(name):
    """Real values with ``compute_dtype=complex128`` multiply complex
    vectors, as JAX's ``vals.astype(x.dtype)`` does; a real vector is
    promoted."""
    d = _inputs()
    x, X = _vectors("herm")
    real = port.BellOperator.from_dense(d["herm"].real, bs=BS_H,
                                        device="cpu")
    op = port.BellOperator(real.vals, real.cols, N_H,
                           compute_dtype=C128)
    jop = JaxBell.from_dense(d["herm"].real, bs=BS_H, use_pallas=False)
    jop = JaxBell(jop.vals, jop.cols, N_H, use_pallas=False,
                  compute_dtype=jnp.complex128)
    want = np.asarray(_apply(jop, name, jnp.asarray(x), jnp.asarray(X)))
    assert op.dtype == C128 and op.vals.dtype == torch.float64
    got = _apply(op, name, _t(x), _t(X))
    assert got.dtype == C128
    assert _rel(got, want) <= 1e-12
    xr = _t(x.real)
    promoted = _apply(op, name, xr, _t(X.real))
    assert promoted.dtype == C128
    assert torch.equal(promoted, _apply(op, name, xr.to(C128),
                                        _t(X.real).to(C128)))


@pytest.mark.parametrize("name", ["tangent_matvec", "tangent_matmat",
                                  "tangent_rmatvec", "tangent_rmatmat"])
def test_tangent_products_match_jax(name):
    """(dA) x, (dA) X and their bilinear transposes against ``jax.jvp``
    of the product in the values."""
    x, X = _vectors("nonherm")
    arg = x if name.endswith("vec") else X[:, :3]
    jop = _jax_op("nonherm")
    dvals = np.asarray(_jax_op("dherm").vals)
    method = name[len("tangent_"):]
    _, want = jax.jvp(lambda v: getattr(jop.with_vals(v), method)(
        jnp.asarray(arg)), (jop.vals,), (jnp.asarray(dvals),))
    op = _port_op("nonherm")
    assert np.array_equal(np.asarray(jop.cols), op.cols.numpy())
    got = getattr(op, name)(_t(arg), (_t(dvals),))
    assert _rel(got, want) <= 1e-12


# -- the Hermitian eigensolver ----------------------------------------------

def _eigh_loss(lam, v, w):
    """λ plus a gauge-invariant eigenvector term, |<w, v>|^2."""
    return lam + abs(w.conj() @ v) ** 2


@functools.lru_cache(maxsize=None)
def _jax_eigh():
    d = _inputs()
    jop, dvals = _jax_op("herm"), jnp.asarray(_jax_op("dherm").vals)
    w, v0 = jnp.asarray(d["w"]), jnp.asarray(d["v0"])

    def pair(vals):
        return jx.dominant_eigh(jop.with_vals(vals), k=N_H, tol=CG_TOL)

    def loss(vals):
        lam, v = pair(vals)
        return jnp.real(_eigh_loss(lam, v, w))

    def lam_of(vals):
        return pair(vals)[0]

    def d1(vals):
        return jax.jvp(lam_of, (vals,), (dvals,))[1]

    def run(vals):
        lam, v = pair(vals)
        (_, (dlam, dv)) = jax.jvp(pair, (vals,), (dvals,))
        return {"lam": lam, "v": v, "grad": jax.grad(loss)(vals),
                "dlam": dlam, "dv": dv,
                "d2": jax.jvp(d1, (vals,), (dvals,))[1]}

    out = jax.jit(run)(jop.vals)
    # JAX's start vector is normal(PRNGKey(0)); the port takes it as v0.
    assert v0.shape == (N_H,)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_pair(op):
    return port.dominant_eigh(op, k=N_H, tol=CG_TOL, v0=_t(_inputs()["v0"]),
                              device="cpu")


def test_dominant_eigh_pair_matches_jax():
    want = _jax_eigh()
    lam, v = _port_pair(_port_op("herm"))
    assert abs(float(lam) - float(want["lam"])) <= 1e-12 * abs(
        float(want["lam"]))
    # Both in the pivot gauge (the largest entry real and positive).
    assert np.abs(v.numpy() - want["v"]).max() <= 1e-8


def test_dominant_eigh_gradient_matches_jax():
    """∂(λ + |<w, v>|²)/∂vals against conj(jax.grad)."""
    op = _port_op("herm")
    vals = op.vals.clone().requires_grad_(True)
    lam, v = _port_pair(op.with_vals(vals))
    _eigh_loss(lam, v, _t(_inputs()["w"])).real.backward()
    # CGs at 1e-12 on both sides, times the deflated system's κ.
    assert _rel(vals.grad, np.conj(_jax_eigh()["grad"])) <= 1e-8


def test_dominant_eigh_forward_mode_matches_jax():
    op = _port_op("herm")
    dvals = _port_op("dherm").vals
    assert torch.equal(op.cols, _port_op("dherm").cols)
    (lam, v), (dlam, dv) = torch.func.jvp(
        lambda vals: _port_pair(op.with_vals(vals)), (op.vals,), (dvals,))
    want = _jax_eigh()
    assert abs(float(dlam) - float(want["dlam"])) <= 1e-9 * abs(
        float(want["dlam"]))
    assert np.abs(dv.numpy() - want["dv"]).max() <= 1e-8


def test_second_derivative_matches_jax():
    """d²λ along a Hermitian direction: a jvp of a jvp on both sides."""
    op = _port_op("herm")
    dvals = _port_op("dherm").vals

    def d1(vals):
        return torch.func.jvp(lambda s: _port_pair(op.with_vals(s))[0],
                              (vals,), (dvals,))[1]

    d2 = torch.func.jvp(d1, (op.vals,), (dvals,))[1]
    want = float(_jax_eigh()["d2"])
    assert abs(float(d2) - want) <= 1e-8 * abs(want)


@pytest.mark.parametrize("method", ["lanczos", "lobpcg"])
def test_dominant_eigh_multi_matches_jax(method):
    """The three lowest pairs of the Hermitian Bell: λ and the projector
    onto their span."""
    kw = dict(r=3, k=N_H if method == "lanczos" else 300, tol=1e-10,
              method=method)
    jop = _jax_op("herm")
    lams_j, V_j = jax.jit(lambda v: jx.dominant_eigh_multi(
        jop.with_vals(v), **kw))(jop.vals)
    start = ({"v0": _t(_inputs()["v0"])} if method == "lanczos" else
             {"x0": _t(np.asarray(jax.random.normal(
                 jax.random.PRNGKey(0), (N_H, 3), jnp.float64)))})
    lams, V = port.dominant_eigh_multi(_port_op("herm"), device="cpu",
                                       **start, **kw)
    np.testing.assert_allclose(lams.numpy(), np.asarray(lams_j), rtol=1e-9)
    V_j = np.asarray(V_j)
    proj = V.numpy() @ V.numpy().conj().T
    assert np.abs(proj - V_j @ V_j.conj().T).max() <= 1e-7


def test_dominant_eig_on_a_non_hermitian_bell_matches_jax():
    """``dominant_eig`` (its rmatvec, the bilinear A^T, gives l) and the
    gradient of |λ|² in the values, against JAX's."""
    jop = _jax_op("nonherm")

    def run(vals):
        def loss(v):
            lam = jx.dominant_eig(jop.with_vals(v), solver="gmres")[0]
            return jnp.abs(lam) ** 2
        lam, l, r = jx.dominant_eig(jop.with_vals(vals), solver="gmres")
        return lam, jnp.outer(r, l), jax.grad(loss)(vals)

    lam_j, proj_j, grad_j = (np.asarray(t) for t in jax.jit(run)(jop.vals))
    op = _port_op("nonherm")
    vals = op.vals.clone().requires_grad_(True)
    lam, l, r = port.dominant_eig(op.with_vals(vals), solver="gmres",
                                  device="cpu")
    (lam.abs() ** 2).backward()
    assert abs(complex(lam.detach()) - complex(lam_j)) <= 1e-10 * abs(lam_j)
    # r l^T is the gauge-free spectral projector (l^T r = 1).
    assert _rel(torch.outer(r, l), proj_j) <= 1e-8
    assert _rel(vals.grad, np.conj(grad_j)) <= 1e-8


# -- autograd of the product itself ------------------------------------------

def _small_product_inputs(real_vals=False):
    d = _inputs()
    op = _port_op("band")
    vals = op.vals.real.contiguous() if real_vals else op.vals
    return (vals.clone().requires_grad_(True), op.cols,
            _t(d["x128"]).requires_grad_(True), op.slot_plan)


@pytest.mark.parametrize("check", [gradcheck, gradgradcheck],
                         ids=["gradcheck", "gradgradcheck"])
@pytest.mark.parametrize("plan", ["gather", "banded"])
def test_bell_product_complex_gradcheck(check, plan):
    """``_BellProduct`` on complex values and x: x̄ = A^H ȳ and
    vals̄ = ȳ x^H (fast mode; gradgradcheck differentiates the
    backward)."""
    vals, cols, x, band = _small_product_inputs()
    band = band if plan == "banded" else None
    assert check(lambda v, xx: spmv._BellProduct.apply(v, cols, xx, band),
                 (vals, x), fast_mode=True)


def test_bell_product_real_values_complex_x_gradcheck():
    """Real values with complex x: the values' gradient is the real part
    of ȳ x^H."""
    vals, cols, x, band = _small_product_inputs(real_vals=True)
    assert gradcheck(lambda v, xx: spmv._BellProduct.apply(v, cols, xx,
                                                           band),
                     (vals, x), fast_mode=True)


def test_vmap_of_a_complex_matvec_is_one_matmat(monkeypatch):
    op = _port_op("band")
    X = _t(_inputs()["X128"])
    calls = []
    product = spmv._product

    def counted(vals, cols, x, plan):
        calls.append(tuple(x.shape))
        return product(vals, cols, x, plan)

    monkeypatch.setattr(spmv, "_product", counted)
    got = torch.func.vmap(op.matvec, in_dims=1, out_dims=1)(X)
    assert calls == [tuple(X.shape)]
    assert torch.equal(got, op.matmat(X))


@pytest.mark.parametrize("shape", ["x", "X"])
def test_real_values_route_runs_one_real_product_on_re_im_columns(shape):
    """Real values times a complex vector on the card: one real product
    on the (re, im) columns (here through the plain product, which the
    kernel is held against on the card)."""
    d = _inputs()
    vals = _port_op("band").vals.real.contiguous()
    cols = _port_op("band").cols
    x = _t(d["x128"] if shape == "x" else d["X128"])
    seen = []

    def real_product(v, c, xr, plan):
        seen.append((xr.dtype, tuple(xr.shape)))
        return spmv._product(v, c, xr, plan)

    got = spmv._on_real_columns(real_product, vals, cols, x, None)
    width = 2 if shape == "x" else 2 * x.shape[1]
    assert seen == [(torch.float64, (N_B, width))]
    want = (spmv._bell_spmv_torch if shape == "x" else
            spmv._bell_spmm_torch)(vals, cols, x)
    assert got.dtype == C128 and got.shape == want.shape
    assert _rel(got, want.numpy()) <= 1e-14


class _Stop(Exception):
    pass


@pytest.mark.parametrize("lazy", ["x", "X", "vals", "real vals, x"])
def test_launch_hands_the_kernel_resolved_conjugate_views(monkeypatch,
                                                          lazy):
    """A lazily conjugated view (``x.conj()``) is contiguous and keeps
    the unconjugated values in its storage, which is what a kernel reads:
    ``_launch`` materializes it before it checks and passes pointers."""
    d = _inputs()
    op = _port_op("band")
    vals = op.vals.real.contiguous() if lazy.startswith("real") else op.vals
    x = _t(d["X128"] if lazy == "X" else d["x128"])
    if lazy == "vals":
        vals = vals.conj()
    else:
        x = x.conj()
    seen = {}

    def capture(v, c, xx, plan=None):
        seen.update(vals=v, x=xx)
        raise _Stop

    monkeypatch.setattr(spmv, "_check_kernel_args", capture)
    with pytest.raises(_Stop):
        spmv._launch(vals, op.cols, x, op.slot_plan)
    assert not seen["vals"].is_conj() and not seen["x"].is_conj()
    assert torch.equal(seen["vals"], vals) and torch.equal(seen["x"], x)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_bell_operator_from_numpy_carries_complex(dtype):
    d = _inputs()
    vals = d["band_vals"].astype(dtype)
    op = port.bell_operator_from_numpy(vals, d["band_cols"], N_B,
                                       symmetric=True, device="cpu")
    assert op.vals.dtype == op.dtype == _t(vals).dtype
    assert np.array_equal(op.vals.numpy(), vals)
    assert op.slot_plan == tuple(tuple(p) for p in d["band_plan"])
