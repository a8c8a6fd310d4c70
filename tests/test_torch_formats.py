"""The port's COO, CSR and BCOO operators (``ops/sparse.py``) against the
JAX package's (CPU, f64), after ``tests/test_sparse.py:26-60`` and
``:150-243``: products, dense forms and round trips, ``dominant_eigh``
and its gradient in the stored values, CSR built under a transform,
LOBPCG on a CSR, format parity (``tests/test_fuzz.py:121``), forward
mode and the second derivative through a CSR of the TFIM, the
structural diagonal, and complex Hermitian values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dominantsparseeigenad_tpu.ops.eigh import dominant_eigh as jax_eigh
from dominantsparseeigenad_tpu.ops.lobpcg import lobpcg_eigh as jax_lobpcg
from dominantsparseeigenad_tpu.ops.observables import (
    energy_curvature as jax_curvature)
from dominantsparseeigenad_tpu.ops.observables import (
    fidelity_susceptibility as jax_chi)
from dominantsparseeigenad_tpu.ops.operators import DenseOperator as JaxDense
from dominantsparseeigenad_tpu.ops.operators import ScaledOperator as JaxScaled
from dominantsparseeigenad_tpu.ops.precond import (
    operator_diagonal as jax_diagonal)
from dominantsparseeigenad_tpu.ops.sparse import BCOOOperator as JaxBCOO
from dominantsparseeigenad_tpu.ops.sparse import COOOperator as JaxCOO
from dominantsparseeigenad_tpu.ops.sparse import CSROperator as JaxCSR

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

torch.set_num_threads(2)

F64 = torch.float64
FORMATS = ("coo", "csr", "bcoo")


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _random_sparse_sym(n, density=0.1, seed=0):
    """``tests/test_sparse.py::_random_sparse_sym``."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    return (a + a.T) / 2


def _jax_format(fmt, a):
    a = jnp.asarray(a)
    return {"coo": lambda: JaxCOO.from_dense(a),
            "csr": lambda: JaxCSR.from_dense(a),
            "bcoo": lambda: JaxBCOO(a)}[fmt]()


def _carried(fmt, jop):
    """The port's operator for the JAX one, through the converters."""
    if fmt == "coo":
        return port.coo_operator_from_numpy(
            np.asarray(jop.rows), np.asarray(jop.cols), np.asarray(jop.vals),
            jop.n, device="cpu")
    if fmt == "csr":
        return port.csr_operator_from_numpy(
            np.asarray(jop.indptr), np.asarray(jop.indices),
            np.asarray(jop.data), jop.n, device="cpu")
    return port.bcoo_operator_from_numpy(
        np.asarray(jop.mat.indices), np.asarray(jop.mat.data), jop.dim,
        device="cpu")


def _port_format(fmt, a):
    return {"coo": lambda: port.COOOperator.from_dense(a, device="cpu"),
            "csr": lambda: port.CSROperator.from_dense(a, device="cpu"),
            "bcoo": lambda: port.BCOOOperator(torch.from_numpy(a))}[fmt]()


def _values(jop):
    """The JAX operator's differentiable values."""
    return {JaxCOO: lambda: jop.vals, JaxCSR: lambda: jop.data,
            JaxBCOO: lambda: jop.mat.data}[type(jop)]()


@jax.jit
def _jax_products(op, x, X):
    return (op.matvec(x), op.rmatvec(x), op.matmat(X), op.rmatmat(X),
            op.to_dense())


@pytest.mark.parametrize("fmt", FORMATS)
def test_products_and_dense_forms_match_jax(fmt):
    """``tests/test_sparse.py:26-36, :150-175``: the four products and
    ``to_dense``, by the port's own constructor and by the converter;
    the stored arrays equal JAX's."""
    n = 96
    a = _random_sparse_sym(n, seed=11)
    a[3, 7] += 0.5                       # not symmetric: A^T x is its own
    jop = _jax_format(fmt, a)
    rng = np.random.default_rng(4)
    x, X = rng.standard_normal(n), rng.standard_normal((n, 3))
    want = _jax_products(jop, jnp.asarray(x), jnp.asarray(X))
    for op in (_port_format(fmt, a), _carried(fmt, jop)):
        xt, Xt = torch.from_numpy(x), torch.from_numpy(X)
        got = (op.matvec(xt), op.rmatvec(xt), op.matmat(Xt), op.rmatmat(Xt),
               op.to_dense())
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w) <= 1e-12
        assert op.nnz == int(np.count_nonzero(a)) and op.dim == n
        (vals,) = op.parameters()
        np.testing.assert_array_equal(vals.numpy(), np.asarray(_values(jop)))
    if fmt == "bcoo":
        np.testing.assert_array_equal(op.mat.to_dense().numpy(), a)
        np.testing.assert_array_equal(op.mat.values().numpy(),
                                      op.values.numpy())


def test_csr_round_trips_match_jax():
    """``tests/test_sparse.py:160-175``: ``from_scipy`` (duplicates
    summed, the canonical CSR) and ``to_coo`` give the same matrix, and
    the arrays are JAX's."""
    n = 96
    a = _random_sparse_sym(n, seed=11)
    jop = JaxCSR.from_dense(jnp.asarray(a))
    op = port.CSROperator.from_dense(a, device="cpu")
    for name in ("indptr", "indices", "_rows"):
        np.testing.assert_array_equal(getattr(op, name).numpy(),
                                      np.asarray(getattr(jop, name)))
    # A COO with a duplicate entry: scipy sums it on the way in.
    rows, cols = np.nonzero(a)
    dup = sp.coo_matrix((np.r_[a[rows, cols], 1.0], (np.r_[rows, 0],
                                                      np.r_[cols, 0])),
                        shape=(n, n))
    want = a.copy()
    want[0, 0] += 1.0
    from_sp = port.CSROperator.from_scipy(dup, device="cpu")
    np.testing.assert_allclose(from_sp.to_dense().numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(
        from_sp.to_dense().numpy(),
        np.asarray(JaxCSR.from_scipy(dup).to_dense()), rtol=1e-12)
    coo = op.to_coo()
    assert isinstance(coo, port.COOOperator)
    np.testing.assert_allclose(coo.to_dense().numpy(),
                               np.asarray(jop.to_coo().to_dense()),
                               rtol=1e-12)


def test_csr_from_scipy_rejects_rectangular():
    """``tests/test_sparse.py:235``."""
    with pytest.raises(ValueError, match="square-only"):
        port.CSROperator.from_scipy(sp.random(6, 9, density=0.5,
                                              format="csr"), device="cpu")


@pytest.mark.parametrize("fmt", FORMATS)
def test_dominant_eigh_and_value_gradient_match_jax(fmt):
    """``tests/test_sparse.py:39-60, :178-210``: λ of ``dominant_eigh``
    within 1e-10 and the gradient of λ + Σv⁴ in the stored values within
    1e-8 of JAX's (deflated solves at 1e-12)."""
    n = 64
    a = _random_sparse_sym(n, seed=12)
    jop = _jax_format(fmt, a)

    def loss_jax(vals):
        if fmt == "coo":
            o = JaxCOO(jop.rows, jop.cols, vals, n)
        elif fmt == "csr":
            o = JaxCSR(jop.indptr, jop.indices, vals, n, jop._rows)
        else:
            import jax.experimental.sparse as jsparse
            o = JaxBCOO(jsparse.BCOO((vals, jop.mat.indices),
                                     shape=jop.mat.shape))
        lam, v = jax_eigh(o, k=n, extreme="min", tol=1e-12)
        return lam + jnp.sum(v ** 4), lam

    (_, lam_j), g_j = jax.jit(jax.value_and_grad(loss_jax, has_aux=True))(
        _values(jop))
    op = _carried(fmt, jop)
    (vals,) = op.parameters()
    vals = vals.clone().requires_grad_(True)
    lam, v = port.dominant_eigh(op.with_parameters([vals]), k=n, tol=1e-12,
                                device="cpu")
    (g,) = torch.autograd.grad(lam + (v ** 4).sum(), vals)
    np.testing.assert_allclose(float(lam.detach()), float(lam_j),
                               rtol=1e-10)
    np.testing.assert_allclose(float(lam.detach()), np.linalg.eigvalsh(a)[0],
                               rtol=1e-10)
    assert _rel(g.numpy(), g_j) <= 1e-8


def test_csr_constructible_under_transforms():
    """``tests/test_sparse.py:213-232``: the derived row index needs no
    host read, so a CSR built inside ``torch.func.vmap`` and
    ``torch.func.jvp`` (from the 4-argument constructor) gives the
    products of the matrices it stands for."""
    rng = np.random.default_rng(31)
    a = np.where(rng.random((12, 12)) < 0.3, rng.standard_normal((12, 12)),
                 0.0)
    base = port.CSROperator.from_dense(a, device="cpu")
    x = torch.from_numpy(rng.standard_normal(12))
    scales = torch.tensor([1.0, -2.0, 0.5], dtype=F64)

    def mv(data):
        op = port.CSROperator(base.indptr, base.indices, data, 12)
        return torch.stack([op.matvec(x), op.rmatvec(x)])

    got = torch.func.vmap(mv)(scales[:, None] * base.data)
    for s, g in zip(scales, got):
        np.testing.assert_allclose(g[0].numpy(), float(s) * a @ x.numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(g[1].numpy(), float(s) * a.T @ x.numpy(),
                                   atol=1e-12)
    _, tangent = torch.func.jvp(mv, (base.data,), (base.data,))
    np.testing.assert_allclose(tangent[0].numpy(), a @ x.numpy(), atol=1e-12)


def test_lobpcg_on_a_csr_matches_jax():
    """The LOBPCG half of ``tests/test_sparse.py:244``: the block solver
    on a CSR (every A @ X one segment-sum product), against numpy and
    JAX (different start blocks: converged values compared)."""
    n, r = 150, 3
    a = _random_sparse_sym(n, seed=13)
    ew = np.linalg.eigvalsh(a)
    lams_j, _, info_j = jax.jit(lambda o: jax_lobpcg(
        o, r, tol=1e-6, maxiter=600, with_info=True))(
        JaxCSR.from_dense(jnp.asarray(a)))
    lams, _, info = port.lobpcg_eigh(
        port.CSROperator.from_dense(a, device="cpu"), r, tol=1e-6,
        maxiter=600, with_info=True, device="cpu")
    assert float(info.converged) == 1.0 and float(info_j.converged) == 1.0
    np.testing.assert_allclose(lams.numpy(), ew[:r], rtol=1e-7)
    np.testing.assert_allclose(lams.numpy(), np.asarray(lams_j), rtol=1e-7)


N_PARITY = 48


@jax.jit
def _jax_dense_value_grad(a, t):
    return jax.value_and_grad(lambda t: jax_eigh(
        JaxDense(t * a), k=a.shape[0], extreme="min")[0])(t)


def _parity_ops(a_np, t):
    """``tests/test_fuzz.py:121``'s formats, each scaled by ``t``."""
    n = a_np.shape[0]
    rows, cols = np.nonzero(a_np)
    csr = sp.csr_matrix(a_np)
    at = torch.from_numpy(a_np)
    return {
        "dense": port.DenseOperator(t * at),
        "coo": port.COOOperator(torch.from_numpy(rows), torch.from_numpy(cols),
                                t * at[rows, cols], n),
        "csr": port.CSROperator(torch.from_numpy(csr.indptr),
                                torch.from_numpy(csr.indices),
                                t * torch.from_numpy(csr.data), n),
        "bcoo": port.BCOOOperator(at).with_parameters(
            [t * at[rows, cols]]),
        "mf": port.MatrixFreeOperator(lambda p, x: p * (at @ x), t, n,
                                      dtype=F64),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_format_parity(seed):
    """The same random sparse symmetric matrix in every format gives the
    same λ and dλ/dt in a global scale t (``tests/test_fuzz.py:121``),
    held against JAX's dense."""
    rng = np.random.default_rng(3000 + seed)
    a_np = rng.standard_normal((N_PARITY, N_PARITY)) \
        * (rng.random((N_PARITY, N_PARITY)) < 0.2)
    a_np = (a_np + a_np.T) / 2
    val_j, g_j = _jax_dense_value_grad(jnp.asarray(a_np), 1.0)
    np.testing.assert_allclose(float(val_j), np.linalg.eigvalsh(a_np)[0],
                               rtol=1e-9)
    for name in ("dense", "coo", "csr", "bcoo", "mf"):
        t = torch.tensor(1.0, dtype=F64, requires_grad=True)
        lam, _ = port.dominant_eigh(_parity_ops(a_np, t)[name], k=N_PARITY,
                                    device="cpu")
        (g,) = torch.autograd.grad(lam, t)
        np.testing.assert_allclose(float(lam.detach()), float(val_j),
                                   rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(float(g), float(g_j), rtol=1e-7,
                                   err_msg=name)


TFIM_N, TFIM_G = 8, 1.2


def _tfim_triplets(n):
    """The N-spin TFIM as sparse parts: the zz diagonal, and the
    transverse term's entries (state s to s ^ (1 << i), value 1), both
    row-major (numpy)."""
    s = np.arange(1 << n)
    spins = 1 - 2 * ((s[:, None] >> np.arange(n)) & 1)
    zz = -(spins * np.roll(spins, -1, axis=1)).sum(axis=1).astype(np.float64)
    cols = (s[:, None] ^ (1 << np.arange(n))).reshape(-1)
    return zz, cols, np.ones(cols.shape[0])


def _tfim_csr_parts(ns_csr, to_index, to_vals, n):
    zz, cols, ones = _tfim_triplets(n)
    dim = 1 << n
    return (ns_csr(to_index(np.arange(dim + 1)), to_index(np.arange(dim)),
                   to_vals(zz), dim),
            ns_csr(to_index(np.arange(dim + 1) * n), to_index(cols),
                   to_vals(ones), dim))


@jax.jit
def _jax_tfim(g):
    zz, x = _tfim_csr_parts(JaxCSR, lambda a: jnp.asarray(a, jnp.int32),
                            jnp.asarray, TFIM_N)

    def make(gg):
        return zz + JaxScaled(x, -gg)

    kw = dict(k=256, tol=1e-12)
    return (*jax_curvature(make, g, **kw), jax_chi(make, g, **kw))


def test_tfim_csr_forward_mode_and_curvature_match_jax():
    """H(g) = CSR_zz + (-g) CSR_x at N = 8 through the algebra: E0,
    dE0/dg and d²E0/dg² by ``energy_curvature`` (a jvp of a jvp), dE0/dg
    by ``torch.func.jvp`` and χ_F by ``fidelity_susceptibility``, against
    JAX on the same operators, and E0 against the matrix-free
    ``tfim_operator``."""
    zz, x = _tfim_csr_parts(port.CSROperator, torch.from_numpy,
                            torch.from_numpy, TFIM_N)

    def make(gg):
        return zz + (-gg) * x

    kw = dict(k=256, tol=1e-12, device="cpu")
    g = torch.tensor(TFIM_G, dtype=F64)
    e, d1, d2 = port.energy_curvature(make, g, **kw)
    _, d1_fwd = torch.func.jvp(
        lambda gg: port.dominant_eigh(make(gg), **kw)[0], (g,),
        (torch.ones_like(g),))
    chi = port.fidelity_susceptibility(make, g, **kw)
    want = [float(t) for t in _jax_tfim(jnp.float64(TFIM_G))]
    np.testing.assert_allclose(float(e), want[0], rtol=1e-12)
    np.testing.assert_allclose(float(d1), want[1], rtol=1e-9)
    np.testing.assert_allclose(float(d1_fwd), want[1], rtol=1e-9)
    np.testing.assert_allclose(float(d2), want[2], rtol=1e-7)
    np.testing.assert_allclose(float(chi), want[3], rtol=1e-7)
    e_mf, _ = port.dominant_eigh(models.tfim_operator(TFIM_N, TFIM_G,
                                                      device="cpu"), **kw)
    np.testing.assert_allclose(float(e), float(e_mf), rtol=1e-12)


@pytest.mark.parametrize("fmt", FORMATS)
def test_operator_diagonal_matches_jax(fmt):
    """``tests/test_precond.py:41-82``'s matrix: the segment sum of the
    diagonal entries, equal to JAX's (no arithmetic but adding zeros)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64)) * (rng.random((64, 64)) < 0.3)
    a = (a + a.T) / 2
    np.fill_diagonal(a, rng.standard_normal(64))
    jop = _jax_format(fmt, a)
    got = port.operator_diagonal(_carried(fmt, jop)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_diagonal(jop)))
    np.testing.assert_array_equal(got, np.diagonal(a))


@jax.jit
def _jax_complex_eigh(op):
    def loss(vals):
        lam, v = jax_eigh(JaxCOO(op.rows, op.cols, vals, op.n), k=op.n,
                          extreme="min", tol=1e-12)
        return lam + jnp.sum(jnp.abs(v) ** 4), lam
    return jax.value_and_grad(loss, has_aux=True)(op.vals)


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_complex_hermitian_values_match_jax(fmt):
    """A complex Hermitian sparse matrix in COO and CSR form: λ within
    1e-10 of JAX's, and the gradient of the gauge-invariant λ + Σ|v|⁴ in
    the complex values within 1e-8 of the conjugate of JAX's (the
    port's convention for a complex leaf)."""
    n = 48
    rng = np.random.default_rng(17)
    b = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) \
        * (rng.random((n, n)) < 0.15)
    h = (b + b.conj().T) / 2
    jcoo = JaxCOO.from_dense(jnp.asarray(h))
    (_, lam_j), g_j = _jax_complex_eigh(jcoo)
    op = _port_format(fmt, h)
    assert op.dtype == torch.complex128
    (vals,) = op.parameters()
    vals = vals.clone().requires_grad_(True)
    lam, v = port.dominant_eigh(op.with_parameters([vals]), k=n, tol=1e-12,
                                device="cpu")
    (g,) = torch.autograd.grad(lam + (v.abs() ** 4).sum(), vals)
    np.testing.assert_allclose(float(lam.detach()), float(lam_j),
                               rtol=1e-10)
    np.testing.assert_allclose(float(lam.detach()), np.linalg.eigvalsh(h)[0],
                               rtol=1e-10)
    # The same entries in the same (row-major) order in both formats.
    assert _rel(g.numpy(), np.conj(np.asarray(g_j))) <= 1e-8
