"""The plain references against a dense float64 ``eigh`` at tiny sizes."""

import numpy as np
import pytest
import torch

from eigbench.reference import bell, krylov, lobpcg, tfim
from eigbench.reference.precision import Precision, round_tf32

F64 = Precision("f64")
SMALL_BELL = dict(n=512, bs=16, blocks_per_row=5, pattern_seed=7)


def _dense_bell(vals, cols):
    nb, m, bs, _ = vals.shape
    a = torch.zeros(nb * bs, nb * bs, dtype=torch.float64)
    for i in range(nb):
        for j in range(m):
            c = int(cols[i, j])
            a[i * bs:(i + 1) * bs, c * bs:(c + 1) * bs] += vals[i, j].double()
    return a


@pytest.fixture(scope="module")
def small_bell():
    vals, cols = bell.make_inputs(SMALL_BELL, 2**33 + 5, "cpu")
    return vals, cols, _dense_bell(vals, cols)


def test_bell_inputs_are_symmetric_and_fixed_in_pattern(small_bell):
    vals, cols, a = small_bell
    assert torch.equal(a, a.T)
    vals2, cols2 = bell.make_inputs(SMALL_BELL, 3, "cpu")
    assert torch.equal(cols, cols2) and not torch.equal(vals, vals2)
    vals3, _ = bell.make_inputs(SMALL_BELL, 2**33 + 5, "cpu")
    assert torch.equal(vals, vals3)


def test_bell_product_matches_dense(small_bell):
    vals, cols, a = small_bell
    x = torch.randn(a.shape[0], 3, dtype=torch.float64)
    y = bell.matmat(vals, cols, x, F64)
    assert torch.allclose(y, a @ x, rtol=0, atol=1e-12)
    y1 = bell.matmat(vals, cols, x[:, 0], F64)
    assert torch.allclose(y1, a @ x[:, 0], rtol=0, atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    # at exponent 1 a TF32 step is 2^-9: 3 + 2^-10 is a tie, away from 0
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-12, 3.0 + 2.0**-10])
    assert round_tf32(x).tolist() == [1.0 + 2.0**-10, 1.0, 3.0 + 2.0**-9]


def test_lanczos_full_space_gives_the_lowest_pair(small_bell):
    vals, cols, a = small_bell
    n = a.shape[0]
    evals, evecs = torch.linalg.eigh(a)
    v0 = torch.randn(n, generator=torch.Generator().manual_seed(1))
    lam, v = krylov.lanczos_min_pair(
        lambda x: bell.matmat(vals, cols, x, F64), v0, 160, 2, F64)
    assert lam == pytest.approx(float(evals[0]), rel=1e-9)
    assert min(float((v - evecs[:, 0]).norm()),
               float((v + evecs[:, 0]).norm())) < 1e-6
    assert float(v[torch.argmax(v.abs())]) > 0


def test_gradient_summary_matches_dense(small_bell):
    vals, cols, a = small_bell
    nb, m, bs, _ = vals.shape
    v = torch.randn(a.shape[0], 2, dtype=torch.float64)
    g = torch.einsum("iac,imbc->imab", v.reshape(nb, bs, 2),
                     v.reshape(nb, bs, 2)[cols.long()])
    rows = [1, 7]
    got = bell.grad_summary(v, v, cols, rows)
    want = bell.program_grad_summary(g, rows)
    assert bell.grad_gap(got, want) < 1e-12


def test_lobpcg_converges_to_the_lowest_block(small_bell):
    vals, cols, a = small_bell
    evals = torch.linalg.eigvalsh(a)
    x0 = torch.randn(a.shape[0], 3, generator=torch.Generator().manual_seed(2))
    lams, x, it = lobpcg.lobpcg_min(
        lambda z: bell.matmat(vals, cols, z, F64), x0, 500, 1e-10, 1e-14,
        F64)
    assert it < 500
    assert torch.allclose(lams, evals[:3], rtol=1e-8)
    assert torch.allclose(x.T @ x, torch.eye(3, dtype=torch.float64),
                          atol=1e-8)


def _dense_tfim(n, g):
    dim = 1 << n
    idx = np.arange(dim)
    h = np.zeros((dim, dim))
    for i in range(n):
        si = 1 - 2 * ((idx >> i) & 1)
        sj = 1 - 2 * ((idx >> ((i + 1) % n)) & 1)
        h[idx, idx] -= si * sj
        h[idx, idx ^ (1 << i)] -= g
    return torch.from_numpy(h)


def test_tfim_chain_matches_dense():
    n, g = 6, 1.3
    h = _dense_tfim(n, g)
    chain = tfim.Chain(n, g, F64)
    x = torch.randn(1 << n, dtype=torch.float64)
    assert torch.allclose(chain.matvec(x), h @ x, atol=1e-12)
    dh = _dense_tfim(n, g + 1.0) - h
    assert torch.allclose(chain.dmatvec(x), dh @ x, atol=1e-12)


def test_tfim_fidelity_reference_matches_dense():
    n, g = 6, 1.2
    h = _dense_tfim(n, g)
    evals, evecs = torch.linalg.eigh(h)
    chain = tfim.Chain(n, g, F64)
    v0 = torch.randn(1 << n, generator=torch.Generator().manual_seed(3))
    e0, psi = krylov.lanczos_min_pair(chain.matvec, v0, 40, 1, F64)
    assert e0 == pytest.approx(float(evals[0]), rel=1e-12)
    dpsi_a = chain.dmatvec(psi)
    de0 = float(torch.dot(psi, dpsi_a))
    dpsi, _ = krylov.deflated_cg(chain.matvec, e0, psi,
                                 -(dpsi_a - de0 * psi), 1e-12, 500)
    # sum over states: χ_F = Σ_{m>0} |<m|dH|0>|² / (E_m - E_0)²
    dh = _dense_tfim(n, g + 1.0) - h
    psi0 = evecs[:, 0]
    coup = evecs[:, 1:].T @ (dh @ psi0)
    chi = float((coup**2 / (evals[1:] - evals[0])**2).sum())
    assert de0 == pytest.approx(float(psi0 @ dh @ psi0), rel=1e-10)
    assert float(dpsi @ dpsi) == pytest.approx(chi, rel=1e-8)


def test_thick_restart_converges_to_the_ground_state():
    n, g = 8, 1.3
    evals = torch.linalg.eigvalsh(_dense_tfim(n, g))
    chain = tfim.Chain(n, g, F64)
    v0 = torch.randn(1 << n, generator=torch.Generator().manual_seed(4))
    e0, psi = krylov.thick_restart_min_pair(chain.matvec, v0, 16, 8, 1, F64)
    assert e0 == pytest.approx(float(evals[0]), rel=1e-10)
    assert float(torch.linalg.vector_norm(chain.matvec(psi) - e0 * psi)) \
        < 1e-6


def test_couplings_cover_every_stratum_each_cycle():
    t = {"g_range": [1.1, 1.45], "g_strata": 8}
    gs = tfim.couplings(t, 2**40 + 1, 16)
    assert all(1.1 <= g < 1.45 for g in gs)
    for cycle in (gs[:8], gs[8:]):
        strata = sorted(int((g - 1.1) / (0.35 / 8)) for g in cycle)
        assert strata == list(range(8))
    assert tfim.couplings(t, 2**40 + 1, 16) == gs
    assert tfim.couplings(t, 2**40 + 2, 16) != gs
