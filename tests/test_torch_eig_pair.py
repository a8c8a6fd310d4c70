"""The complex half of the port's non-symmetric solver
(``dominant_eig_pair``, ``dominant_eig_spectrum``, ``spectrum_structure``)
against the JAX package's (CPU, f64), on real operators whose spectra
mix real eigenvalues and complex-conjugate pairs (after
``tests/test_eig.py:327-640`` and ``examples/complex_spectrum.py``):
values and both eigenvectors, the gauge and the bilinear normalization,
reverse and forward mode, the fixed-structure cascade to second order,
the defective-pair contract and the raise at discovery, and complex128
gradcheck/gradgradcheck of the pair rule.

The pair's outputs are complex and its parameters real, so a gradient is
the same number in both packages.  The JAX order-2 replay is a jvp of a
jvp; the port's forward mode is first order (PyTorch does not nest dual
levels), so it is held by reverse over reverse here.  JAX references are
jitted once per shape and reused.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.autograd import gradcheck, gradgradcheck

import dominantsparseeigenad_tpu as jx
from dominantsparseeigenad_tpu.ops import eig as jax_eig_mod

import dominantsparseeigenad_tpu_torch as port

eig_mod = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.eig")

torch.set_num_threads(2)

F64 = torch.float64
N = 24
ITERS, PTOL = 800, 1e-13


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _rot(rho, th):
    return rho * np.array([[np.cos(th), -np.sin(th)],
                           [np.sin(th), np.cos(th)]])


def _conjugated(blk, seed):
    """``Q blk Qᵀ`` for a random orthogonal Q: the spectrum of blk."""
    n = blk.shape[0]
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    return q @ blk @ q.T


def _pair_dominant(seed, th=0.7, rho=3.0, rest=1.5):
    rng = np.random.default_rng(seed)
    blk = np.zeros((N, N))
    blk[:2, :2] = _rot(rho, th)
    blk[2:, 2:] = np.diag(rest * rng.random(N - 2))
    return _conjugated(blk, seed + 1)


def _s(x):
    return torch.tensor(float(x), dtype=F64)


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _jax_pair():
    """JAX's pair solve with its report, jitted once for every (N, N)
    input of this module."""
    return jax.jit(lambda a: jx.dominant_eig_pair(
        a, num_iters=ITERS, power_tol=PTOL, with_info=True))


def _port_pair(a, **kw):
    return port.dominant_eig_pair(torch.as_tensor(a), num_iters=ITERS,
                                  power_tol=PTOL, with_info=True,
                                  device="cpu", **kw)


def _grad_and_jvp(f):
    t = _s(0.0).requires_grad_(True)
    (g,) = torch.autograd.grad(f(t), t)
    with fwAD.dual_level():
        jv = fwAD.unpack_dual(f(fwAD.make_dual(_s(0.0), _s(1.0)))).tangent
    return float(g), float(jv)


def _fd(f, eps=1e-6):
    return (float(f(_s(eps))) - float(f(_s(-eps)))) / (2 * eps)


def test_dominant_eig_pair_complex_dominant():
    """A dominant conjugate pair 3 e^{±0.7i}: λ (the Im > 0 member), l
    and r equal JAX's, λ the exact one, both residuals vanish, l^T r = 1
    (bilinear) and r's pivot entry is real and positive."""
    a = _pair_dominant(95)
    lam, l, r, info = _port_pair(a)
    want = _jax_pair()(jnp.asarray(a))
    for got, w in zip((lam, l, r), want[:3]):
        assert _err(got, w) <= 1e-9
    assert float(info.converged) == float(want[3].converged) == 1.0
    assert abs(complex(lam) - 3.0 * np.exp(0.7j)) <= 1e-11
    rn, ln = r.numpy(), l.numpy()
    assert np.linalg.norm(a @ rn - complex(lam) * rn) < 1e-10
    assert np.linalg.norm(a.T @ ln - complex(lam) * ln) < 1e-9
    assert abs(complex((l * r).sum()) - 1.0) <= 1e-12
    pivot = complex(r[torch.argmax(r.abs())])
    assert abs(pivot.imag) < 1e-14 and pivot.real > 0


def test_discovery_matches_jax():
    """Discovery on a dominant pair with m = 1: the Arnoldi probe flags
    the stage, the pair solve fills both slots; the structure (and
    ``spectrum_structure``'s) and the triples equal JAX's discovery run
    (eager, host decisions in both)."""
    a = _pair_dominant(95)
    lams, ls, rs, structure = _port_spectrum(a, 1)
    want = jx.dominant_eig_spectrum(jnp.asarray(a), m=1, num_iters=ITERS,
                                    power_tol=PTOL)
    assert structure == want[3] == ("pair",)
    assert port.spectrum_structure(torch.from_numpy(a), m=1,
                                   num_iters=ITERS, power_tol=PTOL,
                                   device="cpu") == want[3]
    for got, w in zip((lams, ls, rs), want[:3]):
        assert _err(got, w) <= 1e-9


def test_dominant_eig_pair_gradients():
    """d|λ|/dt and d arg λ/dt along a real direction, through the pair
    rule on the lifted operator, by reverse and forward mode, against
    JAX's gradients (1e-8) and a central difference (2e-5)."""
    a0 = _pair_dominant(96, th=0.5, rest=1.2)
    a1 = 0.3 * np.random.default_rng(97).standard_normal((N, N))

    def stats(lam, pkg):
        return (pkg.abs(lam), pkg.angle(lam))

    def jax_f(t):
        lam = jx.dominant_eig_pair(jnp.asarray(a0) + t * jnp.asarray(a1),
                                   num_iters=ITERS, power_tol=PTOL)[0]
        return jnp.stack(stats(lam, jnp))

    jac = np.asarray(jax.jit(jax.jacrev(jax_f))(jnp.float64(0.0)))
    for i in range(2):
        def f(t, i=i):
            lam = port.dominant_eig_pair(
                torch.from_numpy(a0) + t * torch.from_numpy(a1),
                num_iters=ITERS, power_tol=PTOL, device="cpu")[0]
            return stats(lam, torch)[i]

        g, jv = _grad_and_jvp(f)
        assert abs(g - jac[i]) <= 1e-8 * abs(jac[i])
        assert abs(jv - g) <= 1e-10 * abs(g)
        assert abs(g - _fd(f)) <= 2e-5 * abs(g)


def test_dominant_eig_pair_real_degenerate_case():
    """A dominant real simple eigenvalue (a positive matrix) comes out
    real, as ``dominant_eig``'s, and as JAX's pair solve gives it."""
    a = np.random.default_rng(98).uniform(size=(N, N)) + 0.1
    lam, l, r, _ = _port_pair(a)
    want = _jax_pair()(jnp.asarray(a))
    assert _err(lam, want[0]) <= 1e-11 and _err(r, want[2]) <= 1e-9
    assert abs(complex(lam).imag) < 1e-12
    lam_1d = port.dominant_eig(torch.from_numpy(a), device="cpu")[0]
    assert abs(complex(lam).real - float(lam_1d)) <= 1e-11 * float(lam_1d)


def test_dominant_eig_pair_negative_dominant_real():
    """Spectrum {-5, 2, ...}: the larger-magnitude root -5 (not the
    subdominant 2), converged, r JAX's, and d|λ|/dt = -1 exactly along
    the direction that moves only -5."""
    rng = np.random.default_rng(98)
    d = np.concatenate([[-5.0, 2.0], 0.8 * rng.standard_normal(N - 2)])
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    a = q @ np.diag(d) @ q.T
    a1 = np.outer(q[:, 0], q[:, 0])
    lam, _, r, info = _port_pair(a)
    want = _jax_pair()(jnp.asarray(a))
    assert abs(complex(lam) + 5.0) <= 1e-12 and _err(r, want[2]) <= 1e-9
    assert float(info.converged) == 1.0
    assert np.linalg.norm(a @ r.numpy() + 5.0 * r.numpy()) < 1e-10
    t = _s(0.0).requires_grad_(True)
    lam = port.dominant_eig_pair(torch.from_numpy(a) + t
                                 * torch.from_numpy(a1), num_iters=ITERS,
                                 power_tol=PTOL, device="cpu")[0]
    (g,) = torch.autograd.grad(lam.abs(), t)
    assert abs(float(g) + 1.0) <= 1e-9


def test_pair_defective_guard_finite_and_flagged():
    """An exactly defective dominant pair (Jordan-coupled rotations,
    l^T r -> 0): λ finite and of the right modulus, l and r finite, and
    ``converged`` 0 in both packages."""
    m = np.zeros((4, 4))
    m[:2, :2] = m[2:, 2:] = _rot(1.3, 0.7)
    m[:2, 2:] = np.eye(2)
    lam, l, r, info = port.dominant_eig_pair(torch.from_numpy(m),
                                             num_iters=400, with_info=True,
                                             device="cpu")
    want = jax.jit(lambda x: jx.dominant_eig_pair(x, num_iters=400,
                                                  with_info=True))(
        jnp.asarray(m))
    for t in (lam, l, r):
        assert bool(torch.isfinite(torch.view_as_real(t.reshape(-1))).all())
    assert abs(abs(complex(lam)) - 1.3) <= 1e-2
    assert float(info.converged) == float(want[3].converged) == 0.0


def _mixed(seed=101):
    """Real 3, pair 2.8 e^{±0.8i}, real -2.2, pair 1.5 e^{±1.9i}, then
    |λ| < 0.4."""
    blk = np.zeros((N, N))
    blk[0, 0] = 3.0
    blk[1:3, 1:3] = _rot(2.8, 0.8)
    blk[3, 3] = -2.2
    blk[4:6, 4:6] = _rot(1.5, 1.9)
    blk[6:, 6:] = np.diag(0.4 * np.random.default_rng(seed).random(N - 6))
    return _conjugated(blk, seed + 1)


def _replay(structure, m):
    """JAX's fixed-structure cascade, jitted once per structure."""
    return jax.jit(lambda a: jx.dominant_eig_spectrum(
        a, m=m, num_iters=ITERS, power_tol=PTOL, structure=structure)[:3])


def _port_spectrum(a, m, **kw):
    return port.dominant_eig_spectrum(torch.as_tensor(a), m=m,
                                      num_iters=ITERS, power_tol=PTOL,
                                      device="cpu", **kw)


def test_dominant_eig_spectrum_mixed_real_and_pairs():
    """Top 6 of a mixed spectrum: the structure the JAX test finds for
    this construction, every λ_j, l_j and r_j equal to JAX's cascade of
    that structure, the values numpy's, each triple an eigentriple of the
    ORIGINAL operator with l_j^T r_j = 1."""
    a = _mixed()
    lams, ls, rs, structure = _port_spectrum(a, 6)
    assert structure == ("real", "pair", "real", "pair")
    want = _replay(structure, 6)(jnp.asarray(a))
    for got, w in zip((lams, ls, rs), want):
        assert _err(got, w) <= 1e-8
    w = np.linalg.eigvals(a)
    w = w[np.argsort(-np.abs(w))][:6]
    assert _err(np.sort_complex(lams.numpy()), np.sort_complex(w)) <= 1e-10
    for j in range(6):
        r_j, lam_j = rs[:, j].numpy(), complex(lams[j])
        assert np.linalg.norm(a @ r_j - lam_j * r_j) < 1e-9
        assert abs(complex((ls[:, j] * rs[:, j]).sum()) - 1.0) <= 1e-10


def test_dominant_eig_spectrum_gradients_with_structure():
    """The replayed cascade is differentiable: d Σ|λ_j|² / dt over a
    mixed spectrum against JAX's gradient (1e-8) and a central
    difference (2e-5), by reverse and forward mode."""
    blk = np.zeros((N, N))
    blk[0, 0] = 3.0
    blk[1:3, 1:3] = _rot(2.5, 0.6)
    blk[3:, 3:] = np.diag(0.8 * np.random.default_rng(102).random(N - 3))
    a0 = _conjugated(blk, 103)
    a1 = 0.2 * np.random.default_rng(104).standard_normal((N, N))
    structure = port.spectrum_structure(torch.from_numpy(a0), m=3,
                                        num_iters=ITERS, power_tol=PTOL,
                                        device="cpu")
    assert structure == ("real", "pair")

    def f(t):
        lams = _port_spectrum(torch.from_numpy(a0) + t * torch.from_numpy(a1),
                              3, structure=structure)[0]
        return (lams.abs() ** 2).sum()

    g_j = jax.jit(jax.grad(lambda t: jnp.sum(jnp.abs(jx.dominant_eig_spectrum(
        jnp.asarray(a0) + t * jnp.asarray(a1), m=3, num_iters=ITERS,
        power_tol=PTOL, structure=structure)[0]) ** 2)))(jnp.float64(0.0))
    g, jv = _grad_and_jvp(f)
    assert abs(g - float(g_j)) <= 1e-8 * abs(g)
    assert abs(jv - g) <= 1e-9 * abs(g)
    assert abs(g - _fd(f)) <= 2e-5 * abs(g)


@pytest.mark.parametrize("second", [5.0 - 1e-4, -5.0], ids=["near", "tie"])
def test_dominant_eig_spectrum_degenerate_real_cluster(second):
    """A real cluster of (nearly) tied moduli, {5, 5 - 1e-4, 2} as in the
    JAX test or {5, -5, 2}.  A stage the 1-D probe cannot certify (the
    exact tie, and the near one where the Arnoldi sweep does not resolve
    it) is solved as a pair whose λ comes out real: it takes ONE slot
    ("pair_real") and deflates rank-1.  The values are numpy's, the
    replay gives the same, and so does JAX's replay of that structure."""
    rng = np.random.default_rng(103)
    d = np.concatenate([[5.0, second, 2.0],
                        0.8 * rng.standard_normal(N - 3)])
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    a = q @ np.diag(d) @ q.T
    kw = dict(num_iters=2000)
    lams, _, _, structure = port.dominant_eig_spectrum(
        torch.from_numpy(a), m=3, power_tol=1e-12, device="cpu", **kw)
    assert np.abs(lams.numpy().imag).max() < 1e-8
    np.testing.assert_allclose(np.sort(lams.numpy().real),
                               np.sort([5.0, second, 2.0]), rtol=1e-6)
    if second < 0:
        assert structure[0] == "pair_real"
    else:
        assert "pair_real" in structure or structure == ("real",) * 3
    again = port.dominant_eig_spectrum(torch.from_numpy(a), m=3,
                                       power_tol=1e-12, structure=structure,
                                       device="cpu", **kw)[0]
    assert _err(np.sort(again.numpy().real), np.sort(lams.numpy().real)) \
        <= 1e-10
    want = jax.jit(lambda x: jx.dominant_eig_spectrum(
        x, m=3, power_tol=1e-12, structure=structure, **kw)[0])(
        jnp.asarray(a))
    assert _err(np.sort(lams.numpy().real), np.sort(np.asarray(want).real)) \
        <= 1e-6


def test_dominant_eig_spectrum_never_splits_a_pair():
    """m = 2 falls on the first member of a pair: both come back (three
    values, conjugates adjacent), as in JAX's cascade, and a replay keeps
    the length."""
    blk = np.zeros((N, N))
    blk[0, 0] = 3.0
    blk[1:3, 1:3] = _rot(2.5, 0.7)
    blk[3:, 3:] = np.diag(0.5 * np.random.default_rng(104).random(N - 3))
    a = _conjugated(blk, 105)
    lams, ls, rs, structure = _port_spectrum(a, 2)
    assert structure == ("real", "pair")
    assert lams.shape == (3,) and ls.shape == rs.shape == (N, 3)
    assert complex(lams[2]) == complex(lams[1]).conjugate()
    want = _replay(structure, 2)(jnp.asarray(a))
    for got, w in zip((lams, ls, rs), want):
        assert _err(got, w) <= 1e-8
    assert _port_spectrum(a, 2, structure=structure)[0].shape == (3,)


def _reverse_over_reverse(f, x):
    """``(f(x), f'(x), f''(x))`` by two reverse passes."""
    x = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    val = f(x)
    (d1,) = torch.autograd.grad(val, x, create_graph=True)
    (d2,) = torch.autograd.grad(d1, x)
    return val.detach(), d1.detach(), d2


def _order2_mixed(derivatives):
    """``spectrum_structure`` once, then the replay of a mixed structure
    to second order by ``derivatives(f, 0.0)``: d/dt and d²/dt² of
    Σ|λ_j|² (top 4) against JAX's jvp of a jvp (1e-7, 1e-6) and the dense
    oracle's differences (1e-6, 1e-3)."""
    blk = np.zeros((N, N))
    blk[0, 0] = 6.0
    blk[1:3, 1:3] = np.array([[4.0, 3.0], [-3.0, 4.0]])
    blk[3, 3] = 4.2
    blk[4:, 4:] = np.diag(1.5 * np.random.default_rng(103).random(N - 4))
    a0 = _conjugated(blk, 106)
    da = 0.1 * np.random.default_rng(107).standard_normal((N, N))
    structure = port.spectrum_structure(torch.from_numpy(a0), m=4,
                                        num_iters=ITERS, power_tol=PTOL,
                                        device="cpu")
    assert structure == ("real", "pair", "real")

    def f(t):
        lams = _port_spectrum(torch.from_numpy(a0) + t * torch.from_numpy(da),
                              4, structure=structure)[0]
        return (lams.abs() ** 2).sum()

    val, d1, d2 = derivatives(f, 0.0)

    def fj(t):
        lams = jx.dominant_eig_spectrum(
            jnp.asarray(a0) + t * jnp.asarray(da), m=4, num_iters=ITERS,
            power_tol=PTOL, structure=structure)[0]
        return jnp.sum(jnp.abs(lams) ** 2)

    _, d1_j, d2_j = jax.jit(lambda t: jx.ops.observables.value_d1_d2(fj, t))(
        jnp.float64(0.0))

    def oracle(t):
        w = np.linalg.eigvals(a0 + t * da)
        return float(np.sum(np.abs(w[np.argsort(-np.abs(w))][:4]) ** 2))

    eps = 1e-4
    num1 = (oracle(eps) - oracle(-eps)) / (2 * eps)
    num2 = (oracle(eps) - 2 * oracle(0.0) + oracle(-eps)) / eps ** 2
    assert abs(float(val) - oracle(0.0)) <= 1e-9 * oracle(0.0)
    assert abs(float(d1) - float(d1_j)) <= 1e-7 * abs(num1)
    assert abs(float(d2) - float(d2_j)) <= 1e-6 * abs(num2)
    assert abs(float(d1) - num1) <= 1e-6 * abs(num1)
    assert abs(float(d2) - num2) <= 1e-3 * abs(num2)


def test_spectrum_structure_replay_order2_mixed():
    """The replay to second order by reverse over reverse (see
    :func:`_order2_mixed`)."""
    _order2_mixed(_reverse_over_reverse)


def test_spectrum_structure_replay_order2_mixed_forward():
    """Its twin by forward over forward, as JAX nests forward mode:
    ``value_d1_d2``, a ``torch.func.jvp`` of a ``torch.func.jvp``."""
    _order2_mixed(lambda f, x: port.value_d1_d2(f, x, device="cpu"))


def test_spectrum_raises_on_a_defective_pair(monkeypatch):
    """Discovery raises on a numerically defective pair (left/right
    cosine below 1000 eps), whose projector has no finite deflation; so
    does JAX's.  The pair solve is given the exact (λ, l, r) of a
    Jordan-coupled rotation (l ⟂ r bilinearly), what a converged solve
    would return; a subspace iteration only approaches it as 1/k."""
    m = np.zeros((4, 4))
    m[:2, :2] = m[2:, 2:] = _rot(1.3, 0.7)
    m[:2, 2:] = np.eye(2)
    lam = 1.3 * np.exp(0.7j)
    r = np.array([1.0, -1.0j, 0.0, 0.0]) / np.sqrt(2)
    l = np.array([0.0, 0.0, 1.0, 1.0j]) / np.sqrt(2)
    assert np.allclose(m @ r, lam * r) and np.allclose(m.T @ l, lam * l)
    assert abs(l @ r) == 0.0

    monkeypatch.setattr(eig_mod, "dominant_eig_pair", lambda *a, **k: tuple(
        torch.tensor(x) for x in (lam, l, r)))
    monkeypatch.setattr(jax_eig_mod, "dominant_eig_pair",
                        lambda *a, **k: tuple(jnp.asarray(x)
                                              for x in (lam, l, r)))
    with pytest.raises(RuntimeError, match="numerically defective"):
        port.dominant_eig_spectrum(torch.from_numpy(m), m=2, num_iters=50,
                                   device="cpu")
    with pytest.raises(RuntimeError, match="numerically defective"):
        jx.dominant_eig_spectrum(jnp.asarray(m), m=2, num_iters=50)


def test_biased_transfer_phase_gradient_is_one():
    """``examples/complex_spectrum.py``'s biased transfer operator: the
    bias rotates the sub-dominant pair to 1.5 e^{±ib}, so d arg λ₂ / db
    = 1 exactly, through the replayed cascade; the spectrum numpy's."""
    bias = 0.25
    blk = np.zeros((N, N))
    blk[0, 0], blk[3, 3] = 2.0, 1.05
    blk[4:, 4:] = np.diag(0.6 * np.random.default_rng(0).random(N - 4))
    q, _ = np.linalg.qr(np.random.default_rng(1).standard_normal((N, N)))

    def biased(b, pkg):
        sub = 1.5 * pkg.stack([pkg.stack([pkg.cos(b), -pkg.sin(b)]),
                               pkg.stack([pkg.sin(b), pkg.cos(b)])])
        if pkg is torch:
            a = torch.from_numpy(blk).clone()
            a[1:3, 1:3] = sub
            qt = torch.from_numpy(q)
            return qt @ a @ qt.T
        a = jnp.asarray(blk).at[1:3, 1:3].set(sub)
        return jnp.asarray(q) @ a @ jnp.asarray(q.T)

    a = biased(_s(bias), torch)
    lams, _, _, structure = _port_spectrum(a, 5)
    assert structure[:3] == ("real", "pair", "real")
    w = np.linalg.eigvals(a.numpy())
    w = w[np.argsort(-np.abs(w))][:len(lams)]
    assert _err(np.sort_complex(lams.numpy()), np.sort_complex(w)) <= 1e-10

    def phase(b):
        lam2 = _port_spectrum(biased(b, torch), 5, structure=structure)[0][1]
        return torch.atan2(lam2.imag.abs(), lam2.real)

    b = _s(bias).requires_grad_(True)
    (g,) = torch.autograd.grad(phase(b), b)
    assert abs(float(g) - 1.0) <= 1e-8


def _pair_for_gradcheck():
    blk = np.zeros((4, 4))
    blk[:2, :2] = _rot(3.0, 0.5)
    blk[2:, 2:] = np.diag(0.3 * np.random.default_rng(3).random(2))
    return _conjugated(blk, 4)


def test_gradcheck_dominant_eig_pair():
    """PyTorch's own check of the Wirtinger convention on the pair rule's
    complex outputs (λ, l, r) of a real matrix, first and second order
    (GMRES tangent solves; BiCGStab is held against JAX above)."""
    a = torch.from_numpy(_pair_for_gradcheck()).requires_grad_(True)

    def f(x):
        return port.dominant_eig_pair(x, num_iters=500, power_tol=1e-15,
                                      tol=1e-13, solver="gmres", device="cpu")

    assert gradcheck(f, (a,), fast_mode=True)
    assert gradgradcheck(f, (a,), fast_mode=True)


def test_complex_operators_are_refused_by_the_pair_solvers():
    """The pair solvers take REAL operators (a complex one goes to
    ``dominant_eig``), with the JAX package's ValueError."""
    c = torch.eye(6, dtype=torch.complex128)
    with pytest.raises(ValueError, match="REAL operator"):
        port.dominant_eig_pair(c, device="cpu")
    with pytest.raises(ValueError, match="REAL operator"):
        port.dominant_eig_spectrum(c, device="cpu")
