"""The bfloat16 Lanczos basis with its Newton polish
(``refine_eigenpair``), ``early_exit_tol`` and the argument guards of the
port's ``dominant_eigh`` against the JAX package's (CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from dominantsparseeigenad_tpu.models import (
    tfim_dense_hamiltonian as jax_tfim_dense)
from dominantsparseeigenad_tpu.models import tfim_operator as jax_tfim
from dominantsparseeigenad_tpu.ops.cg import (
    solve_deflated_info as jax_solve_info)
from dominantsparseeigenad_tpu.ops.eigh import dominant_eigh as jax_eigh
from dominantsparseeigenad_tpu.ops.eigh import (
    refine_eigenpair as jax_refine)
from dominantsparseeigenad_tpu.ops.lanczos import (
    _project_out as jax_project_out)
from dominantsparseeigenad_tpu.ops.lanczos import lanczos as jax_lanczos
from dominantsparseeigenad_tpu.ops.operators import DenseOperator as JaxDense

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models
from dominantsparseeigenad_tpu_torch.ops.lanczos import (_project_out,
                                                         _ritz_vector)

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _f32_pair():
    """A float32 ground pair of the n = 8 TFIM at g = 0.9 (the start of
    ``tests/test_eigh.py::test_refine_eigenpair_mixed_precision``)."""
    h = models.tfim_dense_hamiltonian(8, 0.9, device="cpu")
    lam, v = port.dominant_eigh(h.float(), k=50, device="cpu")
    return h.numpy(), float(lam), v.numpy()


@pytest.mark.parametrize("definite_sign", [1.0, None],
                         ids=["cg", "minres"])
def test_refine_eigenpair_f32_to_f64_matches_jax(definite_sign):
    h, lam32, v32 = _f32_pair()
    w = np.linalg.eigvalsh(h)
    assert abs(lam32 - w[0]) > 1e-12          # float32 is the coarse tier
    lam, v = port.refine_eigenpair(
        torch.from_numpy(h), lam32, torch.from_numpy(v32),
        definite_sign=definite_sign, device="cpu")
    lam_j, v_j = jax.jit(lambda m, l, x: jax_refine(
        JaxDense(m), l, x, definite_sign=definite_sign))(
        jnp.asarray(h), jnp.float32(lam32), jnp.asarray(v32))
    assert lam.dtype == v.dtype == torch.float64
    # Two Newton steps from a float32 pair: float64 round-off.
    np.testing.assert_allclose(float(lam), w[0], rtol=1e-14, atol=1e-13)
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=1e-14)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-10)
    assert np.linalg.norm(h @ v.numpy() - float(lam) * v.numpy()) < 1e-11


@pytest.mark.parametrize("maxiter", [5, 60])
def test_polish_of_an_unconverged_pair_matches_jax(maxiter):
    """One Newton step from a Ritz pair that is not converged (its value
    above the second eigenvalue, so the deflated system is indefinite)
    and a capped CG: the port's step is the JAX one.  With 5 iterations
    it raises λ and the residual, in both packages: what the polish of
    the bf16 basis does to an unconverged pair (config #5 at k = 100)."""
    rng = np.random.default_rng(3)
    s = rng.standard_normal((96, 96))
    a = (s + s.T) / 2
    w = np.linalg.eigvalsh(a)
    lam0, v0 = port.lanczos_eigh(torch.from_numpy(a), 10, extreme="min",
                                 v0=torch.from_numpy(rng.standard_normal(96)),
                                 device="cpu")
    assert float(lam0) > w[1]
    lam, v = port.refine_eigenpair(torch.from_numpy(a), lam0, v0, iters=1,
                                   tol=1e-12, maxiter=maxiter,
                                   definite_sign=1.0, device="cpu")
    lam_j, v_j = jax.jit(lambda m, l, x: jax_refine(
        JaxDense(m), l, x, iters=1, tol=1e-12, maxiter=maxiter,
        definite_sign=1.0))(jnp.asarray(a), jnp.asarray(float(lam0)),
                            jnp.asarray(v0.numpy()))
    # f64 CG steps on the same system, at κ ~ 1e2.
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-10)

    def resid(lam, v):
        return np.linalg.norm(a @ v - lam * v)

    if maxiter == 5:
        assert float(lam) > float(lam0)
        assert resid(float(lam), v.numpy()) > resid(float(lam0), v0.numpy())


def _f6_case():
    """A float32 symmetric operator (n = 256) whose two lowest eigenvalues
    0 and 1e-4 sit below a gap (the rest from 1e-2 to 10), and the Ritz
    pair of a 40-step Lanczos with a bfloat16 basis: not converged, its
    value above the lowest few eigenvalues, so the polish's deflated
    system is indefinite and ill-conditioned."""
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((256, 256)))
    d = np.concatenate([[0.0, 1e-4], np.geomspace(1e-2, 10.0, 254)])
    a = ((q * d) @ q.T).astype(np.float32)
    a = (a + a.T) / 2
    lam0, v0 = port.lanczos_eigh(
        torch.from_numpy(a), 40, extreme="min",
        v0=torch.from_numpy(rng.standard_normal(256).astype(np.float32)),
        basis_dtype=torch.bfloat16, device="cpu")
    return a, float(lam0), v0


def test_float32_polish_of_an_unconverged_pair_is_the_reference_behaviour():
    """F6 (ROADMAP.md): the float32 polish of an unconverged bf16 Ritz
    pair runs its CG to the cap on an indefinite system and ends far
    from the float64 step.  The JAX package's float32 polish does the
    same from the same pair, at the same tolerance (1e-6, clamped to
    6e-6) and cap: the two take the same steps (5 iterations: equal to
    float32 round-off), and at a cap of 3000 both CGs run to the cap
    without meeting the tolerance and both leave a Ritz residual over
    10 times the float64 step's."""
    a, lam0, v0 = _f6_case()
    a64 = a.astype(np.float64)
    w = np.linalg.eigvalsh(a64)
    assert lam0 > w[1]                 # above other eigenvalues

    def resid(lam, v):
        v = np.asarray(v, np.float64)
        return np.linalg.norm(a64 @ v - float(lam) * v)

    def polish(maxiter):
        lam, v = port.refine_eigenpair(torch.from_numpy(a), lam0, v0,
                                       iters=1, tol=1e-6, maxiter=maxiter,
                                       definite_sign=1.0, device="cpu")
        lam_j, v_j = jax.jit(lambda m, l, x: jax_refine(
            JaxDense(m), l, x, iters=1, tol=1e-6, maxiter=maxiter,
            definite_sign=1.0))(jnp.asarray(a), jnp.float32(lam0),
                                jnp.asarray(v0.numpy()))
        return (float(lam), v.numpy()), (float(lam_j), np.asarray(v_j))

    (lam, v), (lam_j, v_j) = polish(5)
    np.testing.assert_allclose(lam, lam_j, rtol=1e-5)
    np.testing.assert_allclose(v, v_j, atol=1e-5)
    lam64, v64 = port.refine_eigenpair(torch.from_numpy(a64), lam0, v0,
                                       iters=1, tol=1e-6, maxiter=3000,
                                       definite_sign=1.0, device="cpu")
    floor = resid(lam64, v64.numpy())
    assert floor < 1e-2 * resid(lam0, v0.numpy())   # it converges
    for lam_p, v_p in polish(3000):
        assert resid(lam_p, v_p) > 10 * floor
    # The CG of the step itself: to the cap, the tolerance not met.
    u = v0 / torch.linalg.vector_norm(v0)
    at = torch.from_numpy(a)
    lam_u = u @ at @ u
    _, its, res = port.solve_deflated_info(at, lam_u, u, -(at @ u - lam_u * u),
                                           tol=1e-6, maxiter=3000,
                                           device="cpu")
    _, its_j, res_j = jax.jit(lambda m, l, x: jax_solve_info(
        JaxDense(m), l, x, -(m @ x - l * x), tol=1e-6, maxiter=3000))(
            jnp.asarray(a), jnp.float32(float(lam_u)), jnp.asarray(u.numpy()))
    assert its == int(its_j) == 3000
    assert res > 1e-2 and float(res_j) > 1e-2


def _narrow_inputs():
    """Twelve orthonormal rows of length 256 rounded to bfloat16 (by
    JAX's cast; torch's rounds the same way), a float32 w and float32
    Ritz coefficients y."""
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((256, 12)))
    rows = np.asarray(jnp.asarray(q.T, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    return (rows, rng.standard_normal(256).astype(np.float32),
            rng.standard_normal(12).astype(np.float32))


def test_narrow_projection_and_ritz_vector_match_jax():
    """The narrow arithmetic on the same inputs as JAX's: w and the
    coefficients rounded to bfloat16, the products accumulated in float32
    (``preferred_element_type``).  Measured 6e-8 (projection) and 1.5e-8
    (Ritz vector) from JAX's; the widened products (no rounding of w or y)
    miss it by 2.2e-3 and 2.1e-4, so the bars of 1e-6 tell them apart."""
    rows, w, y = _narrow_inputs()
    basis = torch.from_numpy(rows).bfloat16()
    assert torch.equal(basis.float(), torch.from_numpy(rows))
    out = _project_out(basis, torch.from_numpy(w)).numpy()
    out_j = np.asarray(jax.jit(jax_project_out)(
        jnp.asarray(rows, jnp.bfloat16), jnp.asarray(w)))
    np.testing.assert_allclose(out, out_j, rtol=0, atol=1e-6)
    assert np.abs(w - rows.T @ (rows @ w) - out_j).max() > 1e-4

    v = _ritz_vector(basis.T, torch.from_numpy(y)).numpy()
    v_j = jnp.matmul(jnp.asarray(rows.T, jnp.bfloat16),
                     jnp.asarray(y).astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    v_j = np.asarray(v_j / jnp.linalg.norm(v_j))
    np.testing.assert_allclose(v, v_j, rtol=0, atol=1e-6)
    widened = rows.T @ y
    assert np.abs(widened / np.linalg.norm(widened) - v_j).max() > 1e-5


def _tfim_v0():
    return np.random.default_rng(0).standard_normal(2 ** 10).astype(
        np.float32)


@pytest.mark.parametrize("reorth_chunks, reorth_passes", [(0, 2), (4, 1)])
def test_bf16_lanczos_coefficients_match_jax(reorth_chunks, reorth_passes):
    """The bf16-basis recurrence against JAX's from the same v0 (n = 10
    TFIM, float32, k = 30).  Rounding w to bfloat16 flips a few last bits
    where the float32 sums differ, and Lanczos amplifies that step by
    step, so only the first six steps are held: measured within 2.1e-4
    (α) and 1.4e-6 (β) of JAX's; the widened basis is 2.4e-3 off in α,
    and an unrounded projection 1.2e-3, so the bar of 6e-4 fails both."""
    res_j = jax.jit(lambda g, v: jax_lanczos(
        jax_tfim(10, g, dtype=jnp.float32), 30, v0=v,
        basis_dtype=jnp.bfloat16, reorth_chunks=reorth_chunks,
        reorth_passes=reorth_passes))(jnp.float32(1.2),
                                      jnp.asarray(_tfim_v0()))
    op = models.tfim_operator(10, 1.2, dtype=torch.float32, device="cpu")

    def run(basis_dtype):
        return port.lanczos(op, 30, v0=torch.from_numpy(_tfim_v0()),
                            basis_dtype=basis_dtype,
                            reorth_chunks=reorth_chunks,
                            reorth_passes=reorth_passes, device="cpu")

    res = run(torch.bfloat16)
    alphas_j, betas_j = np.asarray(res_j.alphas), np.asarray(res_j.betas)
    assert res.basis.dtype == torch.bfloat16
    np.testing.assert_allclose(res.alphas[:6].numpy(), alphas_j[:6],
                               rtol=0, atol=6e-4)
    np.testing.assert_allclose(res.betas[:6].numpy(), betas_j[:6],
                               rtol=0, atol=1e-5)
    widened = run(None)
    assert np.abs(widened.alphas[:6].numpy() - alphas_j[:6]).max() > 6e-4


def _observables(dtype, tol, **kw):
    """(E0, dE0/dg, χ_F) of the n = 10 TFIM at g = 1.2 from one
    forward-mode pass (k = 30, as the JAX test)."""
    with torch.no_grad(), fwAD.dual_level():
        g = fwAD.make_dual(torch.tensor(1.2, dtype=dtype),
                           torch.ones((), dtype=dtype))
        lam, v = port.dominant_eigh(
            models.tfim_operator(10, g, dtype=dtype, device="cpu"), k=30,
            tol=tol, device="cpu", **kw)
        e0, de0 = fwAD.unpack_dual(lam)
        psi, dpsi = fwAD.unpack_dual(v)
    chi = torch.dot(dpsi, dpsi) - torch.dot(psi, dpsi) ** 2
    return np.array([float(e0), float(de0), float(chi)]), psi


@functools.lru_cache(maxsize=None)
def _jax_observables(reorth_chunks, reorth_passes, restart_mode):
    """The same pass through JAX's ``dominant_eigh`` with the bf16 basis
    (``tests/test_eigh.py::test_bf16_basis_storage_matches_f32``)."""
    def ground(g):
        return jax_eigh(jax_tfim(10, g, dtype=jnp.float32), k=30,
                        extreme="min", tol=1e-6, basis_dtype=jnp.bfloat16,
                        reorth_chunks=reorth_chunks,
                        reorth_passes=reorth_passes,
                        restart_mode=restart_mode)

    (lam, _), (dlam, dv) = jax.jvp(jax.jit(ground), (jnp.float32(1.2),),
                                   (jnp.float32(1.0),))
    return np.array([float(lam), float(dlam), float(jnp.vdot(dv, dv))])


@functools.lru_cache(maxsize=None)
def _truth():
    return _observables(torch.float64, 1e-12)[0]


@pytest.mark.parametrize("reorth_chunks, reorth_passes, restart_mode",
                         [(0, 2, "cond"), (4, 1, "cond"), (4, 1, "carry")])
def test_bf16_basis_holds_the_f64_truth(reorth_chunks, reorth_passes,
                                        restart_mode):
    """``tests/test_eigh.py:224-277``: the bf16 basis and its polish in
    both packages against a float64 truth at that test's bars (E0 1e-5,
    dE0/dg 1e-4, χ_F 1e-3), not against the float32 basis or each other
    (their float32 sums differ in order); (4, 1) is the bench's headline
    setting."""
    obs, psi = _observables(torch.float32, 1e-6,
                            basis_dtype=torch.bfloat16,
                            reorth_chunks=reorth_chunks,
                            reorth_passes=reorth_passes,
                            restart_mode=restart_mode)
    truth = _truth()
    for got in (obs, _jax_observables(reorth_chunks, reorth_passes,
                                      restart_mode)):
        np.testing.assert_allclose(got[0], truth[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], truth[1], rtol=1e-4)
        np.testing.assert_allclose(got[2], truth[2], rtol=1e-3)
    # The polished pair is an eigenpair at float32 precision, gauged.
    op = models.tfim_operator(10, 1.2, dtype=torch.float32, device="cpu")
    lam = float(obs[0])
    resid = float(torch.linalg.vector_norm(op.matvec(psi) - lam * psi)
                  / abs(lam))
    assert resid < 1e-5, resid
    assert float(psi[torch.argmax(psi.abs())]) > 0


def test_bf16_basis_is_stored_narrow():
    op = models.tfim_operator(6, 1.0, dtype=torch.float32, device="cpu")
    res = port.lanczos(op, 10, basis_dtype=torch.bfloat16, device="cpu")
    assert res.basis.dtype == torch.bfloat16
    assert res.alphas.dtype == res.betas.dtype == torch.float32


GUARDS = [
    dict(restart_cycles=2, extreme="both"),
    dict(restart_cycles=2, early_exit_tol=1e-8),
    dict(reorth_chunks=4, early_exit_tol=1e-8),
    dict(with_info=True, extreme="both"),
    dict(early_exit_tol=1e-8, extreme="both"),
    dict(basis_dtype="bf16", early_exit_tol=1e-8),
    dict(basis_dtype="bf16", restart_cycles=1),
    dict(restart_mode="carry", early_exit_tol=1e-8),
    dict(restart_mode="carry", restart_cycles=1),
]


@pytest.mark.parametrize("kw", GUARDS, ids=lambda kw: "+".join(kw))
def test_guards_raise_the_jax_value_errors(kw):
    def call(eigh, bf16, a):
        args = {k: (bf16 if v == "bf16" else v) for k, v in kw.items()}
        return eigh(a, k=4, **args)

    a = np.eye(8)
    with pytest.raises(ValueError) as err_j:
        call(jax_eigh, jnp.bfloat16, jnp.asarray(a))
    with pytest.raises(ValueError) as err:
        call(lambda *x, **y: port.dominant_eigh(*x, device="cpu", **y),
             torch.bfloat16, torch.from_numpy(a))
    assert str(err.value) == str(err_j.value)


def test_restart_cycles_wait_for_item_10():
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        port.dominant_eigh(torch.eye(8, dtype=torch.float64), k=4,
                           restart_cycles=1, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_early_exit():
    def f(g):
        lam, _, info = jax_eigh(JaxDense(jax_tfim_dense(8, g)), k=100,
                                tol=1e-10, early_exit_tol=1e-11,
                                with_info=True)
        return lam, info

    (lam, info), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.float64(1.0))
    return float(lam), float(g), tuple(float(t) for t in info)


def test_early_exit_with_info_and_gradient_match_jax():
    g = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    lam, v, info = port.dominant_eigh(
        models.tfim_dense_hamiltonian(8, g, device="cpu"), k=100, tol=1e-10,
        early_exit_tol=1e-11, with_info=True, device="cpu")
    assert not any(f.requires_grad for f in info)
    (d1,) = torch.autograd.grad(lam, g)
    lam = lam.detach()
    lam_j, d1_j, (k_j, res_j, conv_j) = _jax_early_exit()
    h = models.tfim_dense_hamiltonian(8, 1.0, device="cpu")
    # Both runs stop early at the floored 1e-11 (their start vectors
    # differ, so their checkpoints may too).
    assert float(info.converged) == conv_j == 1.0
    assert float(info.effective_k) < 100 and k_j < 100
    assert float(info.residual) <= 1e-11 and res_j <= 1e-11
    np.testing.assert_allclose(float(lam), lam_j, rtol=1e-12)
    np.testing.assert_allclose(float(lam), float(torch.linalg.eigvalsh(h)[0]),
                               rtol=1e-12)
    # dE0/dg = <v, dH/dg v>: the IFT rule on the early-exit pair.
    np.testing.assert_allclose(float(d1), d1_j, rtol=1e-8)
    fixed = port.dominant_eigh(
        models.tfim_dense_hamiltonian(8, g, device="cpu"), k=100, tol=1e-10,
        device="cpu")[0]
    np.testing.assert_allclose(float(d1),
                               float(torch.autograd.grad(fixed, g)[0]),
                               rtol=1e-8)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()
