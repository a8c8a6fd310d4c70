"""The port's example drivers (``dominantsparseeigenad_tpu_torch/examples``)
at the small arguments of ``tests/test_examples.py::_CASES``, called
in-process on the CPU: each runs clean, passes its own check, and its key
numbers at the first point of its sweep match the JAX functions that the
JAX driver calls, computed here on the same inputs (CPU, f64 unless
stated)."""

import importlib
import importlib.util
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dominantsparseeigenad_tpu as J
from dominantsparseeigenad_tpu import models as jm
from dominantsparseeigenad_tpu.ops.eig import dominant_eig_multi as j_eig_multi

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch.models import tfim_exact_de0_dg

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DRIVERS = ("tfim_ed", "tfim_sparse", "heisenberg", "spectral", "ising2d",
           "transfer_spectrum", "lobpcg_precond", "spectrum_slice",
           "vibrational_modes", "complex_spectrum", "sharded_sparse",
           "distributed_lanczos")


def _jax_cases():
    """``tests/test_examples.py::_CASES``, as ``{script stem: [args, ...]}``
    (loaded from the file, so the arguments are the JAX smoke test's)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_example_cases", ROOT / "tests" / "test_examples.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cases = {}
    for script, args in mod._CASES:
        cases.setdefault(script[:-3], []).append(list(args))
    return cases


CASES = _jax_cases()


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _run(name, args, capsys=None):
    mod = importlib.import_module(
        f"dominantsparseeigenad_tpu_torch.examples.{name}")
    out = mod.main([*args, "--device", "cpu"])
    if capsys is not None:
        printed = capsys.readouterr().out
        assert printed.strip() and "nan" not in printed.lower(), printed
    return out


def _rel(a, b):
    a, b = np.asarray(a, dtype=complex), np.asarray(b, dtype=complex)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _finite(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite(v) for v in obj)
    if isinstance(obj, float):
        return math.isfinite(obj)
    return True


def test_the_cases_cover_every_driver():
    assert set(CASES) == set(DRIVERS)
    for name in DRIVERS:
        mod = importlib.import_module(
            f"dominantsparseeigenad_tpu_torch.examples.{name}")
        assert callable(mod.main)


def test_tfim_ed(capsys):
    """E0, dE0/dg, d²E0/dg² at g = 0.2 (N = 6) against JAX's jit(grad) of
    the same solve (1e-12 / 1e-10 / 1e-8) and Jordan-Wigner."""
    out = _run("tfim_ed", CASES["tfim_ed"][0], capsys)
    assert len(out["rows"]) == 2 and _finite(out)
    row = out["rows"][0]

    def e0(g):
        h = jm.tfim_dense_hamiltonian(6, g)
        return J.dominant_eigh(J.DenseOperator(h), k=64, extreme="min",
                               tol=1e-12)[0]

    ref = jax.jit(lambda g: (e0(g), jax.grad(e0)(g),
                             jax.grad(jax.grad(e0))(g)))(
        jnp.float64(row["g"]))
    for key, r, tol in zip(("e0", "de0", "d2e0"), ref, (1e-12, 1e-10, 1e-8)):
        assert _rel(row[key], float(r)) <= tol, key
    assert max(max(r["abs_err"]) for r in out["rows"]) < 1e-8


@pytest.mark.parametrize("case", [0, 1], ids=["pointwise", "batched"])
def test_tfim_sparse(case, capsys):
    """E0, dE0/dg and χ_F at g = 0.5 (N = 8, k = 40) against JAX's jvp
    pass (pointwise) or ``tfim_observables_sweep`` (batched): 1e-12 /
    1e-10 / 1e-8."""
    args = CASES["tfim_sparse"][case]
    out = _run("tfim_sparse", args, capsys)
    assert _finite(out) and len(out["rows"]) == (2, 3)[case]
    row = out["rows"][0]
    g0 = jnp.float64(row["g"])
    if case == 0:
        def ground(g):
            return J.dominant_eigh(jm.tfim_operator(8, g, dtype=jnp.float64),
                                   k=40, extreme="min", tol=1e-10,
                                   maxiter=400)

        def obs(g):
            (lam, _), (dlam, dv) = jax.jvp(ground, (g,),
                                           (jnp.ones((), jnp.float64),))
            return jnp.stack([lam, dlam, jnp.vdot(dv, dv)])
        ref = jax.jit(obs)(g0)
    else:
        ref = jax.jit(lambda z: jm.tfim_observables_sweep(
            8, z, k=40, tol=1e-10, maxiter=400, dtype=jnp.float64))(
            g0[None])[0]
    for key, r, tol in zip(("e0", "de0", "chi"), ref, (1e-12, 1e-10, 1e-8)):
        assert _rel(row[key], float(r)) <= tol, key
    assert max(r["rel_err_e0"] for r in out["rows"]) < 1e-12


def test_heisenberg(capsys):
    """E0/N and d(E0/N)/dJz at Jz = -1.5 (N = 6, k = 40) against JAX's
    value_and_grad (1e-12 / 1e-10)."""
    out = _run("heisenberg", CASES["heisenberg"][0], capsys)
    assert len(out["rows"]) == 3 and _finite(out)
    row = out["rows"][0]
    val, d1 = jax.jit(jax.value_and_grad(
        lambda jz: jm.heisenberg_ground_energy(6, 1.0, jz, k=40)))(
        jnp.float64(row["jz"]))
    assert _rel(row["e0_per_site"], float(val) / 6) <= 1e-12
    assert _rel(row["de0"], float(d1) / 6) <= 1e-10


def test_spectral(capsys):
    """E0 and S(ω) at both frequencies (N = 6) against JAX's
    ``spectral_function`` on its own ground state (1e-12 / 1e-9)."""
    out = _run("spectral", CASES["spectral"][0], capsys)
    assert len(out["rows"]) == 2 and _finite(out)

    def ref():
        op = jm.tfim_operator(6, 1.2)
        e0, psi0 = J.dominant_eigh(op, k=64, extreme="min", tol=1e-10)
        probe = jm.tfim.flip_sum(psi0, 6)
        omegas = e0 + jnp.linspace(0.0, 12.0, 2)
        return e0, J.spectral_function(op, probe, omegas, 0.2, tol=1e-10)

    e0, s = jax.jit(ref)()
    assert _rel(out["e0"], float(e0)) <= 1e-12
    assert _rel([r["s"] for r in out["rows"]], np.asarray(s)) <= 1e-9


def test_ising2d(capsys):
    """ln Z/N, u and c_v at β = 0.3 (CTMRG, chi = 8, 8 steps) against JAX's
    ``ising_observables`` (1e-12 / 1e-10 / 1e-8), and the Onsager errors
    the driver prints against JAX's Onsager."""
    out = _run("ising2d", CASES["ising2d"][0], capsys)
    assert len(out["rows"]) == 2 and _finite(out)
    row = out["rows"][0]
    ref = jm.ising_observables(row["beta"], method="ctmrg", chi=8,
                               n_steps=8, dtype=jnp.float64)
    for key, r, tol in zip(("lnz", "u", "cv"), ref, (1e-12, 1e-10, 1e-8)):
        assert _rel(row[key], float(r)) <= tol, key
    ex = lambda b: jm.onsager_free_energy(b, n_quad=256)  # noqa: E731
    b = jnp.float64(row["beta"])
    exact = (float(ex(b)), -float(jax.grad(ex)(b)),
             row["beta"] ** 2 * float(jax.grad(jax.grad(ex))(b)))
    assert _rel(row["onsager"], exact) <= 1e-12


def test_ising2d_vmap_and_f32(capsys):
    """``--vmap`` (``torch.func.vmap`` over the β points) against the
    pointwise loop (1e-12), and ``--f32`` against float64 (1e-4)."""
    args = CASES["ising2d"][0]
    rows = {flag: _run("ising2d", args + flags, capsys)["rows"]
            for flag, flags in (("loop", []), ("vmap", ["--vmap"]),
                                ("f32", ["--f32"]))}
    keys = ("lnz", "u", "cv")
    for a, b in zip(rows["vmap"], rows["loop"]):
        assert _rel([a[k] for k in keys], [b[k] for k in keys]) <= 1e-12
    for a, b in zip(rows["f32"], rows["loop"]):
        assert _rel([a[k] for k in keys], [b[k] for k in keys]) <= 1e-4


def test_transfer_spectrum(capsys):
    """The top three transfer eigenvalues, ξ and dξ/dβ at β = 0.3 (chi = 8,
    10 CTMRG steps) against JAX's (1e-10 / 1e-10 / 1e-8)."""
    out = _run("transfer_spectrum", CASES["transfer_spectrum"][0], capsys)
    assert len(out["rows"]) == 2 and _finite(out)
    row = out["rows"][0]

    def spectrum(beta):
        c, e, t = jm.ctmrg_environment(beta, chi=8, n_steps=10)
        return j_eig_multi(jm.transfer_operator(c, e, t), m=3)[0]

    b = jnp.float64(row["beta"])
    lams = jax.jit(spectrum)(b)
    xi, dxi = jax.jit(jax.value_and_grad(
        lambda bb: jm.correlation_length(bb, chi=8, n_steps=10)))(b)
    assert _rel(row["lams"], np.asarray(lams)) <= 1e-10
    assert _rel(row["xi"], float(xi)) <= 1e-10
    assert _rel(row["dxi"], float(dxi)) <= 1e-8


def test_lobpcg_precond(capsys):
    """The preconditioned LOBPCG pair, E0 and dE0/dg (N = 10, g = 0.2)
    against JAX's with the same Jacobi preconditioner (1e-10 / 1e-12 /
    1e-8; the start blocks differ, converged results are compared); the
    preconditioner cuts the iterations and the dense-ED check passed."""
    out = _run("lobpcg_precond", CASES["lobpcg_precond"][0], capsys)
    assert _finite(out) and "fd" in out
    assert out["iters_precond"] < out["iters_plain"]
    n, g = 10, 0.2
    diag = jm.tfim.tfim_zz_diagonal(n)
    pre = J.jacobi_precond(diag=diag,
                           shift=float(jnp.min(diag)) - abs(g) * n)
    lams, _ = J.lobpcg_eigh(jm.tfim_operator(n, jnp.float64(g)), 2,
                            tol=1e-9, maxiter=200, precond=pre)

    def e0(gv):
        ls, _ = J.dominant_eigh_multi(jm.tfim_operator(n, gv), r=2, k=200,
                                      method="lobpcg", tol=1e-9,
                                      precond=pre)
        return ls[0]

    val, d1 = jax.value_and_grad(e0)(jnp.float64(g))
    assert _rel(out["lams_precond"], np.asarray(lams)) <= 1e-10
    assert _rel(out["e0"], float(val)) <= 1e-12
    assert _rel(out["de0_dg"], float(d1)) <= 1e-8


def test_spectrum_slice(capsys):
    """The slice of the driver's window (N = 10, g = 0.3, r = 14, degree
    200, 150 iterations): the count inside, the band (1e-10), its centroid
    (1e-12) and d(centroid)/dg (1e-8) against JAX's ``spectral_slice``;
    the dense-ED check passed."""
    out = _run("spectrum_slice", CASES["spectrum_slice"][0], capsys)
    assert _finite(out) and "fd" in out
    lo_e, hi_e = out["window"]

    def centroid(gv):
        ls, _, info = J.spectral_slice(jm.tfim_operator(10, gv), lo_e, hi_e,
                                       r=14, degree=200, maxiter=150,
                                       tol=1e-9)
        msk = (ls >= lo_e) & (ls <= hi_e)
        return (jnp.sum(jnp.where(msk, ls, 0.0)) / jnp.maximum(
            jnp.sum(msk), 1), (ls, info.n_inside))

    (c, (ls, n_in)), dc = jax.value_and_grad(centroid, has_aux=True)(
        jnp.float64(0.3))
    ls = np.asarray(ls)
    assert out["n_inside"] == int(n_in)
    assert _rel(out["band"], np.sort(ls[(ls >= lo_e) & (ls <= hi_e)])) \
        <= 1e-10
    assert _rel(out["centroid"], float(c)) <= 1e-12
    assert _rel(out["dcentroid_dg"], float(dc)) <= 1e-8


def test_vibrational_modes(capsys):
    """The lowest three ω² of the chain (n = 100) and d(ω0²)/dm at the
    antinode against JAX's ``dominant_eigh_gen`` with the same K^{-1}
    preconditioner (1e-10 / 1e-8); the scipy check passed."""
    out = _run("vibrational_modes", CASES["vibrational_modes"][0], capsys)
    assert _finite(out) and "fd" in out and out["converged"]
    n, r = 100, 3
    rng = np.random.default_rng(0)
    ks = 1.0 + rng.random(n + 1)
    kmat = (np.diag(ks[:-1] + ks[1:]) - np.diag(ks[1:-1], 1)
            - np.diag(ks[1:-1], -1))
    masses = 0.5 + rng.random(n)
    kinv = jnp.asarray(np.linalg.inv(kmat))

    def modes(m):
        return J.dominant_eigh_gen(
            J.DenseOperator(jnp.asarray(kmat)), J.DenseOperator(jnp.diag(m)),
            r=r, maxiter=100, tol=1e-12, precond=lambda v: kinv @ v)[0]

    lams, vjp = jax.vjp(modes, jnp.asarray(masses))
    grad, = vjp(jnp.zeros(r).at[0].set(1.0))
    assert _rel(out["omega2"], np.asarray(lams)) <= 1e-10
    assert int(np.argmin(np.asarray(grad))) == out["site"]
    assert _rel(out["grad"], float(grad[out["site"]])) <= 1e-8


def test_complex_spectrum(capsys):
    """The operator against the JAX example's construction (1e-14), and
    the mixed spectrum (n = 48, m = 5) against JAX's
    ``dominant_eig_spectrum`` (structure equal, eigenvalues 1e-10); the
    driver's own gates (dθ/db = 1 within 1e-6, numpy's eigvals) passed."""
    from dominantsparseeigenad_tpu_torch.examples.complex_spectrum import (
        biased_transfer)
    out = _run("complex_spectrum", CASES["complex_spectrum"][0], capsys)
    assert _finite(out) and abs(out["dtheta_dbias"] - 1.0) <= 1e-6
    n, bias = 48, 0.25
    # The JAX example's biased_transfer, step for step.
    rng = np.random.default_rng(0)
    blk = np.zeros((n, n))
    blk[0, 0] = 2.0
    c, s = jnp.cos(bias), jnp.sin(bias)
    sub = 1.5 * jnp.array([[c, -s], [s, c]])
    blk[3, 3] = 1.05
    blk[4:, 4:] = np.diag(0.6 * rng.random(n - 4))
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = jnp.asarray(blk).at[1:3, 1:3].set(sub)
    a = jnp.asarray(q) @ a @ jnp.asarray(q.T)
    mine = biased_transfer(n, bias, device="cpu").numpy()
    assert _rel(mine, np.asarray(a)) <= 1e-14
    lams, _, _, structure = J.dominant_eig_spectrum(
        a, m=5, num_iters=1500, power_tol=1e-12)
    assert tuple(out["structure"]) == tuple(structure)
    got = np.array([complex(*z) for z in out["lams"]])
    assert _rel(got, np.asarray(lams)) <= 1e-10


def test_sharded_sparse(capsys):
    """Two spawned gloo ranks (n = 512, bs = 16, k = 30, float32): λ on
    every rank equal, and against JAX's ``lanczos_eigh`` on the same
    values from the port's start vector (1e-5); ‖∂λ/∂vals‖ against
    ‖v vᵀ on the pattern‖ of JAX's Ritz vector (1e-4); the parity gate
    passed."""
    out = _run("sharded_sparse", CASES["sharded_sparse"][0], capsys)
    assert _finite(out) and out["ranks"] == 2
    assert len(set(out["lam_sharded_by_rank"])) == 1
    n, bs, bpr, k = 512, 16, 5, 30
    op = port.random_bell_operator(
        n, bs, bpr, generator=torch.Generator().manual_seed(0),
        dtype=torch.float32, device="cpu")
    v0 = torch.randn(n, generator=torch.Generator().manual_seed(0),
                     dtype=torch.float32)
    vals, cols = op.vals.numpy(), op.cols.numpy()
    jop = J.BellOperator(jnp.asarray(vals), jnp.asarray(cols), n,
                         use_pallas=False)
    lam, v = jax.jit(lambda x: J.lanczos_eigh(jop, k, extreme="min",
                                              v0=x))(jnp.asarray(v0.numpy()))
    assert _rel(out["lam_sharded"], float(lam)) <= 1e-5
    assert _rel(out["lam_local"], float(lam)) <= 1e-5
    blocks = np.asarray(v, dtype=np.float64).reshape(-1, bs)
    sq = (blocks ** 2).sum(axis=1)
    norm = math.sqrt(float((sq[:, None] * sq[cols]).sum()))
    assert _rel(out["grad_norm"], norm) <= 1e-4
    # No kernel runs on the CPU.
    assert not out["panel_launches"] and not out["local_square_launches"]


def test_distributed_lanczos(capsys):
    """Two spawned gloo ranks splitting the TFIM state (N = 8, k = 30,
    g = 1.0, f64): E0 and dE0/dg equal on every rank, and against what
    the JAX driver computes, the jitted value and gradient of its
    ``tfim_sharded_operator`` solve on a 2-shard mesh of the virtual CPU
    devices (1e-12 / 2e-8: each driver draws its own start vector, and
    at k = 30 the two Ritz vectors give dE0/dg 9e-9 apart, each within
    7e-9 of Jordan-Wigner); E0 and dE0/dg against Jordan-Wigner (1e-10 /
    1e-8)."""
    from dominantsparseeigenad_tpu.parallel import make_mesh
    out = _run("distributed_lanczos", CASES["distributed_lanczos"][0],
               capsys)
    assert _finite(out) and out["ranks"] == 2
    assert len(set(out["e0_by_rank"])) == 1
    assert len(set(out["de0_dg_by_rank"])) == 1
    assert out["collectives_by_rank"][0] == out["collectives_by_rank"][1]
    assert out["collectives_by_rank"][0]["ppermute"] > 0
    mesh = make_mesh(n_shards=2)

    def solve(g):
        return J.dominant_eigh(jm.tfim_sharded_operator(8, g, mesh), k=30,
                               extreme="min", tol=1e-10)[0]

    val, grad = jax.jit(jax.value_and_grad(solve))(jnp.float64(1.0))
    assert _rel(out["e0"], float(val)) <= 1e-12
    assert _rel(out["de0_dg"], float(grad)) <= 2e-8
    assert _rel(out["e0"], out["exact"]) <= 1e-10
    assert _rel(out["de0_dg"], tfim_exact_de0_dg(8, 1.0)) <= 1e-8


def test_sharded_ring_mode_raises_item_14():
    """Item 14 is done: ``--mode ring`` no longer raises.  It runs over
    vectors sharded across the ranks (one rank here, in this process, so
    no spawn; on the card its buckets run the gather kernels) and passes
    the example's parity gate against the unsharded operator."""
    out = _run("sharded_sparse", ["--n", "512", "--bs", "16", "--k", "30",
                                  "--mode", "ring", "--ranks", "1"])
    assert _finite(out) and out["ranks"] == 1
    assert out["ring_offsets"] == [0]
    assert _rel(out["lam_sharded"], out["lam_local"]) <= 1e-5


def test_log_records_are_the_printed_numbers(tmp_path, capsys):
    """``--log`` appends one record a point through the port's
    ``JsonlLogger``, with the JAX driver's event and fields."""
    path = tmp_path / "heisenberg.jsonl"
    out = _run("heisenberg", CASES["heisenberg"][0] + ["--log", str(path)],
               capsys)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["xxz"] * 3
    assert [{k: r[k] for k in ("jz", "e0_per_site", "de0")} for r in recs] \
        == out["rows"]


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_needs_a_card_or_device_cpu(name, monkeypatch):
    """Every driver defaults to ``--device cuda``: with no card it raises,
    it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(
        f"dominantsparseeigenad_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(CASES[name][0])
