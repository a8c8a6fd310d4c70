"""The port's thick-restart Lanczos (``ops/restart.py``), its checkpoints
(``utils/checkpoint.py``) and ``dominant_eigh(restart_cycles=...)``
against the JAX package's (CPU, f64), after ``tests/test_restart.py`` and
``tests/test_faulttolerance.py``.

Where no breakdown happens both packages get the same start vector and
their states agree to 1e-10; where one does (the oversized-k and tiny
operators) the restart draws differ between the packages and only the
converged λ is compared.  The SIGKILL rehearsal runs this file as its own
worker (``python tests/test_torch_restart.py <dir> ...``)."""

import argparse
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
F64 = torch.float64
WORKER_N, WORKER_K, WORKER_CYCLES = 384, 24, 6
JAX_K, JAX_CYCLES = 12, 6

torch.set_num_threads(2)


def _sym(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


def _spiked(n, seed):
    """A Wigner matrix (spectrum ~[-1, 1]) plus 3 u u^T: its largest
    eigenvalue ~3.3 stands apart, so a small window converges to it."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(n)
    u /= np.linalg.norm(u)
    return _sym(n, seed + 1) / np.sqrt(2.0 * n) + 3.0 * np.outer(u, u)


def _worker_operator():
    return torch.from_numpy(_sym(WORKER_N, 7))


def worker(argv):
    """Drive the restart cycle by cycle through the public API, save the
    state after every cycle, and SIGKILL this process after cycle
    ``--crash-after``; on a later start, resume from the newest saved
    state.  Prints one ``cycle`` line per cycle and a ``DONE`` line."""
    sys.path.insert(0, ROOT)
    from dominantsparseeigenad_tpu_torch import (restart_cycle,
                                                 restart_extract,
                                                 restart_init)
    from dominantsparseeigenad_tpu_torch.utils import (load_pytree,
                                                       save_pytree)

    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir")
    ap.add_argument("--crash-after", type=int, default=-1)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    a = _worker_operator()
    os.makedirs(args.ckpt_dir, exist_ok=True)
    done = sorted(int(f.split("_")[1].split(".")[0])
                  for f in os.listdir(args.ckpt_dir)
                  if f.startswith("cycle_") and f.endswith(".tree.json"))
    state = restart_init(a, WORKER_K, device="cpu")
    start = 0
    if done:
        start = done[-1] + 1
        state = load_pytree(os.path.join(args.ckpt_dir,
                                          f"cycle_{done[-1]}"), state)
        print(f"resumed from cycle {done[-1]}", flush=True)
    for c in range(start, WORKER_CYCLES):
        state, resid = restart_cycle(a, state, WORKER_K)
        save_pytree(os.path.join(args.ckpt_dir, f"cycle_{c}"), state)
        print(f"cycle {c} resid {float(resid):.3e}", flush=True)
        if c == args.crash_after:
            os.kill(os.getpid(), signal.SIGKILL)
    lam, _, _ = restart_extract(state)
    exact = np.linalg.eigvalsh(a.numpy())[0]
    print(f"DONE lam={float(lam).hex()} value={float(lam):.15e} "
          f"exact={exact:.15e}", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dominantsparseeigenad_tpu.models import tfim_operator as jax_tfim  # noqa
from dominantsparseeigenad_tpu.ops import restart as jr  # noqa: E402
from dominantsparseeigenad_tpu.ops.eigh import dominant_eigh as jax_eigh  # noqa
from dominantsparseeigenad_tpu.utils import checkpoint as jck  # noqa: E402

import dominantsparseeigenad_tpu_torch as port  # noqa: E402
from dominantsparseeigenad_tpu_torch import models  # noqa: E402
from dominantsparseeigenad_tpu_torch.utils import (load_pytree,  # noqa
                                                   save_pytree)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _state_np(state):
    return [np.asarray(getattr(state, f)) for f in state._fields]


def _assert_states_close(got, want, atol):
    """θ, y, s and q within ``atol``, each retained Ritz vector (a row of
    y, with its coupling in s) up to its sign: the sign of an eigenvector
    of the arrowhead is the eigensolver's choice (LAPACK's through JAX and
    through torch may differ), and a flipped pair spans the same next
    Krylov space."""
    theta, y, s, q = _state_np(got)
    theta_w, y_w, s_w, q_w = _state_np(want)
    sign = np.where(np.sum(y * y_w, axis=1) < 0, -1.0, 1.0)
    for name, g, w in (("theta", theta, theta_w),
                       ("y", y * sign[:, None], y_w), ("s", s * sign, s_w),
                       ("q", q, q_w)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


# -- tests/test_restart.py ----------------------------------------------------

def test_restarted_beats_single_shot():
    """With the same window, restarting converges where one k-step run
    cannot (TFIM n = 12 against Jordan-Wigner)."""
    n = 12
    op = models.tfim_operator(n, 1.0, device="cpu")
    exact = float(models.tfim_exact_e0(n, 1.0, device="cpu"))
    lam_single, _ = port.lanczos_eigh(op, 20, extreme="min", device="cpu")
    lam, v, _ = port.lanczos_restarted(op, k=20, n_restarts=10,
                                       extreme="min", device="cpu")
    err_single = abs(float(lam_single) - exact)
    err = abs(float(lam) - exact)
    assert err < 1e-10
    assert err < err_single / 100
    assert float(torch.linalg.vector_norm(op.matvec(v) - lam * v)) < 1e-9


def test_restarted_dense_max():
    """``tests/test_restart.py::test_restarted_dense_max``: k = 28, 8
    cycles, the largest eigenvalue of a 256 x 256 Gaussian matrix."""
    a = _sym(256, 1)
    lam, v, _ = port.lanczos_restarted(torch.from_numpy(a), k=28,
                                       n_restarts=8, extreme="max",
                                       device="cpu")
    np.testing.assert_allclose(float(lam), np.linalg.eigvalsh(a)[-1],
                               rtol=1e-11)
    assert float(v[torch.argmax(v.abs())]) > 0


@pytest.fixture(scope="module")
def jax_run():
    """JAX on a spiked 256 x 256 matrix from one start vector, "max",
    window 12 (one compiled cycle, reused): the state after init and
    after each of 6 cycles, and the compiled cycle."""
    a = _spiked(256, 3)
    v0 = np.random.default_rng(2).standard_normal(256)
    aj = jnp.asarray(a)
    init = jax.jit(lambda v: jr.restart_init(aj, k=JAX_K, extreme="max",
                                             v0=v))
    cyc = jax.jit(lambda st: jr.restart_cycle(aj, st, JAX_K,
                                              extreme="max")[0])
    states = [init(jnp.asarray(v0))]
    for _ in range(JAX_CYCLES):
        states.append(cyc(states[-1]))
    return a, v0, states, cyc


def test_restart_states_match_jax(jax_run):
    """The same start vector and no breakdown: every state (θ, y, s, q)
    after init and after each cycle equals JAX's to 1e-10 (up to the
    signs of the Ritz vectors), and λ is the largest eigenvalue."""
    a, v0, states, _ = jax_run
    at = torch.from_numpy(a)
    state = port.restart_init(at, k=JAX_K, extreme="max",
                              v0=torch.from_numpy(v0), device="cpu")
    _assert_states_close(state, states[0], 1e-10)
    for want in states[1:]:
        state, _ = port.restart_cycle(at, state, JAX_K, extreme="max")
        _assert_states_close(state, want, 1e-10)
    lam, v, resid = port.restart_extract(state)
    np.testing.assert_allclose(float(lam), np.linalg.eigvalsh(a)[-1],
                               rtol=1e-12)
    np.testing.assert_allclose(float(lam), float(states[-1].theta[0]),
                               rtol=1e-14)
    assert float(resid) < 1e-10
    assert float(v[torch.argmax(v.abs())]) > 0


def test_restarted_deterministic():
    op = models.tfim_operator(10, 0.8, device="cpu")
    a, b = (float(port.lanczos_restarted(op, k=16, n_restarts=6,
                                         device="cpu")[0])
            for _ in range(2))
    assert a == b


@pytest.fixture(scope="module")
def tfim8_jax():
    """JAX's E0, dE0/dg and d²E0/dg² by ``dominant_eigh(k=12,
    restart_cycles=6)`` of the TFIM n = 8 at g = 1, in one program."""
    def e0(g):
        return jax_eigh(jax_tfim(8, g), k=12, restart_cycles=6,
                        tol=1e-11)[0]

    out = jax.jit(lambda g: (e0(g), jax.grad(e0)(g),
                             jax.grad(jax.grad(e0))(g)))(jnp.float64(1.0))
    return [float(t) for t in out]


def test_restart_forward_in_dominant_eigh_matches_jax(tfim8_jax):
    """``dominant_eigh(restart_cycles=...)``: the bounded-memory forward
    under the IFT rules, λ and its first and second derivatives against
    JAX's and Jordan-Wigner's, and the info's step count."""
    val_j, d1_j, d2_j = tfim8_jax
    g = torch.tensor(1.0, dtype=F64, requires_grad=True)
    lam, _ = port.dominant_eigh(models.tfim_operator(8, g, device="cpu"),
                                k=12, restart_cycles=6, tol=1e-11,
                                device="cpu")
    (d1,) = torch.autograd.grad(lam, g, create_graph=True)
    (d2,) = torch.autograd.grad(d1, g)
    jw = [float(models.tfim_exact_e0(8, 1.0, device="cpu")),
          models.tfim_exact_de0_dg(8, 1.0), models.tfim_exact_d2e0_dg2(8, 1.0)]
    for got, want_j, want, rtol in ((lam, val_j, jw[0], 1e-12),
                                    (d1, d1_j, jw[1], 1e-10),
                                    (d2, d2_j, jw[2], 1e-8)):
        np.testing.assert_allclose(float(got.detach()), want_j, rtol=rtol)
        np.testing.assert_allclose(float(got.detach()), want, rtol=rtol)
    # The steps run: k, then k - max(1, k // 4) a cycle (JAX's count).
    _, _, info = port.dominant_eigh(models.tfim_operator(8, 1.0,
                                                         device="cpu"),
                                    k=12, restart_cycles=6, tol=1e-11,
                                    with_info=True, device="cpu")
    assert float(info.effective_k) == 12 + 6 * (12 - 3)
    assert float(info.converged) == 1.0


def test_restart_cycle_clamps_oversized_k():
    """The cycle clamps the caller's k to op.dim as restart_init does (a
    window wider than the space converges to spurious ~0 Ritz values):
    the clamped run is the correctly sized one, and λ the smallest
    eigenvalue (the JAX test's oracle)."""
    a = _sym(32, 7)
    at = torch.from_numpy(a)
    big = port.restart_init(at, k=64, device="cpu")
    ref = port.restart_init(at, k=32, device="cpu")
    for _ in range(4):
        big, _ = port.restart_cycle(at, big, 64)
        ref, _ = port.restart_cycle(at, ref, 32)
    np.testing.assert_allclose(big.theta.numpy(), ref.theta.numpy(),
                               rtol=1e-12)
    lam, _, _ = port.restart_extract(big)
    evals = np.linalg.eigvalsh(a)
    np.testing.assert_allclose(float(lam), evals[0], rtol=1e-10)


def test_restart_tiny_operator_retains_a_ritz_vector():
    """A dim-3 operator clamps k to 3 with one Ritz vector kept (the
    space is exhausted: only the converged λ is compared with JAX's); an
    explicit num_kept=0 is refused with JAX's message."""
    a = np.diag([1.0, 2.0, 5.0])
    lam, _, _ = port.lanczos_restarted(torch.from_numpy(a), k=64,
                                       n_restarts=3, device="cpu")
    lam_j = jax.jit(lambda m: jr.lanczos_restarted(m, k=64, n_restarts=3)[0])(
        jnp.asarray(a))
    np.testing.assert_allclose(float(lam), 1.0, rtol=1e-10)
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=1e-10)
    with pytest.raises(ValueError, match="num_kept >= 1") as err:
        port.restart_init(torch.from_numpy(a), k=3, num_kept=0,
                          device="cpu")
    with pytest.raises(ValueError) as err_j:
        jr.restart_init(jnp.asarray(a), k=3, num_kept=0)
    assert str(err.value) == str(err_j.value)


def test_stepped_driver_matches_fused():
    """The cycle-stepped driver (``restart_init``, ``restart_cycle``,
    ``restart_extract``) is the fused ``lanczos_restarted``, bit for bit
    (in process: nothing here needs the JAX test's subprocess)."""
    n, k, cycles = 200, 16, 6
    a = _sym(n, 33)
    at = torch.from_numpy(a)
    lam_f, v_f, _ = port.lanczos_restarted(at, k, n_restarts=cycles,
                                           device="cpu")
    st = port.restart_init(at, k=k, device="cpu")
    for _ in range(cycles):
        st, _ = port.restart_cycle(at, st, k)
    lam_s, v_s, _ = port.restart_extract(st)
    assert float(lam_s) == float(lam_f)
    assert torch.equal(v_s, v_f)
    np.testing.assert_allclose(float(lam_s), np.linalg.eigvalsh(a)[0],
                               rtol=1e-9)


# -- tests/test_faulttolerance.py ---------------------------------------------

def _run_worker(ckpt_dir, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, os.path.abspath(__file__),
                           ckpt_dir, *extra], capture_output=True, text=True,
                          timeout=300, cwd=ROOT, env=env)


def test_sigkill_midrun_then_resume_matches_uninterrupted(tmp_path):
    """A worker SIGKILLs itself after cycle 2; relaunched, it resumes from
    the last checkpoint, runs only the remaining cycles, and ends bit for
    bit where an uninterrupted run ends."""
    clean = _run_worker(str(tmp_path / "clean"))
    assert clean.returncode == 0, clean.stderr[-2000:]
    done_clean = [ln for ln in clean.stdout.splitlines()
                  if ln.startswith("DONE")]
    assert done_clean, clean.stdout

    crash_dir = str(tmp_path / "crash")
    crashed = _run_worker(crash_dir, "--crash-after", "2")
    assert crashed.returncode == -signal.SIGKILL, (crashed.returncode,
                                                   crashed.stderr[-500:])
    assert "DONE" not in crashed.stdout
    assert "cycle 2" in crashed.stdout

    resumed = _run_worker(crash_dir)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "resumed from cycle 2" in resumed.stdout
    ran = [ln for ln in resumed.stdout.splitlines()
           if ln.startswith("cycle ")]
    assert [ln.split()[1] for ln in ran] == ["3", "4", "5"]
    done = [ln for ln in resumed.stdout.splitlines()
            if ln.startswith("DONE")]
    assert done == done_clean
    lam = float(done[0].split("value=")[1].split()[0])
    exact = float(done[0].split("exact=")[1].split()[0])
    assert abs(lam - exact) < 1e-8 * max(1.0, abs(exact))


# -- checkpoints across the packages -----------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(jax_run, writer, tmp_path):
    """One package saves the state after cycle 2, the other loads it and
    runs cycles 3-6: the final state and λ are the uninterrupted JAX
    run's to 1e-10.  The files are the JAX package's format both ways."""
    a, v0, states, cyc = jax_run
    at = torch.from_numpy(a)
    path = str(tmp_path / "cycle_2")
    if writer == "jax":
        jck.save_pytree(path, states[2])
        like = port.restart_init(at, JAX_K, extreme="max", device="cpu")
        state = load_pytree(path, like)
        assert state.y.dtype == F64 and state.y.shape == like.y.shape
        for _ in range(JAX_CYCLES - 2):
            state, _ = port.restart_cycle(at, state, JAX_K, extreme="max")
        lam = float(port.restart_extract(state)[0])
    else:
        state = port.restart_init(at, JAX_K, extreme="max",
                                  v0=torch.from_numpy(v0), device="cpu")
        for _ in range(2):
            state, _ = port.restart_cycle(at, state, JAX_K, extreme="max")
        save_pytree(path, state)
        state = jck.load_pytree(path, states[2])
        for _ in range(JAX_CYCLES - 2):
            state = cyc(state)
        lam = float(state.theta[0])
    _assert_states_close(state, states[-1], 1e-10)
    np.testing.assert_allclose(lam, float(states[-1].theta[0]), rtol=1e-10,
                               atol=0)


def test_restart_state_from_numpy_and_tree_order(jax_run, tmp_path):
    """``restart_state_from_numpy`` carries a JAX state across in its
    dtypes; ``save_pytree``/``load_pytree`` take a dict's leaves in
    sorted key order as ``jax.tree.flatten`` does (JAX reads the port's
    file and the port JAX's), restore each leaf to ``like``'s dtype, and
    refuse a file with another leaf count."""
    st = jax_run[2][0]
    conv = port.restart_state_from_numpy(*_state_np(st), device="cpu")
    assert [t.dtype for t in conv] == [F64] * 4
    _assert_states_close(conv, st, 0.0)

    tree = {"z": torch.arange(3.0, dtype=F64), "a": (torch.ones(2, 2),
                                                     None),
            "m": [torch.tensor(5, dtype=torch.int32),
                  torch.full((2,), 0.5, dtype=torch.bfloat16)]}
    save_pytree(str(tmp_path / "port"), tree)
    like_j = {"z": jnp.zeros(3), "a": (jnp.zeros((2, 2), jnp.float32), None),
              "m": [jnp.zeros((), jnp.int32), jnp.zeros(2, jnp.bfloat16)]}
    got_j = jck.load_pytree(str(tmp_path / "port"), like_j)
    np.testing.assert_array_equal(np.asarray(got_j["z"]), [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(np.asarray(got_j["a"][0]), np.ones((2, 2)))
    assert int(got_j["m"][0]) == 5

    jck.save_pytree(str(tmp_path / "jax"), {
        "z": jnp.arange(3.0), "a": (jnp.full((2, 2), 2.0), None),
        "m": [jnp.asarray(7, jnp.int32), jnp.zeros(2)]})
    got = load_pytree(str(tmp_path / "jax"), tree)
    assert list(got) == ["z", "a", "m"] and got["a"][1] is None
    assert torch.equal(got["z"], torch.arange(3.0, dtype=F64))
    assert torch.equal(got["a"][0], torch.full((2, 2), 2.0))
    assert got["m"][0].dtype == torch.int32 and int(got["m"][0]) == 7
    assert got["m"][1].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "jax"), {"z": tree["z"]})


def test_restart_complex_hermitian_matches_eigvalsh():
    """A complex Hermitian operator through the cycles: real Ritz values,
    λ against ``eigvalsh``, a pivot-gauged eigenvector."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((96, 96)) + 1j * rng.standard_normal((96, 96))
    h = (h + h.conj().T) / 2
    lam, v, _ = port.lanczos_restarted(torch.from_numpy(h), k=20,
                                       n_restarts=10, device="cpu")
    assert lam.dtype == F64
    np.testing.assert_allclose(float(lam), np.linalg.eigvalsh(h)[0],
                               rtol=1e-10)
    hv = torch.from_numpy(h) @ v
    assert float(torch.linalg.vector_norm(hv - lam * v)) < 1e-8
    piv = v[torch.argmax(v.abs())]
    assert abs(float(piv.imag)) < 1e-14 and float(piv.real) > 0
