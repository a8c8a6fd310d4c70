"""Rules the port keeps: it imports neither JAX nor the JAX package, its
entry points never run on the CPU unless asked, its reductions never run
in TF32, and ``chip_smoke.py`` gives no result without a card."""

import importlib
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import torch

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models
from dominantsparseeigenad_tpu_torch.ops import operators

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "dominantsparseeigenad_tpu_torch"

torch.set_num_threads(2)

# The JAX package's name is a prefix of the port's, so match it exactly.
_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax(\.|\s|$)"),
    re.compile(r"dominantsparseeigenad_tpu\."),
    re.compile(r"from\s+dominantsparseeigenad_tpu\s"),
    re.compile(r"import\s+dominantsparseeigenad_tpu\s*$"),
]


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "import dominantsparseeigenad_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert 'dominantsparseeigenad_tpu_torch.ops.eigh' in names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 8


def test_import_scan_covers_the_parallel_package():
    """The scan below reads every source of ``parallel/``, and the import
    check above imports every module of it with JAX blocked."""
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"parallel/__init__.py", "parallel/mesh.py",
            "parallel/collectives.py", "parallel/sharded.py",
            "parallel/sharded_sparse.py"} <= names
    code = (
        "import sys, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "import dominantsparseeigenad_tpu_torch as p\n"
        "print(' '.join(m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert {f"dominantsparseeigenad_tpu_torch.parallel.{m}" for m in
            ("mesh", "collectives", "sharded", "sharded_sparse")} <= walked


def test_import_scan_covers_the_tfim_and_observables_modules():
    """The scan below reads ``models/`` and ``ops/observables.py``, and
    the import check imports them with JAX blocked."""
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"models/__init__.py", "models/tfim.py",
            "ops/observables.py"} <= names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "import dominantsparseeigenad_tpu_torch.models.tfim\n"
        "import dominantsparseeigenad_tpu_torch.ops.observables\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_import_scan_covers_the_precond_module():
    """The scan below reads ``ops/precond.py``, and the import check
    imports it with JAX blocked."""
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"ops/precond.py", "ops/cg.py", "ops/lanczos.py"} <= names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "import dominantsparseeigenad_tpu_torch.ops.precond\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_import_scan_covers_the_restart_gen_and_utils_modules():
    """The scan below reads ``ops/restart.py``, ``ops/gen.py`` and
    ``utils/``, and the import check imports them with JAX blocked."""
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"ops/restart.py", "ops/gen.py", "utils/__init__.py",
            "utils/checkpoint.py"} <= names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "import dominantsparseeigenad_tpu_torch.ops.restart\n"
        "import dominantsparseeigenad_tpu_torch.ops.gen\n"
        "import dominantsparseeigenad_tpu_torch.utils.checkpoint\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_import_scan_covers_the_eig_module():
    """The scan below reads ``ops/eig.py``, and the import check imports
    it with JAX blocked."""
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert "ops/eig.py" in names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "import dominantsparseeigenad_tpu_torch.ops.eig\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_import_scan_covers_the_ising2d_modules():
    """The scan below reads ``ops/decomp.py``, ``ops/svd.py`` and
    ``models/ising2d.py``, and the import check imports them with JAX
    blocked."""
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"ops/decomp.py", "ops/svd.py", "models/ising2d.py"} <= names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "import dominantsparseeigenad_tpu_torch.ops.decomp\n"
        "import dominantsparseeigenad_tpu_torch.ops.svd\n"
        "import dominantsparseeigenad_tpu_torch.models.ising2d\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_source_imports_the_jax_package(path):
    for no, line in enumerate(path.read_text().splitlines(), 1):
        for pat in _FORBIDDEN:
            assert not pat.search(line), f"{path.name}:{no}: {line}"


def test_forbidden_patterns_do_not_match_the_port_itself():
    ok = ["import dominantsparseeigenad_tpu_torch",
          "from dominantsparseeigenad_tpu_torch.ops import sparse",
          "import jaxtyping_like_name"]
    bad = ["import jax", "from jax import numpy",
           "from dominantsparseeigenad_tpu.ops import sparse",
           "from dominantsparseeigenad_tpu import dominant_eigh",
           "import dominantsparseeigenad_tpu"]
    assert not any(p.search(s) for s in ok for p in _FORBIDDEN)
    assert all(any(p.search(s) for p in _FORBIDDEN) for s in bad)


def _entry_points():
    a = torch.eye(8, dtype=torch.float64)
    v = torch.zeros(8, dtype=torch.float64)
    v[0] = 1.0
    vals = torch.zeros(1, 1, 8, 8)
    cols = torch.zeros(1, 1, dtype=torch.int32)
    return {
        "random_bell_operator": lambda: port.random_bell_operator(16, 8, 1),
        "BellOperator.from_dense": lambda: port.BellOperator.from_dense(
            a.numpy(), bs=8),
        "bell_operator_from_numpy": lambda: port.bell_operator_from_numpy(
            vals.numpy(), cols.numpy(), 8),
        "dense_operator_from_numpy": lambda: port.dense_operator_from_numpy(
            a.numpy()),
        "MatrixFreeOperator": lambda: port.MatrixFreeOperator(
            lambda p, x: x, None, 8),
        "lanczos": lambda: port.lanczos(a, 4),
        "lanczos_eigh": lambda: port.lanczos_eigh(a, 4, extreme="min"),
        "cg": lambda: port.cg(lambda x: x, v),
        "solve_deflated": lambda: port.solve_deflated(a, 1.0, v, v),
        "solve_deflated_info": lambda: port.solve_deflated_info(a, 1.0, v, v),
        "dominant_eigh": lambda: port.dominant_eigh(a, k=4),
        "lobpcg_eigh": lambda: port.lobpcg_eigh(a, 2),
        "dominant_eigh_multi": lambda: port.dominant_eigh_multi(a, r=2, k=4),
        "dominant_eigh_multi lobpcg": lambda: port.dominant_eigh_multi(
            a, r=2, k=4, method="lobpcg"),
        # The SpMM's device is its tensors'; a user reaches it through a
        # BellOperator, made on CUDA unless asked otherwise.
        "bell_spmm": lambda: port.bell_spmm(
            *(t.to(port.resolve_device()) for t in (vals, cols, a[:, :2]))),
        "BellOperator.matmat": lambda: port.BellOperator.from_dense(
            a.numpy(), bs=8).matmat(a[:, :2]),
        "row_sharded_bell_operator_from_numpy":
            lambda: port.row_sharded_bell_operator_from_numpy(
                vals.numpy(), cols.numpy(), 8),
        "fidelity_susceptibility": lambda: port.fidelity_susceptibility(
            lambda g: a + g * a, 0.5, k=4),
        "tfim_zz_diagonal": lambda: models.tfim_zz_diagonal(4),
        "tfim_operator": lambda: models.tfim_operator(4, 1.0),
        "tfim_dense_hamiltonian": lambda: models.tfim_dense_hamiltonian(
            4, 1.0),
        "tfim_exact_e0": lambda: models.tfim_exact_e0(4, 1.0),
        "tfim_ground_energy": lambda: models.tfim_ground_energy(4, 1.0),
        "tfim_ground_state": lambda: models.tfim_ground_state(4, 1.0),
        "tfim fidelity_susceptibility":
            lambda: models.fidelity_susceptibility(4, 1.0),
        "tfim_ed_observables": lambda: models.tfim_ed_observables(4, 1.0),
        "value_d1_d2": lambda: port.value_d1_d2(lambda x: x * x, 0.5),
        "energy_curvature": lambda: port.energy_curvature(
            lambda g: port.DenseOperator(a + g * a), 0.5, k=4),
        "eigh_safe": lambda: port.eigh_safe(a),
        "eigh_safe_truncated": lambda: port.eigh_safe_truncated(a, 2),
        "svd_safe": lambda: port.svd_safe(a),
        "svd_safe_truncated": lambda: port.svd_safe_truncated(a, 2),
        "dominant_svd": lambda: port.dominant_svd(a, r=2, k=8),
        "ising_vertex_tensor": lambda: models.ising_vertex_tensor(0.5),
        "onsager_free_energy": lambda: models.onsager_free_energy(0.5),
        "trg_free_energy": lambda: models.trg_free_energy(0.5, chi=4,
                                                          n_steps=2),
        "ctmrg_environment": lambda: models.ctmrg_environment(
            0.5, chi=4, n_steps=2),
        "ctmrg_free_energy": lambda: models.ctmrg_free_energy(
            0.5, chi=4, n_steps=2),
        "transfer_operator": lambda: models.transfer_operator(
            torch.eye(2), torch.ones(2, 2, 2), torch.ones(2, 2, 2, 2)),
        "ising_observables": lambda: models.ising_observables(
            0.5, chi=4, n_steps=2),
        "cg_info": lambda: port.cg_info(lambda x: x, v),
        "minres": lambda: port.minres(lambda x: x, v),
        "solve_spd": lambda: port.solve_spd(a, v),
        "solve_symmetric": lambda: port.solve_symmetric(a, v),
        "solve_deflated minres": lambda: port.solve_deflated(
            a, 1.0, v, v, method="minres"),
        "lanczos carry": lambda: port.lanczos(a, 4, restart_mode="carry"),
        "lanczos bf16 basis": lambda: port.lanczos(
            a.float(), 4, basis_dtype=torch.bfloat16),
        "lanczos_adaptive": lambda: port.lanczos_adaptive(a, 4),
        "power_iteration": lambda: port.power_iteration(a, 4),
        "refine_eigenpair": lambda: port.refine_eigenpair(a, 1.0, v),
        "dominant_eigh bf16 basis": lambda: port.dominant_eigh(
            a.float(), k=4, basis_dtype=torch.bfloat16, reorth_chunks=4),
        "dominant_eigh early_exit_tol": lambda: port.dominant_eigh(
            a, k=4, early_exit_tol=1e-8),
        "dominant_eigh precond": lambda: port.dominant_eigh(
            a, k=4, precond=lambda x: x),
        "dominant_eigh_multi precond": lambda: port.dominant_eigh_multi(
            a, r=2, k=4, precond=lambda x: x),
        # A preconditioner's device is its operator's, made on CUDA unless
        # asked otherwise.
        "operator_diagonal": lambda: port.operator_diagonal(
            port.BellOperator.from_dense(a.numpy(), bs=8)),
        "jacobi_precond": lambda: port.jacobi_precond(
            port.BellOperator.from_dense(a.numpy(), bs=8)),
        "block_jacobi_precond": lambda: port.block_jacobi_precond(
            port.BellOperator.from_dense(a.numpy(), bs=8)),
        "tfim_energy_gap": lambda: models.tfim_energy_gap(4, 1.0),
        "tfim_observables_sweep": lambda: models.tfim_observables_sweep(
            4, [1.0]),
        "dominant_eig": lambda: port.dominant_eig(a),
        "dominant_eig arnoldi": lambda: port.dominant_eig(a,
                                                          method="arnoldi"),
        "dominant_eig_multi": lambda: port.dominant_eig_multi(a),
        "solve_general": lambda: port.solve_general(a, v),
        "bicgstab": lambda: port.bicgstab(lambda x: x, v),
        "gmres": lambda: port.gmres(lambda x: x, v),
        "transfer_spectral_gap": lambda: models.transfer_spectral_gap(
            0.5, chi=4, n_steps=2),
        "correlation_length": lambda: models.correlation_length(
            0.5, chi=4, n_steps=2),
        "dominant_eig_pair": lambda: port.dominant_eig_pair(a),
        "dominant_eig_spectrum": lambda: port.dominant_eig_spectrum(a),
        "spectrum_structure": lambda: port.spectrum_structure(a),
        # The sparse formats' constructors from host data, made on CUDA
        # unless asked otherwise; an operator built from tensors lives
        # where its tensors do.
        "COOOperator.from_dense": lambda: port.COOOperator.from_dense(
            a.numpy()),
        "CSROperator.from_dense": lambda: port.CSROperator.from_dense(
            a.numpy()),
        "CSROperator.from_scipy": lambda: port.CSROperator.from_scipy(
            scipy.sparse.csr_matrix(a.numpy())),
        "BCOOOperator": lambda: port.BCOOOperator(
            a.to(port.resolve_device())),
        "coo_operator_from_numpy": lambda: port.coo_operator_from_numpy(
            np.arange(8), np.arange(8), np.ones(8), 8),
        "csr_operator_from_numpy": lambda: port.csr_operator_from_numpy(
            np.arange(9), np.arange(8), np.ones(8), 8),
        "bcoo_operator_from_numpy": lambda: port.bcoo_operator_from_numpy(
            np.stack([np.arange(8)] * 2, axis=1), np.ones(8), 8),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_needs_a_card_or_device_cpu(name, monkeypatch):
    """Without device=, an entry point runs on CUDA: with no card it raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_cpu_operator_on_a_cuda_call_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="runs on cuda"):
        port.dominant_eigh(torch.eye(8, dtype=torch.float64), k=4)


@pytest.mark.parametrize("call", [
    lambda a: port.lobpcg_eigh(a, 2),
    lambda a: port.dominant_eigh_multi(a, r=2, k=4),
    lambda a: port.dominant_eigh_multi(a, r=2, k=4, method="lobpcg"),
], ids=["lobpcg_eigh", "dominant_eigh_multi", "dominant_eigh_multi_lobpcg"])
def test_cpu_operator_on_a_cuda_block_call_is_refused(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="runs on cuda"):
        call(torch.eye(8, dtype=torch.float64))


def test_tf32_is_off_and_refused():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    a = torch.eye(3)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            operators.hmatmul(a, a)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_gives_no_result_without_a_card(alone, tmp_path):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _complex_hermitian():
    """The input that showed the fault (ROADMAP.md queue 3, F1): a 16 x 16
    complex128 Hermitian matrix."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(16, 16, dtype=torch.complex128, generator=gen)
    return (a + a.conj().T) / 2


_BELL = (r"blocked-ELL kernels .* have no complex dtype "
         r"\(ROADMAP\.md queue 1 item 17\)")
_SHARDED = r"row-sharded tier is real only .*\(ROADMAP\.md queue 1 item 14\)"
_ISING = r"real weights, tensors and transfer matrices"


def _complex_calls():
    """The calls that still refuse complex input, each with the reason
    its message must name.  Every other entry point takes complex input
    now and is held against the JAX package in
    ``tests/test_torch_complex.py::test_complex_input_matches_jax``."""
    h = _complex_hermitian()
    vals = torch.zeros(2, 1, 8, 8, dtype=torch.complex128)
    cols = torch.zeros(2, 1, dtype=torch.int32)
    real_vals = vals.real.contiguous()
    ising = dict(dtype=torch.complex128, device="cpu")
    flow = dict(chi=4, n_steps=2, **ising)
    return {
        "BellOperator vals": (
            lambda: port.BellOperator(vals, cols, 16), _BELL),
        "BellOperator compute_dtype": (
            lambda: port.BellOperator(real_vals, cols, 16,
                                      compute_dtype=torch.complex128),
            _BELL),
        "BellOperator.with_vals": (
            lambda: port.BellOperator(real_vals, cols, 16).with_vals(vals),
            _BELL),
        "RowShardedOperator": (lambda: port.RowShardedOperator(h), _SHARDED),
        "RowShardedBellOperator": (
            lambda: port.RowShardedBellOperator(vals, cols, 16), _SHARDED),
        "ising_vertex_tensor": (
            lambda: models.ising_vertex_tensor(0.5, **ising), _ISING),
        "onsager_free_energy": (
            lambda: models.onsager_free_energy(0.5, **ising), _ISING),
        "trg_free_energy": (
            lambda: models.trg_free_energy(0.5, **flow), _ISING),
        "ctmrg_free_energy": (
            lambda: models.ctmrg_free_energy(0.5, **flow), _ISING),
        "ising_observables": (
            lambda: models.ising_observables(0.5, **flow), _ISING),
        "transfer_spectral_gap": (
            lambda: models.transfer_spectral_gap(0.5, **flow), _ISING),
        "correlation_length": (
            lambda: models.correlation_length(0.5, **flow), _ISING),
    }


@pytest.mark.parametrize("name", sorted(_complex_calls()))
def test_complex_input_is_refused(name):
    """Where the port has no complex form (the blocked-ELL kernels, the
    row-sharded tier, the real Ising model) complex input is refused with
    a TypeError that names the reason and its ROADMAP.md item, not failed
    with incidental errors."""
    call, reason = _complex_calls()[name]
    with pytest.raises(TypeError, match=reason):
        call()


def test_no_message_names_the_finished_or_a_wrong_item():
    """The complex item (5) and the formats and algebra (items 6 and 7)
    are done, and the sharded tier's refusals name item 14, not item 12
    (the spectral tiers)."""
    for path in _sources():
        text = path.read_text()
        assert "queue 1 item 5)" not in text, path.name
        assert not re.search(r"items\s+6\s+and\s+7", text), path.name
        if path.parent.name == "parallel":
            assert "queue 1 item 12)" not in text, path.name


def test_hdot_fault_input_is_what_the_refusal_guards():
    """The F1 observation: torch.dot does not conjugate, so a complex
    <x, x> is not ||x||^2.  ``hdot`` conjugates now (``torch.vdot``, the
    JAX package's ``jnp.vdot``) and gives ||x||^2 on that same input."""
    x = _complex_hermitian()[:, 0]
    assert not torch.allclose(torch.dot(x, x).real,
                              torch.linalg.vector_norm(x) ** 2)
    assert torch.allclose(port.hdot(x, x),
                          torch.linalg.vector_norm(x).to(x.dtype) ** 2)


@pytest.mark.parametrize("call", [
    lambda: port.make_mesh(n_batch=2),
    lambda: port.RowShardedOperator(torch.eye(4), mode="ring"),
    lambda: port.RowShardedBellOperator(
        torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, dtype=torch.int32), 4,
        mode="ring"),
], ids=["make_mesh n_batch", "RowShardedOperator ring",
        "RowShardedBellOperator ring"])
def test_sharded_refusals_name_item_14(call):
    """F7: the batch axis and mode="ring" wait for the rest of
    ``parallel/``, queue 1 item 14."""
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md, queue 1 item 14\)"):
        call()


def test_option_classes_and_pair_solvers_are_exported():
    """F8: the option classes and the complex half of ``ops/eig.py`` are
    exported by ``ops`` and by the package, as the JAX package's
    ``__init__`` exports them."""
    ops_pkg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops")
    for name in ("EighOptions", "EighMultiOptions", "EigOptions",
                 "PowerInfo", "dominant_eig_pair", "dominant_eig_spectrum",
                 "spectrum_structure"):
        assert name in port.__all__ and name in ops_pkg.__all__, name
        assert getattr(port, name) is getattr(ops_pkg, name)
    assert port.EighOptions().k == 128
    assert port.EighMultiOptions().r == 4


def test_restart_and_pencil_solvers_are_exported():
    """Items 10 and 11: the thick-restart and generalized-pencil names
    that JAX's ``ops/__init__.py`` exports are exported by the port's
    ``ops`` and package, and ``utils`` has the checkpoint functions."""
    ops_pkg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops")
    utils = importlib.import_module("dominantsparseeigenad_tpu_torch.utils")
    for name in ("lanczos_restarted", "RestartState", "restart_init",
                 "restart_cycle", "restart_extract", "lobpcg_eigh_general",
                 "dominant_eigh_gen", "EighGenOptions",
                 "solve_deflated_pencil"):
        assert name in port.__all__ and name in ops_pkg.__all__, name
        assert getattr(port, name) is getattr(ops_pkg, name)
    for name in ("save_pytree", "load_pytree", "save_orbax", "load_orbax"):
        assert name in utils.__all__, name
    assert port.EighGenOptions().r == 4
    assert port.RestartState._fields == ("theta", "y", "s", "q")


def _port_functions():
    """Every ``torch.autograd.Function`` the port defines, by name."""
    found = {}
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        mod = importlib.import_module(".".join(rel.parts))
        for name, obj in vars(mod).items():
            if (isinstance(obj, type)
                    and issubclass(obj, torch.autograd.Function)
                    and obj.__module__ == mod.__name__):
                found[f"{mod.__name__}.{name}"] = obj
    return found


def test_every_function_composes_with_torch_func():
    """All 16 Functions (the 15 of the solvers, decompositions and
    collectives, the generalized pencil's two among them, and the pair
    solver's subclass) use the ``setup_context`` form (a forward without
    ctx), define a ``jvp`` and a ``vmap`` of their own, and none asks
    PyTorch to generate its vmap rule (the solvers read the host)."""
    import inspect
    functions = _port_functions()
    assert len(functions) == 16, sorted(functions)
    base = torch.autograd.Function
    for name, cls in functions.items():
        assert cls.setup_context is not base.setup_context, name
        assert "ctx" not in inspect.signature(cls.forward).parameters, name
        assert cls.jvp is not base.jvp, name
        assert cls.vmap is not base.vmap, name
        assert not cls.generate_vmap_rule, name
        # A subclass gets a vmap rule that applies itself, not its base.
        for sub in cls.__subclasses__():
            assert sub.vmap is not cls.vmap, sub.__name__


def _family(kind):
    """``g -> A + g B`` for a 16 x 16 symmetric pair (B sparse) as a COO,
    a CSR (each built inside the transforms from its host arrays) or a
    composite (Shifted(Sum(Dense, Scaled(CSR, g)), σ)), float64."""
    gen = torch.Generator().manual_seed(5)
    a, b = torch.randn(2, 16, 16, dtype=torch.float64, generator=gen)
    b = b * (torch.rand(16, 16, generator=gen) < 0.4)
    a, b = (a + a.T) / 2, (b + b.T) / 2
    rows, cols = np.nonzero(a.numpy())
    csr = port.CSROperator.from_dense(b, device="cpu")
    if kind == "coo":
        return lambda g: port.COOOperator(
            torch.from_numpy(rows).to(torch.int32),
            torch.from_numpy(cols).to(torch.int32),
            a[rows, cols] + g * b[rows, cols], 16)
    if kind == "csr":
        dense = port.CSROperator.from_dense(a, device="cpu")
        return lambda g: port.CSROperator(
            dense.indptr.long(), dense.indices.long(),
            a[rows, cols] + g * b[rows, cols], 16)
    return lambda g: port.ShiftedOperator(
        port.DenseOperator(a) + g * csr, 0.25)


@pytest.mark.parametrize("kind", ["coo", "csr", "composite"])
def test_every_operator_format_composes_with_torch_func(kind):
    """The sparse formats and the composites hold the same ``torch.func``
    contract as the Functions above: through ``dominant_eigh``,
    ``grad`` equals ``jvp``, ``hessian`` equals a jvp of a jvp, and
    ``vmap`` over couplings equals the loop."""
    make = _family(kind)

    def e0(g):
        return port.dominant_eigh(make(g), k=16, tol=1e-12,
                                  device="cpu")[0]

    g = torch.tensor(0.7, dtype=torch.float64)
    one = torch.ones_like(g)
    d1 = torch.func.grad(e0)(g)
    _, d1_fwd = torch.func.jvp(e0, (g,), (one,))
    d2 = torch.func.hessian(e0)(g)
    _, d2_fwd = torch.func.jvp(lambda s: torch.func.jvp(e0, (s,), (one,))[1],
                               (g,), (one,))
    gs = torch.tensor([0.5, 0.7, 1.1], dtype=torch.float64)
    lanes = torch.func.vmap(e0)(gs)
    loop = torch.stack([e0(x) for x in gs])
    torch.testing.assert_close(d1, d1_fwd, rtol=1e-8, atol=0)
    torch.testing.assert_close(d2, d2_fwd, rtol=1e-6, atol=0)
    torch.testing.assert_close(lanes, loop, rtol=1e-12, atol=0)

