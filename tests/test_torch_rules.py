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


def test_import_scan_covers_the_spectral_tier_and_heisenberg_modules():
    """The scan below reads ``ops/interior.py``, ``ops/slicing.py``,
    ``ops/spectral.py`` and ``models/heisenberg.py``, and the import
    check imports them with JAX blocked."""
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"ops/interior.py", "ops/slicing.py", "ops/spectral.py",
            "models/heisenberg.py"} <= names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "import dominantsparseeigenad_tpu_torch.ops.interior\n"
        "import dominantsparseeigenad_tpu_torch.ops.slicing\n"
        "import dominantsparseeigenad_tpu_torch.ops.spectral\n"
        "import dominantsparseeigenad_tpu_torch.models.heisenberg\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_import_scan_covers_the_utils_and_example_modules():
    """The scan below reads ``utils/timing.py``, ``utils/logging.py``,
    ``utils/diagnostics.py`` and every driver of ``examples/``, and the
    import check imports them with JAX blocked."""
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    drivers = sorted(n for n in names if n.startswith("examples/")
                     and n != "examples/__init__.py")
    assert len(drivers) == 12, drivers
    assert {"utils/timing.py", "utils/logging.py",
            "utils/diagnostics.py"} <= names
    modules = ["utils.timing", "utils.logging", "utils.diagnostics",
               *(n[:-3].replace("/", ".") for n in drivers)]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "pkg = 'dominantsparseeigenad_tpu_torch'\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(f'{pkg}.{m}')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_import_scan_covers_the_sharded_tfim_and_its_driver():
    """The scan below reads the modules of the sharded matrix-free tier
    (``parallel/collectives.py`` with ``ppermute``, ``parallel/sharded.py``,
    ``models/tfim.py``), the driver ``examples/distributed_lanczos.py``
    and ``chip_smoke.py``, and the import check imports the modules and
    the driver with JAX blocked."""
    ids = {_source_id(p) for p in _sources()}
    assert {"parallel/collectives.py", "parallel/sharded.py",
            "models/tfim.py", "examples/distributed_lanczos.py",
            "chip_smoke.py"} <= ids
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dominantsparseeigenad_tpu'] = None\n"
        "pkg = 'dominantsparseeigenad_tpu_torch'\n"
        "for m in ('parallel.collectives', 'parallel.sharded', "
        "'models.tfim', 'examples.distributed_lanczos'):\n"
        "    importlib.import_module(f'{pkg}.{m}')\n"
        "from dominantsparseeigenad_tpu_torch import (BATCH_AXIS, "
        "ShardedMatrixFreeOperator, ppermute)\n"
        "from dominantsparseeigenad_tpu_torch.models import "
        "tfim_sharded_operator\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_sharded_tier_names_match_the_jax_exports():
    """``parallel`` and ``models`` export the JAX package's names, the
    placement helpers of the sharded-vector layout (``shard_vector``,
    ``row_sharding``, ``replicated``) among them, and so does the
    package."""
    parallel = importlib.import_module("dominantsparseeigenad_tpu_torch."
                                       "parallel")
    jax_parallel = {"SHARD_AXIS", "BATCH_AXIS", "init_distributed",
                    "make_mesh", "row_sharding", "replicated",
                    "RowShardedOperator", "ShardedMatrixFreeOperator",
                    "shard_vector", "RowShardedBellOperator"}
    assert jax_parallel <= set(parallel.__all__)
    for name in jax_parallel:
        assert name in port.__all__ and getattr(port, name) is \
            getattr(parallel, name), name
    assert "tfim_sharded_operator" in models.__all__
    assert port.BATCH_AXIS == "batch" and port.SHARD_AXIS == "shards"


def test_drivers_import_without_side_effects():
    """Importing a driver parses no arguments, initializes no CUDA and
    changes no global torch setting (default dtype, threads, TF32)."""
    code = (
        "import argparse, importlib, pkgutil, sys, torch\n"
        "import dominantsparseeigenad_tpu_torch.examples as ex\n"
        "def refuse(*a, **k):\n"
        "    raise SystemExit('parse_args called on import')\n"
        "argparse.ArgumentParser.parse_args = refuse\n"
        "def state():\n"
        "    return (torch.get_default_dtype(), torch.get_num_threads(),\n"
        "            torch.backends.cuda.matmul.allow_tf32,\n"
        "            torch.backends.cudnn.allow_tf32, list(sys.argv))\n"
        "before = state()\n"
        "names = [m.name for m in pkgutil.iter_modules(ex.__path__)]\n"
        "for n in names:\n"
        "    importlib.import_module(ex.__name__ + '.' + n)\n"
        "assert state() == before, (state(), before)\n"
        "assert not torch.cuda.is_initialized()\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 12


def _source_id(path):
    """A source's path relative to the package (``examples/ising2d.py``
    and ``models/ising2d.py`` apart), or its name outside it."""
    if path.is_relative_to(PKG):
        return path.relative_to(PKG).as_posix()
    return path.name


@pytest.mark.parametrize("path", _sources(), ids=_source_id)
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
        "interior_eigh": lambda: port.interior_eigh(a, 0.5, k=4),
        "spectral_slice": lambda: port.spectral_slice(a, 0.5, 1.5, r=2),
        "spectral_bounds": lambda: port.spectral_bounds(a, k=4),
        "spectral_density": lambda: port.spectral_density(a, [0.0]),
        "trace_function": lambda: port.trace_function(a, torch.exp),
        "logdet": lambda: port.logdet(a),
        "spectral_function": lambda: port.spectral_function(a, v, [0.0],
                                                            0.1),
        "heisenberg_operator": lambda: models.heisenberg_operator(4),
        "heisenberg_dense": lambda: models.heisenberg_dense(4),
        "heisenberg_ground_energy":
            lambda: models.heisenberg_ground_energy(4),
        "tfim2d_zz_diagonal": lambda: models.tfim2d_zz_diagonal(3, 3),
        "tfim2d_operator": lambda: models.tfim2d_operator(3, 3, 1.0),
        "tfim2d_dense_hamiltonian":
            lambda: models.tfim2d_dense_hamiltonian(3, 3, 1.0),
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


_ISING = r"real weights, tensors and transfer matrices"


def _complex_calls():
    """The calls that still refuse complex input, each with the reason
    its message must name.  Every other entry point takes complex input
    now and is held against the JAX package in
    ``tests/test_torch_complex.py::test_complex_input_matches_jax``."""
    ising = dict(dtype=torch.complex128, device="cpu")
    flow = dict(chi=4, n_steps=2, **ising)
    return {
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
    """Where the port has no complex form (the real Ising model) complex
    input is refused with a TypeError that names the reason, not failed
    with incidental errors."""
    call, reason = _complex_calls()[name]
    with pytest.raises(TypeError, match=reason):
        call()


def _bell_complex_cases():
    """The blocked-ELL calls that refused complex values until the
    complex kernels came, each as ``(port call, JAX call)`` of the vals,
    cols and x of a 16 x 16 complex128 operator (2 x 2 blocks of 8);
    the row-sharded one on a one-rank group."""
    rng = np.random.default_rng(17)
    vals = (rng.standard_normal((2, 2, 8, 8))
            + 1j * rng.standard_normal((2, 2, 8, 8)))
    cols = np.array([[0, 1], [1, 0]], np.int32)
    x = rng.standard_normal(16) + 1j * rng.standard_normal(16)

    def jax_bell(v, **kw):
        import jax.numpy as jnp
        from dominantsparseeigenad_tpu import BellOperator
        return BellOperator(jnp.asarray(v), jnp.asarray(cols), 16,
                            use_pallas=False, **kw)

    def bell(v, **kw):
        return port.BellOperator(torch.from_numpy(v), torch.from_numpy(cols),
                                 16, **kw)

    c128 = dict(compute_dtype=torch.complex128)
    return {
        "BellOperator vals": (lambda: bell(vals), lambda: jax_bell(vals)),
        "BellOperator compute_dtype": (
            lambda: bell(vals.real.copy(), **c128),
            lambda: jax_bell(vals.real.copy(), compute_dtype="complex128")),
        "BellOperator.with_vals": (
            lambda: bell(vals.real.copy()).with_vals(torch.from_numpy(vals)),
            lambda: jax_bell(vals.real.copy()).with_vals(vals)),
        "RowShardedBellOperator": (
            lambda: port.RowShardedBellOperator(
                torch.from_numpy(vals), torch.from_numpy(cols), 16),
            lambda: jax_bell(vals)),
    }, x


@pytest.mark.parametrize("name", sorted(_bell_complex_cases()[0]))
def test_complex_bell_calls_match_jax(name, tmp_path):
    """The four blocked-ELL calls that refused complex values until the
    complex kernels (K5, K6) take them, and their A x and bilinear A^T x
    are the JAX package's (1e-12)."""
    cases, x = _bell_complex_cases()
    port_call, jax_call = cases[name]
    group = name == "RowShardedBellOperator"
    if group:
        port.init_distributed("gloo", f"file://{tmp_path}/store", 0, 1)
    try:
        op = port_call()
        got = [op.matvec(torch.from_numpy(x)), op.rmatvec(torch.from_numpy(x))]
    finally:
        if group:
            torch.distributed.destroy_process_group()
    jop = jax_call()
    want = [np.asarray(jop.matvec(x)), np.asarray(jop.rmatvec(x))]
    # with_vals keeps the compute dtype, in both packages.
    assert str(op.dtype) == f"torch.{np.dtype(jop.dtype).name}"
    for g, w in zip(got, want):
        assert g.dtype == torch.complex128
        assert np.abs(g.numpy() - w).max() <= 1e-12 * np.abs(w).max()


@pytest.mark.parametrize("vals_dtype, x_dtype", [
    (torch.complex128, torch.complex128),
    (torch.complex64, torch.complex128),
    (torch.complex64, torch.float32),
], ids=["complex128", "complex128_x", "complex_values_real_x"])
def test_kernel_arguments_refuse_other_complex_dtypes(vals_dtype, x_dtype):
    """The CUDA kernels take complex64 values with a complex64 x (and
    real values with it); complex128, or complex values with a real x,
    are refused, on any device, with both dtypes named."""
    spmv = importlib.import_module(
        "dominantsparseeigenad_tpu_torch.ops.bell_spmv")
    vals = torch.zeros(2, 1, 8, 8, dtype=vals_dtype)
    with pytest.raises(ValueError) as err:
        spmv._check_kernel_args(vals, torch.zeros(2, 1, dtype=torch.int32),
                                torch.zeros(16, dtype=x_dtype))
    assert str(vals_dtype) in str(err.value)
    assert str(x_dtype) in str(err.value)


def test_no_message_names_the_finished_or_a_wrong_item():
    """The complex items (5, and 17, the blocked-ELL values) and the
    formats and algebra (items 6 and 7) are done, and the sharded tier's
    refusals name item 18 (item 14 is done), not item 12 (the spectral
    tiers)."""
    for path in _sources():
        text = path.read_text()
        assert "queue 1 item 14)" not in text, path.name
        assert "queue 1 item 5)" not in text, path.name
        assert "queue 1 item 17)" not in text, path.name
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


def _solo_sharded():
    """A one-rank sharded-vector operator, its ShardGroup given (no
    process group is needed before a product)."""
    from dominantsparseeigenad_tpu_torch.parallel.mesh import ShardGroup
    sg = ShardGroup(group=None, rank=0, size=1, backend="gloo")
    return sg, port.RowShardedOperator(torch.eye(4, dtype=torch.float64), sg,
                                       vectors="sharded")


@pytest.mark.parametrize("call, error, match", [
    (lambda: port.RowShardedOperator(torch.eye(4), _solo_sharded()[0],
                                     mode="ring"),
     ValueError, r"mode='ring' needs vectors='sharded'"),
    (lambda: port.RowShardedBellOperator(
        torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, dtype=torch.int32), 4,
        _solo_sharded()[0], mode="ring"),
     ValueError, r"mode='ring' needs vectors='sharded'"),
], ids=["RowShardedOperator ring", "RowShardedBellOperator ring"])
def test_sharded_refusals_name_item_14(call, error, match):
    """F7's refusals after item 14: ring mode over replicated vectors
    (the segment a ring step would send is already on every rank).  The
    general tier carries the sharded-vector layout since item 18 was
    done, and refuses nothing there."""
    with pytest.raises(error, match=match):
        call()


def test_no_module_defines_or_calls_refuse_sharded():
    """Every solver carries the sharded-vector layout: no module of the
    port defines or calls ``refuse_sharded``, nor keeps its message."""
    for path in _sources():
        text = path.read_text()
        assert "refuse_sharded" not in text, path.name
        assert "SHARDED_REFUSAL" not in text, path.name
        assert "on vectors sharded over ranks is not ported" not in text, \
            path.name


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


def test_spectral_tiers_and_models_are_exported():
    """Items 12 and 13: the names that JAX's ``ops/__init__.py`` exports
    from ``interior.py``, ``slicing.py`` and ``spectral.py`` (with the
    option class ``InteriorOptions``) are exported by the port's ``ops``
    and package, and ``models`` has the XXZ chain and the 2D TFIM."""
    ops_pkg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops")
    for name in ("interior_eigh", "InteriorOptions", "spectral_slice",
                 "SliceInfo", "SliceOptions", "spectral_bounds",
                 "spectral_density", "trace_function", "logdet",
                 "spectral_function"):
        assert name in port.__all__ and name in ops_pkg.__all__, name
        assert getattr(port, name) is getattr(ops_pkg, name)
    for name in ("heisenberg_operator", "heisenberg_dense",
                 "heisenberg_ground_energy", "tfim2d_operator",
                 "tfim2d_zz_diagonal", "tfim2d_dense_hamiltonian"):
        assert name in models.__all__, name
    assert port.InteriorOptions().k == 64
    assert port.SliceOptions().degree == 80
    assert port.SliceInfo._fields == ("n_inside", "residual", "residuals",
                                      "converged")


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
    """All 21 Functions (the 20 of the solvers, decompositions and
    collectives, the generalized pencil's two, the spectral tiers'
    ``_InteriorEigh`` and ``_SpectralSlice``, the exchange's
    ``_Ppermute`` and the sharded layout's ``_AllGatherSharded`` and
    ``_ReduceScatterRows`` among them, and the pair solver's subclass)
    use the ``setup_context`` form (a forward without ctx), define a
    ``jvp`` and a ``vmap`` of their own, and none asks PyTorch to
    generate its vmap rule (the solvers read the host)."""
    import inspect
    functions = _port_functions()
    assert len(functions) == 21, sorted(functions)
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

