"""Rules the port keeps: it imports neither JAX nor the JAX package, its
entry points never run on the CPU unless asked, its reductions never run
in TF32, and ``chip_smoke.py`` gives no result without a card."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

import dominantsparseeigenad_tpu_torch as port
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
