"""BENCHMARK.json and the files it names: every entry parses, every name
and unit uses the allowed characters, each cell finds its configuration,
traffic mix, driver and metric readers, and nothing imports JAX."""

import ast
import json
import re
from pathlib import Path

import pytest

from eigbench.lib import guard, loader

ROOT = loader.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "eigbench/run.py"]
    assert BENCH["paths"] == ["eigbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names():
    yield from (c["name"] for c in BENCH["configs"])
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


def test_entries_have_their_keys_and_units():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("eigbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
    names = [x["name"] for k in ("configs", "workloads") for x in BENCH[k]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert len(set(metrics)) == len(metrics)
    assert "setup_s" in metrics


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_parts(workload):
    cell = loader.Cell(workload)
    for fn in ("setup", "inputs", "solve", "digest", "release", "reference",
               "compare"):
        assert callable(getattr(cell.driver, fn))
    assert set(cell.traffic["limits"])
    assert cell.traffic["control"] in {"tf32", "bf16"}
    assert cell.traffic["check_within"] <= cell.traffic["trace_solves"]
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    # every per-layer metric of the cell moves an end-to-end one it reports
    assert {m["moves"] for m in cell.per_layer} <= e2e


def test_check_fits_the_time_limit():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "eigbench").rglob("*.py")))
def test_no_jax_import(path):
    tops = {name.split(".", 1)[0] for name in _imports(ROOT / path)}
    assert not tops & guard.FORBIDDEN, (path, tops & guard.FORBIDDEN)


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(
        ["dominantsparseeigenad_tpu_torch", "dominantsparseeigenad_tpu_torch"
         ".ops", "jaxtyping", "numpy"]) == []
    assert guard.forbidden_modules(
        ["jax.numpy", "dominantsparseeigenad_tpu.ops", "flax"]) == [
        "dominantsparseeigenad_tpu.ops", "flax", "jax.numpy"]


def test_reference_imports_nothing_of_the_port():
    for p in (ROOT / "eigbench" / "reference").glob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(p)}
        assert "dominantsparseeigenad_tpu_torch" not in tops, p
        assert not any(n and n.startswith("eigbench.drivers")
                       for n in _imports(p)), p


def test_harness_runs_nothing_of_the_jax_benchmarks():
    for p in (ROOT / "eigbench").rglob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(p) if n}
        assert not tops & {"benchmarks", "bench", "chip_smoke"}, p
