"""Finding a cell's parts by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix.  The configuration's
sizes are the JSON file its ``configs`` entry names; the traffic mix is
``traffic/<traffic>.json``, which names its driver,
``drivers/<driver>.py``; each per-layer metric is ``metrics/<name>.py``.
Modules are loaded by path, so any allowed name (dots included) works,
and a later cell, mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # eigbench/
ROOT = HERE.parent                                  # the checkout


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, driver and metrics."""

    def __init__(self, workload: str, bench_path: Path | None = None):
        bench = load_json(bench_path or ROOT / "BENCHMARK.json")
        by_name = {w["name"]: w for w in bench["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"there are {sorted(by_name)}")
        self.workload = by_name[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        cfg_entry = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = load_json(ROOT / cfg_entry["file"])
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.traffic_name}.json")
        self.driver = load_module(
            HERE / "drivers" / f"{self.traffic['driver']}.py",
            f"eigbench_driver_{self.traffic['driver']}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]

    def metric_reader(self, name: str):
        return load_module(HERE / "metrics" / f"{name}.py",
                           f"eigbench_metric_{name}")
