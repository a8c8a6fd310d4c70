"""On the card, at each cell's own size: the control (the reference one
precision step below the configuration's) fails at least one of the
cell's limits on three seeds, and the program meets them all on the same
seeds.  Run with ``python3 -m pytest eigbench -m chip``."""

import json

import pytest

from eigbench import calibrate
from eigbench.lib import loader

WORKLOADS = [w["name"] for w in json.loads(
    (loader.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_program_holds(card, workload):
    cell = loader.Cell(workload)
    limits = cell.traffic["limits"]
    rows = calibrate.readings(cell, SEEDS, len(SEEDS), None, card)
    for row in rows:
        assert all(row["program"][k] <= limits[k] for k in limits), row
        assert any(row["control"][k] > limits[k] for k in limits), row
