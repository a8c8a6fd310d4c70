"""Readings that a cell's limits are set from, at the cell's own size.

    python3 eigbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 3] [--witness f32]

For each seed, in one process: the cell's inputs from that seed, one
checked solve on the program (the first solve the run would check),
and its numbers against the float64 reference (the lower readings).
For the first ``--control-seeds`` seeds, the control too: the reference
itself in the precision one step below the configuration's (the mix's
``control``), compared the same way (the upper readings).  A witness
precision (e.g. plain float32) may be read beside it.  Prints one JSON
line per seed and a summary: the largest program reading and the
smallest control reading of each number.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from eigbench.lib import harness  # noqa: E402
from eigbench.lib.loader import Cell  # noqa: E402
from eigbench.lib.spans import sync  # noqa: E402


def readings(cell, seeds, n_control, witness, device):
    port = importlib.import_module(harness.PORT)
    drv = cell.driver
    control = cell.traffic["control"]
    out = []
    for n_seed, seed in enumerate(seeds):
        ctx = harness.Context(cell, seed, device, port)
        state = drv.setup(ctx)
        if n_seed == 0:
            drv.solve(state, drv.inputs(state, 0, "warm"), None)
        i = harness._sample(cell, seed)[0]
        inp = drv.inputs(state, i, "timed")
        t0 = time.perf_counter()
        got = drv.digest(state, inp, drv.solve(state, inp, None))
        sync(device)
        t_solve = time.perf_counter() - t0
        drv.release(state)
        gc.collect()
        t0 = time.perf_counter()
        ref = drv.reference(state, inp, "f64")
        sync(device)
        row = {"seed": seed, "solve": i, "solve_s": t_solve,
               "reference_s": time.perf_counter() - t0,
               "program": drv.compare(got, ref)}
        if n_seed < n_control:
            row["control"] = drv.compare(drv.reference(state, inp, control),
                                         ref)
            if witness:
                row[witness] = drv.compare(
                    drv.reference(state, inp, witness), ref)
        print("CAL " + json.dumps(row), flush=True)
        out.append(row)
        del state, got, ref
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--witness", default=None)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    rows = readings(cell, args.seeds, args.control_seeds, args.witness,
                    "cuda")
    names = list(rows[0]["program"])
    summary = {
        "lower": {k: max(r["program"][k] for r in rows) for k in names},
        "upper": {k: min(r["control"][k] for r in rows if "control" in r)
                  for k in names},
        "limits": cell.traffic["limits"]}
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
