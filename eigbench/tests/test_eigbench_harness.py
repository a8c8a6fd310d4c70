"""Whole runs of each cell at a tiny size on the CPU: the result line's
keys, ``correct`` on the sound program, and ``correct`` false with the
timed path broken underneath (the faults a cell can have: a product that
returns its state unchanged, half of a block left out, an answer altered
where it is produced).  The harness's look for a card is skipped: the run
is driven through ``harness.run`` with ``device="cpu"``."""

import importlib
import json

import pytest
import torch

from eigbench.lib import harness
from eigbench.lib.loader import Cell

SMALL = {
    "config5.eigval_grad": (dict(n=2048, bs=32, blocks_per_row=5),
                            dict(k=24)),
    "config5.block8": (dict(n=2048, bs=32, blocks_per_row=5), dict(k=12)),
    "tfim_n24.fidelity": (dict(n_spins=8), dict(k=30)),
    "tfim_n24.restart": (dict(n_spins=8), dict(k=16, cycles=3)),
}
SEED = 2**35 + 17
PORT = importlib.import_module(harness.PORT)
EIGH = importlib.import_module(harness.PORT + ".ops.eigh")
TFIM = importlib.import_module(harness.PORT + ".models.tfim")


def small_cell(workload):
    cell = Cell(workload)
    cfg, traffic = SMALL[workload]
    cell.config = dict(cell.config, **cfg)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


def run(workload, trace=False):
    torch.manual_seed(0)
    return harness.run(small_cell(workload), SEED, 0.2, trace, "cpu")


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= res["failed"] == 0
    assert "setup_s" in res["metrics"] and "solve_s" in res["metrics"]
    json.dumps(res)


@pytest.mark.parametrize("workload", ["config5.eigval_grad",
                                      "tfim_n24.fidelity"])
def test_traced_run_is_correct(workload):
    res = run(workload, trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] == small_cell(workload).traffic["trace_solves"]
    assert "setup_s" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _identity(self, x):
    return x.clone()


def _fault_unchanged(monkeypatch, workload):
    """A product that returns its state unchanged."""
    if workload.startswith("config5"):
        monkeypatch.setattr(PORT.BellOperator, "matvec", _identity)
        monkeypatch.setattr(PORT.BellOperator, "matmat", _identity)
    else:
        monkeypatch.setattr(TFIM, "tfim_matvec", lambda params, x: x * 1.0)


def _fault_eigenvalue(monkeypatch, workload):
    """The eigenvalue altered by 1e-3 where the solver returns it."""
    for name in ("dominant_eigh", "dominant_eigh_multi"):
        orig = getattr(PORT, name)

        def altered(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            return (out[0] * (1 + 1e-3),) + tuple(out[1:])
        monkeypatch.setattr(PORT, name, altered)


def _fault_derivative(monkeypatch, workload):
    """The IFT rule's answer altered by 5%: the cotangent product of the
    reverse rules, the deflated solve of the forward one."""
    orig_vjp, orig_solve = EIGH.partial_vjp, EIGH.solve_deflated
    monkeypatch.setattr(EIGH, "partial_vjp", lambda *a, **k: [
        None if g is None else g * 1.05 for g in orig_vjp(*a, **k)])
    monkeypatch.setattr(EIGH, "solve_deflated",
                        lambda *a, **k: orig_solve(*a, **k) * 1.1)


FAULTS = {"unchanged": _fault_unchanged, "eigenvalue": _fault_eigenvalue,
          "derivative": _fault_derivative}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_fault_is_not_correct(monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch, workload)
    try:
        res = run(workload)
    except (RuntimeError, ValueError, torch.linalg.LinAlgError):
        return        # a broken path that raises prints no result either
    assert not res["correct"], res["checks"]


def test_half_the_block_left_out_is_not_correct(monkeypatch):
    orig = PORT.BellOperator.matmat

    def half(self, x):
        y = orig(self, x)
        return torch.cat([y[:, :y.shape[1] // 2],
                          torch.zeros_like(y[:, y.shape[1] // 2:])], dim=1)
    monkeypatch.setattr(PORT.BellOperator, "matmat", half)
    try:
        res = run("config5.block8")
    except (RuntimeError, ValueError, torch.linalg.LinAlgError):
        return
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_reads_above_the_program(workload):
    """The control (the reference one precision step down) departs from
    the float64 reference by more than the program does, on every
    number but the easy ones, at this size too."""
    cell = small_cell(workload)
    ctx = harness.Context(cell, SEED, "cpu", PORT)
    drv = cell.driver
    state = drv.setup(ctx)
    inp = drv.inputs(state, 0, "timed")
    got = drv.digest(state, inp, drv.solve(state, inp, None))
    drv.release(state)
    ref = drv.reference(state, inp, "f64")
    prog = drv.compare(got, ref)
    ctrl = drv.compare(drv.reference(state, inp, cell.traffic["control"]),
                       ref)
    assert max(ctrl[k] / max(prog[k], 1e-300) for k in prog) > 3
