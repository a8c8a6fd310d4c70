"""The readers of the port's own ranges and counters (``ops/spans.py``)
on hand-built traces: each reads its ranges on every host thread, and
reads None where its range or counter is absent (a port without them,
whose result line then leaves the metric out)."""

from types import SimpleNamespace

import pytest

from eigbench.lib import roofline
from eigbench.lib.loader import HERE, load_module
from eigbench.lib.trace import Trace

MAIN, AUTOGRAD = 1, 2          # the solving thread, autograd's device thread


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py",
                       f"eigbench_metric_{name}")


def _range(name, ts, dur, tid=MAIN):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur,
                tid=tid)


def _launch(corr, ts, tid=MAIN):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts,
                dur=1, tid=tid, args={"correlation": corr})


def _kernel(corr, ts, dur, name="k"):
    return dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur,
                args={"correlation": corr})


def _ctx(events, n_solves=2, counts=None, config=None):
    port = SimpleNamespace()
    if counts is not None:
        port.ops = SimpleNamespace(spans=SimpleNamespace(counts=counts))
    return SimpleNamespace(trace=Trace(events), n_solves=n_solves, port=port,
                           config=config or {"n_spins": 10})


def _window(end=1000):
    return [_range("eigbench_solve", 0, end / 2),
            _range("eigbench_solve", end / 2, end / 2)]


def _launched_under(name, spans, kernel_us, tid=MAIN, corr0=0):
    """A ``name`` range at each start of ``spans`` on ``tid``, each
    launching one kernel of ``kernel_us``."""
    out = []
    for i, ts in enumerate(spans):
        corr = corr0 + i
        out += [_range(name, ts, 10, tid), _launch(corr, ts + 2, tid),
                _kernel(corr, ts + 5, kernel_us)]
    return out


@pytest.mark.parametrize("metric,name", [
    ("lobpcg_rr_ms", "lobpcg_rayleigh_ritz"),
    ("restart_reorth_ms", "restart_reorth")])
def test_device_time_under_a_range_per_solve(metric, name):
    events = _window() + _launched_under(name, [100, 300, 600], 40)
    # A launch outside the range does not count.
    events += [_launch(99, 700), _kernel(99, 705, 50)]
    assert reader(metric).read(_ctx(events)) == pytest.approx(
        3 * 40e-3 / 2)
    assert reader(metric).read(_ctx(_window())) is None


def test_ift_rule_ms_sums_both_rules_on_every_thread():
    events = (_window()
              + _launched_under("ift_backward", [100], 30, tid=AUTOGRAD)
              + _launched_under("ift_jvp", [400], 50, corr0=10))
    assert reader("ift_rule_ms").read(_ctx(events)) == pytest.approx(
        (30 + 50) * 1e-3 / 2)
    assert reader("ift_rule_ms").read(_ctx(_window())) is None


def test_tfim_product_roofline_over_the_products():
    events = _window() + _launched_under("tfim_matvec", [100, 300], 20) \
        + _launched_under("tfim_matvec", [500], 50, tid=AUTOGRAD, corr0=10)
    least = roofline.least_seconds(roofline.tfim_matvec_bytes(10))
    got = reader("tfim_product_roofline").read(_ctx(events))
    assert got == pytest.approx(100 * least / (90e-6 / 3))
    # The Krylov layer's range alone is not the operator's.
    other = _window() + _launched_under("lanczos_matvec", [100], 20)
    assert reader("tfim_product_roofline").read(_ctx(other)) is None


def test_host_reads_per_solve_counts_every_site_and_thread():
    events = _window() + [
        _range("host_read.lanczos_beta", 100, 5),
        _range("host_read.lanczos_beta", 200, 5),
        _range("host_read.cg_check", 300, 5, tid=AUTOGRAD),
        _range("host_read.lobpcg_ritz_eigh", 400, 5),
        _range("host_readout", 500, 5),
        _range("host_read.cg_check", 1200, 5)]           # after the window
    assert reader("host_reads_per_solve").read(_ctx(events)) == 2.0
    assert reader("host_reads_per_solve").read(_ctx(_window())) is None


def _copy(corr, ts, dur):
    return dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=ts,
                dur=dur, args={"correlation": corr})


def test_read_stall_counts_gaps_that_open_inside_a_read():
    events = _window() + [
        _kernel(1, 0, 95), _kernel(3, 150, 45), _kernel(5, 300, 100),
        _kernel(6, 450, 100), _kernel(8, 600, 400),
        # gap 100-150 opens where a read's copy ends: a stall of 50
        _range("host_read.lanczos_beta", 90, 20), _launch(2, 92),
        _copy(2, 95, 5),
        # gap 200-300 opens after a read launched on autograd's thread:
        # 100, though the device clock puts the copy's end after the
        # range's end on the host's
        _range("host_read.cg_check", 190, 8, tid=AUTOGRAD),
        _launch(4, 192, tid=AUTOGRAD), _copy(4, 195, 5),
        # gap 400-450 opens after work launched before this read: dispatch
        _launch(5, 290), _range("host_read.restart_dead", 395, 20),
        # gap 550-600 opens after work launched inside a read, but on
        # another thread than the read's: dispatch
        _range("host_read.lobpcg_residual", 440, 20),
        _launch(6, 445, tid=AUTOGRAD)]
    got = reader("read_stall_pct").read(_ctx(events))
    assert got == pytest.approx(100 * (50 + 100) / 1000)
    idle = Trace(events).idle_share()
    assert got < 100 * idle
    no_reads = _window() + [_kernel(1, 0, 100)]
    assert reader("read_stall_pct").read(_ctx(no_reads)) is None


def test_cg_useful_pct_reads_the_port_counter():
    events = _window() + [_range("cg_matvec", 100 + 10 * i, 5)
                          for i in range(20)]
    got = reader("cg_useful_pct").read(
        _ctx(events, counts={"cg_iterations": 17}))
    assert got == pytest.approx(85.0)
    # A port without counters, or a trace with no CG, reads None.
    assert reader("cg_useful_pct").read(_ctx(events)) is None
    assert reader("cg_useful_pct").read(
        _ctx(_window(), counts={"cg_iterations": 17})) is None
