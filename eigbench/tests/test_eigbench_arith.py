"""The yardstick's arithmetic against hand counts: roofline bytes, and
the trace's idle share, ranges and attribution on synthetic events."""

import pytest

from eigbench.lib import roofline
from eigbench.lib.trace import Trace, idle_gaps, union_length


def test_bell_bytes_by_hand():
    # 2 block-rows, 3 slots, 2 x 2 blocks: 24 values, 6 indices, N = 4.
    assert roofline.bell_product_bytes(2, 3, 2) == 24 * 4 + 6 * 4 + 2 * 4 * 4
    assert roofline.bell_product_bytes(2, 3, 2, r=3) == \
        24 * 4 + 6 * 4 + 2 * 4 * 3 * 4
    assert roofline.bell_product_flops(2, 3, 2, r=3) == 2 * 24 * 3


def test_config5_bounds_match_the_kernel_table():
    nb, m, bs = 4096, 17, 128
    spmv = roofline.least_seconds(roofline.bell_product_bytes(nb, m, bs),
                                  roofline.bell_product_flops(nb, m, bs))
    spmm = roofline.least_seconds(
        roofline.bell_product_bytes(nb, m, bs, r=8),
        roofline.bell_product_flops(nb, m, bs, r=8))
    assert spmv * 1e3 == pytest.approx(1.364, abs=5e-4)
    assert spmm * 1e3 == pytest.approx(1.372, abs=5e-4)


def test_tfim_bytes_by_hand():
    assert roofline.tfim_matvec_bytes(3) == 3 * 4 * 8
    assert roofline.tfim_matvec_bytes(24) == 201326592


def test_share_pct():
    assert roofline.share_pct(1.0, 2.0) == 50.0
    assert roofline.share_pct(1.0, 0.0) is None


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (8, 20)]
    assert union_length(iv, 0, 10) == 3 + 1 + 2
    assert idle_gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert idle_gaps([], 0, 4) == [(0, 4)]


def _events():
    x = dict(ph="X")
    return [
        dict(x, cat="user_annotation", name="eigbench_solve", ts=0, dur=100,
             tid=1),
        dict(x, cat="user_annotation", name="lanczos_matvec", ts=10, dur=10,
             tid=1),
        dict(x, cat="user_annotation", name="lanczos_matvec", ts=40, dur=10,
             tid=1),
        dict(x, cat="cpu_op", name="aten::mm", ts=60, dur=30, tid=1),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", ts=12, dur=1,
             tid=1, args={"correlation": 1}),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", ts=42, dur=1,
             tid=1, args={"correlation": 2}),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", ts=61, dur=1,
             tid=1, args={"correlation": 3}),
        dict(x, cat="kernel", name="flip", ts=15, dur=20,
             args={"correlation": 1}),
        dict(x, cat="kernel", name="flip", ts=45, dur=10,
             args={"correlation": 2}),
        dict(x, cat="kernel", name="gemv", ts=62, dur=18,
             args={"correlation": 3}),
        dict(x, cat="gpu_memcpy", name="Memcpy DtoH", ts=90, dur=5,
             args={"correlation": 4}),
    ]


def test_trace_window_idle_and_ranges():
    t = Trace(_events())
    assert (t.lo, t.hi) == (0, 100)
    assert t.busy_us() == 20 + 10 + 18 + 5
    assert t.idle_share() == pytest.approx(1 - 53 / 100)
    assert t.count_ranges("lanczos_matvec") == 2
    assert t.device_us_under("lanczos_matvec") == (30.0, 2)
    assert t.kernel_count() == 3
    assert t.kernels("^flip$") == [20.0, 10.0]
    assert t.device_ops()[0] == ["flip", pytest.approx(30e-6)]


def test_trace_idle_gaps_named_by_host():
    # gaps (middle): 0-15 (7.5, the solve only), 35-45 (40, the second
    # matvec range), 55-62 (58.5, the solve: mm starts at 60), 80-90 (85,
    # mm), 95-100 (97.5, the solve)
    named = dict(Trace(_events()).idle_by_host())
    assert named["lanczos_matvec"] == pytest.approx(10e-6)
    assert named["eigbench_solve"] == pytest.approx((15 + 7 + 5) * 1e-6)
    assert named["aten::mm"] == pytest.approx(10e-6)


def test_no_window_reads_none():
    t = Trace([])
    assert t.idle_share() is None


def _block_driver():
    from eigbench.lib.loader import Cell
    return Cell("config5.block8").driver


def test_ritz_clusters_by_relative_gap():
    import torch
    lams = torch.tensor([-10.0, -9.999, -9.0, -8.9995, -8.0],
                        dtype=torch.float64)
    assert _block_driver().clusters(lams, 1e-3) == [[0, 1], [2, 3], [4]]
    assert _block_driver().clusters(lams, 1e-5) == [[0], [1], [2], [3], [4]]


def test_block_vectors_rotate_freely_only_within_a_cluster():
    import math

    import torch
    drv = _block_driver()
    gen = torch.Generator().manual_seed(0)
    w = torch.linalg.qr(torch.randn(50, 4, dtype=torch.float64,
                                    generator=gen))[0]
    lams = torch.tensor([-3.0, -2.9999, -2.0, -1.0], dtype=torch.float64)
    grad = {"rows": torch.ones(3), "blocks": torch.ones(3), "norm": 1.0}
    ref = {"lams": lams, "vecs": w, "grad": grad,
           "clusters": drv.clusters(lams, 1e-3)}
    c, s = math.cos(0.3), math.sin(0.3)
    rot = torch.eye(4, dtype=torch.float64)

    def read(mix):
        got = {"lams": lams, "vecs": w @ mix, "grad": grad}
        return drv.compare(got, ref)["vecs"]
    inside = rot.clone()
    inside[:2, :2] = torch.tensor([[c, -s], [s, c]])
    across = rot.clone()
    across[2:, 2:] = torch.tensor([[c, -s], [s, c]])
    assert read(inside) < 1e-12
    assert read(across) == pytest.approx(s, rel=1e-6)
    assert read(-rot) < 1e-12      # a column's sign is free
