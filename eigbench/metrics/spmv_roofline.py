"""spmv_roofline: the banded blocked-ELL SpMV kernel on float32 values
(K4b, ``bell_spmv_banded_kernel<float, ...>`` of ``csrc/bell_spmv.cu``)
against its least time, in %: values, column indices, x and y once over
the peak bandwidth, over the kernel's mean time in the trace."""

from eigbench.lib import roofline

KERNEL = r"bell_spmv_banded_kernel<float, "


def read(ctx):
    times = ctx.trace.kernels(KERNEL)
    if not times:
        return None
    cfg = ctx.config
    least = roofline.least_seconds(
        roofline.bell_product_bytes(cfg["n"] // cfg["bs"],
                                    cfg["blocks_per_row"], cfg["bs"]),
        roofline.bell_product_flops(cfg["n"] // cfg["bs"],
                                    cfg["blocks_per_row"], cfg["bs"]))
    return roofline.share_pct(least, sum(times) * 1e-6 / len(times))
