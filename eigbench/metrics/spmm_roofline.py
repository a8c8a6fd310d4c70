"""spmm_roofline: the banded blocked-ELL SpMM kernel on float32 values at
the traffic mix's block width r (K4b, ``bell_spmm_{narrow,wide}_kernel``
of ``csrc/bell_spmm.cu`` in banded mode) against its least time, in %:
values, column indices, X (N, r) and Y (N, r) once over the peak
bandwidth, over the kernel's mean time in the trace."""

from eigbench.lib import roofline

KERNEL = r"bell_spmm_(?:narrow|wide)_kernel<float, [^>]*, true>"


def read(ctx):
    times = ctx.trace.kernels(KERNEL)
    if not times:
        return None
    cfg, r = ctx.config, int(ctx.traffic["r"])
    nb = cfg["n"] // cfg["bs"]
    least = roofline.least_seconds(
        roofline.bell_product_bytes(nb, cfg["blocks_per_row"], cfg["bs"],
                                    r=r),
        roofline.bell_product_flops(nb, cfg["blocks_per_row"], cfg["bs"],
                                    r=r))
    return roofline.share_pct(least, sum(times) * 1e-6 / len(times))
