"""tfim_product_roofline: the matrix-free TFIM product against its least
time, in %, read at the operator itself.  Least bytes: x read once, the
zz diagonal read once, y written once (float32), over the peak
bandwidth; measured: the device time launched under the ``tfim_matvec``
ranges of ``models/tfim.py`` over their count, every product of the
solve (Lanczos, the restart's cycles, the CG, the rules' products)."""

from eigbench.lib import roofline


def read(ctx):
    us, launches = ctx.trace.device_us_under("tfim_matvec")
    count = ctx.trace.count_ranges("tfim_matvec")
    if not launches or not count:
        return None
    least = roofline.least_seconds(
        roofline.tfim_matvec_bytes(ctx.config["n_spins"]))
    return roofline.share_pct(least, us * 1e-6 / count)
