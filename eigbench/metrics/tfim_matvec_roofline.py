"""tfim_matvec_roofline: the matrix-free TFIM product (``models/tfim.py``)
against its least time, in %.  Least bytes: x read once, the zz diagonal
read once, y written once (float32), over the peak bandwidth; measured:
the device time launched under the ``lanczos_matvec`` ranges over their
count."""

from eigbench.lib import roofline


def read(ctx):
    us, launches = ctx.trace.device_us_under("lanczos_matvec")
    count = ctx.trace.count_ranges("lanczos_matvec")
    if not launches or not count:
        return None
    least = roofline.least_seconds(
        roofline.tfim_matvec_bytes(ctx.config["n_spins"]))
    return roofline.share_pct(least, us * 1e-6 / count)
