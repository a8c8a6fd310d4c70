"""The yardstick of the kernels: the chip's published peaks and the least
bytes each product needs.

A product's roofline share is the least time the chip could take for it
over the time it took.  The least time is the larger of its operations
over the peak rate and its bytes over the peak bandwidth, with each input
read once and each output written once, whatever a kernel reads again.
The counts are of what these inputs need, so a later kernel that does
the same work is read against the same bound.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
# sheet): HBM3 bandwidth, float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def bell_product_bytes(nb: int, slots: int, bs: int, r: int = 1,
                       val_bytes: int = 4, vec_bytes: int = 4) -> int:
    """Least bytes of one blocked-ELL product ``Y = A X`` with X (N, r):
    the values and the column indices once, X once and Y once."""
    n = nb * bs
    return (nb * slots * bs * bs * val_bytes + nb * slots * 4
            + 2 * n * r * vec_bytes)


def bell_product_flops(nb: int, slots: int, bs: int, r: int = 1) -> int:
    """Operations of one real blocked-ELL product: a multiply and an add
    per stored value and column of X."""
    return 2 * nb * slots * bs * bs * r


def tfim_matvec_bytes(n_spins: int, vec_bytes: int = 4) -> int:
    """Least bytes of one matrix-free TFIM product ``y = H(g) x``: x read
    once, the zz diagonal read once, y written once."""
    return 3 * vec_bytes * (1 << n_spins)


def least_seconds(nbytes: float, flops: float = 0.0) -> float:
    """The least time of a product: bytes over the bandwidth or
    operations over the float32 rate, whichever is larger."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)


def share_pct(least_s: float, measured_s: float):
    """The roofline share in %, or None where nothing was measured."""
    if measured_s is None or measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
