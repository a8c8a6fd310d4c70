"""The 1D transverse-field Ising chain, H(g) = -sum_i sz_i sz_{i+1} -
g sum_i sx_i with periodic boundaries, on 2^n amplitudes: its per-solve
inputs and its plain product.

Basis state j has spin s_i = 1 - 2 bit_i(j); sx_i maps j to j XOR 2^i.
"""

from __future__ import annotations

import torch

from .seeds import generator, rng


def couplings(traffic, seed: int, count: int, stream: str = "timed"):
    """The first ``count`` couplings of a run: stratified over
    ``traffic["g_range"]`` so that every seed covers the range alike.
    Each cycle of ``traffic["g_strata"]`` solves visits every stratum
    once, in an order drawn from the seed, at a point drawn inside it."""
    lo, hi = traffic["g_range"]
    m = int(traffic["g_strata"])
    out, gen = [], rng(seed, "tfim-couplings", stream)
    width = (hi - lo) / m
    while len(out) < count:
        for s in gen.permutation(m):
            out.append(lo + (s + gen.uniform()) * width)
    return out[:count]


def start_vector(cfg, seed: int, i: int, device, stream="timed"):
    """The start vector of solve ``i``, float32 on ``device``."""
    return torch.randn(1 << cfg["n_spins"],
                       generator=generator(seed, "tfim-start", stream, i,
                                           device=device), device=device)


def zz_diagonal(n: int, dtype, device):
    """-sum_i sz_i sz_{i+1} = 2 * (anti-aligned bonds) - n."""
    idx = torch.arange(1 << n, dtype=torch.int64, device=device)
    anti = torch.zeros(1 << n, dtype=torch.int64, device=device)
    for i in range(n):
        anti += ((idx >> i) ^ (idx >> ((i + 1) % n))) & 1
    return (2 * anti - n).to(dtype)


def flip_sum(x: torch.Tensor, n: int) -> torch.Tensor:
    """sum_i x[j XOR 2^i]: the transverse term's n single-spin flips."""
    out = torch.zeros_like(x)
    for i in range(n):
        out += x.reshape(1 << (n - 1 - i), 2, 1 << i).flip(1).reshape(-1)
    return out


class Chain:
    """H(g) in one precision: ``matvec`` is H x, ``dmatvec`` is dH/dg x."""

    def __init__(self, n: int, g: float, prec):
        self.n, self.g, self.prec = n, float(g), prec
        self.diag = None

    def matvec(self, x):
        if self.diag is None:
            self.diag = zz_diagonal(self.n, x.dtype, x.device)
        return self.diag * x - self.g * flip_sum(x, self.n)

    def dmatvec(self, x):
        return -flip_sum(x, self.n)
