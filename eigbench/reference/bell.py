"""A symmetric blocked-ELL operator whose every slot is a ring band
(BASELINE config #5): its inputs, made from the seed, and its plain
products and gradient summaries.

The pattern is the one of the JAX package's ``random_bell_operator``:
slot 0 the diagonal block (symmetrized), then pairs of bands at offsets
±o drawn from ``np.random.default_rng(pattern_seed)``, the -o band the
transpose of the +o band, entries normal and scaled by
``1/sqrt(blocks_per_row * bs)``.  The values are drawn on the device
from the run's seed, in a few large calls.  The pattern is fixed, so
every seed gives the same work.

Nothing here imports the port: the products are a plain ``einsum`` over
chunks of block-rows, in the precision asked for.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import Precision, no_tf32
from .seeds import generator

CHUNK_ROWS = 256          # block-rows a chunk of a plain product


def make_inputs(cfg, seed: int, device):
    """``(vals, cols)``: vals (nb, blocks_per_row, bs, bs) float32 and
    cols (nb, blocks_per_row) int32, on ``device``."""
    n, bs, bpr = cfg["n"], cfg["bs"], cfg["blocks_per_row"]
    if bpr % 2 == 0 or n % bs:
        raise ValueError("need an odd blocks_per_row and bs dividing n")
    nb = n // bs
    offs = np.random.default_rng(cfg["pattern_seed"]).permutation(
        np.arange(1, nb))[:(bpr - 1) // 2]
    gen = generator(seed, "bell-values", device=device)
    scale = 1.0 / math.sqrt(bpr * bs)
    vals = torch.empty((nb, bpr, bs, bs), dtype=torch.float32,
                       device=device)
    diag = torch.randn((nb, bs, bs), generator=gen, device=device)
    vals[:, 0] = (diag + diag.transpose(-1, -2)) * (scale / 2)
    del diag
    bands = torch.randn((len(offs), nb, bs, bs), generator=gen,
                        device=device)
    bands.mul_(scale)
    i = np.arange(nb)
    cols = [i]
    for o_idx, o in enumerate(offs):
        vals[:, 1 + 2 * o_idx] = bands[o_idx]
        cols.append((i + o) % nb)
        src = torch.from_numpy((i - o) % nb).to(device)
        vals[:, 2 + 2 * o_idx] = bands[o_idx][src].transpose(-1, -2)
        cols.append((i - o) % nb)
    del bands
    cols = torch.from_numpy(np.stack(cols, axis=1).astype(np.int32))
    return vals, cols.to(device)


def matmat(vals, cols, x, prec: Precision):
    """``A x`` for x (N,) or (N, r), in ``prec``: chunk by chunk of
    block-rows, the blocks and the gathered x rounded as ``prec``'s
    products round them."""
    nb, _, bs, _ = vals.shape
    xb = x.reshape(nb, bs, -1)
    y = torch.empty((nb, bs, xb.shape[2]), dtype=prec.dtype,
                    device=vals.device)
    idx = cols.long()
    with no_tf32():
        for s in range(0, nb, CHUNK_ROWS):
            blk = prec.operand(vals[s:s + CHUNK_ROWS].detach())
            xg = prec.operand(xb[idx[s:s + CHUNK_ROWS]])
            y[s:s + CHUNK_ROWS] = torch.einsum("cmab,cmbr->car", blk, xg)
    return y.reshape(x.shape)


def grad_summary(u, v, cols, sample_rows):
    """Summaries of the gradient ``G[i, j] = sum_c u_i[:, c] v_{cols[i,
    j]}[:, c]^T`` of ``sum_c u_c^T A v_c`` in the values, from the (N,)
    or (N, r) ``u`` and ``v``, without forming G: its row sums
    ``sum_{j, b} G[i, j, a, b]`` (N,), its block-rows ``sample_rows`` and
    its Frobenius norm, in float64."""
    nb, m = cols.shape
    u = u.double().reshape(nb, -1, u.shape[1] if u.ndim == 2 else 1)
    v = v.double().reshape(nb, -1, u.shape[2])
    idx = cols.long()
    colsum = v.sum(dim=1)                                   # (nb, r)
    rows = (u * colsum[idx].sum(dim=1)[:, None, :]).sum(dim=2)
    sel = torch.as_tensor(sample_rows, device=u.device, dtype=torch.long)
    blocks = torch.einsum("sac,smbc->smab", u[sel], v[idx[sel]])
    gram_u = torch.einsum("iac,iad->icd", u, u)              # (nb, r, r)
    gram_v = torch.einsum("iac,iad->icd", v, v)
    sq = torch.einsum("icd,imcd->", gram_u, gram_v[idx])
    return {"rows": rows.reshape(-1).cpu(), "blocks": blocks.cpu(),
            "norm": float(sq.clamp(min=0.0).sqrt())}


def program_grad_summary(grad, sample_rows):
    """The same summaries of a gradient the program returned, taken on
    the device (the norm's squares summed in float64, chunk by chunk)."""
    sel = torch.as_tensor(sample_rows, device=grad.device, dtype=torch.long)
    sq = sum(float(grad[s:s + CHUNK_ROWS // 4].double().square().sum())
             for s in range(0, grad.shape[0], CHUNK_ROWS // 4))
    return {"rows": grad.sum(dim=(1, 3)).reshape(-1).double().cpu(),
            "blocks": grad[sel].double().cpu(), "norm": sq ** 0.5}


def grad_gap(got, ref) -> float:
    """The largest relative gap of the three summaries."""
    rows = float((got["rows"] - ref["rows"]).abs().max()
                 / ref["rows"].abs().max())
    blocks = float((got["blocks"] - ref["blocks"]).abs().max()
                   / ref["blocks"].abs().max())
    norm = abs(got["norm"] - ref["norm"]) / ref["norm"]
    return max(rows, blocks, norm)
