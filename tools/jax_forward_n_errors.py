#!/usr/bin/env python3
"""The JAX package's own float32 errors for nested forward mode on a
small spiked blocked-ELL operator, on a CPU.

    python3 tools/jax_forward_n_errors.py

Runs the JAX reference package (not the PyTorch port) on the CPU in
float32 at the settings of ``chip_smoke.py``'s ``forward_n`` phase, part
(d): H(g) = A0 + g A1 at g = 0.5 over two symmetric ring-banded
blocked-ELL operators (n = 4096, bs = 32, 5 blocks per row, values from
``numpy.random.default_rng(21)`` and ``(22)``, A0's three lowest diagonal
entries lowered by 4, 8 and 12 so that the ground state is isolated),
``dominant_eigh`` with k = 100 and the CG at tol 1e-6 (clamped to 50 eps
of float32) and at most 3000 iterations.  E, dE/dg and d²E/dg² come from
one ``jax.jvp`` of a ``jax.jvp`` (``value_d1_d2``), and each is held
against the float64 sum over states of the dense H.  It prints one JSON
line with each value and its relative error; the card's bars in
``chip_smoke.py`` are set from these (about 8 times each).  A CPU run: no
device number.  The inputs are built by :func:`spiked_bell`, which
``chip_smoke.py`` repeats line for line.
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dominantsparseeigenad_tpu import (  # noqa: E402
    BellOperator, MatrixFreeOperator, dominant_eigh)
from dominantsparseeigenad_tpu.ops.observables import value_d1_d2  # noqa: E402

N, BS, BPR, G, K, CG_TOL, CG_MAXITER = 4096, 32, 5, 0.5, 100, 1e-6, 3000
SEEDS, SPIKES = (21, 22), (4.0, 8.0, 12.0)


def spiked_bell(n, bs, bpr, seed, spikes=()):
    """``(vals, cols)`` of a symmetric ring-banded blocked-ELL operator:
    the pattern of ``random_bell_operator`` (band offsets from
    ``default_rng(7)``), values from ``default_rng(seed)`` scaled by
    ``1/sqrt(bpr bs)``, the diagonal block symmetrized and its first
    entries lowered by ``spikes``; float32 values, int32 columns."""
    nb, n_off = n // bs, (bpr - 1) // 2
    offs = np.random.default_rng(7).permutation(np.arange(1, nb))[:n_off]
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(bpr * bs)
    i = np.arange(nb)
    d = rng.standard_normal((nb, bs, bs)) * scale
    vals, cols = [(d + d.transpose(0, 2, 1)) / 2], [i]
    for o in offs:
        b = rng.standard_normal((nb, bs, bs)) * scale
        vals += [b, b[(i - o) % nb].transpose(0, 2, 1)]
        cols += [(i + o) % nb, (i - o) % nb]
    vals = np.stack(vals, axis=1)
    for j, s in enumerate(spikes):
        vals[0, 0, j, j] -= s
    return vals.astype(np.float32), np.stack(cols, axis=1).astype(np.int32)


def dense(vals, cols, n):
    """The dense float64 matrix of a blocked-ELL operator."""
    nb, mb, bs, _ = vals.shape
    out = np.zeros((nb, bs, nb, bs))
    for j in range(mb):
        out[np.arange(nb), :, cols[:, j], :] += vals[:, j].astype(np.float64)
    return out.reshape(n, n)


def sum_over_states(a0, a1, g):
    """E, dE/dg and d²E/dg² of the lowest eigenvalue of A0 + g A1, in
    float64 (dense eigh)."""
    w, v = np.linalg.eigh(a0 + g * a1)
    m = v.T @ (a1 @ v[:, 0])
    return (float(w[0]), float(m[0]),
            float(2.0 * np.sum(m[1:] ** 2 / (w[0] - w[1:]))))


def main():
    (v0, c0), (v1, c1) = (spiked_bell(N, BS, BPR, SEEDS[0], SPIKES),
                          spiked_bell(N, BS, BPR, SEEDS[1]))
    a0 = BellOperator(jnp.asarray(v0), jnp.asarray(c0), N, symmetric=True,
                      use_pallas=False)
    a1 = BellOperator(jnp.asarray(v1), jnp.asarray(c1), N, symmetric=True,
                      use_pallas=False)

    def energy(g):
        op = MatrixFreeOperator(lambda p, x: a0.matvec(x) + p * a1.matvec(x),
                                g, dim=N, dtype=jnp.float32)
        return dominant_eigh(op, k=K, extreme="min", tol=CG_TOL,
                             maxiter=CG_MAXITER)[0]

    t0 = time.perf_counter()
    got = [float(t) for t in jax.jit(lambda g: value_d1_d2(energy, g))(
        jnp.float32(G))]
    seconds = time.perf_counter() - t0
    want = sum_over_states(dense(v0, c0, N), dense(v1, c1, N), G)
    print(json.dumps({
        "n": N, "bs": BS, "blocks_per_row": BPR, "g": G, "k": K,
        "cg_tol": CG_TOL, "cg_maxiter": CG_MAXITER, "spikes": SPIKES,
        "values": dict(zip(("e", "de_dg", "d2e_dg2"), got)),
        "float64_sum_over_states": dict(zip(("e", "de_dg", "d2e_dg2"),
                                            want)),
        "rel_err": dict(zip(("e", "de_dg", "d2e_dg2"),
                            (abs(a - b) / abs(b) for a, b in zip(got, want)))),
        "seconds_cpu": seconds}))


if __name__ == "__main__":
    main()
