#!/usr/bin/env python3
"""The JAX package's own float32 errors for the TFIM curvature, on a CPU.

    python3 tools/jax_f32_curvature_errors.py

Runs the JAX reference package (not the PyTorch port) on the CPU in
float32 at the settings of ``chip_smoke.py``'s ``second_order`` phase,
part (a): the matrix-free TFIM at N = 20, g = 1.2, ``dominant_eigh`` with
k = 60, its default two reorthogonalization passes (``energy_curvature``
takes no other), CG tol 1e-5 and at most 150 iterations.  It takes E0 from the forward, dE0/dg from ``jax.grad`` and
d²E0/dg² from ``jax.grad(jax.grad(...))``, and prints one JSON line with
each value and its relative error against the Jordan-Wigner closed
forms.  Those errors are what the card's tolerances in ``chip_smoke.py``
are set from (about 8 times each).  A CPU run: no device number.
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

from dominantsparseeigenad_tpu import dominant_eigh  # noqa: E402
from dominantsparseeigenad_tpu.models import tfim_operator  # noqa: E402

N, G, K, CG_TOL, CG_MAXITER, REORTH_PASSES = 20, 1.2, 60, 1e-5, 150, 2


def exact(n, g):
    """E0, dE0/dg and d²E0/dg² of the Jordan-Wigner solution (even N,
    PBC), in numpy float64."""
    k = (2 * np.arange(n) + 1) * np.pi / n
    eps = np.sqrt(1.0 + g * g - 2.0 * g * np.cos(k))
    return (float(-eps.sum()), float(-np.sum((g - np.cos(k)) / eps)),
            float(-np.sum(np.sin(k) ** 2 / eps ** 3)))


def energy(g):
    lam, _ = dominant_eigh(tfim_operator(N, g, dtype=jnp.float32), k=K,
                           extreme="min", tol=CG_TOL, maxiter=CG_MAXITER,
                           reorth_passes=REORTH_PASSES)
    return lam


def main():
    g = jnp.asarray(G, jnp.float32)
    t0 = time.perf_counter()
    got = (float(energy(g)), float(jax.grad(energy)(g)),
           float(jax.grad(jax.grad(energy))(g)))
    seconds = time.perf_counter() - t0
    want = exact(N, G)
    print(json.dumps({
        "n": N, "g": G, "k": K, "cg_tol": CG_TOL, "cg_maxiter": CG_MAXITER,
        "reorth_passes": REORTH_PASSES, "dtype": "float32",
        "platform": jax.devices()[0].platform,
        "e0": got[0], "de0_dg": got[1], "d2e0_dg2": got[2],
        "exact": dict(zip(("e0", "de0_dg", "d2e0_dg2"), want)),
        "rel_err": {name: abs(a - b) / abs(b) for name, a, b in
                    zip(("e0", "de0_dg", "d2e0_dg2"), got, want)},
        "seconds": seconds}))


if __name__ == "__main__":
    main()
