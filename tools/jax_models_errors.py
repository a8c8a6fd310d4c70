#!/usr/bin/env python3
"""The JAX package's own float32 errors on the XXZ chain and the 2D TFIM,
on a CPU.

    python3 tools/jax_models_errors.py

Runs the JAX reference package (not the PyTorch port) on the CPU in
float32 at the settings of ``chip_smoke.py``'s ``models`` phase, at the
sizes a CPU run may take (the card runs N = 20 and the 4 x 5 torus):

* the isotropic XXZ chain (j = jz = 1) at N = 16: E0 and its gradient in
  (j, jz) through ``dominant_eigh`` (k = 200, the ``models`` phase's k);
  the Euler identity E0 = j ∂E0/∂j + jz ∂E0/∂jz and the SU(2) identity
  ∂E0/∂j = 2 ∂E0/∂jz, each as a relative error, and E0/N against the
  Bethe value 1/4 - ln 2;
* the 2D TFIM on the 4 x 4 torus at g = 3.04 (k = 150): dE0/dg against
  -<ψ|Σ σˣ|ψ> by ``flip_sum``, relative.

It prints one JSON line; the card's bars in ``chip_smoke.py`` are about 8
times these.  A CPU run: no device number.
"""

import json
import math
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from dominantsparseeigenad_tpu import dominant_eigh  # noqa: E402
from dominantsparseeigenad_tpu.models import (  # noqa: E402
    heisenberg_operator, tfim2d_operator)
from dominantsparseeigenad_tpu.models.tfim import flip_sum  # noqa: E402

XXZ_N, XXZ_K = 16, 200
TFIM2D, TFIM2D_G, TFIM2D_K = (4, 4), 3.04, 150


def xxz_errors():
    def e0(j, jz):
        op = heisenberg_operator(XXZ_N, j, jz, dtype=jnp.float32)
        return dominant_eigh(op, k=XXZ_K, extreme="min", tol=1e-6)[0]

    one = jnp.float32(1.0)
    e, (dj, djz) = jax.jit(jax.value_and_grad(e0, argnums=(0, 1)))(one, one)
    e, dj, djz = float(e), float(dj), float(djz)
    return {"n": XXZ_N, "k": XXZ_K, "e0": e, "de0_dj": dj, "de0_djz": djz,
            "euler_rel": abs(e - (dj + djz)) / abs(e),
            "su2_rel": abs(dj - 2.0 * djz) / abs(dj),
            "bethe_abs": abs(e / XXZ_N - (0.25 - math.log(2.0)))}


def tfim2d_errors():
    lx, ly = TFIM2D
    n = lx * ly

    def pair(g):
        return dominant_eigh(tfim2d_operator(lx, ly, g, dtype=jnp.float32),
                             k=TFIM2D_K, extreme="min", tol=1e-6)

    g0 = jnp.float32(TFIM2D_G)
    (e, psi), de = jax.jit(lambda g: (pair(g), jax.grad(
        lambda gg: pair(gg)[0])(g)))(g0)
    hf = -float(jnp.vdot(psi, flip_sum(psi, n)))
    return {"lattice": [lx, ly], "g": TFIM2D_G, "k": TFIM2D_K,
            "e0": float(e), "de0_dg": float(de), "hellmann_feynman": hf,
            "de0_dg_vs_hf_rel": abs(float(de) - hf) / abs(hf)}


def main():
    t0 = time.perf_counter()
    out = {"tool": "jax_models_errors", "platform": "cpu",
           "xxz": xxz_errors(), "tfim2d": tfim2d_errors()}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
