#!/usr/bin/env python3
"""The JAX package's own errors for config #4's transfer observables, on a CPU.

    python3 tools/jax_transfer_errors.py

Runs the JAX reference package (not the PyTorch port) on the CPU at the
settings of ``chip_smoke.py``'s ``eig`` phase: the CTMRG environment at
chi = 30, 30 steps, float64.  At β = 0.35 (disordered) it takes
``correlation_length`` and dξ/dβ by ``jax.grad`` and compares them with
Onsager's row-to-row result ``ξ = 1 / (-ln tanh β - 2β)``, ``dξ/dβ =
ξ² (2 / sinh 2β + 2)``; it compares ξ with the value from
``numpy.linalg.eigvals`` of the same 1800 x 1800 transfer matrix, and
the β-derivative of ``transfer_spectral_gap`` with a central difference
at ε = 1e-4.  At β = 0.5 (ordered) it compares ξ with the ``eigvals``
value.  It prints one JSON line per β with the values, the relative
errors and the seconds taken, compile included.  The card's Onsager bars
in ``chip_smoke.py`` are set from these errors (about 8 times each).
A CPU run: no device number.
"""

import json
import math
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dominantsparseeigenad_tpu.models import (  # noqa: E402
    correlation_length, ctmrg_environment, transfer_operator,
    transfer_spectral_gap)

CHI, STEPS, FD_EPS = 30, 30, 1e-4


def onsager_xi(beta):
    xi = 1.0 / (-math.log(math.tanh(beta)) - 2.0 * beta)
    return xi, xi * xi * (2.0 / math.sinh(2.0 * beta) + 2.0)


def eigvals_xi(beta):
    c, e, t = ctmrg_environment(jnp.float64(beta), chi=CHI, n_steps=STEPS)
    m = np.asarray(transfer_operator(c, e, t).to_dense())
    w = np.sort(np.abs(np.linalg.eigvals(m)))[::-1]
    return 1.0 / math.log(w[0] / w[1])


def rel(a, b):
    return abs(a - b) / abs(b)


def main():
    xi_f = jax.jit(jax.value_and_grad(
        lambda b: correlation_length(b, chi=CHI, n_steps=STEPS)))
    gap_f = jax.jit(jax.value_and_grad(
        lambda b: transfer_spectral_gap(b, chi=CHI, n_steps=STEPS)))
    for beta in (0.35, 0.5):
        t0 = time.perf_counter()
        xi, dxi = (float(x) for x in xi_f(jnp.float64(beta)))
        dense = eigvals_xi(beta)
        out = {"beta": beta, "chi": CHI, "n_steps": STEPS, "xi": xi,
               "dxi_dbeta": dxi, "xi_eigvals": dense,
               "xi_vs_eigvals_rel": rel(xi, dense)}
        if beta < 0.4406867935:
            xi_o, dxi_o = onsager_xi(beta)
            lam, dlam = (float(x) for x in gap_f(jnp.float64(beta)))
            fd = (float(gap_f(jnp.float64(beta + FD_EPS))[0])
                  - float(gap_f(jnp.float64(beta - FD_EPS))[0])) / (
                      2 * FD_EPS)
            out.update({"xi_onsager": xi_o, "dxi_onsager": dxi_o,
                        "xi_vs_onsager_rel": rel(xi, xi_o),
                        "dxi_vs_onsager_rel": rel(dxi, dxi_o),
                        "lam": lam, "dlam_dbeta": dlam, "dlam_fd": fd,
                        "dlam_vs_fd_rel": rel(dlam, fd)})
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
