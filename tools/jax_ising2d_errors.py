#!/usr/bin/env python3
"""The JAX package's own errors for BASELINE config #4, on a CPU.

    python3 tools/jax_ising2d_errors.py [case ...]

Runs the JAX reference package (not the PyTorch port) on the CPU at the
settings of ``chip_smoke.py``'s ``ising2d`` phase, β = 0.5: TRG at
chi = 30, 20 steps (``benchmarks/ising2d_bench.py:32-35``) with the
float64 ``gram`` split, the float32 ``subspace`` split and the float64
``lanczos`` split; CTMRG at chi = 30, 30 steps, float64, with the
``truncated`` and ``lanczos`` corner solvers.  Each case takes ln Z, u =
-d lnZ/dβ and c_v = β² d² lnZ/dβ² by the package's nested forward mode
(``ops.observables.value_d1_d2``), and prints one JSON line with the
values, their relative errors against Onsager's (the package's
``onsager_free_energy`` at 256 nodes, differentiated the same way), and
the seconds taken, compile included.  A last line gives the lanczos
split's and the lanczos corner solver's differences from the gram split
and the truncated solver.  The card's tolerances in ``chip_smoke.py``
are set from these errors (about 8 times each).  Cases: trg_gram,
trg_subspace_f32, trg_lanczos, ctmrg_truncated, ctmrg_lanczos (all by
default).  A CPU run: no device number.
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from dominantsparseeigenad_tpu.models import (  # noqa: E402
    ctmrg_free_energy, onsager_free_energy, trg_free_energy)
from dominantsparseeigenad_tpu.ops.observables import (  # noqa: E402
    value_d1_d2)

BETA, TRG_CHI, TRG_STEPS, CTM_CHI, CTM_STEPS = 0.5, 30, 20, 30, 30
NAMES = ("lnz", "u", "cv")

CASES = {
    "trg_gram": (trg_free_energy, jnp.float64,
                 dict(chi=TRG_CHI, n_steps=TRG_STEPS, split_method="gram")),
    "trg_subspace_f32": (trg_free_energy, jnp.float32,
                         dict(chi=TRG_CHI, n_steps=TRG_STEPS,
                              split_method="subspace")),
    "trg_lanczos": (trg_free_energy, jnp.float64,
                    dict(chi=TRG_CHI, n_steps=TRG_STEPS,
                         split_method="lanczos")),
    "ctmrg_truncated": (ctmrg_free_energy, jnp.float64,
                        dict(chi=CTM_CHI, n_steps=CTM_STEPS,
                             eigh_solver="truncated")),
    "ctmrg_lanczos": (ctmrg_free_energy, jnp.float64,
                      dict(chi=CTM_CHI, n_steps=CTM_STEPS,
                           eigh_solver="lanczos")),
}


def observables(f, dtype, beta):
    """(ln Z, u, c_v) of ``f`` at ``beta`` in ``dtype``."""
    b = jnp.asarray(beta, dtype)
    lnz, d1, d2 = jax.jit(lambda x: value_d1_d2(f, x))(b)
    return float(lnz), -float(d1), float(b * b * d2)


def main(names):
    exact = observables(lambda b: onsager_free_energy(b, n_quad=256),
                        jnp.float64, BETA)
    got = {}
    for name in names:
        fn, dtype, kw = CASES[name]
        t0 = time.perf_counter()
        vals = observables(lambda b: fn(b, dtype=dtype, **kw), dtype, BETA)
        got[name] = vals
        print(json.dumps({
            "case": name, "beta": BETA, "dtype": jnp.dtype(dtype).name,
            **kw, "platform": jax.devices()[0].platform,
            "values": dict(zip(NAMES, vals)),
            "onsager": dict(zip(NAMES, exact)),
            "rel_err": {k: abs(a - e) / abs(e)
                        for k, a, e in zip(NAMES, vals, exact)},
            "seconds": time.perf_counter() - t0}), flush=True)
    diffs = {}
    for a, b in (("trg_lanczos", "trg_gram"),
                 ("ctmrg_lanczos", "ctmrg_truncated")):
        if a in got and b in got:
            diffs[f"{a}_vs_{b}"] = {
                k: abs(x - y) / abs(y)
                for k, x, y in zip(NAMES, got[a], got[b])}
    if diffs:
        print(json.dumps({"rel_diff": diffs}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(CASES))
