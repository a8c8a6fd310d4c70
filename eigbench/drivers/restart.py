"""The TFIM ground state by thick-restart Lanczos, the bounded-memory path:
``dominant_eigh(tfim_operator(n, g), k, restart_cycles, reorth_passes)``
and dE0/dg in reverse mode, at a fresh coupling g and start vector each
solve."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from eigbench.lib.spans import span
from eigbench.reference import krylov, tfim
from eigbench.reference.precision import Precision

MAX_SOLVES = 1 << 14       # couplings drawn per stream


def setup(ctx):
    from dominantsparseeigenad_tpu_torch import models
    t = ctx.traffic
    g = {"warm": tfim.couplings(t, ctx.seed, t["warm_solves"], "warm"),
         "timed": tfim.couplings(t, ctx.seed, MAX_SOLVES)}
    return SimpleNamespace(ctx=ctx, cfg=ctx.config, t=t, models=models,
                           g=g)


def inputs(state, i, stream):
    return SimpleNamespace(
        g=state.g[stream][i],
        v0=tfim.start_vector(state.cfg, state.ctx.seed, i,
                             state.ctx.device, stream))


def solve(state, inp, spans):
    t, dev, n = state.t, state.ctx.device, state.cfg["n_spins"]
    g = torch.tensor(inp.g, dtype=torch.float32, device=dev,
                     requires_grad=True)
    lam, v = state.ctx.port.dominant_eigh(
        state.models.tfim_operator(n, g, dtype=torch.float32, device=dev),
        k=t["k"], extreme="min", restart_cycles=t["cycles"],
        reorth_passes=t["reorth_passes"], v0=inp.v0, device=dev)
    with span(spans, "backward_ms", state.ctx.device):
        (de0,) = torch.autograd.grad(lam, g)
    return lam.detach(), v.detach(), de0


def digest(state, inp, out):
    e0, psi, de0 = out
    return {"e0": float(e0), "de0": float(de0), "psi": psi.cpu()}


def release(state):
    pass


def reference(state, inp, precision):
    t = state.t
    prec = Precision(precision)
    chain = tfim.Chain(state.cfg["n_spins"], inp.g, prec)
    e0, psi = krylov.thick_restart_min_pair(
        chain.matvec, inp.v0, t["k"], t["cycles"], t["reorth_passes"], prec)
    de0 = torch.dot(psi, chain.dmatvec(psi))
    return {"e0": e0, "de0": float(de0), "psi": psi.float().cpu()}


def compare(got, ref):
    dpsi = min(float(torch.linalg.vector_norm(got["psi"] - ref["psi"])),
               float(torch.linalg.vector_norm(got["psi"] + ref["psi"])))
    return {"e0": abs(got["e0"] - ref["e0"]) / abs(ref["e0"]),
            "de0": abs(got["de0"] - ref["de0"]) / abs(ref["de0"]),
            "psi": dpsi}
