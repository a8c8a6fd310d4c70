"""One point of the TFIM's fidelity-susceptibility curve: E0, dE0/dg and
χ_F = <∂ψ|∂ψ> - <ψ|∂ψ>² from one forward-mode ``dominant_eigh`` on the
matrix-free chain (``models.tfim_operator``) under ``forward_ad``, at a
fresh coupling g and start vector each solve.  The tangent of ψ is the
IFT rule's deflated CG."""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.autograd.forward_ad as fwAD

from eigbench.reference import krylov, tfim
from eigbench.reference.precision import Precision

MAX_SOLVES = 1 << 16       # couplings drawn per stream


def setup(ctx):
    from dominantsparseeigenad_tpu_torch import models
    cfg, t = ctx.config, ctx.traffic
    g = {"warm": tfim.couplings(t, ctx.seed, t["warm_solves"], "warm"),
         "timed": tfim.couplings(t, ctx.seed, MAX_SOLVES)}
    return SimpleNamespace(ctx=ctx, cfg=cfg, t=t, models=models, g=g)


def inputs(state, i, stream):
    return SimpleNamespace(
        g=state.g[stream][i],
        v0=tfim.start_vector(state.cfg, state.ctx.seed, i,
                             state.ctx.device, stream))


def solve(state, inp, spans):
    t, dev, n = state.t, state.ctx.device, state.cfg["n_spins"]
    f32 = torch.float32
    with torch.no_grad(), fwAD.dual_level():
        g = fwAD.make_dual(torch.tensor(inp.g, dtype=f32, device=dev),
                           torch.ones((), dtype=f32, device=dev))
        lam, v = state.ctx.port.dominant_eigh(
            state.models.tfim_operator(n, g, dtype=f32, device=dev),
            k=t["k"], extreme="min", tol=t["cg_tol"],
            maxiter=t["cg_maxiter"], reorth_passes=t["reorth_passes"],
            v0=inp.v0, device=dev)
        e0, de0 = fwAD.unpack_dual(lam)
        psi, dpsi = fwAD.unpack_dual(v)
    chi = torch.dot(dpsi, dpsi) - torch.dot(psi, dpsi) ** 2
    return e0, de0, chi, psi


def digest(state, inp, out):
    e0, de0, chi, psi = out
    return {"e0": float(e0), "de0": float(de0), "chi": float(chi),
            "psi": psi.cpu()}


def release(state):
    pass


def reference(state, inp, precision):
    t = state.t
    prec = Precision(precision)
    chain = tfim.Chain(state.cfg["n_spins"], inp.g, prec)
    e0, psi = krylov.lanczos_min_pair(chain.matvec, inp.v0, t["k"],
                                      t["reorth_passes"], prec)
    dpsi_a = chain.dmatvec(psi)
    de0 = torch.dot(psi, dpsi_a)
    dpsi, _ = krylov.deflated_cg(
        chain.matvec, e0, psi, -(dpsi_a - de0 * psi),
        t["reference_cg_tol"], t["reference_cg_maxiter"])
    chi = torch.dot(dpsi, dpsi) - torch.dot(psi, dpsi) ** 2
    return {"e0": e0, "de0": float(de0), "chi": float(chi),
            "psi": psi.float().cpu()}


def compare(got, ref):
    dpsi = min(float(torch.linalg.vector_norm(got["psi"] - ref["psi"])),
               float(torch.linalg.vector_norm(got["psi"] + ref["psi"])))
    return {"e0": abs(got["e0"] - ref["e0"]) / abs(ref["e0"]),
            "de0": abs(got["de0"] - ref["de0"]) / abs(ref["de0"]),
            "chi": abs(got["chi"] - ref["chi"]) / abs(ref["chi"]),
            "psi": dpsi}
