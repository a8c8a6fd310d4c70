"""The lowest eigenvalue of a blocked-ELL operator and its gradient in
every stored value: ``dominant_eigh(op, k, extreme="min")``, then
``torch.autograd.grad(λ, vals)``, from a fresh start vector each solve."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from eigbench.lib.spans import span
from eigbench.reference import bell, krylov
from eigbench.reference.precision import Precision
from eigbench.reference.seeds import generator, rng


def setup(ctx):
    cfg, t = ctx.config, ctx.traffic
    vals, cols = bell.make_inputs(cfg, ctx.seed, ctx.device)
    vals.requires_grad_(True)
    op = ctx.port.BellOperator(vals, cols, cfg["n"], symmetric=True)
    nb = cfg["n"] // cfg["bs"]
    rows = rng(ctx.seed, "grad-rows").choice(nb, int(t["grad_rows"]),
                                             replace=False)
    return SimpleNamespace(ctx=ctx, cfg=cfg, t=t, vals=vals, cols=cols,
                           op=op, rows=sorted(int(r) for r in rows))


def inputs(state, i, stream):
    gen = generator(state.ctx.seed, "bell-start", stream, i,
                    device=state.ctx.device)
    return SimpleNamespace(v0=torch.randn(state.cfg["n"], generator=gen,
                                          device=state.ctx.device))


def solve(state, inp, spans):
    t = state.t
    lam, v = state.ctx.port.dominant_eigh(
        state.op, k=t["k"], extreme="min",
        reorth_passes=t["reorth_passes"], v0=inp.v0,
        device=state.ctx.device)
    with span(spans, "backward_ms", state.ctx.device):
        (grad,) = torch.autograd.grad(lam, state.vals)
    return lam, v, grad


def digest(state, inp, out):
    lam, v, grad = out
    return {"lam": float(lam.detach()), "v": v.detach().double().cpu(),
            "grad": bell.program_grad_summary(grad.detach(), state.rows)}


def release(state):
    state.op = None


def reference(state, inp, precision):
    prec = Precision(precision)
    vals, cols = state.vals, state.cols

    def matvec(x):
        return bell.matmat(vals, cols, x, prec)

    lam, v = krylov.lanczos_min_pair(matvec, inp.v0, state.t["k"],
                                     state.t["reorth_passes"], prec)
    return {"lam": lam, "v": v.double().cpu(),
            "grad": bell.grad_summary(v, v, cols, state.rows)}


def compare(got, ref):
    dv = min(float(torch.linalg.vector_norm(got["v"] - ref["v"])),
             float(torch.linalg.vector_norm(got["v"] + ref["v"])))
    return {"lam": abs(got["lam"] - ref["lam"]) / abs(ref["lam"]),
            "vec": dv,
            "grad": bell.grad_gap(got["grad"], ref["grad"])}
