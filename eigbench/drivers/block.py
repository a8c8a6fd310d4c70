"""The r lowest eigenpairs of a blocked-ELL operator by the block solver,
``dominant_eigh_multi(op, r, k, method="lobpcg")``, and the gradient of
their sum in every stored value, from a fresh start block each solve."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from eigbench.lib.spans import span
from eigbench.reference import bell, lobpcg
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
    gen = generator(state.ctx.seed, "bell-block", stream, i,
                    device=state.ctx.device)
    return SimpleNamespace(x0=torch.randn((state.cfg["n"], state.t["r"]),
                                          generator=gen,
                                          device=state.ctx.device))


def solve(state, inp, spans):
    t = state.t
    lams, vecs = state.ctx.port.dominant_eigh_multi(
        state.op, r=t["r"], k=t["k"], method="lobpcg", tol=t["tol"],
        x0=inp.x0, device=state.ctx.device)
    with span(spans, "backward_ms", state.ctx.device):
        (grad,) = torch.autograd.grad(lams.sum(), state.vals)
    return lams, vecs, grad


def digest(state, inp, out):
    lams, vecs, grad = out
    return {"lams": lams.detach().double().cpu(),
            "vecs": vecs.detach().double().cpu(),
            "grad": bell.program_grad_summary(grad.detach(), state.rows)}


def release(state):
    state.op = None


def reference(state, inp, precision):
    prec = Precision(precision)
    vals, cols, t = state.vals, state.cols, state.t
    # The thresholds the configuration's float32 sets: the port floors
    # its tolerance at 50 eps and drops whitened directions below 50 eps
    # of the largest.
    eps = float(torch.finfo(torch.float32).eps)
    lams, vecs, _ = lobpcg.lobpcg_min(
        lambda x: bell.matmat(vals, cols, x, prec), inp.x0, t["k"],
        max(t["tol"], 50 * eps), 50 * eps, prec)
    return {"lams": lams, "vecs": vecs.double().cpu(),
            "grad": bell.grad_summary(vecs, vecs, cols, state.rows),
            "clusters": clusters(lams, t["cluster_gap"])}


def clusters(lams, gap):
    """Runs of the ascending Ritz values ``lams`` in which each neighbour
    lies within ``gap`` times the block's largest |λ| of the last."""
    scale = float(lams.abs().max())
    cuts = [j + 1 for j in range(len(lams) - 1)
            if float(lams[j + 1] - lams[j]) > gap * scale]
    edges = [0] + cuts + [len(lams)]
    return [list(range(a, b)) for a, b in zip(edges, edges[1:])]


def compare(got, ref):
    # Each eigenvector is compared by its own angle, sqrt(1 - (v.w)^2),
    # where the reference's Ritz value stands apart from its neighbours.
    # Within a run of Ritz values closer than the mix's ``cluster_gap``
    # (relative to the largest |λ|, about ten times the float32 solve's own
    # error in λ) the columns are not resolved and rotate among themselves
    # from one rounding to the next, so that cluster is compared as a
    # subspace, by the chordal distance sqrt(m - ||V_c^T W_c||_F^2).  The
    # number is the largest of these.
    v = got["vecs"] / torch.linalg.vector_norm(got["vecs"], dim=0)
    w = ref["vecs"] / torch.linalg.vector_norm(ref["vecs"], dim=0)
    vecs = 0.0
    for c in ref["clusters"]:
        overlap = float(torch.linalg.matrix_norm(v[:, c].T @ w[:, c]) ** 2)
        vecs = max(vecs, max(len(c) - overlap, 0.0) ** 0.5)
    return {"lams": float(((got["lams"] - ref["lams"]).abs()
                           / ref["lams"].abs()).max()),
            "vecs": vecs,
            "grad": bell.grad_gap(got["grad"], ref["grad"])}
