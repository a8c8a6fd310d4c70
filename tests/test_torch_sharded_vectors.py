"""The port's sharded-vector layout (``vectors="sharded"``,
``shard_vector``, ``row_sharding``, ``replicated``), ``mode="ring"`` of
both row-sharded operators and multi-process checkpoints, against the
JAX package on the 8-virtual-device CPU mesh (f64 unless stated).

The port runs one process per rank on a gloo group, spawned once per
world size by a module-scoped fixture (p = 1 runs in this process).
Every rank computes everything below in that one spawn, on the rank's
rows of every vector, and sends it back; the tests compare with the JAX
package in this process, at the bars of the JAX tests they mirror
(``tests/test_parallel.py:33-155``, ``tests/test_sharded_sparse.py``).
The products, the ring offsets and the hop counts are JAX's on a
p-device sub-mesh at each p; the solves' references are the oracles
those JAX tests use (the dense or single-device path, the Jordan-Wigner
closed forms), each jitted once.  The rank processes import no JAX: this
module imports it only inside the functions that compute the expected
values.

A loss over sharded vectors is summed over the ranks
(``collectives.sum_over_ranks``); a global leaf that builds a row-sharded
operator's rows gets each rank's share of the gradient (the tests sum
them), a replicated parameter (the TFIM's g) the whole gradient on every
rank.
"""

import functools
import multiprocessing
import os
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models, utils
from dominantsparseeigenad_tpu_torch.convert import _tensor_from_numpy
from dominantsparseeigenad_tpu_torch.ops.lanczos import LanczosResult
from dominantsparseeigenad_tpu_torch.parallel import collectives
from dominantsparseeigenad_tpu_torch.parallel.mesh import ShardGroup

torch.set_num_threads(2)

F64 = torch.float64
RANK_TIMEOUT_S = 180        # a rank's whole run; each queue read and join
MODES = ("all_gather", "ring")
LOBPCG_R, LOBPCG_K = 2, 400
BLOCK_R, BLOCK_K = 5, 60
CKPT_K = 6                  # the checkpointed Lanczos basis's columns


# -- inputs, made in this process -------------------------------------------

def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


def _block_tridiag(n, bs, seed, zero_band=False):
    """The symmetric block-tridiagonal ring of the JAX tests (halo 1);
    with ``zero_band`` its +1 band is stored but zero (the values it would
    hold returned apart), the round-4 regression's input."""
    nb = n // bs
    rng = np.random.default_rng(seed)
    vals = np.zeros((nb, 3, bs, bs))
    cols = np.zeros((nb, 3), np.int32)
    diag = rng.standard_normal((nb, bs, bs))
    vals[:, 0] = diag + np.swapaxes(diag, 1, 2)
    cols[:, 0] = np.arange(nb)
    cols[:, 1] = (np.arange(nb) + 1) % nb
    cols[:, 2] = (np.arange(nb) - 1) % nb
    if zero_band:
        vals[:, 2] = rng.standard_normal((nb, bs, bs))
        vals[:, 1] = np.swapaxes(np.roll(vals[:, 2], -1, axis=0), 1, 2)
        off = vals[:, 1].copy()
        vals[:, 1] = 0.0
        x = rng.standard_normal(n)
        return vals, cols, off, x
    vals[:, 1] = rng.standard_normal((nb, bs, bs))
    vals[:, 2] = np.swapaxes(np.roll(vals[:, 1], 1, axis=0), 1, 2)
    return vals, cols, rng.standard_normal(n)


def _complex_hermitian_pair(n, seed):
    """Two complex Hermitian (n, n) matrices and a complex probe vector."""
    rng = np.random.default_rng(seed)

    def herm():
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return (a + a.conj().T) / 2

    return herm(), herm(), rng.standard_normal(n) + 1j * rng.standard_normal(n)


@functools.lru_cache(maxsize=None)
def _inputs():
    """The JAX tests' inputs and JAX's default start vectors."""
    import jax
    import jax.numpy as jnp
    from dominantsparseeigenad_tpu import BellOperator, random_bell_operator

    def bell(key, n, bpr, dtype=jnp.float64, vals_dtype=None):
        op = random_bell_operator(jax.random.PRNGKey(key), n=n, bs=8,
                                  blocks_per_row=bpr, dtype=dtype,
                                  vals_dtype=vals_dtype, use_pallas=False)
        return np.asarray(op.vals), np.asarray(op.cols)

    def normal(key, shape, dtype=jnp.float64):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(key), shape,
                                            dtype))

    rng = np.random.default_rng(3)
    a = np.zeros((64, 64))
    for i in range(8):
        for j in (i, (i + 2) % 8):
            a[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = \
                rng.standard_normal((8, 8))
    nonsym = BellOperator.from_dense(jnp.asarray(a), bs=8, use_pallas=False)
    return {
        "a": _sym(64, 0), "x": np.random.default_rng(1).standard_normal(64),
        "a7": _sym(64, 7),
        "x6": np.random.default_rng(2).standard_normal(64),
        "v0_256": normal(0, (256,)), "v0_64": normal(0, (64,)),
        "sym": bell(5, 128, 5), "bell3": bell(5, 64, 3),
        "xb": np.random.default_rng(0).standard_normal(128),
        "nonsym": (np.asarray(nonsym.vals), np.asarray(nonsym.cols)),
        "xn": rng.standard_normal(64),
        "bf16": bell(11, 128, 5, jnp.float32, jnp.bfloat16),
        "x32": normal(12, (128,), jnp.float32),
        "block": bell(21, 128, 5), "X": normal(22, (128, 4)),
        "x0_block": normal(0, (128, BLOCK_R)),
        "chi": bell(31, 128, 5), "v0_128": normal(0, (128,)),
        "ringmm": bell(51, 128, 5), "Xr": normal(52, (128, 4)),
        "wr": normal(53, (128, 4)),
        "zeros": _block_tridiag(256, 16, 31, zero_band=True),
        "hops": _block_tridiag(256, 16, 41),
        "basis": np.random.default_rng(9).standard_normal((128, CKPT_K)),
        "cx": _complex_hermitian_pair(32, 13),
        "alphas": np.random.default_rng(10).standard_normal(CKPT_K),
    }


# -- what every rank computes (no JAX here) ----------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bell(spec, sg, n, **kw):
    vals, cols = spec
    return port.RowShardedBellOperator(_tensor_from_numpy(vals), _t(cols),
                                       n, sg, **kw)


def _panel_rows(sg, a):
    """The rank's block-rows of a global (nb, ...) array."""
    nb_l = a.shape[0] // sg.size
    return _t(a[sg.rank * nb_l:(sg.rank + 1) * nb_l])


def _ppermutes(fn):
    """``(fn(), ppermutes it ran)``."""
    before = collectives.collective_counts["ppermute"]
    out = fn()
    return out, collectives.collective_counts["ppermute"] - before


def _global_sum(sg, t):
    return collectives.sum_over_ranks(t, sg)


def _dense_part(inp, sg, out):
    a, x = _t(inp["a"]), _t(inp["x"])
    xs = port.shard_vector(x, sg)
    for mode in MODES:
        op = port.RowShardedOperator(a, sg, mode=mode, vectors="sharded")
        out[f"dense_mv_{mode}"], hops = _ppermutes(lambda: op.matvec(xs))
        out[f"dense_hops_{mode}"] = hops
        out[f"dense_rmv_{mode}"] = op.rmatvec(xs).numpy()
        out[f"dense_mv_{mode}"] = out[f"dense_mv_{mode}"].numpy()
        leaf = a.clone().requires_grad_(True)
        op = port.RowShardedOperator(leaf, sg, mode=mode, vectors="sharded")
        lam, v = port.dominant_eigh(op, k=64, device="cpu")
        loss = lam + _global_sum(sg, (v ** 4).sum())
        loss.backward()
        out[f"dense_loss_{mode}"] = float(loss)
        out[f"dense_grad_{mode}"] = leaf.grad.numpy()
    # LOBPCG through the block product, in the JAX test's mode (ring
    # mode's block product runs LOBPCG in _bell_part).
    leaf = _t(inp["a7"]).clone().requires_grad_(True)
    op = port.RowShardedOperator(leaf, sg, vectors="sharded")
    lams, _ = port.dominant_eigh_multi(op, r=LOBPCG_R, k=LOBPCG_K,
                                       method="lobpcg", tol=1e-11,
                                       device="cpu")
    (lams * torch.arange(1.0, LOBPCG_R + 1, dtype=F64)).sum().backward()
    out["lobpcg_lams"] = lams.detach().numpy()
    out["lobpcg_grad"] = leaf.grad.numpy()


def _tfim_part(inp, sg, out):
    x6 = port.shard_vector(_t(inp["x6"]), sg)
    op = models.tfim_sharded_operator(6, 0.7, sg, device="cpu",
                                      vectors="sharded")
    out["tfim_mv"] = op.matvec(x6).numpy()
    g = torch.tensor(0.9, dtype=F64, requires_grad=True)
    op = models.tfim_sharded_operator(8, g, sg, device="cpu",
                                      vectors="sharded")
    lam, _ = port.dominant_eigh(op, k=60, device="cpu",
                                v0=port.shard_vector(_t(inp["v0_256"]), sg))
    (d1,) = torch.autograd.grad(lam, g)
    out["tfim_e0"], out["tfim_de0"] = float(lam), float(d1)
    g = torch.tensor(1.2, dtype=F64, requires_grad=True)
    op = models.tfim_sharded_operator(6, g, sg, device="cpu",
                                      vectors="sharded")
    lam, _ = port.dominant_eigh(op, k=64, device="cpu")
    (d1,) = torch.autograd.grad(lam, g, create_graph=True)
    (d2,) = torch.autograd.grad(d1, g)
    out["tfim_d2e0"] = float(d2)
    # The block solver on the sharded TFIM: values and the gap gradient.
    op = models.tfim_sharded_operator(6, 0.9, sg, device="cpu",
                                      vectors="sharded")
    out["tfim_multi"] = port.dominant_eigh_multi(op, r=3, k=64,
                                                 device="cpu")[0].numpy()
    g = torch.tensor(0.9, dtype=F64, requires_grad=True)
    lams, _ = port.dominant_eigh_multi(models.tfim_sharded_operator(
        6, g, sg, device="cpu", vectors="sharded"), r=2, k=64, device="cpu")
    (dgap,) = torch.autograd.grad(lams[1] - lams[0], g)
    out["tfim_dgap"] = float(dgap)


def _bell_part(inp, sg, out):
    xb = _t(inp["xb"])
    xs = port.shard_vector(xb, sg)
    rep = _bell(inp["sym"], sg, 128, symmetric=True)
    for mode in MODES:
        op = _bell(inp["sym"], sg, 128, symmetric=True, mode=mode,
                   vectors="sharded")
        out[f"bell_offsets_{mode}"] = op.ring_offsets
        out[f"bell_mv_{mode}"] = op.matvec(xs).numpy()
        out[f"bell_rmv_{mode}"] = op.rmatvec(xs).numpy()
        # Against the replicated-vector operator at the same p.
        out[f"bell_vs_rep_{mode}"] = float(
            (op.matvec(xs) - op.vector_layout.rows(rep.matvec(xb)))
            .abs().max())
        nop = _bell(inp["nonsym"], sg, 64, mode=mode, vectors="sharded")
        xn = port.shard_vector(_t(inp["xn"]), sg)
        out[f"nonsym_mv_{mode}"] = nop.matvec(xn).numpy()
        out[f"nonsym_rmv_{mode}"] = nop.rmatvec(xn).numpy()
        bop = _bell(inp["bf16"], sg, 128, symmetric=True, mode=mode,
                    vectors="sharded")
        y = bop.matvec(port.shard_vector(_t(inp["x32"]), sg))
        out[f"bf16_dtype_{mode}"] = (str(bop.dtype), str(y.dtype))
        out[f"bf16_mv_{mode}"] = y.numpy()
        # dominant_eigh and ∂(λ + Σ v⁴)/∂panel from JAX's start vector.
        sop = _bell(inp["bell3"], sg, 64, symmetric=True, mode=mode,
                    vectors="sharded")
        panel = sop.vals.clone().requires_grad_(True)
        lam, v = port.dominant_eigh(
            sop.with_vals(panel), k=40, device="cpu",
            v0=port.shard_vector(_t(inp["v0_64"]), sg))
        loss = lam + _global_sum(sg, (v ** 4).sum())
        loss.backward()
        out[f"eig_loss_{mode}"] = float(loss)
        out[f"eig_grad_{mode}"] = panel.grad.numpy()
        # The block tier: matmat, and LOBPCG on it.
        kop = _bell(inp["block"], sg, 128, symmetric=True, mode=mode,
                    vectors="sharded")
        Xs = port.shard_vector(_t(inp["X"]), sg)
        out[f"block_mm_{mode}"] = kop.matmat(Xs).numpy()
        lams, _ = port.dominant_eigh_multi(
            kop, r=BLOCK_R, k=BLOCK_K, method="lobpcg", tol=1e-9,
            maxiter=400, x0=port.shard_vector(_t(inp["x0_block"]), sg),
            device="cpu")
        out[f"block_lams_{mode}"] = lams.numpy()
        # χ_F of a sharded family (one jvp through the IFT rule).
        cop = _bell(inp["chi"], sg, 128, symmetric=True, mode=mode,
                    vectors="sharded")
        out[f"chi_{mode}"] = float(port.fidelity_susceptibility(
            lambda t, c=cop: c.with_vals(c.vals + t * torch.ones_like(
                c.vals) * 1e-2), torch.tensor(0.1, dtype=F64), k=80,
            device="cpu"))
    # The sharded and replicated layouts' λ at the same p.
    v0 = _t(inp["v0_128"])
    lam_rep = port.dominant_eigh(rep, k=60, v0=v0, device="cpu")[0]
    ring = _bell(inp["sym"], sg, 128, symmetric=True, mode="ring",
                 vectors="sharded")
    lam_sh = port.dominant_eigh(ring, k=60, v0=port.shard_vector(v0, sg),
                                device="cpu")[0]
    out["lam_vs_rep"] = float(abs(lam_sh - lam_rep) / abs(lam_rep))


def _ring_part(inp, sg, out):
    vals, cols, off, x = inp["zeros"]
    vals2 = vals.copy()
    vals2[:, 1] = off
    xs = port.shard_vector(_t(x), sg)
    ring = _bell((vals, cols), sg, 256, mode="ring", vectors="sharded")
    gop = _bell((vals2, cols), sg, 256, vectors="sharded")
    out["zeros_ring"] = ring.with_vals(_panel_rows(sg, vals2)).matvec(xs) \
        .numpy()
    out["zeros_ag"] = gop.matvec(xs).numpy()
    vals, cols, x = inp["hops"]
    op = _bell((vals, cols), sg, 256, symmetric=True, mode="ring",
               vectors="sharded")
    out["hops_offsets"], out["hops"] = op.ring_offsets, op.ring_hops
    y, out["hops_ppermutes"] = _ppermutes(
        lambda: op.matvec(port.shard_vector(_t(x), sg)))
    out["hops_mv"] = y.numpy()
    # The ring SpMM and its values-gradient.
    for mode in MODES:
        rop = _bell(inp["ringmm"], sg, 128, symmetric=True, mode=mode,
                    vectors="sharded")
        Xs = port.shard_vector(_t(inp["Xr"]), sg)
        panel = rop.vals.clone().requires_grad_(True)
        Y = rop.with_vals(panel).matmat(Xs)
        (port.shard_vector(_t(inp["wr"]), sg) * Y).sum().backward()
        out[f"ringmm_{mode}"] = Y.detach().numpy()
        out[f"ringmm_grad_{mode}"] = panel.grad.numpy()


def _complex_part(inp, sg, out):
    """A complex Hermitian matrix through both layouts: λ, v (its pivot
    phase), the gradient of the phase-sensitive λ + Re Σ w v (the pivot
    phase cotangent) and χ_F (the pivot phase tangent)."""
    h0, h1, w = (_t(a) for a in inp["cx"])
    for vectors, mode in (("replicated", "all_gather"), ("sharded", "ring")):
        leaf = h0.clone().requires_grad_(True)
        op = port.RowShardedOperator(leaf, sg, mode=mode, vectors=vectors)
        lam, v = port.dominant_eigh(op, k=32, device="cpu")
        if vectors == "sharded":
            probe = _global_sum(sg, (op.vector_layout.rows(w) * v).sum())
            v = port.row_sharding(sg).gather(v)
        else:
            probe = (w * v).sum()
        (lam + probe.real).backward()
        out[f"cx_lam_{vectors}"] = float(lam)
        out[f"cx_v_{vectors}"] = v.detach().numpy()
        out[f"cx_grad_{vectors}"] = leaf.grad.numpy()
        out[f"cx_chi_{vectors}"] = float(port.fidelity_susceptibility(
            lambda t, m=mode, vv=vectors: port.RowShardedOperator(
                h0 + t * h1, sg, mode=m, vectors=vv),
            torch.tensor(0.3, dtype=F64), k=32, device="cpu"))


def _collectives_part(sg, out):
    """The two new collectives against their transposes over the ranks
    (the pairings summed over them), first and second order."""
    gen = torch.Generator().manual_seed(100 + sg.rank)
    x = torch.randn(6, dtype=F64, generator=gen, requires_grad=True)
    g = torch.randn(6 * sg.size, dtype=F64, generator=gen)
    y = collectives.all_gather_sharded(x, sg)
    (xb,) = torch.autograd.grad(y, x, g, create_graph=True)
    lhs = _global_sum(sg, torch.dot(y, g))
    rhs = _global_sum(sg, torch.dot(x, xb))
    out["gather_adjoint"] = float(abs(lhs - rhs) / abs(lhs))
    t = torch.randn(6 * sg.size, dtype=F64, generator=gen,
                    requires_grad=True)
    h = torch.randn(6, dtype=F64, generator=gen)
    z = collectives.reduce_scatter_rows(t, sg)
    (tb,) = torch.autograd.grad(z, t, h, create_graph=True)
    lhs = _global_sum(sg, torch.dot(z, h))
    rhs = _global_sum(sg, torch.dot(t, tb))
    out["scatter_adjoint"] = float(abs(lhs - rhs) / abs(lhs))
    # Second order: the backward of x̄ = RS(g) in g is the gather again.
    gg = g.clone().requires_grad_(True)
    (xb,) = torch.autograd.grad(collectives.all_gather_sharded(x, sg), x,
                                gg, create_graph=True)
    (gb,) = torch.autograd.grad(xb, gg, h)
    want = collectives.all_gather_rows(h, sg)
    out["gather_double"] = float((gb - want).abs().max())


def _pivot_part(sg, out):
    lay = collectives.ShardedVectors(sg, 64)
    cases = []
    for seed in range(3):
        v = torch.randn(64, dtype=F64,
                        generator=torch.Generator().manual_seed(seed))
        # Ties of the magnitude across the ranks' rows (and of sign).
        v[[3, 40, 63]] = torch.tensor([-5.0, 5.0, 5.0], dtype=F64) * \
            (1 + seed)
        cases.append(v)
    block = torch.stack(cases, 1)
    idx, entry = lay.pivot(lay.rows(block))
    out["pivot_block"] = (idx.tolist(), entry.tolist())
    out["pivot_vec"] = [(int(i), float(e)) for i, e in
                        (lay.pivot(lay.rows(c)) for c in cases)]
    out["pivot_want"] = [(int(torch.argmax(c.abs())),
                          float(c[torch.argmax(c.abs())])) for c in cases]
    cv = torch.complex(cases[0], cases[1])
    i, e = lay.pivot(lay.rows(cv))
    j = int(torch.argmax(cv.abs()))
    out["pivot_complex"] = (int(i) == j and complex(e) == complex(cv[j]))


def _checkpoint_part(inp, sg, out, ckpt_dir):
    lay = collectives.ShardedVectors(sg, 128)
    basis = _t(inp["basis"])
    state = LanczosResult(alphas=_t(inp["alphas"]),
                          betas=_t(inp["alphas"][:-1]),
                          basis=lay.rows(basis).clone())
    specs = LanczosResult(alphas=port.replicated(sg), betas=None,
                          basis=port.row_sharding(sg, 2))
    path = os.path.join(ckpt_dir, f"state_p{sg.size}")
    utils.save_orbax(path, state, specs)
    back = utils.load_orbax(path, state, specs)
    out["ckpt_back"] = all(torch.equal(a, b) for a, b in zip(back, state))
    if sg.size == 4:
        # Two ranks (batch row 0 of a 2 x 2 mesh) write; all four read.
        row = port.make_mesh(n_shards=2, n_batch=2)
        half = collectives.ShardedVectors(row, 128)
        if row.batch_index == 0:
            utils.save_orbax(
                os.path.join(ckpt_dir, "state_by2"),
                state._replace(basis=half.rows(basis).clone()),
                LanczosResult(None, None, port.row_sharding(row, 2)))
        dist.barrier()
        got = utils.load_orbax(os.path.join(ckpt_dir, "state_by2"), state,
                               specs)
        out["ckpt_by2_read_by4"] = all(torch.equal(a, b)
                                       for a, b in zip(got, state))


def _compute(inp, ckpt_dir):
    sg = port.make_mesh()
    collectives.reset_collective_counts()
    out = {}
    _dense_part(inp, sg, out)
    _tfim_part(inp, sg, out)
    _bell_part(inp, sg, out)
    _ring_part(inp, sg, out)
    _complex_part(inp, sg, out)
    _collectives_part(sg, out)
    _pivot_part(sg, out)
    # (Before the checkpoints: at p = 4 two of the ranks write one.)
    out["collectives"] = dict(collectives.collective_counts)
    _checkpoint_part(inp, sg, out, ckpt_dir)
    return out


def _rank_results(rank, p, init_method, inp, ckpt_dir):
    port.init_distributed("gloo", init_method, rank, p)
    try:
        return _compute(inp, ckpt_dir)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, p, init_method, inp, ckpt_dir, out_queue):
    torch.set_num_threads(1)
    try:
        out_queue.put((rank, _rank_results(rank, p, init_method, inp,
                                           ckpt_dir), None))
    except Exception:  # reported to the parent, which fails the tests
        out_queue.put((rank, None, traceback.format_exc()))


def _spawn_ranks(p, init_method, inp, ckpt_dir):
    ctx = multiprocessing.get_context("spawn")
    out_queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, p, init_method, inp, ckpt_dir, out_queue),
                         daemon=True) for r in range(p)]
    for proc in procs:
        proc.start()
    try:
        got = {}
        for _ in range(p):
            try:
                rank, res, err = out_queue.get(timeout=RANK_TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError(f"a rank sent nothing in "
                                   f"{RANK_TIMEOUT_S} s") from None
            if err is not None:
                raise RuntimeError(f"rank {rank} of {p} failed:\n{err}")
            got[rank] = res
        for proc in procs:
            proc.join(timeout=RANK_TIMEOUT_S)
            if proc.is_alive() or proc.exitcode != 0:
                raise RuntimeError(f"a rank did not exit cleanly "
                                   f"(exit code {proc.exitcode})")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    return [got[r] for r in range(p)]


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"p{p}")
def ranks(request, tmp_path_factory):
    """(p, [each rank's results], the checkpoint directory)."""
    p = request.param
    init_method = f"file://{tmp_path_factory.mktemp(f'store{p}')}/store"
    ckpt_dir = str(tmp_path_factory.mktemp(f"ckpt{p}"))
    if p == 1:
        res = [_rank_results(0, 1, init_method, _inputs(), ckpt_dir)]
    else:
        res = _spawn_ranks(p, init_method, _inputs(), ckpt_dir)
    return p, res, ckpt_dir


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    import jax
    jax.clear_caches()


# -- the expected values, from the JAX package --------------------------------

@functools.lru_cache(maxsize=None)
def _jax_at(p):
    """The JAX package's row-sharded products on a p-device sub-mesh, in
    one jitted program, and its ring offsets and hops at p."""
    import jax
    import jax.numpy as jnp
    from dominantsparseeigenad_tpu.models import tfim_sharded_operator
    from dominantsparseeigenad_tpu.parallel import (
        RowShardedBellOperator, RowShardedOperator, make_mesh, shard_vector)

    inp = _inputs()
    mesh = make_mesh(n_shards=p, devices=jax.devices()[:p])
    rows = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("shards", None))

    def bell(spec, n, **kw):
        vals, cols = spec
        kw.setdefault("symmetric", True)
        return RowShardedBellOperator(jnp.asarray(vals), jnp.asarray(cols),
                                      n, mesh, use_pallas=False, **kw)

    def vec(a):
        return shard_vector(jnp.asarray(a), mesh)

    ops = {mode: {
        "dense": RowShardedOperator(jnp.asarray(inp["a"]), mesh, mode=mode),
        "sym": bell(inp["sym"], 128, mode=mode),
        "nonsym": bell(inp["nonsym"], 64, mode=mode, symmetric=False),
        "bf16": bell(inp["bf16"], 128, mode=mode),
        "block": bell(inp["block"], 128, mode=mode),
        "ringmm": bell(inp["ringmm"], 128, mode=mode)} for mode in MODES}
    zvals, zcols, zoff, zx = inp["zeros"]
    zvals2 = zvals.copy()
    zvals2[:, 1] = zoff
    zring = bell((zvals, zcols), 256, mode="ring", symmetric=False)
    hvals, hcols, hx = inp["hops"]
    hring = bell((hvals, hcols), 256, mode="ring")
    Xr = jax.device_put(jnp.asarray(inp["Xr"]), rows)

    @jax.jit
    def products(x, xb, xn, x32, X, x6, zx, hx, wr, zv2):
        out = {"tfim_mv": tfim_sharded_operator(6, 0.7, mesh).matvec(x6),
               "zeros_ring": zring.with_vals(zv2).matvec(zx),
               "hops_mv": hring.matvec(hx)}
        for mode, o in ops.items():
            out[f"dense_mv_{mode}"] = o["dense"].matvec(x)
            out[f"dense_rmv_{mode}"] = o["dense"].rmatvec(x)
            out[f"bell_mv_{mode}"] = o["sym"].matvec(xb)
            out[f"nonsym_mv_{mode}"] = o["nonsym"].matvec(xn)
            out[f"bf16_mv_{mode}"] = o["bf16"].matvec(x32)
            out[f"block_mm_{mode}"] = o["block"].matmat(X)
            out[f"ringmm_{mode}"] = o["ringmm"].matmat(Xr)
            out[f"ringmm_grad_{mode}"] = jax.grad(
                lambda v, s=o["ringmm"]: jnp.sum(
                    wr * s.with_vals(v).matmat(Xr)))(o["ringmm"].vals)
        out["nonsym_rmv"] = ops["all_gather"]["nonsym"].rmatvec(xn)
        return out

    out = products(vec(inp["x"]), vec(inp["xb"]), vec(inp["xn"]),
                   vec(inp["x32"]),
                   jax.device_put(jnp.asarray(inp["X"]), rows),
                   vec(inp["x6"]), vec(zx), vec(hx), jnp.asarray(inp["wr"]),
                   jnp.asarray(zvals2))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["bell_offsets"] = ops["ring"]["sym"].ring_offsets
    out["hops_offsets"], out["hops"] = hring.ring_offsets, hring.ring_hops
    return out


@functools.lru_cache(maxsize=None)
def _jax_oracles():
    """The oracles the mirrored JAX tests hold the sharded solves to, each
    jitted once: the dense or single-device path, Jordan-Wigner."""
    import jax
    import jax.numpy as jnp
    from dominantsparseeigenad_tpu import (BellOperator, DenseOperator,
                                           dominant_eigh, dominant_eigh_multi,
                                           fidelity_susceptibility)
    from dominantsparseeigenad_tpu.models import tfim_exact_e0, tfim_operator

    inp = _inputs()
    one = jnp.float64

    def loss_dense(a):
        lam, v = dominant_eigh(DenseOperator(a), k=64, extreme="min")
        return lam + jnp.sum(v ** 4)

    def lobpcg_lams(m):
        return dominant_eigh_multi(DenseOperator(m), r=LOBPCG_R, k=LOBPCG_K,
                                   method="lobpcg", tol=1e-11)[0]

    def gap(g):
        lams, _ = dominant_eigh_multi(tfim_operator(6, g), r=2, k=64)
        return lams[1] - lams[0]

    b3v, b3c = inp["bell3"]

    def loss_bell(vals):
        o = BellOperator(vals, jnp.asarray(b3c), 64, symmetric=True,
                         use_pallas=False)
        lam, v = dominant_eigh(o, k=40, extreme="min")
        return lam + jnp.sum(v ** 4)

    cv, cc = inp["chi"]

    def chi(g):
        return fidelity_susceptibility(
            lambda t: BellOperator(jnp.asarray(cv) + t * jnp.ones_like(
                jnp.asarray(cv)) * 1e-2, jnp.asarray(cc), 128,
                symmetric=True, use_pallas=False), g, k=80)

    @jax.jit
    def oracles(a, a7, b3):
        e0_8 = jax.value_and_grad(lambda g: tfim_exact_e0(8, g))(one(0.9))
        weights = jnp.arange(1.0, LOBPCG_R + 1)
        return {
            "dense": jax.value_and_grad(loss_dense)(a),
            "lobpcg_lams": lobpcg_lams(a7),
            "lobpcg_grad": jax.grad(
                lambda m: jnp.sum(lobpcg_lams(m) * weights))(a7),
            "tfim_e0": e0_8[0], "tfim_de0": e0_8[1],
            "tfim_d2e0": jax.grad(jax.grad(
                lambda g: tfim_exact_e0(6, g)))(one(1.2)),
            "tfim_multi": dominant_eigh_multi(tfim_operator(6, 0.9), r=3,
                                              k=64)[0],
            "tfim_dgap": jax.grad(gap)(one(0.9)),
            "eig": jax.value_and_grad(loss_bell)(b3),
            "chi": chi(one(0.1))}

    out = oracles(jnp.asarray(inp["a"]), jnp.asarray(inp["a7"]),
                  jnp.asarray(b3v))
    out = jax.tree.map(np.asarray, out)
    bv, bc = inp["block"]
    dense = np.asarray(BellOperator(jnp.asarray(bv), jnp.asarray(bc), 128,
                                    use_pallas=False).to_dense())
    out["block_eigvals"] = np.linalg.eigvalsh(dense)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _rows(p, rank, a):
    """The rank's rows of a global array."""
    n_l = a.shape[0] // p
    return a[rank * n_l:(rank + 1) * n_l]


def _cat(results, key):
    return np.concatenate([res[key] for res in results])


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_row_sharded_matvec_matches_jax(ranks, mode):
    """``tests/test_parallel.py:33-43``: both modes, sharded vectors, and
    ring mode walks p column blocks with p - 1 hops."""
    p, results, _ = ranks
    want = _jax_at(p)
    a, x = _inputs()["a"], _inputs()["x"]
    for rk, res in enumerate(results):
        for key in ("mv", "rmv"):
            got = res[f"dense_{key}_{mode}"]
            assert _rel(got, _rows(p, rk, want[f"dense_{key}_{mode}"])) \
                <= 1e-12
            exact = a @ x if key == "mv" else a.T @ x
            assert _rel(got, _rows(p, rk, exact)) <= 1e-12
        assert res[f"dense_hops_{mode}"] == (p - 1 if mode == "ring" else 0)


@pytest.mark.parametrize("mode", MODES)
def test_row_sharded_eigh_and_grad_match_jax(ranks, mode):
    """``tests/test_parallel.py:46-61``: λ + Σ v⁴ and its gradient in the
    global matrix (the ranks' shares summed) against the dense path."""
    p, results, _ = ranks
    want = _jax_oracles()["dense"]
    for res in results:
        assert abs(res[f"dense_loss_{mode}"] - want[0]) <= \
            1e-9 * abs(want[0])
    grad = sum(res[f"dense_grad_{mode}"] for res in results)
    np.testing.assert_allclose(grad, want[1], rtol=1e-6, atol=1e-9)


def test_sharded_tfim_matvec_matches_jax(ranks):
    """``tests/test_parallel.py:65-73`` at p shards."""
    p, results, _ = ranks
    want = _jax_at(p)["tfim_mv"]
    for rk, res in enumerate(results):
        assert _rel(res["tfim_mv"], _rows(p, rk, want)) <= 1e-12


def test_sharded_tfim_energy_and_derivatives(ranks):
    """``tests/test_parallel.py:76-103``: E0, dE0/dg (n = 8) and d²E0/dg²
    (n = 6, by ``create_graph``) against Jordan-Wigner (JAX's)."""
    p, results, _ = ranks
    want = _jax_oracles()
    for res in results:
        assert abs(res["tfim_e0"] - want["tfim_e0"]) <= \
            1e-9 * abs(want["tfim_e0"])
        assert abs(res["tfim_de0"] - want["tfim_de0"]) <= \
            1e-7 * abs(want["tfim_de0"])
        assert abs(res["tfim_d2e0"] - want["tfim_d2e0"]) <= \
            1e-6 * abs(want["tfim_d2e0"])


def test_sharded_multi_eigensolver(ranks):
    """``tests/test_parallel.py:106-127``: the block solver's λ and gap
    gradient on the sharded TFIM against the local operator."""
    p, results, _ = ranks
    want = _jax_oracles()
    for res in results:
        np.testing.assert_allclose(res["tfim_multi"], want["tfim_multi"],
                                   rtol=1e-10)
        assert abs(res["tfim_dgap"] - want["tfim_dgap"]) <= \
            1e-8 * abs(want["tfim_dgap"])


def test_sharded_lobpcg_matches_dense(ranks):
    """``tests/test_parallel.py:130-155``: λ and the gradient of Σ i λ_i
    in the global matrix (the ranks' shares summed)."""
    p, results, _ = ranks
    want = _jax_oracles()
    for res in results:
        np.testing.assert_allclose(res["lobpcg_lams"], want["lobpcg_lams"],
                                   rtol=1e-9)
    grad = sum(res["lobpcg_grad"] for res in results)
    np.testing.assert_allclose(grad, want["lobpcg_grad"], rtol=1e-7,
                               atol=1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_bell_matvec_matches_jax(ranks, mode):
    """``tests/test_sharded_sparse.py:31-42`` (and the non-symmetric
    transpose, ``:56-72``) against JAX's products at p shards; the same
    rows as the replicated-vector operator at the same p."""
    p, results, _ = ranks
    want = _jax_at(p)
    for rk, res in enumerate(results):
        for key in ("bell_mv", "nonsym_mv"):
            assert _rel(res[f"{key}_{mode}"],
                        _rows(p, rk, want[f"{key}_{mode}"])) <= 1e-12
        assert _rel(res[f"bell_rmv_{mode}"],
                    _rows(p, rk, want[f"bell_mv_{mode}"])) <= 1e-12
        assert _rel(res[f"nonsym_rmv_{mode}"],
                    _rows(p, rk, want["nonsym_rmv"])) <= 1e-12
        # all_gather over sharded vectors runs the same panel product on
        # the same inputs: bit for bit.
        bound = 0.0 if mode == "all_gather" else 1e-12
        assert res[f"bell_vs_rep_{mode}"] <= bound * np.abs(
            want[f"bell_mv_{mode}"]).max()


def test_sharded_bell_ring_offsets_match_jax(ranks):
    """``tests/test_sharded_sparse.py:45-52``: the active offsets of the
    ring are JAX's at the same p; all_gather mode has none."""
    p, results, _ = ranks
    want = _jax_at(p)["bell_offsets"]
    assert 1 <= len(want) <= p
    for res in results:
        assert tuple(res["bell_offsets_ring"]) == tuple(want)
        assert tuple(res["bell_offsets_all_gather"]) == ()


@pytest.mark.parametrize("mode", MODES)
def test_sharded_bell_eigh_grad_matches_local(ranks, mode):
    """``tests/test_sharded_sparse.py:75-97``: λ + Σ v⁴ and its gradient
    in the values (the panels concatenated) against the single-device
    operator from the same start vector."""
    p, results, _ = ranks
    want = _jax_oracles()["eig"]
    for res in results:
        assert abs(res[f"eig_loss_{mode}"] - want[0]) <= 1e-9 * abs(want[0])
    np.testing.assert_allclose(_cat(results, f"eig_grad_{mode}"), want[1],
                               rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_bell_bf16_vals_matches_jax(ranks, mode):
    """``tests/test_sharded_sparse.py:134-150``: bfloat16 values, float32
    vectors."""
    p, results, _ = ranks
    want = _jax_at(p)[f"bf16_mv_{mode}"]
    for rk, res in enumerate(results):
        assert res[f"bf16_dtype_{mode}"] == ("torch.float32",
                                             "torch.float32")
        np.testing.assert_allclose(res[f"bf16_mv_{mode}"],
                                   _rows(p, rk, want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_bell_matmat_block_solver(ranks, mode):
    """``tests/test_sharded_sparse.py:153-175``: the SpMM tier, and
    LOBPCG on it against the dense eigenvalues."""
    p, results, _ = ranks
    want = _jax_at(p)[f"block_mm_{mode}"]
    dense = _jax_oracles()["block_eigvals"]
    for rk, res in enumerate(results):
        assert _rel(res[f"block_mm_{mode}"], _rows(p, rk, want)) <= 1e-12
        np.testing.assert_allclose(res[f"block_lams_{mode}"][:2], dense[:2],
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_fidelity_susceptibility(ranks, mode):
    """``tests/test_sharded_sparse.py:178-211``, its χ_F half: one jvp
    through the IFT rule with the dots summed over the ranks."""
    p, results, _ = ranks
    want = float(_jax_oracles()["chi"])
    for res in results:
        assert abs(res[f"chi_{mode}"] - want) <= 1e-8 * abs(want)


def test_ring_mode_keeps_structural_zero_blocks(ranks):
    """``tests/test_sharded_sparse.py:214-254``: a stored block that is
    zero at construction keeps its slot in the ring's buckets."""
    p, results, _ = ranks
    want = _jax_at(p)["zeros_ring"]
    for rk, res in enumerate(results):
        np.testing.assert_allclose(res["zeros_ring"], res["zeros_ag"],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(res["zeros_ring"], _rows(p, rk, want),
                                   rtol=1e-12, atol=1e-12)


def test_ring_hop_accounting_banded(ranks):
    """``tests/test_sharded_sparse.py:272-303``: a block-tridiagonal ring
    visits (0,) at p = 1, (0, 1) at p = 2 and (0, 1, p - 1) from p = 3,
    JAX's offsets; a matvec runs exactly ``ring_hops`` ppermutes (the
    port's stand-in for JAX's HLO count); the values are the dense
    product's."""
    p, results, _ = ranks
    want = _jax_at(p)
    expect = {1: (0,), 2: (0, 1)}.get(p, (0, 1, p - 1))
    assert tuple(want["hops_offsets"]) == expect
    vals, cols, x = _inputs()["hops"]
    n, bs = 256, 16
    a = np.zeros((n, n))
    for i in range(n // bs):
        for j in range(3):
            c = int(cols[i, j])
            a[i * bs:(i + 1) * bs, c * bs:(c + 1) * bs] += vals[i, j]
    for rk, res in enumerate(results):
        assert tuple(res["hops_offsets"]) == expect
        assert res["hops"] == want["hops"] == len(expect) - 1
        assert res["hops_ppermutes"] == res["hops"]
        np.testing.assert_allclose(res["hops_mv"], _rows(p, rk, a @ x),
                                   rtol=1e-11, atol=1e-12)


def test_ring_matmat_shares_bucket_gather(ranks):
    """``tests/test_sharded_sparse.py:306-330``: ring SpMM values and
    values-gradient against JAX's and the all_gather mode's."""
    p, results, _ = ranks
    want = _jax_at(p)
    for rk, res in enumerate(results):
        for mode in MODES:
            assert _rel(res[f"ringmm_{mode}"],
                        _rows(p, rk, want[f"ringmm_{mode}"])) <= 1e-12
    grad_r = _cat(results, "ringmm_grad_ring")
    np.testing.assert_allclose(grad_r, _cat(results, "ringmm_grad_all_gather"),
                               rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(grad_r, want["ringmm_grad_ring"], rtol=1e-11,
                               atol=1e-13)


def test_sharded_and_replicated_layouts_agree(ranks):
    """λ from the same start vector in ring mode over sharded vectors and
    over replicated ones (all_gather), at the same p."""
    p, results, _ = ranks
    for res in results:
        assert res["lam_vs_rep"] <= 1e-12


def test_complex_hermitian_through_both_layouts(ranks):
    """A complex Hermitian operator over sharded vectors in ring mode
    against the replicated layout (held against JAX in
    ``tests/test_torch_sharded_tfim.py``): λ, the
    pivot-gauged v, the gradient of a phase-sensitive loss (the ranks'
    shares summed) and χ_F."""
    p, results, _ = ranks
    for res in results:
        assert abs(res["cx_lam_sharded"] - res["cx_lam_replicated"]) <= \
            1e-10 * abs(res["cx_lam_replicated"])
        np.testing.assert_allclose(res["cx_v_sharded"],
                                   res["cx_v_replicated"], atol=1e-8)
        assert abs(res["cx_chi_sharded"] - res["cx_chi_replicated"]) <= \
            1e-8 * abs(res["cx_chi_replicated"])
    np.testing.assert_allclose(
        sum(res["cx_grad_sharded"] for res in results),
        sum(res["cx_grad_replicated"] for res in results),
        rtol=1e-8, atol=1e-10)


def test_new_collectives_are_their_transposes(ranks):
    """``all_gather_sharded`` and ``reduce_scatter_rows`` against each
    other: <gather(x), g> = <x, x̄> summed over the ranks, the same for
    the reduce-scatter, and the double backward of the gather is the
    gather."""
    p, results, _ = ranks
    for res in results:
        assert res["gather_adjoint"] <= 1e-14
        assert res["scatter_adjoint"] <= 1e-14
        assert res["gather_double"] == 0.0


def test_pivot_matches_argmax_of_the_whole_vector(ranks):
    """``layout.pivot``: the first largest |v| of the whole vector, ties
    included (across ranks and of opposite signs), for vectors, blocks
    and a complex vector, the same on every rank."""
    p, results, _ = ranks
    for res in results:
        assert res["pivot_vec"] == res["pivot_want"]
        idx, entry = res["pivot_block"]
        assert list(zip(idx, entry)) == res["pivot_want"]
        assert res["pivot_complex"]


def test_checkpoint_round_trip_and_jax_load(ranks):
    """A (N/p, k) Lanczos basis with its replicated coefficients, saved by
    every rank (``save_orbax`` with shardings): read back bit for bit, by
    the JAX package's ``load_pytree`` as the global arrays, and, written
    by two ranks, read by four."""
    import jax.numpy as jnp
    from dominantsparseeigenad_tpu.ops.lanczos import (
        LanczosResult as JaxResult)
    from dominantsparseeigenad_tpu.utils import load_pytree
    p, results, ckpt_dir = ranks
    inp = _inputs()
    like = JaxResult(jnp.zeros(CKPT_K), jnp.zeros(CKPT_K - 1),
                     jnp.zeros((128, CKPT_K)))
    names = ["state_p%d" % p] + (["state_by2"] if p == 4 else [])
    for name in names:
        got = load_pytree(os.path.join(ckpt_dir, name), like)
        assert np.array_equal(np.asarray(got.basis), inp["basis"])
        assert np.array_equal(np.asarray(got.alphas), inp["alphas"])
        assert np.array_equal(np.asarray(got.betas), inp["alphas"][:-1])
    for res in results:
        assert res["ckpt_back"]
        if p == 4:
            assert res["ckpt_by2_read_by4"]


def test_ranks_run_the_same_collectives(ranks):
    """Lockstep: every rank ran the same collectives, and the replicated
    results are bitwise the same on every rank."""
    p, results, _ = ranks
    first = results[0]
    for res in results[1:]:
        assert res["collectives"] == first["collectives"]
        for key in ("dense_loss_ring", "tfim_e0", "tfim_d2e0", "chi_ring",
                    "eig_loss_ring"):
            assert res[key] == first[key], key


# -- the refusals, with no process group --------------------------------------

def _solo_operator():
    """A sharded-vector operator on one rank, built with its ShardGroup
    given (no process group is needed before a product)."""
    sg = ShardGroup(group=None, rank=0, size=1, backend="gloo")
    vals = torch.eye(8, dtype=F64).repeat(2, 1, 1, 1)
    cols = torch.tensor([[0], [1]], dtype=torch.int32)
    return port.RowShardedBellOperator(vals, cols, 16, sg, symmetric=True,
                                       vectors="sharded")


def _out_of_slice():
    v = torch.zeros(16, dtype=F64)
    v[0] = 1.0

    def call(fn):
        return lambda op: fn(op, v)

    return {
        "lanczos carry": call(lambda op, v: port.lanczos(
            op, 4, restart_mode="carry", device="cpu")),
        "lanczos bf16 basis": call(lambda op, v: port.lanczos(
            op, 4, basis_dtype=torch.bfloat16, device="cpu")),
        "lanczos_adaptive": call(lambda op, v: port.lanczos_adaptive(
            op, 4, device="cpu")),
        "power_iteration": call(lambda op, v: port.power_iteration(
            op, 4, device="cpu")),
        "refine_eigenpair": call(lambda op, v: port.refine_eigenpair(
            op, 1.0, v, device="cpu")),
        "dominant_eigh restart_cycles": call(lambda op, v: port.dominant_eigh(
            op, k=4, restart_cycles=2, device="cpu")),
        "dominant_eigh early_exit_tol": call(lambda op, v: port.dominant_eigh(
            op, k=4, early_exit_tol=1e-8, device="cpu")),
        "dominant_eigh basis_dtype": call(lambda op, v: port.dominant_eigh(
            op, k=4, basis_dtype=torch.float32, device="cpu")),
        "dominant_eigh carry": call(lambda op, v: port.dominant_eigh(
            op, k=4, restart_mode="carry", device="cpu")),
        "dominant_eigh precond": call(lambda op, v: port.dominant_eigh(
            op, k=4, precond=lambda x: x, device="cpu")),
        "dominant_eigh_multi precond": call(
            lambda op, v: port.dominant_eigh_multi(
                op, r=2, k=4, precond=lambda x: x, device="cpu")),
        "lobpcg_eigh precond": call(lambda op, v: port.lobpcg_eigh(
            op, 2, precond=lambda x: x, device="cpu")),
        "lobpcg_eigh_general": call(lambda op, v: port.lobpcg_eigh_general(
            op, op, 2, device="cpu")),
        "solve_deflated minres": call(lambda op, v: port.solve_deflated(
            op, 1.0, v, v, method="minres", device="cpu")),
        "solve_deflated precond": call(lambda op, v: port.solve_deflated(
            op, 1.0, v, v, precond=lambda x: x, device="cpu")),
        "solve_deflated_info precond": call(
            lambda op, v: port.solve_deflated_info(
                op, 1.0, v, v, precond=lambda x: x, device="cpu")),
        "solve_spd": call(lambda op, v: port.solve_spd(op, v, device="cpu")),
        "solve_symmetric": call(lambda op, v: port.solve_symmetric(
            op, v, device="cpu")),
        "solve_general": call(lambda op, v: port.solve_general(
            op, v, device="cpu")),
        "cg": call(lambda op, v: port.cg(op.matvec, v, device="cpu")),
        "cg_info": call(lambda op, v: port.cg_info(op.matvec, v,
                                                   device="cpu")),
        "minres": call(lambda op, v: port.minres(op.matvec, v,
                                                 device="cpu")),
        "bicgstab": call(lambda op, v: port.bicgstab(op.matvec, v,
                                                     device="cpu")),
        "gmres": call(lambda op, v: port.gmres(op.matvec, v, device="cpu")),
        "dominant_eig": call(lambda op, v: port.dominant_eig(
            op, device="cpu")),
        "dominant_eig_multi": call(lambda op, v: port.dominant_eig_multi(
            op, device="cpu")),
        "dominant_eig_pair": call(lambda op, v: port.dominant_eig_pair(
            op, device="cpu")),
        "dominant_eig_spectrum": call(
            lambda op, v: port.dominant_eig_spectrum(op, device="cpu")),
        "spectrum_structure": call(lambda op, v: port.spectrum_structure(
            op, device="cpu")),
        "dominant_eigh_gen": call(lambda op, v: port.dominant_eigh_gen(
            op, op, 2, device="cpu")),
        "solve_deflated_pencil": call(
            lambda op, v: port.solve_deflated_pencil(
                op, op, 1.0, v, v, v, device="cpu")),
        "interior_eigh": call(lambda op, v: port.interior_eigh(
            op, 0.5, k=4, device="cpu")),
        "spectral_bounds": call(lambda op, v: port.spectral_bounds(
            op, k=4, device="cpu")),
        "spectral_slice": call(lambda op, v: port.spectral_slice(
            op, 0.5, 1.5, r=2, device="cpu")),
        "spectral_density": call(lambda op, v: port.spectral_density(
            op, [0.0], device="cpu")),
        "trace_function": call(lambda op, v: port.trace_function(
            op, torch.exp, device="cpu")),
        "logdet": call(lambda op, v: port.logdet(op, device="cpu")),
        "spectral_function": call(lambda op, v: port.spectral_function(
            op, v, [0.0], 0.1, device="cpu")),
        "restart_init": call(lambda op, v: port.restart_init(
            op, 4, device="cpu")),
        "lanczos_restarted": call(lambda op, v: port.lanczos_restarted(
            op, 4, device="cpu")),
        "dominant_svd": call(lambda op, v: port.dominant_svd(
            op, r=2, k=4, device="cpu")),
        "operator_diagonal": call(lambda op, v: port.operator_diagonal(op)),
        "jacobi_precond": call(lambda op, v: port.jacobi_precond(op)),
        "block_jacobi_precond": call(
            lambda op, v: port.block_jacobi_precond(op)),
        "DeflatedOperator": call(lambda op, v: port.DeflatedOperator(op, v)),
    }


@pytest.mark.parametrize("name", sorted(_out_of_slice()))
def test_out_of_slice_solver_refuses_sharded_vectors(name):
    """Every entry point that does not carry the layout raises, naming
    the queue item that will: a local dot over the rank's rows would be a
    plausible wrong number."""
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md, queue 1 item 18"):
        _out_of_slice()[name](_solo_operator())


def test_restart_cycle_refuses_sharded_vectors():
    from dominantsparseeigenad_tpu_torch.ops.restart import RestartState
    state = RestartState(*(torch.zeros(1),) * len(RestartState._fields))
    with pytest.raises(NotImplementedError, match="queue 1 item 18"):
        port.restart_cycle(_solo_operator(), state, 4)


def test_composites_carry_the_layout():
    """A sum, scaling, shift, transpose or product of sharded operators is
    one (its products act on the rank's rows); a sharded child beside a
    whole one does not conform."""
    op = _solo_operator()
    lay = op.vector_layout
    for comp in (op + op, 2.0 * op, port.ShiftedOperator(op, 0.5), op.T,
                 op @ op, -op):
        assert comp.vector_layout == lay
    whole = port.DenseOperator(torch.eye(16, dtype=F64))
    with pytest.raises(ValueError, match="do not conform"):
        (op + whole).vector_layout


def test_gathered_placements_at_one_rank():
    """``shard_vector``, ``row_sharding`` and ``replicated`` at p = 1 (in
    this process, no group needed for placing)."""
    sg = ShardGroup(group=None, rank=0, size=1, backend="gloo")
    x = torch.arange(6.0, dtype=F64).reshape(3, 2)
    assert torch.equal(port.row_sharding(sg, 2).place(x), x)
    assert port.replicated(sg).place(x) is x
    assert port.replicated(sg).gather(x) is x
    with pytest.raises(ValueError, match="ndim=1"):
        port.row_sharding(sg).place(x)


def test_collectives_gradcheck_at_one_rank(tmp_path):
    """``gradcheck`` and ``gradgradcheck`` (fast mode) of the two new
    collectives on a one-rank group (the multi-rank transposes are held
    in ``test_new_collectives_are_their_transposes``)."""
    from torch.autograd import gradcheck, gradgradcheck
    port.init_distributed("gloo", f"file://{tmp_path}/store", 0, 1)
    try:
        sg = port.make_mesh()
        x = torch.randn(5, 2, dtype=F64, requires_grad=True)
        for fn in (collectives.all_gather_sharded,
                   collectives.reduce_scatter_rows):
            assert gradcheck(lambda t, f=fn: f(t, sg) ** 2, (x,),
                             fast_mode=True)
            assert gradgradcheck(lambda t, f=fn: f(t, sg) ** 2, (x,),
                                 fast_mode=True)
    finally:
        dist.destroy_process_group()


def test_ring_needs_sharded_vectors():
    sg = ShardGroup(group=None, rank=0, size=1, backend="gloo")
    with pytest.raises(ValueError, match="vectors='sharded'"):
        port.RowShardedOperator(torch.eye(4), sg, mode="ring")
    with pytest.raises(ValueError, match="vectors must be"):
        port.RowShardedOperator(torch.eye(4), sg, vectors="columns")
