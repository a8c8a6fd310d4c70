"""The port's sharded-vector layout (``vectors="sharded"``,
``shard_vector``, ``row_sharding``, ``replicated``, and the bordered and
stacked layouts of the general tier), ``mode="ring"`` of both row-sharded
operators, every solver over sharded vectors and multi-process
checkpoints, against the JAX package on the 8-virtual-device CPU mesh
(f64 unless stated).

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

import fcntl
import functools
import multiprocessing
import os
import pickle
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import torch.distributed as dist

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models, utils
from dominantsparseeigenad_tpu_torch.convert import _tensor_from_numpy
from dominantsparseeigenad_tpu_torch.ops.lanczos import LanczosResult
from dominantsparseeigenad_tpu_torch.parallel import collectives
from dominantsparseeigenad_tpu_torch.parallel.mesh import ShardGroup

torch.set_num_threads(2)

F64 = torch.float64
RANK_TIMEOUT_S = 600        # a rank's whole run; each queue read and join
MODES = ("all_gather", "ring")
LOBPCG_R, LOBPCG_K = 2, 400
BLOCK_R, BLOCK_K = 5, 60
CKPT_K = 6                  # the checkpointed Lanczos basis's columns
RESTART_N = 12              # tests/test_parallel.py:215-234
KRY_MID = 30                # the interior eigenpair of the deflated MINRES
KRY_SIGMA = 0.05            # interior_eigh's shift


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


def _general_inputs(nonsym_dense):
    """The inputs of the general tier's cases (item 18, step 5): the
    dense non-symmetric matrix behind ``nonsym``, a positive
    non-symmetric Bell (block-columns i, i ± 1, i ± 2 of block-row i: one
    Perron root, the next modulus about half of it), its tangent
    direction, and a real matrix with a dominant conjugate pair
    3 e^{±0.7i}, then 1.5, then the rest in [0, 0.75): each power or
    subspace iteration contracts by about 1/2 a step."""
    rng = np.random.default_rng(17)
    vals = np.abs(rng.standard_normal((8, 5, 8, 8))) + 0.01
    i = np.arange(8)
    cols = np.stack([i, (i + 1) % 8, (i - 1) % 8, (i + 2) % 8,
                     (i - 2) % 8], 1).astype(np.int32)
    blk = np.zeros((64, 64))
    blk[:2, :2] = 3.0 * np.array([[np.cos(0.7), -np.sin(0.7)],
                                  [np.sin(0.7), np.cos(0.7)]])
    blk[2, 2] = 1.5
    blk[3:, 3:] = np.diag(0.75 * rng.random(61))
    q, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    return {"ns_dense": nonsym_dense, "pos_bell": (vals, cols),
            "pos_dir": rng.standard_normal(vals.shape),
            "pair_a": q @ blk @ q.T}


def _solver_inputs(bell, normal):
    """The inputs of the Hermitian solvers' cases (item 18, steps 1-4)."""
    import jax
    import jax.numpy as jnp
    a = _sym(64, 0)
    w, vecs = np.linalg.eigh(a)
    a11 = _sym(64, 11)
    ew = np.linalg.eigvalsh(a11)
    rng = np.random.default_rng(13)
    c = rng.standard_normal((64, 64)) / np.sqrt(4 * 64)
    key = jax.random.PRNGKey(3)
    chi_vals, chi_cols = bell(31, 128, 5)
    dense = np.zeros((128, 128))
    for i in range(16):
        for j, col in enumerate(chi_cols[i]):
            dense[i * 8:(i + 1) * 8, col * 8:(col + 1) * 8] += chi_vals[i, j]
    return {
        "eig_a": (w, vecs),
        "b64": np.random.default_rng(5).standard_normal(64),
        "c64": np.random.default_rng(6).standard_normal(64),
        "spd": a @ a.T / 64 + np.eye(64),
        "x0_64": normal(23, (64, LOBPCG_R)),
        "lobpcg_shift": float(np.linalg.eigvalsh(_sym(64, 7))[0] - 1.0),
        "blocks_a": np.stack([a[i * 8:(i + 1) * 8, i * 8:(i + 1) * 8]
                              for i in range(8)]),
        "omegas": np.linspace(-3.0, 3.0, 7),
        "a11": a11,
        # Two eigenvalues inside, one buffer (tests/test_parallel.py:166).
        "slice_band": (float((ew[30] + ew[29]) / 2),
                       float((ew[32] + ew[31]) / 2)),
        "pa": _sym(64, 13) + 2.0 * np.diag(np.arange(1.0, 65.0)),
        "pb": c @ c.T + np.eye(64),
        "kpm_v0": np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                               (128,), jnp.float64)),
        "kpm_z": np.asarray(jax.random.rademacher(
            jax.random.fold_in(key, 2), (128, 8), dtype=jnp.float64)),
        "kpm_xs": np.linspace(-1.6, 1.6, 9),
        # A - shift I positive definite for logdet.
        "kpm_shift": float(np.linalg.eigvalsh(dense)[0] - 1.0),
    }


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
        **_solver_inputs(bell, normal),
        **_general_inputs(a),
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


class _Layout:
    """One layout of the step-4 cases at the rank's p: the sharded
    vectors, or the replicated ones (the reference at the same p).  The
    outputs are the rank's rows either way."""

    def __init__(self, sg, vectors, n=64):
        self.sg, self.vectors = sg, vectors
        self.lay = collectives.ShardedVectors(sg, n)

    def op(self, a, **kw):
        return port.RowShardedOperator(a, self.sg, vectors=self.vectors,
                                       **kw)

    def bell(self, spec, n=64):
        """A non-symmetric ``RowShardedBellOperator`` of the global
        ``(vals, cols)``: the rank's panel."""
        return _bell(spec, self.sg, n, symmetric=False, vectors=self.vectors)

    def place(self, x):
        return self.lay.rows(x) if self.vectors == "sharded" else x

    def rows(self, t):
        return t if self.vectors == "sharded" else self.lay.rows(t)

    def total(self, t):
        """A loss term summed over the whole vector."""
        return _global_sum(self.sg, t) if self.vectors == "sharded" else t


def _eigh_loss(L, a, v0, **kw):
    """λ + Σ v⁴ of ``dominant_eigh`` with options ``kw``, its gradient
    share in the matrix, and v."""
    leaf = a.clone().requires_grad_(True)
    lam, v = port.dominant_eigh(L.op(leaf), device="cpu", v0=L.place(v0),
                                **kw)
    loss = lam + L.total((v ** 4).sum())
    loss.backward()
    return [loss, L.rows(v), leaf.grad]


def _solve_grads(L, solve, a, b, c):
    """``x = solve(op(a), b)`` and the gradient shares of <c, x> in the
    matrix and the right-hand side."""
    leaf = a.clone().requires_grad_(True)
    bleaf = b.clone().requires_grad_(True)
    x = solve(L.op(leaf), L.place(bleaf))
    L.total((L.place(c) * x).sum()).backward()
    return [L.rows(x), leaf.grad, L.lay.rows(bleaf.grad)]


def _krylov_cases(inp):
    """The step-4 entry points, each ``L -> [tensors]`` on the 64 x 64
    matrix of the JAX tests, from shared start vectors."""
    a, a7 = _t(inp["a"]), _t(inp["a7"])
    v0, b, c = _t(inp["v0_64"]), _t(inp["b64"]), _t(inp["c64"])
    spd = _t(inp["spd"])
    w, vecs = (_t(t) for t in inp["eig_a"])
    x0 = _t(inp["x0_64"])
    blocks = _t(inp["blocks_a"])
    mid = KRY_MID

    def jacobi(L, m, shift=0.0):
        return port.jacobi_precond(L.op(m), diag=torch.diagonal(m),
                                   shift=shift)

    def multi(L):
        # Jacobi of A - σ with σ below the spectrum: an SPD
        # approximation of (A - σ)^{-1} for LOBPCG's residuals.
        leaf = a7.clone().requires_grad_(True)
        lams, v = port.dominant_eigh_multi(
            L.op(leaf), r=LOBPCG_R, k=LOBPCG_K, method="lobpcg", tol=1e-11,
            precond=jacobi(L, a7, inp["lobpcg_shift"]), x0=L.place(x0),
            device="cpu")
        (lams * torch.arange(1.0, LOBPCG_R + 1, dtype=F64)).sum().backward()
        return [lams, leaf.grad]

    def lobpcg(L):
        op = L.op(a)
        lams, v = port.lobpcg_eigh(
            op, 2, tol=1e-10, maxiter=400, x0=L.place(x0), device="cpu",
            precond=port.block_jacobi_precond(op, blocks=blocks, shift=-9.0))
        return [lams, L.rows(v)]

    def adaptive(L):
        lam, v, info = port.lanczos_adaptive(L.op(a), 48, v0=L.place(v0),
                                             tol=1e-10, device="cpu")
        return [lam, L.rows(v), info.effective_k, info.residual]

    def power(L):
        lam, v = port.power_iteration(L.op(a), 300, v0=L.place(v0),
                                      device="cpu")
        return [lam, L.rows(v)]

    def refine(L, sign):
        v = vecs[:, 0] + 1e-3 * vecs[:, 1]
        lam, v = port.refine_eigenpair(L.op(a), w[0] + 1e-3, L.place(v),
                                       iters=2, definite_sign=sign,
                                       device="cpu")
        return [lam, L.rows(v)]

    def minres(L):
        op = L.op(a)
        return [L.rows(port.minres(op.matvec, L.place(b), tol=1e-12,
                                   maxiter=2000, device="cpu"))]

    def cg(L):
        op = L.op(spd)
        x = port.cg(op.matvec, L.place(b), tol=1e-12, device="cpu")
        xi, it, res = port.cg_info(op.matvec, L.place(b), tol=1e-12,
                                   precond=jacobi(L, spd), device="cpu")
        return [L.rows(x), L.rows(xi), torch.tensor(float(it), dtype=F64),
                torch.tensor(res, dtype=F64)]

    def deflated(L, method, precond, at):
        op = L.op(a)
        return [L.rows(port.solve_deflated(
            op, w[at], L.place(vecs[:, at]), L.place(b), method=method,
            tol=1e-11, maxiter=5000, device="cpu",
            precond=jacobi(L, a, float(w[at])) if precond else None))]

    def deflated_info(L):
        x, its, res = port.solve_deflated_info(
            L.op(a), w[0], L.place(vecs[:, 0]), L.place(b), tol=1e-11,
            precond=jacobi(L, a, float(w[0])), device="cpu")
        return [L.rows(x), torch.tensor(float(its), dtype=F64),
                torch.tensor(res, dtype=F64)]

    def interior(L):
        leaf = a.clone().requires_grad_(True)
        lam, v = port.interior_eigh(L.op(leaf), KRY_SIGMA, k=12,
                                    v0=L.place(v0), inner_tol=1e-12,
                                    tol=1e-10, device="cpu")
        loss = lam + L.total((v ** 4).sum())
        loss.backward()
        return [loss, L.rows(v), leaf.grad]

    def spectral(L):
        leaf = a.clone().requires_grad_(True)
        y = port.spectral_function(L.op(leaf), L.place(b),
                                   _t(inp["omegas"]), 0.5, tol=1e-11,
                                   device="cpu")
        y.sum().backward()
        return [y, leaf.grad]

    def deflated_op(L):
        d = port.DeflatedOperator(L.op(a), L.place(vecs[:, :2]))
        lam, v = port.dominant_eigh(d, k=64, v0=L.place(v0), device="cpu")
        return [L.rows(d.matvec(L.place(b))), lam]

    return {
        "carry": lambda L: _eigh_loss(L, a, v0, k=64, restart_mode="carry"),
        "early_exit": lambda L: _eigh_loss(L, a, v0, k=64,
                                           early_exit_tol=1e-10),
        "basis_f32": lambda L: _eigh_loss(L, a, v0, k=64,
                                          basis_dtype=torch.float32),
        "precond": lambda L: _eigh_loss(
            L, a, v0, k=64, precond=jacobi(L, a, float(w[0]))),
        "restart": lambda L: _eigh_loss(L, a, v0, k=24, restart_cycles=12),
        "multi_precond": multi,
        "lobpcg_precond": lobpcg,
        "adaptive": adaptive,
        "power": power,
        "refine_cg": lambda L: refine(L, 1.0),
        "refine_minres": lambda L: refine(L, None),
        "minres": minres,
        "cg": cg,
        "deflated_minres": lambda L: deflated(L, "minres", False, mid),
        "deflated_minres_precond": lambda L: deflated(L, "minres", True,
                                                      mid),
        "deflated_cg_precond": lambda L: deflated(L, "cg", True, 0),
        "deflated_info_precond": deflated_info,
        "solve_spd": lambda L: _solve_grads(
            L, lambda op, x: port.solve_spd(op, x, tol=1e-12, device="cpu"),
            spd, b, c),
        "solve_symmetric": lambda L: _solve_grads(
            L, lambda op, x: port.solve_symmetric(op, x, tol=1e-12,
                                                  maxiter=2000,
                                                  device="cpu"), a, b, c),
        "jacobi": lambda L: [L.rows(jacobi(L, a, 0.3)(L.place(b)))],
        "block_jacobi": lambda L: [L.rows(port.block_jacobi_precond(
            L.op(a), blocks=blocks, shift=0.3)(L.place(b)))],
        "interior": interior,
        "spectral_function": spectral,
        "deflated_operator": deflated_op,
    }


def _krylov_part(inp, sg, out):
    """Every step-4 entry point in both layouts at the rank's p."""
    for name, case in _krylov_cases(inp).items():
        for vectors in ("sharded", "replicated"):
            got = case(_Layout(sg, vectors))
            out[f"kry_{name}_{vectors}"] = [
                np.asarray(t.detach().numpy()) for t in got]


def _restart_part(inp, sg, out):
    """``tests/test_parallel.py:215-234``: thick restart through the
    sharded TFIM (N = 12, k = 24, 6 cycles), value and dE0/dg;
    d²E0/dg² through the restart (N = 6); the stepped API against the
    replicated layout."""
    g = torch.tensor(1.0, dtype=F64, requires_grad=True)
    op = models.tfim_sharded_operator(RESTART_N, g, sg, device="cpu",
                                      vectors="sharded")
    lam, _ = port.dominant_eigh(op, k=24, restart_cycles=6, extreme="min",
                                device="cpu")
    (d1,) = torch.autograd.grad(lam, g)
    out["restart_e0"], out["restart_de0"] = float(lam), float(d1)
    g = torch.tensor(1.2, dtype=F64, requires_grad=True)
    op = models.tfim_sharded_operator(6, g, sg, device="cpu",
                                      vectors="sharded")
    lam, _ = port.dominant_eigh(op, k=16, restart_cycles=6, device="cpu")
    (d1,) = torch.autograd.grad(lam, g, create_graph=True)
    (d2,) = torch.autograd.grad(d1, g)
    out["restart_d2e0"] = float(d2)
    # restart_init / restart_cycle / restart_extract in both layouts.
    v0 = _t(inp["v0_256"])
    got = {}
    for vectors in ("sharded", "replicated"):
        op = models.tfim_sharded_operator(8, 0.9, sg, device="cpu",
                                          vectors=vectors)
        lay = collectives.ShardedVectors(sg, 256)
        start = lay.rows(v0) if vectors == "sharded" else v0
        state = port.restart_init(op, 16, v0=start, device="cpu")
        for _ in range(3):
            state, _ = port.restart_cycle(op, state, 16)
        lam, v, resid = port.restart_extract(state, op)
        got[vectors] = (lam, v if vectors == "sharded" else lay.rows(v),
                        resid)
    (ls, vs, rs), (lr, vr, rr) = got["sharded"], got["replicated"]
    out["restart_stepped"] = (float(abs(ls - lr) / abs(lr)),
                              float((vs - vr).abs().max()),
                              float(abs(rs - rr)), float(ls))


def _slice_part(inp, sg, out):
    """``tests/test_parallel.py:157-182``: the band of an interior slice
    of a ``RowShardedOperator`` and its gradient (the ranks' shares)."""
    lo_e, hi_e = inp["slice_band"]
    leaf = _t(inp["a11"]).clone().requires_grad_(True)
    lams, _, _ = port.spectral_slice(
        port.RowShardedOperator(leaf, sg, vectors="sharded"), lo_e, hi_e,
        r=3, degree=80, maxiter=200, tol=1e-10, device="cpu")
    inside = (lams >= lo_e) & (lams <= hi_e)
    band = torch.where(inside, lams, torch.zeros_like(lams)).sum()
    band.backward()
    out["slice_band"] = float(band)
    out["slice_grad"] = leaf.grad.numpy()


def _jax_draws(inp, slicing):
    """Make the KPM estimators draw JAX's enclosure start vector and
    Rademacher probes (``tests/test_torch_slicing.py``'s patch), each
    rank its rows of them; returns the undo."""
    bounds, rademacher = slicing.spectral_bounds, slicing._rademacher
    v0, z = _t(inp["kpm_v0"]), _t(inp["kpm_z"])

    def jax_bounds(op, k, **kw):
        lay = op.vector_layout
        return bounds(op, k, v0=v0 if lay is None else lay.rows(v0),
                      device=kw.get("device"))

    slicing.spectral_bounds = jax_bounds
    slicing._rademacher = lambda shape, generator, dtype, device: z.clone()

    def undo():
        slicing.spectral_bounds, slicing._rademacher = bounds, rademacher
    return undo


def _kpm_part(inp, sg, out):
    """``tests/test_sharded_sparse.py:178-212``, its density half (n =
    128, degree 64, 8 probes) and ``trace_function(exp)``, in both modes
    with JAX's draws; ``logdet`` of the shifted operator against the
    replicated layout."""
    from dominantsparseeigenad_tpu_torch.ops import slicing
    undo = _jax_draws(inp, slicing)
    try:
        xs = _t(inp["kpm_xs"])
        for mode in MODES:
            op = _bell(inp["chi"], sg, 128, symmetric=True, mode=mode,
                       vectors="sharded")
            out[f"kpm_density_{mode}"] = port.spectral_density(
                op, xs, degree=64, n_probe=8, device="cpu").numpy()
            out[f"kpm_trace_{mode}"] = float(port.trace_function(
                op, torch.exp, degree=64, n_probe=8, device="cpu"))
        for vectors in ("sharded", "replicated"):
            op = _bell(inp["chi"], sg, 128, symmetric=True, vectors=vectors)
            out[f"kpm_logdet_{vectors}"] = float(port.logdet(
                port.ShiftedOperator(op, inp["kpm_shift"]), degree=64,
                n_probe=8, device="cpu"))
    finally:
        undo()


def _pencil_part(inp, sg, out):
    """``tests/test_parallel.py:185-212``: the generalized pencil with A
    row-sharded (B on the same layout: operators whose layouts differ do
    not conform), values and both gradients (the ranks' shares)."""
    a = _t(inp["pa"]).clone().requires_grad_(True)
    b = _t(inp["pb"]).clone().requires_grad_(True)
    lams, _ = port.dominant_eigh_gen(
        port.RowShardedOperator((a + a.T) / 2, sg, vectors="sharded"),
        port.RowShardedOperator((b + b.T) / 2, sg, vectors="sharded"),
        r=2, maxiter=300, tol=1e-11, device="cpu")
    loss = (lams * torch.arange(1.0, 3.0, dtype=F64)).sum()
    loss.backward()
    out["pencil_loss"] = float(loss)
    out["pencil_grad_a"], out["pencil_grad_b"] = a.grad.numpy(), \
        b.grad.numpy()


def _diagnostics_part(inp, sg, out):
    """F11: the diagnostics on sharded vectors against the replicated
    layout, on F11's recorded input (the 64 x 64 matrix, k = 60, λ +
    0.1; a 10-step Lanczos run; an unconverged CG)."""
    a, v0, b = _t(inp["a"]), _t(inp["v0_64"]), _t(inp["b64"])
    spd = _t(inp["spd"])
    for vectors in ("sharded", "replicated"):
        L = _Layout(sg, vectors)
        op = L.op(a)
        lam, v = port.dominant_eigh(op, k=60, v0=L.place(v0), device="cpu")
        health = utils.lanczos_health(op, port.lanczos(op, 10,
                                                       v0=L.place(v0),
                                                       device="cpu"))
        sop = L.op(spd)
        x = port.cg(sop.matvec, L.place(b), maxiter=5, device="cpu")
        out[f"f11_{vectors}"] = [
            float(utils.ritz_residual(op, lam + 0.1, v)),
            float(health["ortho_loss"]),
            float(health["ritz_residual_min"]),
            float(health["ritz_residual_max"]),
            float(utils.cg_relative_residual(sop.matvec, L.place(b), x))]


SPEC_M = 3                   # the spectrum's slots: a pair, then a real
PAIR_ITERS, PAIR_PTOL = 800, 1e-13    # tests/test_torch_eig_pair.py
GEN_SHIFT = 8.0              # the solves' A + 8 I: eigenvalues near 8
GEN_TOL = 1e-12
GEN_RESTART = 20             # GMRES restarts within the 64 unknowns
STRUCTURE_CODES = {"pair": 0, "real": 1, "pair_real": 2}


def _panel_of(L, t):
    """The rank's block-rows of a global (nb, ...) tensor."""
    nb_l = t.shape[0] // L.sg.size
    return t[L.sg.rank * nb_l:(L.sg.rank + 1) * nb_l]


def _general_cases(inp):
    """The general tier's entry points (item 18, step 5), each ``L ->
    [tensors]`` in the layout of ``L``: the rank's rows of each vector,
    the rank's share (or panel) of each gradient, the replicated values
    as they are."""
    b, c = _t(inp["b64"]), _t(inp["c64"])
    ns = _t(inp["ns_dense"])
    shifted = ns + GEN_SHIFT * torch.eye(64, dtype=F64)
    pos, pos_dir = inp["pos_bell"], _t(inp["pos_dir"])
    pair_a = _t(inp["pair_a"])

    def solve(L, method):
        return _solve_grads(L, lambda op, x: port.solve_general(
            op, x, tol=GEN_TOL, method=method, device="cpu"), shifted, b, c)

    def eig(L, method):
        """λ, l, r; the panel's gradient of λ + Σ r⁴ + <c, l> (both
        bordered solves); with Arnoldi, forward mode along the values'
        direction (the rule does not depend on the method)."""
        op = L.bell(pos)
        panel = op.vals.clone().requires_grad_(True)
        lam, l, r = port.dominant_eig(op.with_vals(panel), method=method,
                                      tol=GEN_TOL, device="cpu")
        loss = lam + L.total((r ** 4).sum()) + L.total((L.place(c) * l)
                                                       .sum())
        loss.backward()
        out = [lam, L.rows(l), L.rows(r), panel.grad]
        if method == "power":
            return out
        with fwAD.dual_level():
            dual = fwAD.make_dual(op.vals, _panel_of(L, pos_dir))
            tangents = [fwAD.unpack_dual(t).tangent for t in
                        port.dominant_eig(op.with_vals(dual), method=method,
                                          tol=GEN_TOL, device="cpu")]
        return out + [tangents[0], L.rows(tangents[1]),
                      L.rows(tangents[2])]

    def eig_second_order(L):
        """λ + Σ r⁴ along vals + t D (t replicated: the ranks' shares of
        its gradient summed): the value, d/dt and d²/dt², the bordered
        solves inside the first backward."""
        op = L.bell(pos)
        t = torch.zeros((), dtype=F64, requires_grad=True)
        vals = op.vals + collectives.replicate(t, L.sg) * _panel_of(L,
                                                                     pos_dir)
        lam, _, r = port.dominant_eig(op.with_vals(vals), method="arnoldi",
                                      tol=GEN_TOL, device="cpu")
        loss = lam + L.total((r ** 4).sum())
        (d1,) = torch.autograd.grad(loss, t, create_graph=True)
        (d2,) = torch.autograd.grad(d1, t)
        return [loss, d1, d2]

    def multi(L):
        op = L.bell(pos)
        panel = op.vals.clone().requires_grad_(True)
        lams, ls, rs = port.dominant_eig_multi(op.with_vals(panel), m=2,
                                               tol=GEN_TOL, device="cpu")
        (lams * torch.tensor([1.0, 2.0], dtype=F64)).sum().backward()
        return [lams, L.rows(ls), L.rows(rs), panel.grad]

    def pair(L):
        """λ, l, r and the gradient of a loss on λ and on Re r (its phase
        gauge's pivot inside the rule)."""
        leaf = pair_a.clone().requires_grad_(True)
        lam, l, r = port.dominant_eig_pair(L.op(leaf), num_iters=PAIR_ITERS,
                                           power_tol=PAIR_PTOL, tol=GEN_TOL,
                                           device="cpu")
        loss = lam.real + 0.5 * lam.imag + L.total((r.real ** 3).sum())
        loss.backward()
        return [lam, L.rows(l), L.rows(r), leaf.grad]

    def spectrum(L):
        """The discovered structure, then the replay and its gradient."""
        kw = dict(num_iters=PAIR_ITERS, power_tol=PAIR_PTOL, tol=GEN_TOL,
                  device="cpu")
        found = port.spectrum_structure(L.op(pair_a), SPEC_M, **kw)
        leaf = pair_a.clone().requires_grad_(True)
        lams, ls, rs, _ = port.dominant_eig_spectrum(
            L.op(leaf), SPEC_M, structure=found, **kw)
        (lams.real.sum() + 0.3 * lams.imag.abs().sum()).backward()
        return [lams, L.rows(ls), L.rows(rs), leaf.grad,
                torch.tensor([STRUCTURE_CODES[k] for k in found])]

    def svd(L):
        leaf = ns.clone().requires_grad_(True)
        u, s, v = port.dominant_svd(L.op(leaf), r=2, k=64, device="cpu")
        (s * torch.tensor([1.0, 2.0], dtype=F64)).sum().backward()
        return [s, L.rows(u), L.rows(v), leaf.grad]

    return {
        "bicgstab": lambda L: [L.rows(port.bicgstab(
            L.op(shifted).matvec, L.place(b), tol=GEN_TOL, device="cpu"))],
        "gmres": lambda L: [L.rows(port.gmres(
            L.op(shifted).matvec, L.place(b), tol=GEN_TOL,
            restart=GEN_RESTART, device="cpu"))],
        "solve_general_bicgstab": lambda L: solve(L, "bicgstab"),
        "solve_general_gmres": lambda L: solve(L, "gmres"),
        "solve_general_cgnr": lambda L: solve(L, "cgnr"),
        "eig_power": lambda L: eig(L, "power"),
        "eig_arnoldi": lambda L: eig(L, "arnoldi"),
        "eig_second_order": eig_second_order,
        "eig_multi": multi,
        "eig_pair": pair,
        "eig_spectrum": spectrum,
        "svd": svd,
    }


def _general_part(inp, sg, out):
    """Every entry point of the general tier in both layouts at the
    rank's p."""
    for name, case in _general_cases(inp).items():
        for vectors in ("sharded", "replicated"):
            got = case(_Layout(sg, vectors))
            out[f"gen_{name}_{vectors}"] = [
                np.asarray(t.detach().numpy()) for t in got]


def _layouts_part(sg, out):
    """The two layouts of this slice at the rank's p: a bordered dot
    against the whole one, and the stacked layout's draw, pivot, take and
    one-hot against the whole (2N,) vector."""
    lay = collectives.ShardedVectors(sg, 64)
    gen = torch.Generator().manual_seed(7)
    x1, x2 = (torch.randn(64, dtype=F64, generator=gen) for _ in range(2))
    nu1, nu2 = (torch.randn(2, dtype=F64, generator=gen) for _ in range(2))
    bl = lay.bordered(2)
    got = bl.sum(port.hdot(bl.join(lay.rows(x1), nu1),
                           bl.join(lay.rows(x2), nu2)))
    want = port.hdot(torch.cat([x1, nu1]), torch.cat([x2, nu2]))
    out["bordered_dot"] = (float(got), float(want))
    out["bordered_norm"] = (float(bl.norm(bl.join(lay.rows(x1), nu1))),
                            float(torch.linalg.vector_norm(
                                torch.cat([x1, nu1]))))
    st = lay.stacked()
    whole = torch.randn(128, 3, dtype=F64,
                        generator=torch.Generator().manual_seed(8))
    drawn = st.draw((128, 3), torch.Generator().manual_seed(8), F64, "cpu")
    out["stacked_draw"] = bool(torch.equal(drawn, st.rows(whole)))
    o, n_l = sg.rank * (64 // sg.size), 64 // sg.size
    out["stacked_rows"] = bool(torch.equal(st.rows(whole), torch.cat(
        [whole[o:o + n_l], whole[64 + o:64 + o + n_l]])))
    # A tie of magnitude between a row of u that rank 1 holds (global
    # 64/p + 3 < 64) and a row of v that rank 0 holds (64 + 2): the lower
    # global index wins, as torch.argmax of the whole vector.
    v = whole[:, 0].clone()
    v[[64 // sg.size + 3, 64 + 2]] = torch.tensor([5.0, -5.0], dtype=F64)
    idx, entry = st.pivot(st.rows(v))
    j = int(torch.argmax(v.abs()))
    out["stacked_pivot"] = (int(idx), float(entry), j, float(v[j]))
    blk = whole.clone()
    blk[64 // sg.size + 3] = 9.0
    blk[64 + 2] = -9.0
    bidx, bentry = st.pivot(st.rows(blk))
    bwant = torch.argmax(blk.abs(), dim=0)
    out["stacked_pivot_block"] = (bidx.tolist(), bentry.tolist(),
                                  bwant.tolist(),
                                  blk[bwant, torch.arange(3)].tolist())
    out["stacked_take"] = (float(st.take(st.rows(whole[:, 1]), idx)),
                           float(whole[int(idx), 1]))
    hot = torch.zeros(128, dtype=F64)
    hot[int(idx)] = 1.0
    out["stacked_one_hot"] = bool(torch.equal(st.one_hot(idx, F64),
                                              st.rows(hot)))


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
    _diagnostics_part(inp, sg, out)
    _restart_part(inp, sg, out)
    _slice_part(inp, sg, out)
    _kpm_part(inp, sg, out)
    _pencil_part(inp, sg, out)
    _krylov_part(inp, sg, out)
    _layouts_part(sg, out)
    _general_part(inp, sg, out)
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


# The directory the pytest-xdist workers of one run share (set per module).
_SHARED = {}


@pytest.fixture(scope="module", autouse=True)
def _shared_root(tmp_path_factory):
    if os.environ.get("PYTEST_XDIST_WORKER"):
        _SHARED["root"] = tmp_path_factory.getbasetemp().parent
    yield
    _SHARED.clear()


def _shared(name, compute):
    """``compute()``, once for all the xdist workers of a run: the first
    worker to take the lock computes and pickles it, the others wait and
    read it (``--dist load`` sends one module's tests to several workers,
    and a module-scoped fixture is per worker)."""
    root = _SHARED.get("root")
    if root is None:
        return compute()
    if name in _SHARED:
        return _SHARED[name]
    path = root / f"sharded_vectors_{name}.pkl"
    with open(root / f"sharded_vectors_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                out = pickle.loads(path.read_bytes())
            else:
                out = compute()
                path.write_bytes(pickle.dumps(out))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    _SHARED[name] = out
    return out


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"p{p}")
def ranks(request, tmp_path_factory):
    """(p, [each rank's results], the checkpoint directory)."""
    p = request.param
    base = _SHARED.get("root")
    if base is None:
        base = tmp_path_factory.mktemp(f"ranks{p}")
    base = base / f"sharded_vectors_p{p}"

    def compute():
        os.makedirs(base / "ckpt", exist_ok=True)
        init_method = f"file://{base}/store"
        if p == 1:
            return [_rank_results(0, 1, init_method, _inputs(),
                                  str(base / "ckpt"))]
        return _spawn_ranks(p, init_method, _inputs(), str(base / "ckpt"))

    return p, _shared(f"p{p}", compute), str(base / "ckpt")


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


def _jax_oracles():
    """The oracles the mirrored JAX tests hold the sharded solves to, each
    jitted once (and computed once for the run's xdist workers)."""
    return _shared("jax_oracles", _compute_jax_oracles)


@functools.lru_cache(maxsize=None)
def _compute_jax_oracles():
    """The dense or single-device path, Jordan-Wigner."""
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
    out.update(_jax_solver_oracles(inp))
    out = jax.tree.map(np.asarray, out)
    bv, bc = inp["block"]
    dense = np.asarray(BellOperator(jnp.asarray(bv), jnp.asarray(bc), 128,
                                    use_pallas=False).to_dense())
    out["block_eigvals"] = np.linalg.eigvalsh(dense)
    return out


def _jax_solver_oracles(inp):
    """The JAX package's values for the Hermitian solvers' cases (item
    18, steps 1-4), in one jitted program: the mirrored tests' oracles
    (Jordan-Wigner, the dense slice and pencil, the local operator's
    density) and each step-4 entry point on the unsharded operator, from
    the same start vectors where it takes one."""
    import jax
    import jax.numpy as jnp
    import dominantsparseeigenad_tpu as jx
    from dominantsparseeigenad_tpu.models import tfim_exact_e0

    one = jnp.float64
    lo_e, hi_e = inp["slice_band"]
    w, vecs = (jnp.asarray(t) for t in inp["eig_a"])
    # The preconditioners' shifts, concrete (JAX's constructors read them).
    w_mid, w_0 = (float(inp["eig_a"][0][i]) for i in (KRY_MID, 0))
    cv, cc = inp["chi"]
    key = jax.random.PRNGKey(3)

    def band(m):
        lams, _, _ = jx.spectral_slice(jx.DenseOperator(m), lo_e, hi_e, r=3,
                                       degree=80, maxiter=200, tol=1e-10)
        inside = (lams >= lo_e) & (lams <= hi_e)
        return jnp.sum(jnp.where(inside, lams, 0.0))

    def pencil(am, bm):
        lams, _ = jx.dominant_eigh_gen(jx.DenseOperator((am + am.T) / 2),
                                       jx.DenseOperator((bm + bm.T) / 2),
                                       r=2, maxiter=300, tol=1e-11)
        return jnp.sum(lams * jnp.arange(1.0, 3.0))

    def interior(m):
        lam, v = jx.interior_eigh(jx.DenseOperator(m), KRY_SIGMA, k=16,
                                  inner_tol=1e-12, tol=1e-10)
        return lam + jnp.sum(v ** 4)

    def solve(fn, m, b, c):
        return jnp.dot(c, fn(lambda x: m @ x, b, tol=1e-12, maxiter=2000))

    # JAX's constructors read their inputs on the host: built outside jit.
    a_j, spd_j = jnp.asarray(inp["a"]), jnp.asarray(inp["spd"])
    pre = {"spd": jx.jacobi_precond(jx.DenseOperator(spd_j)),
           "mid": jx.jacobi_precond(jx.DenseOperator(a_j), shift=w_mid),
           "min": jx.jacobi_precond(jx.DenseOperator(a_j), shift=w_0),
           "a": jx.jacobi_precond(jx.DenseOperator(a_j), shift=0.3),
           "block": jx.block_jacobi_precond(jx.DenseOperator(a_j), bs=8,
                                            shift=0.3)}

    @jax.jit
    def oracles(a, spd, a11, pa, pb, vals, v0, b, c, omegas):
        op = jx.DenseOperator(a)
        bell = jx.BellOperator(vals, jnp.asarray(cc), 128, symmetric=True,
                               use_pallas=False)
        vp = vecs[:, 0] + 1e-3 * vecs[:, 1]
        mid = KRY_MID
        out = {
            "restart": jax.value_and_grad(
                lambda g: tfim_exact_e0(RESTART_N, g))(one(1.0)),
            "slice": jax.value_and_grad(band)(a11),
            "pencil": (pencil(pa, pb),
                       jax.grad(pencil, argnums=(0, 1))(pa, pb)),
            "kpm_density": jx.spectral_density(
                bell, jnp.asarray(inp["kpm_xs"]), degree=64, n_probe=8,
                key=key),
            "kpm_trace": jx.trace_function(bell, jnp.exp, degree=64,
                                           n_probe=8, key=key),
            "adaptive": jx.lanczos_adaptive(op, 48, v0=v0, tol=1e-10),
            "power": jx.power_iteration(op, 300, v0=v0),
            "refine_cg": jx.refine_eigenpair(op, w[0] + 1e-3, vp, iters=2,
                                             definite_sign=1.0),
            "refine_minres": jx.refine_eigenpair(op, w[0] + 1e-3, vp,
                                                 iters=2),
            "minres": jx.minres(lambda x: a @ x, b, tol=1e-12,
                                maxiter=2000),
            "cg": jx.cg(lambda x: spd @ x, b, tol=1e-12),
            "cg_info": jx.cg_info(lambda x: spd @ x, b, tol=1e-12,
                                  precond=pre["spd"])[0],
            "deflated_minres": jx.solve_deflated(
                op, w[mid], vecs[:, mid], b, method="minres", tol=1e-11,
                maxiter=5000),
            "deflated_minres_precond": jx.solve_deflated(
                op, w[mid], vecs[:, mid], b, method="minres", tol=1e-11,
                maxiter=5000, precond=pre["mid"]),
            "deflated_cg_precond": jx.solve_deflated(
                op, w[0], vecs[:, 0], b, tol=1e-11, maxiter=5000,
                precond=pre["min"]),
            "deflated_info_precond": jx.solve_deflated_info(
                op, w[0], vecs[:, 0], b, tol=1e-11,
                precond=pre["min"])[0],
            "solve_spd": (jx.solve_spd(lambda x: spd @ x, b, tol=1e-12),
                          jax.grad(lambda m, r: solve(jx.solve_spd, m, r, c),
                                   argnums=(0, 1))(spd, b)),
            "solve_symmetric": (
                jx.solve_symmetric(lambda x: a @ x, b, tol=1e-12,
                                   maxiter=2000),
                jax.grad(lambda m, r: solve(jx.solve_symmetric, m, r, c),
                         argnums=(0, 1))(a, b)),
            "jacobi": pre["a"](b),
            "block_jacobi": pre["block"](b),
            "interior": jax.value_and_grad(interior)(a),
            "spectral_function": (
                jx.spectral_function(op, b, omegas, 0.5, tol=1e-11),
                jax.grad(lambda m: jnp.sum(jx.spectral_function(
                    jx.DenseOperator(m), b, omegas, 0.5, tol=1e-11)))(a)),
            "deflated_operator": jx.DeflatedOperator(op, vecs[:, :2])
            .matvec(b)}
        return out

    got = oracles(*(jnp.asarray(inp[k]) for k in (
        "a", "spd", "a11", "pa", "pb")), jnp.asarray(cv),
        *(jnp.asarray(inp[k]) for k in ("v0_64", "b64", "c64", "omegas")))
    got["eigvals_a"] = np.asarray(inp["eig_a"][0])
    return got


def _jax_general():
    """The JAX package's values for the general tier's cases, computed
    once for the run's xdist workers."""
    return _shared("jax_general", _compute_jax_general)


@functools.lru_cache(maxsize=None)
def _compute_jax_general():
    """Each general-tier case on the unsharded operator, in one jitted
    program, at the settings the ranks use (JAX draws its own start
    vectors: a converged triple is the same after the gauge); the
    spectrum's structure is discovered once, on the host, as the JAX
    function does."""
    import jax
    import jax.numpy as jnp
    import dominantsparseeigenad_tpu as jx

    inp = _inputs()
    pair_kw = dict(num_iters=PAIR_ITERS, power_tol=PAIR_PTOL, tol=GEN_TOL)
    structure = jx.spectrum_structure(jx.DenseOperator(
        jnp.asarray(inp["pair_a"])), SPEC_M, **pair_kw)
    cols = jnp.asarray(inp["pos_bell"][1])
    weights = jnp.array([1.0, 2.0])

    def bell(v):
        return jx.BellOperator(v, cols, 64, symmetric=False,
                               use_pallas=False)

    @jax.jit
    def oracles(ns, b, c, vals, direction, pair_a):
        shifted = ns + GEN_SHIFT * jnp.eye(64)
        out = {"bicgstab": jx.bicgstab(lambda x: shifted @ x, b,
                                       tol=GEN_TOL),
               "gmres": jx.gmres(lambda x: shifted @ x, b, tol=GEN_TOL,
                                 restart=GEN_RESTART)}
        for method in ("bicgstab", "gmres", "cgnr"):
            def solve(m, rhs, method=method):
                return jx.solve_general(lambda x: m @ x, lambda x: m.T @ x,
                                        rhs, tol=GEN_TOL, method=method)
            out[f"solve_general_{method}"] = (
                solve(shifted, b),
                jax.grad(lambda m, rhs: jnp.dot(c, solve(m, rhs)),
                         argnums=(0, 1))(shifted, b))
        for method in ("power", "arnoldi"):
            def eig(v, method=method):
                return jx.dominant_eig(bell(v), method=method, tol=GEN_TOL)

            def loss(v, eig=eig):
                lam, l, r = eig(v)
                return lam + jnp.sum(r ** 4) + jnp.dot(c, l)
            out[f"eig_{method}"] = (eig(vals), jax.grad(loss)(vals),
                                    jax.jvp(eig, (vals,), (direction,))[1])

        def multi(v):
            return jx.dominant_eig_multi(bell(v), m=2, tol=GEN_TOL)
        out["eig_multi"] = (multi(vals), jax.grad(
            lambda v: jnp.sum(multi(v)[0] * weights))(vals))

        def pair(m):
            return jx.dominant_eig_pair(jx.DenseOperator(m), **pair_kw)

        def pair_loss(m):
            lam, _, r = pair(m)
            return lam.real + 0.5 * lam.imag + jnp.sum(r.real ** 3)
        out["eig_pair"] = (pair(pair_a), jax.grad(pair_loss)(pair_a))

        def spectrum(m):
            return jx.dominant_eig_spectrum(jx.DenseOperator(m), SPEC_M,
                                            structure=structure,
                                            **pair_kw)[:3]

        def spectrum_loss(m):
            lams = spectrum(m)[0]
            return jnp.sum(lams.real) + 0.3 * jnp.sum(jnp.abs(lams.imag))
        out["eig_spectrum"] = (spectrum(pair_a),
                               jax.grad(spectrum_loss)(pair_a))

        def svd(m):
            return jx.dominant_svd(m, r=2, k=64)
        out["svd"] = (svd(ns), jax.grad(
            lambda m: jnp.sum(svd(m)[1] * weights))(ns))
        return out

    got = oracles(*(jnp.asarray(t) for t in (
        inp["ns_dense"], inp["b64"], inp["c64"], inp["pos_bell"][0],
        inp["pos_dir"], inp["pair_a"])))
    got = jax.tree.map(np.asarray, got)
    got["structure"] = tuple(structure)
    return got


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
    results are bitwise the same on every rank, those of the Hermitian
    solvers and of the general tier over sharded vectors too (every host
    branch there reads one of them: breakdowns, the early exit, the
    residual reads of CG, MINRES, BiCGStab and GMRES, LOBPCG's stop, the
    power loops' stop, the spectrum's decisions)."""
    p, results, _ = ranks
    first = results[0]
    for res in results[1:]:
        assert res["collectives"] == first["collectives"]
        for key in ("dense_loss_ring", "tfim_e0", "tfim_d2e0", "chi_ring",
                    "eig_loss_ring", "restart_e0", "restart_d2e0",
                    "slice_band", "pencil_loss", "kpm_trace_ring",
                    "kpm_logdet_sharded", "f11_sharded"):
            assert res[key] == first[key], key
        for name in _KRY_REPLICATED:
            for i in _KRY_REPLICATED[name]:
                assert np.array_equal(res[f"kry_{name}_sharded"][i],
                                      first[f"kry_{name}_sharded"][i]), name
        for name, outputs in _GEN_REPLICATED.items():
            for i in outputs:
                assert np.array_equal(res[f"gen_{name}_sharded"][i],
                                      first[f"gen_{name}_sharded"][i]), name


# -- the Hermitian solvers over sharded vectors (item 18, steps 1-4) ----------

def test_sharded_restart_cycles_value_and_grad(ranks):
    """``tests/test_parallel.py:215-234``: thick restart (k = 24, 6
    cycles) through the sharded TFIM N = 12 against Jordan-Wigner."""
    p, results, _ = ranks
    e0, de0 = _jax_oracles()["restart"]
    for res in results:
        assert abs(res["restart_e0"] - e0) <= 1e-10 * abs(e0)
        assert abs(res["restart_de0"] - de0) <= 1e-8 * abs(de0)


def test_sharded_restart_second_order(ranks):
    """d²E0/dg² through the restart (N = 6) at the bar of
    ``test_sharded_tfim_energy_and_derivatives``: a missing
    ``layout_bcast`` mark passes at first order and at p = 1, not at
    p = 2 and 4."""
    p, results, _ = ranks
    want = _jax_oracles()["tfim_d2e0"]
    for res in results:
        assert abs(res["restart_d2e0"] - want) <= 1e-6 * abs(want)


def test_sharded_restart_stepped_matches_replicated(ranks):
    """``restart_init``, three ``restart_cycle`` and ``restart_extract``
    on the sharded TFIM N = 8 against the replicated layout from the same
    start vector (λ, the rank's rows of v, the residual coupling)."""
    p, results, _ = ranks
    for res in results:
        lam_rel, v_err, resid_err, _ = res["restart_stepped"]
        assert lam_rel <= 1e-12 and v_err <= 1e-10 and resid_err <= 1e-12


def test_sharded_spectral_slice_matches_dense(ranks):
    """``tests/test_parallel.py:157-182``: the band of an interior slice
    (n = 64, r = 3, degree 80) and its gradient (the ranks' shares)
    against JAX's dense path."""
    p, results, _ = ranks
    val, grad = _jax_oracles()["slice"]
    for res in results:
        assert abs(res["slice_band"] - val) <= 1e-9 * abs(val)
    np.testing.assert_allclose(sum(res["slice_grad"] for res in results),
                               grad, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_kpm_density_and_trace(ranks, mode):
    """``tests/test_sharded_sparse.py:178-212``, its density half, and
    ``trace_function(exp)``: a ``RowShardedBellOperator`` (n = 128,
    degree 64, 8 probes, each rank its rows of JAX's probes) against
    JAX's local operator; ``logdet`` against the replicated layout."""
    p, results, _ = ranks
    want = _jax_oracles()
    for res in results:
        np.testing.assert_allclose(res[f"kpm_density_{mode}"],
                                   want["kpm_density"], rtol=1e-9,
                                   atol=1e-12)
        assert abs(res[f"kpm_trace_{mode}"] - want["kpm_trace"]) <= \
            1e-9 * abs(want["kpm_trace"])
        assert abs(res["kpm_logdet_sharded"] - res["kpm_logdet_replicated"]) \
            <= 1e-12 * abs(res["kpm_logdet_replicated"])


def test_sharded_generalized_pencil_matches_dense(ranks):
    """``tests/test_parallel.py:185-212``: the pencil with A row-sharded
    (B on the same layout), Σ i λ_i and both gradients (the ranks'
    shares) against JAX's dense pencil."""
    p, results, _ = ranks
    val, (ga, gb) = _jax_oracles()["pencil"]
    for res in results:
        assert abs(res["pencil_loss"] - val) <= 1e-9 * abs(val)
    np.testing.assert_allclose(sum(res["pencil_grad_a"] for res in results),
                               ga, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(sum(res["pencil_grad_b"] for res in results),
                               gb, rtol=1e-6, atol=1e-9)


def test_diagnostics_reduce_over_the_ranks(ranks):
    """F11: ``ritz_residual``, ``lanczos_health`` (the orthogonality loss
    and both Ritz residuals) and ``cg_relative_residual`` on sharded
    vectors give the replicated layout's values on every rank (f64, on
    F11's recorded input)."""
    p, results, _ = ranks
    for res in results:
        sh, rep = res["f11_sharded"], res["f11_replicated"]
        for got, want in zip(sh, rep):
            assert abs(got - want) <= 1e-12 * max(abs(want), 1.0)
        assert rep[1] <= 1e-14       # the replicated basis is orthonormal


def _vec(outs, i):
    """The whole vector of output ``i`` from the ranks' rows."""
    return np.concatenate([o[i] for o in outs])


def _share(outs, i):
    """The ranks' gradient shares of output ``i``, summed."""
    return sum(o[i] for o in outs)


def _eigh_option(outs, want):
    np.testing.assert_allclose(float(outs[0][0]), want["dense"][0],
                               rtol=1e-9)
    np.testing.assert_allclose(_share(outs, 2), want["dense"][1], rtol=1e-6,
                               atol=1e-9)


def _pair(outs, want, lam_rtol=1e-12, v_atol=1e-10):
    lam, v = want
    np.testing.assert_allclose(float(outs[0][0]), float(lam), rtol=lam_rtol)
    np.testing.assert_allclose(_vec(outs, 1), v, atol=v_atol)


def _solve_x(outs, want, rtol):
    assert _rel(_vec(outs, 0), want) <= rtol


def _check_solve_grads(outs, want):
    x, (gm, gb) = want
    assert _rel(_vec(outs, 0), x) <= 1e-9
    np.testing.assert_allclose(_share(outs, 1), gm, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(_vec(outs, 2), gb, rtol=1e-7, atol=1e-10)


def _kry_checks():
    """Each step-4 case against the JAX package on the unsharded operator,
    at the bar of that option's JAX test."""
    def adaptive(outs, want):
        lam, v, info = want
        _pair(outs, (lam, v), v_atol=1e-8)
        assert float(outs[0][2]) == float(info.effective_k)

    def multi(outs, want):
        np.testing.assert_allclose(outs[0][0], want["lobpcg_lams"],
                                   rtol=1e-9)
        np.testing.assert_allclose(_share(outs, 1), want["lobpcg_grad"],
                                   rtol=1e-7, atol=1e-10)

    def cg(outs, want):
        _solve_x(outs, want["cg"], 1e-10)
        assert _rel(_vec(outs, 1), want["cg_info"]) <= 1e-10
        assert float(outs[0][3]) <= 1e-11

    def interior(outs, want):
        val, grad = want["interior"]
        np.testing.assert_allclose(float(outs[0][0]), float(val), rtol=1e-9)
        np.testing.assert_allclose(_share(outs, 2), grad, rtol=1e-6,
                                   atol=1e-9)

    def spectral(outs, want):
        y, grad = want["spectral_function"]
        np.testing.assert_allclose(outs[0][0], y, rtol=1e-9)
        np.testing.assert_allclose(_share(outs, 1), grad, rtol=1e-7,
                                   atol=1e-10)

    def deflated_op(outs, want):
        assert _rel(_vec(outs, 0), want["deflated_operator"]) <= 1e-12
        np.testing.assert_allclose(float(outs[0][1]), want["eigvals_a"][2],
                                   rtol=1e-9)

    return {
        "carry": _eigh_option, "early_exit": _eigh_option,
        "basis_f32": _eigh_option, "precond": _eigh_option,
        "restart": _eigh_option, "multi_precond": multi,
        "lobpcg_precond": lambda outs, want: np.testing.assert_allclose(
            outs[0][0], want["eigvals_a"][:2], rtol=1e-9),
        "adaptive": lambda outs, want: adaptive(outs, want["adaptive"]),
        "power": lambda outs, want: _pair(outs, want["power"]),
        "refine_cg": lambda outs, want: _pair(outs, want["refine_cg"]),
        "refine_minres": lambda outs, want: _pair(outs,
                                                  want["refine_minres"]),
        "minres": lambda outs, want: _solve_x(outs, want["minres"], 1e-9),
        "cg": cg,
        "deflated_minres": lambda outs, want: _solve_x(
            outs, want["deflated_minres"], 1e-8),
        "deflated_minres_precond": lambda outs, want: _solve_x(
            outs, want["deflated_minres_precond"], 1e-8),
        "deflated_cg_precond": lambda outs, want: _solve_x(
            outs, want["deflated_cg_precond"], 1e-8),
        "deflated_info_precond": lambda outs, want: _solve_x(
            outs, want["deflated_info_precond"], 1e-8),
        "solve_spd": lambda outs, want: _check_solve_grads(
            outs, want["solve_spd"]),
        "solve_symmetric": lambda outs, want: _check_solve_grads(
            outs, want["solve_symmetric"]),
        "jacobi": lambda outs, want: _solve_x(outs, want["jacobi"], 1e-14),
        # One batched eigh of the blocks on each side.
        "block_jacobi": lambda outs, want: _solve_x(
            outs, want["block_jacobi"], 1e-10),
        "interior": interior,
        "spectral_function": spectral,
        "deflated_operator": deflated_op,
    }


# The outputs of each case that are replicated (the same on every rank).
_KRY_REPLICATED = {
    "carry": (0,), "early_exit": (0,), "basis_f32": (0,), "precond": (0,),
    "restart": (0,), "multi_precond": (0,), "lobpcg_precond": (0,),
    "adaptive": (0, 2, 3), "power": (0,), "refine_cg": (0,),
    "refine_minres": (0,), "cg": (2, 3), "deflated_info_precond": (1, 2),
    "interior": (0,), "spectral_function": (0,), "deflated_operator": (1,)}

# The outputs that are residuals, relative already and down to
# round-off: compared absolutely.
_KRY_RESIDUALS = {"adaptive": (3,), "cg": (3,), "deflated_info_precond": (2,)}

# The cases whose iterative solves stop at a tolerance (MINRES and the
# block CG at 1e-10 to 1e-11 through hundreds of iterations, LOBPCG's
# Ritz vectors at 1e-10): the two layouts sum their dots in different
# orders, and the outputs agree within ten times that tolerance.
_KRY_SOLVE_BAR = {"deflated_minres": 1e-10, "deflated_minres_precond": 1e-10,
                  "spectral_function": 1e-10, "interior": 1e-10,
                  "multi_precond": 1e-9, "lobpcg_precond": 1e-9}


@pytest.mark.parametrize("name", sorted(_kry_checks()))
def test_krylov_option_on_sharded_vectors(ranks, name):
    """Each step-4 entry point (the Krylov options of ``dominant_eigh``,
    the preconditioners, LOBPCG with one, ``lanczos_adaptive``,
    ``power_iteration``, ``refine_eigenpair``, ``cg``/``cg_info``/
    ``minres`` on a bound matvec, the deflated and undeflated solves,
    ``interior_eigh``, ``spectral_function``, ``DeflatedOperator``) over
    sharded vectors: equal to the replicated layout at the same p (1e-12
    in f64; the rank's rows of each vector, its share of each gradient),
    and to the JAX function on the unsharded operator at the bar of that
    option's JAX test."""
    p, results, _ = ranks
    bar = _KRY_SOLVE_BAR.get(name, 1e-12)
    for res in results:
        for i, (got, want) in enumerate(zip(res[f"kry_{name}_sharded"],
                                            res[f"kry_{name}_replicated"])):
            scale = 1.0 if i in _KRY_RESIDUALS.get(name, ()) \
                else np.abs(want).max()
            assert np.abs(got - want).max() <= bar * scale, (name, i)
    _kry_checks()[name]([res[f"kry_{name}_sharded"] for res in results],
                        _jax_oracles())


# -- the general tier over sharded vectors (item 18, step 5) ------------------

def _crel(a, b):
    """max |a - b| / max |b|, complex arrays as they are."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _sign_fixed(got, want):
    """``got``'s columns with the signs that match ``want``'s (a singular
    pair is defined up to one sign)."""
    return got * np.sign((got * want).sum(axis=0))[None, :]


def _gen_checks():
    """Each general-tier case against the JAX package on the unsharded
    operator: values at 1e-10, vectors at 1e-9, first derivatives at
    1e-8 (the IFT solves stop at 1e-12 in both packages), the singular
    vectors and their gradient at Lanczos's tolerance."""
    def solve(x, want):
        assert _crel(_vec(x, 0), want) <= 1e-10

    def triple(outs, want, grad, panels=True):
        (lam, l, r), g = want[:2]
        assert _crel(outs[0][0], lam) <= 1e-10
        assert _crel(_vec(outs, 1), l) <= 1e-9
        assert _crel(_vec(outs, 2), r) <= 1e-9
        got_g = _vec(outs, 3) if panels else _share(outs, 3)
        assert _crel(got_g, g) <= grad

    def eig(outs, want):
        triple(outs, want, 1e-8)
        if len(outs[0]) == 4:
            return
        dlam, dl, dr = want[2]
        assert _crel(outs[0][4], dlam) <= 1e-8
        assert _crel(_vec(outs, 5), dl) <= 1e-8
        assert _crel(_vec(outs, 6), dr) <= 1e-8

    def spectrum(outs, want, structure):
        triple(outs, want, 1e-8, panels=False)
        assert tuple(outs[0][4]) == tuple(STRUCTURE_CODES[k]
                                          for k in structure)

    def svd(outs, want):
        (u, s, v), g = want
        assert _crel(outs[0][0], s) <= 1e-9
        assert _crel(_sign_fixed(_vec(outs, 1), u), u) <= 1e-7
        assert _crel(_sign_fixed(_vec(outs, 2), v), v) <= 1e-7
        assert _crel(_share(outs, 3), g) <= 1e-7

    return {
        "bicgstab": lambda outs, want: solve(outs, want["bicgstab"]),
        "gmres": lambda outs, want: solve(outs, want["gmres"]),
        **{f"solve_general_{m}": (
            lambda outs, want, m=m: _check_solve_grads(
                outs, want[f"solve_general_{m}"]))
           for m in ("bicgstab", "gmres", "cgnr")},
        "eig_power": lambda outs, want: eig(outs, want["eig_power"]),
        "eig_arnoldi": lambda outs, want: eig(outs, want["eig_arnoldi"]),
        "eig_multi": lambda outs, want: triple(outs, want["eig_multi"],
                                               1e-8),
        "eig_pair": lambda outs, want: triple(outs, want["eig_pair"], 1e-8,
                                              panels=False),
        "eig_spectrum": lambda outs, want: spectrum(
            outs, want["eig_spectrum"], want["structure"]),
        "svd": lambda outs, want: svd(outs, want["svd"]),
    }


# The outputs of each case that are replicated (the same on every rank).
_GEN_REPLICATED = {
    "eig_power": (0,), "eig_arnoldi": (0, 4),
    "eig_second_order": (0, 1, 2), "eig_multi": (0,), "eig_pair": (0,),
    "eig_spectrum": (0, 4), "svd": (0,)}


def _layouts_agree(results, p, name, bar):
    """Case ``name`` over sharded vectors against the replicated layout
    at the same p: equal at p = 1, within ``bar`` of each output's scale
    at p > 1 (the ranks' dots sum in another order)."""
    for res in results:
        for i, (got, want) in enumerate(zip(res[f"gen_{name}_sharded"],
                                            res[f"gen_{name}_replicated"])):
            if p == 1:
                assert np.array_equal(got, want), (name, i)
            else:
                assert np.abs(got - want).max() <= \
                    bar * np.abs(want).max(), (name, i)


@pytest.mark.parametrize("name", sorted(_gen_checks()))
def test_general_tier_on_sharded_vectors(ranks, name):
    """Each entry point of the general tier (BiCGStab and GMRES on a
    bound matvec, ``solve_general`` by its three methods with the
    gradients in the matrix and the right-hand side, ``dominant_eig`` by
    power and Arnoldi with the gradient of a loss on λ, l and r and
    forward mode, ``dominant_eig_multi``, ``dominant_eig_pair``,
    ``spectrum_structure`` and ``dominant_eig_spectrum``, ``dominant_svd``)
    over sharded vectors: equal to the replicated layout at the same p
    (exactly at p = 1, 1e-10 in f64 above; the rank's rows of each
    vector, its share or panel of each gradient), and to the JAX
    function on the unsharded operator."""
    p, results, _ = ranks
    _layouts_agree(results, p, name, 1e-10)
    _gen_checks()[name]([res[f"gen_{name}_sharded"] for res in results],
                        _jax_general())


def test_general_tier_second_order_on_sharded_vectors(ranks):
    """d²/dt² of λ + Σ r⁴ of ``dominant_eig`` along a direction of the
    values: the bordered solves run inside the first backward, and the
    second differentiates through them.  Equal to the replicated layout
    at the same p (a missing mark where λ or ν enters the rank's rows
    passes at first order and at p = 1, not at p = 2 and 4)."""
    p, results, _ = ranks
    _layouts_agree(results, p, "eig_second_order", 1e-9)


def test_bordered_dot_counts_the_border_once(ranks):
    """A bordered vector (x; ν) holds its border on the first rank only:
    the dot and the norm of two, summed over the ranks, are the whole
    vectors' (a border on every rank would count ν p times)."""
    p, results, _ = ranks
    for res in results:
        for key in ("bordered_dot", "bordered_norm"):
            got, want = res[key]
            assert abs(got - want) <= 1e-13 * abs(want), key


def test_stacked_layout_is_the_whole_embedding_vector(ranks):
    """The stacked layout of the Hermitian embedding: a rank's rows are
    its rows of u and of v; the draw is those rows of the whole draw;
    the pivot on a tie between a u row of rank 1 and a v row of rank 0
    is the lower global index (``torch.argmax`` of the whole vector, not
    rank order), for a vector and per column of a block; ``take`` and
    ``one_hot`` at that index."""
    p, results, _ = ranks
    for res in results:
        assert res["stacked_draw"] and res["stacked_rows"]
        idx, entry, want_idx, want_entry = res["stacked_pivot"]
        assert (idx, entry) == (want_idx, want_entry)
        bidx, bentry, bwant, bwant_entry = res["stacked_pivot_block"]
        assert bidx == bwant and bentry == bwant_entry
        got, want = res["stacked_take"]
        assert got == want
        assert res["stacked_one_hot"]


# -- one rank, with no spawn -------------------------------------------------

def _solo_operator():
    """A sharded-vector operator on one rank, built with its ShardGroup
    given (no process group is needed before a product)."""
    sg = ShardGroup(group=None, rank=0, size=1, backend="gloo")
    vals = torch.eye(8, dtype=F64).repeat(2, 1, 1, 1)
    cols = torch.tensor([[0], [1]], dtype=torch.int32)
    return port.RowShardedBellOperator(vals, cols, 16, sg, symmetric=True,
                                       vectors="sharded")


def _solo_general(name):
    """The general tier on a one-rank group: ``name``'s call, its
    operator built from a global dense matrix in the given layout."""
    rng = np.random.default_rng(29)
    pos = np.abs(rng.standard_normal((16, 16))) + 0.01
    blk = np.diag(np.concatenate([[0.0, 0.0], 1.5 * rng.random(14)]))
    blk[:2, :2] = [[0.0, -3.0], [3.0, 0.0]]
    q, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    pair_a = _t(q @ blk @ q.T)
    shifted = _t(rng.standard_normal((16, 16)) + 6.0 * np.eye(16))
    b = _t(rng.standard_normal(16))

    def call(vectors):
        sg = ShardGroup(group=None, rank=0, size=1, backend="gloo")

        def op(a):
            return port.RowShardedOperator(a, sg, vectors=vectors)
        return {
            "bicgstab": lambda: [port.bicgstab(op(shifted).matvec, b,
                                               device="cpu")],
            "gmres": lambda: [port.gmres(op(shifted).matvec, b, restart=6,
                                         device="cpu")],
            "solve_general": lambda: [port.solve_general(op(shifted), b,
                                                         device="cpu")],
            "dominant_eig": lambda: list(port.dominant_eig(
                op(_t(pos)), device="cpu")),
            "dominant_eig_multi": lambda: list(port.dominant_eig_multi(
                op(_t(pos)), device="cpu")),
            "dominant_eig_pair": lambda: list(port.dominant_eig_pair(
                op(pair_a), device="cpu")),
            "dominant_eig_spectrum": lambda: list(port.dominant_eig_spectrum(
                op(pair_a), m=2, device="cpu")[:3]),
            "spectrum_structure": lambda: [torch.tensor([
                STRUCTURE_CODES[k] for k in port.spectrum_structure(
                    op(pair_a), m=2, device="cpu")])],
            "dominant_svd": lambda: list(port.dominant_svd(
                op(_t(pos)), r=2, k=16, device="cpu")),
        }[name]()
    return call


_GENERAL_NAMES = ("bicgstab", "dominant_eig", "dominant_eig_multi",
                  "dominant_eig_pair", "dominant_eig_spectrum",
                  "dominant_svd", "gmres", "solve_general",
                  "spectrum_structure")


@pytest.mark.parametrize("name", _GENERAL_NAMES)
def test_general_tier_runs_on_sharded_vectors(name, tmp_path):
    """Each entry point of the general tier on a one-rank sharded-vector
    operator gives the replicated layout's outputs exactly."""
    port.init_distributed("gloo", f"file://{tmp_path}/store", 0, 1)
    try:
        call = _solo_general(name)
        sharded, replicated = call("sharded"), call("replicated")
    finally:
        dist.destroy_process_group()
    for got, want in zip(sharded, replicated):
        assert torch.equal(got, want), name


def _row_sharded_types(sg):
    return {
        "RowShardedOperator": port.RowShardedOperator(
            torch.eye(16, dtype=F64), sg, vectors="sharded"),
        "RowShardedBellOperator": _solo_operator(),
        "ShardedMatrixFreeOperator": models.tfim_sharded_operator(
            4, 0.5, sg, device="cpu", vectors="sharded")}


@pytest.mark.parametrize("kind", ["RowShardedOperator",
                                  "RowShardedBellOperator",
                                  "ShardedMatrixFreeOperator"])
def test_operator_diagonal_refuses_row_sharded_types(kind):
    """``operator_diagonal`` knows no row-sharded operator (TypeError, as
    the JAX function's type dispatch); the preconditioners take an
    explicit ``diag=`` or ``blocks=`` there."""
    sg = ShardGroup(group=None, rank=0, size=1, backend="gloo")
    op = _row_sharded_types(sg)[kind]
    with pytest.raises(TypeError, match="no structural diagonal"):
        port.operator_diagonal(op)
    with pytest.raises(TypeError, match="no structural diagonal"):
        port.jacobi_precond(op)


def test_preconditioners_take_the_ranks_rows():
    """Rank 1 of 2 applies rows 12..23 of the whole ``diag``; block-Jacobi
    raises when the rank's rows are not whole blocks, or when the blocks
    do not cover the whole dimension."""
    sg = ShardGroup(group=None, rank=1, size=2, backend="gloo")
    op = port.RowShardedOperator(torch.eye(24, dtype=F64), sg,
                                 vectors="sharded")
    d = torch.arange(1.0, 25.0, dtype=F64)
    r = torch.ones(12, dtype=F64)
    torch.testing.assert_close(port.jacobi_precond(op, diag=d)(r),
                               1.0 / d[12:], rtol=0, atol=0)
    with pytest.raises(ValueError, match="pass the whole 24"):
        port.jacobi_precond(op, diag=d[12:])
    with pytest.raises(ValueError, match="not a whole number"):
        port.block_jacobi_precond(op, blocks=torch.eye(8, dtype=F64)
                                  .repeat(3, 1, 1))
    with pytest.raises(ValueError, match="pass the whole 24"):
        port.block_jacobi_precond(op, blocks=torch.eye(4, dtype=F64)
                                  .repeat(3, 1, 1))
    m = port.block_jacobi_precond(op, blocks=torch.eye(4, dtype=F64)
                                  .repeat(6, 1, 1) * 2.0)
    torch.testing.assert_close(m(r), r / 2.0)


def test_pencil_layouts_must_conform():
    """A pencil whose A is sharded and whose B is whole does not conform
    (the composites' rule), in the solver and in its pencil solve."""
    op = _solo_operator()
    whole = port.DenseOperator(torch.eye(16, dtype=F64))
    v = torch.zeros(16, 1, dtype=F64)
    for call in (lambda: port.dominant_eigh_gen(op, whole, 2, device="cpu"),
                 lambda: port.lobpcg_eigh_general(op, whole, 2,
                                                  device="cpu"),
                 lambda: port.solve_deflated_pencil(op, whole, 0.0, v, v,
                                                    v[:, 0], device="cpu")):
        with pytest.raises(ValueError, match="do not conform"):
            call()


def test_deflated_operator_takes_the_ranks_rows():
    """``DeflatedOperator`` over sharded vectors takes V with the rank's
    rows (rank 1 of 2 holds 8 of 16)."""
    sg = ShardGroup(group=None, rank=1, size=2, backend="gloo")
    op = port.RowShardedOperator(torch.eye(16, dtype=F64), sg,
                                 vectors="sharded")
    assert port.DeflatedOperator(op, torch.zeros(8, 1, dtype=F64)).V \
        .shape == (8, 1)
    with pytest.raises(ValueError, match="the operator's vectors 8"):
        port.DeflatedOperator(op, torch.zeros(16, 1, dtype=F64))


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
