"""The port's sharded matrix-free tier and the derivative modes of the
sharded operators against the JAX package on the 8-virtual-device CPU
mesh (f64): ``tfim_sharded_operator`` with its XOR-partner exchange
(``ppermute``), ``ShardedMatrixFreeOperator``, forward mode and second
order through the collectives, a complex ``RowShardedOperator``, the
block, restarted, slicing and pencil solvers through the sharded
operators, and the batch axis of ``make_mesh``.

The port runs one process per rank on a gloo group, spawned once per
world size by a module-scoped fixture (p = 1 runs in this process).
Every rank computes everything below in that one spawn (the dense
row-sharded solvers at p = 1 and 2 only) and sends it back; the tests
compare with the JAX package's sharded functions at the same shard
count, each jitted once, computed in this process.  The rank processes
import no JAX: this module imports it only inside the functions that
compute the expected values.

A parameter that builds a row-sharded operator's rows (the ``t`` of
``h0 + t h1``, or of the panel ``vals + t pert``) receives on each rank
the share of that rank's rows in reverse mode: the shares sum to the
derivative (the tests sum them).  In forward mode every rank gets the
whole tangent.  A replicated parameter of ``ShardedMatrixFreeOperator``
(the TFIM's g) gets the whole gradient on every rank.
"""

import functools
import multiprocessing
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import torch.distributed as dist

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models
from dominantsparseeigenad_tpu_torch.parallel import collectives

torch.set_num_threads(2)

F64 = torch.float64
RANK_TIMEOUT_S = 180        # a rank's whole run; each queue read and join
BATCH_G = (0.6, 1.1)        # the couplings of the two batch rows
SLICE_R, LOBPCG_R, GEN_R = 3, 2, 2


# -- inputs, made in this process -------------------------------------------

def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


@functools.lru_cache(maxsize=None)
def _inputs():
    """The JAX tests' inputs (``tests/test_parallel.py``,
    ``tests/test_sharded_sparse.py``) and JAX's default start vectors."""
    import jax
    import jax.numpy as jnp

    def normal(shape, dtype=jnp.float64):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape,
                                            dtype))

    # The symmetric operator of test_sharded_bell_second_derivative (its
    # pattern is the JAX generator's; the values are drawn here, once, for
    # both packages) and its symmetric pattern perturbation: a random B on
    # the pattern, (B + B^T) / 2, projected back on the operator's slots.
    op = port.random_bell_operator(64, 8, 3,
                                   generator=torch.Generator().manual_seed(5),
                                   dtype=F64, device="cpu")
    vals, cols = op.vals.numpy(), op.cols.numpy()
    nb, max_blk, bs, _ = vals.shape
    dvals = np.random.default_rng(9).standard_normal(vals.shape)
    b = np.zeros((nb, bs, nb, bs))
    for i in range(nb):
        for j in range(max_blk):
            b[i, :, cols[i, j], :] += dvals[i, j]
    b = b.reshape(64, 64)
    bmat = ((b + b.T) / 2).reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
    pert = np.zeros(vals.shape)
    for i in range(nb):
        for j in range(max_blk):
            pert[i, j] = bmat[i, cols[i, j]]

    rng = np.random.default_rng(12)
    h0 = rng.standard_normal((256, 256)) + 1j * rng.standard_normal(
        (256, 256))
    h1 = rng.standard_normal((256, 256)) + 1j * rng.standard_normal(
        (256, 256))
    slice_a = _sym(64, 11)
    ew = np.linalg.eigvalsh(slice_a)
    c = np.random.default_rng(13).standard_normal((64, 64)) / np.sqrt(4 * 64)
    return {
        "x6": np.random.default_rng(2).standard_normal(64),
        "v0_64": normal((64,)), "v0_256": normal((256,)),
        "v0_c256": normal((256,), jnp.complex128),
        "bell_vals": vals, "bell_cols": cols,
        "bell_pert": pert,
        "h0": (h0 + h0.conj().T) / 2, "h1": (h1 + h1.conj().T) / 2,
        "lobpcg_a": _sym(64, 7), "lobpcg_x0": normal((64, LOBPCG_R)),
        "slice_a": slice_a, "slice_window": (float((ew[30] + ew[29]) / 2),
                                             float((ew[32] + ew[31]) / 2)),
        "gen_a": _sym(64, 13) + 2.0 * np.diag(np.arange(1.0, 65)),
        "gen_b": c @ c.T + np.eye(64), "gen_x0": normal((64, GEN_R)),
    }


# -- what every rank computes (no JAX here) ----------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a))


def _leaf(x):
    return torch.tensor(x, dtype=F64, requires_grad=True)


def _e0(n, g, sg, k, v0, **kw):
    return port.dominant_eigh(models.tfim_sharded_operator(n, g, sg,
                                                           device="cpu"),
                              k=k, v0=v0, device="cpu", **kw)[0]


def _tfim(inp, sg, out):
    p = sg.size
    out["matvec"] = models.tfim_sharded_operator(
        6, 0.7, sg, device="cpu").matvec(_t(inp["x6"])).numpy()
    g = _leaf(0.9)
    lam = _e0(8, g, sg, 60, _t(inp["v0_256"]))
    (d1,) = torch.autograd.grad(lam, g)
    out["e0"], out["de0"] = float(lam), float(d1)
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(0.9, dtype=F64),
                              torch.tensor(1.0, dtype=F64))
        lam = _e0(8, dual, sg, 60, _t(inp["v0_256"]))
        out["de0_fwd"] = float(fwAD.unpack_dual(lam).tangent)
    g = _leaf(1.2)
    lam = _e0(6, g, sg, 64, _t(inp["v0_64"]))
    (d1,) = torch.autograd.grad(lam, g, create_graph=True)
    (d2,) = torch.autograd.grad(d1, g)
    out["d2e0"] = float(d2)
    lams, _ = port.dominant_eigh_multi(
        models.tfim_sharded_operator(6, 0.9, sg, device="cpu"), r=3, k=64,
        v0=_t(inp["v0_64"]), device="cpu")
    out["multi_lams"] = lams.numpy()
    g = _leaf(0.9)
    lams, _ = port.dominant_eigh_multi(
        models.tfim_sharded_operator(6, g, sg, device="cpu"), r=2, k=64,
        v0=_t(inp["v0_64"]), device="cpu")
    (dgap,) = torch.autograd.grad(lams[1] - lams[0], g)
    out["dgap"] = float(dgap)
    if p > 1:
        g = _leaf(1.0)
        lam = _e0(12, g, sg, 24, None, restart_cycles=6)
        (d1,) = torch.autograd.grad(lam, g)
        out["restart"] = (float(lam), float(d1))


def _bell(inp, sg, out):
    sop = port.RowShardedBellOperator(_t(inp["bell_vals"]),
                                      _t(inp["bell_cols"]), 64,
                                      symmetric=True, group=sg)
    nb_l = sop.vals.shape[0]
    pert = _t(inp["bell_pert"])[sg.rank * nb_l:(sg.rank + 1) * nb_l]
    v0 = _t(inp["v0_64"])
    t = _leaf(0.0)
    lam, _ = port.dominant_eigh(sop.with_vals(sop.vals + t * pert), k=40,
                                v0=v0, device="cpu")
    (d1,) = torch.autograd.grad(lam, t, create_graph=True)
    (d2,) = torch.autograd.grad(d1, t)
    out["bell_d2_share"] = float(d2)
    with fwAD.dual_level():
        lam, _ = port.dominant_eigh(
            sop.with_vals(fwAD.make_dual(sop.vals, pert)), k=40, v0=v0,
            device="cpu")
        out["bell_dlam_fwd"] = float(fwAD.unpack_dual(lam).tangent)


def _dense(inp, sg, out):
    h0, h1 = _t(inp["h0"]), _t(inp["h1"])
    t = _leaf(0.0)
    lam, _ = port.dominant_eigh(port.RowShardedOperator(h0 + t * h1, sg),
                                k=60, v0=_t(inp["v0_c256"]), device="cpu")
    (dt,) = torch.autograd.grad(lam, t)
    out["cx_lam"], out["cx_dlam_share"] = float(lam), float(dt)
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(0.0, dtype=F64),
                              torch.tensor(1.0, dtype=F64))
        lam, _ = port.dominant_eigh(
            port.RowShardedOperator(h0 + dual * h1, sg), k=60,
            v0=_t(inp["v0_c256"]), device="cpu")
        out["cx_dlam_fwd"] = float(fwAD.unpack_dual(lam).tangent)

    weights = torch.arange(1.0, LOBPCG_R + 1, dtype=F64)
    m = _t(inp["lobpcg_a"]).clone().requires_grad_(True)
    lams, _ = port.dominant_eigh_multi(
        port.RowShardedOperator(m, sg), r=LOBPCG_R, k=400, method="lobpcg",
        tol=1e-11, x0=_t(inp["lobpcg_x0"]), device="cpu")
    (grad,) = torch.autograd.grad((lams * weights).sum(), m)
    out["lobpcg_lams"], out["lobpcg_grad_share"] = (lams.detach().numpy(),
                                                    grad.numpy())

    lo, hi = inp["slice_window"]
    m = _t(inp["slice_a"]).clone().requires_grad_(True)
    lams, _, _ = port.spectral_slice(port.RowShardedOperator(m, sg), lo, hi,
                                     r=SLICE_R, degree=80, maxiter=200,
                                     tol=1e-10, device="cpu")
    inside = (lams >= lo) & (lams <= hi)
    band = torch.where(inside, lams, torch.zeros_like(lams)).sum()
    (grad,) = torch.autograd.grad(band, m)
    out["slice_band"], out["slice_grad_share"] = float(band), grad.numpy()

    a = _t(inp["gen_a"]).clone().requires_grad_(True)
    b = _t(inp["gen_b"]).clone().requires_grad_(True)
    lams, _ = port.dominant_eigh_gen(
        port.RowShardedOperator((a + a.T) / 2, sg),
        port.DenseOperator((b + b.T) / 2), r=GEN_R, maxiter=300, tol=1e-11,
        x0=_t(inp["gen_x0"]), device="cpu")
    loss = (lams * torch.arange(1.0, GEN_R + 1, dtype=F64)).sum()
    ga, gb = torch.autograd.grad(loss, (a, b))
    out["gen_loss"] = float(loss)
    out["gen_grad_a_share"], out["gen_grad_b"] = ga.numpy(), gb.numpy()


def _compute(inp):
    """Every number a rank sends back, and the collectives it ran."""
    sg = port.make_mesh()
    out = {"group": (sg.rank, sg.size, sg.batch_index, sg.n_batch)}
    collectives.reset_collective_counts()
    _tfim(inp, sg, out)
    _bell(inp, sg, out)
    if sg.size in DENSE_SHARDS:
        _dense(inp, sg, out)
    if sg.size > 1:
        # The batch axis: two rows of p/2 shards, each its own coupling.
        row = port.make_mesh(n_shards=sg.size // 2, n_batch=2)
        g = _leaf(BATCH_G[row.batch_index])
        lam = _e0(8, g, row, 60, _t(inp["v0_256"]))
        (d1,) = torch.autograd.grad(lam, g)
        out["batch"] = {"row": (row.batch_index, row.rank, row.size,
                                row.n_batch),
                        "e0": float(lam), "de0": float(d1)}
    out["counts"] = dict(collectives.collective_counts)
    try:
        port.make_mesh(n_shards=sg.size, n_batch=2)
        out["mesh_error"] = None
    except ValueError as exc:
        out["mesh_error"] = str(exc)
    return out


def _rank_results(rank, p, init_method, inp):
    port.init_distributed("gloo", init_method, rank, p)
    try:
        return _compute(inp)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, p, init_method, inp, out_queue):
    torch.set_num_threads(1)
    try:
        out_queue.put((rank, _rank_results(rank, p, init_method, inp), None))
    except Exception:  # reported to the parent, which fails the tests
        out_queue.put((rank, None, traceback.format_exc()))


def _spawn_ranks(p, init_method, inp):
    ctx = multiprocessing.get_context("spawn")
    out_queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, p, init_method, inp, out_queue),
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


# The dense row-sharded solvers (complex, LOBPCG, slice, pencil) run the
# same program at any shard count; the slice's thousands of gathers make
# them the bulk of a rank's time, so they run at p = 1 and 2 only.
DENSE_SHARDS = (1, 2)


def pytest_generate_tests(metafunc):
    if "ranks" in metafunc.fixturenames:
        ps = DENSE_SHARDS if "dense" in metafunc.function.__name__ \
            else (1, 2, 4)
        metafunc.parametrize("ranks", ps, indirect=True, scope="module",
                             ids=[f"p{p}" for p in ps])


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    """(p, [each rank's results])."""
    p = request.param
    init_method = f"file://{tmp_path_factory.mktemp(f'store{p}')}/store"
    if p == 1:
        return p, [_rank_results(0, 1, init_method, _inputs())]
    return p, _spawn_ranks(p, init_method, _inputs())


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    import jax
    jax.clear_caches()


# -- the expected values, from the JAX package --------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tfim(p):
    """One jitted program at p shards: the sharded TFIM's matvec, E0 and
    its derivatives (reverse, forward, second order), the block solver's
    values and gap gradient; a function of the couplings, so the batch
    rows reuse it."""
    import jax
    import jax.numpy as jnp
    from dominantsparseeigenad_tpu import dominant_eigh, dominant_eigh_multi
    from dominantsparseeigenad_tpu.models import tfim_sharded_operator
    from dominantsparseeigenad_tpu.parallel import make_mesh, shard_vector

    mesh = make_mesh(n_shards=p)

    def e0(n, k):
        return lambda g: dominant_eigh(tfim_sharded_operator(n, g, mesh),
                                       k=k, extreme="min")[0]

    def gap(g):
        lams, _ = dominant_eigh_multi(tfim_sharded_operator(6, g, mesh),
                                      r=2, k=64)
        return lams[1] - lams[0]

    @jax.jit
    def refs(x6, g8, g6):
        one = jnp.ones((), jnp.float64)
        val, d1 = jax.value_and_grad(e0(8, 60))(g8)
        return {"matvec": tfim_sharded_operator(6, 0.7, mesh).matvec(x6),
                "e0": val, "de0": d1,
                "de0_fwd": jax.jvp(e0(8, 60), (g8,), (one,))[1],
                "d2e0": jax.grad(jax.grad(e0(6, 64)))(g6),
                "multi_lams": dominant_eigh_multi(
                    tfim_sharded_operator(6, 0.9, mesh), r=3, k=64)[0],
                "dgap": jax.grad(gap)(jnp.float64(0.9))}

    x6 = shard_vector(jnp.asarray(_inputs()["x6"]), mesh)

    def run(g8=0.9, g6=1.2):
        out = refs(x6, jnp.float64(g8), jnp.float64(g6))
        return {k: np.asarray(v) for k, v in out.items()}
    return run


@functools.lru_cache(maxsize=None)
def _jax_bell(p):
    """The sharded Bell panel's d²λ/dt² and forward dλ/dt at p shards
    (``tests/test_sharded_sparse.py:98``), jitted once."""
    import jax
    import jax.numpy as jnp
    from dominantsparseeigenad_tpu import BellOperator, dominant_eigh
    from dominantsparseeigenad_tpu.parallel import (RowShardedBellOperator,
                                                    make_mesh)

    inp = _inputs()
    sop = RowShardedBellOperator.from_bell(
        BellOperator(jnp.asarray(inp["bell_vals"]),
                     jnp.asarray(inp["bell_cols"]), 64, symmetric=True,
                     use_pallas=False), make_mesh(n_shards=p))

    @jax.jit
    def refs(vals, pert):
        def lam(t):
            return dominant_eigh(sop.with_vals(vals + t * pert), k=40,
                                 extreme="min")[0]
        zero, one = jnp.zeros((), jnp.float64), jnp.ones((), jnp.float64)
        return {"bell_d2": jax.grad(jax.grad(lam))(zero),
                "bell_dlam_fwd": jax.jvp(lam, (zero,), (one,))[1]}

    out = refs(jnp.asarray(inp["bell_vals"]), jnp.asarray(inp["bell_pert"]))
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _jax_dense(p):
    """One jitted program at p shards: the complex Hermitian λ and dλ/dt,
    and the LOBPCG, slice and pencil values and gradients through
    ``RowShardedOperator`` (``tests/test_parallel.py:130``, ``:157``,
    ``:185``, ``:237``)."""
    import jax
    import jax.numpy as jnp
    from dominantsparseeigenad_tpu import (DenseOperator, dominant_eigh,
                                           dominant_eigh_gen,
                                           dominant_eigh_multi,
                                           spectral_slice)
    from dominantsparseeigenad_tpu.parallel import (RowShardedOperator,
                                                    make_mesh)

    inp = _inputs()
    mesh = make_mesh(n_shards=p)
    lo, hi = inp["slice_window"]

    def cx_lam(h0, h1):
        return lambda t: dominant_eigh(RowShardedOperator(h0 + t * h1, mesh),
                                       k=60, extreme="min")[0]

    def lobpcg(m):
        lams, _ = dominant_eigh_multi(RowShardedOperator(m, mesh),
                                      r=LOBPCG_R, k=400, method="lobpcg",
                                      tol=1e-11)
        return jnp.sum(lams * jnp.arange(1.0, LOBPCG_R + 1)), lams

    def band(m):
        lams, _, _ = spectral_slice(RowShardedOperator(m, mesh), lo, hi,
                                    r=SLICE_R, degree=80, maxiter=200,
                                    tol=1e-10)
        return jnp.sum(jnp.where((lams >= lo) & (lams <= hi), lams, 0.0))

    def gen(a, b):
        lams, _ = dominant_eigh_gen(RowShardedOperator((a + a.T) / 2, mesh),
                                    DenseOperator((b + b.T) / 2), r=GEN_R,
                                    maxiter=300, tol=1e-11)
        return jnp.sum(lams * jnp.arange(1.0, GEN_R + 1))

    @jax.jit
    def refs(h0, h1, la, sa, ga, gb):
        zero = jnp.zeros((), jnp.float64)
        cx, dcx = jax.value_and_grad(cx_lam(h0, h1))(zero)
        (_, lams), glob = jax.value_and_grad(lobpcg, has_aux=True)(la)
        sband, gslice = jax.value_and_grad(band)(sa)
        gloss, (gga, ggb) = jax.value_and_grad(gen, argnums=(0, 1))(ga, gb)
        return {"cx_lam": cx, "cx_dlam": dcx, "lobpcg_lams": lams,
                "lobpcg_grad": glob, "slice_band": sband,
                "slice_grad": gslice, "gen_loss": gloss, "gen_grad_a": gga,
                "gen_grad_b": ggb}

    out = refs(*(jnp.asarray(inp[k]) for k in (
        "h0", "h1", "lobpcg_a", "slice_a", "gen_a", "gen_b")))
    return {k: np.asarray(v) for k, v in out.items()}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _total(results, key):
    """The ranks' shares of a derivative, summed."""
    return sum(np.asarray(res[key]) for res in results)


# -- the tests ---------------------------------------------------------------

def test_sharded_tfim_matvec_matches_jax(ranks):
    p, results = ranks
    want = _jax_tfim(p)()["matvec"]
    for res in results:
        assert _rel(res["matvec"], want) <= 1e-12


def test_sharded_tfim_matvec_matches_the_unsharded_operator(ranks):
    """The bit order of the shards: the XOR exchange flips the top bits
    of the global index, as ``tfim_operator`` does."""
    _, results = ranks
    x = _t(_inputs()["x6"])
    want = models.tfim_operator(6, 0.7, device="cpu").matvec(x).numpy()
    for res in results:
        assert _rel(res["matvec"], want) <= 1e-14


def test_sharded_tfim_e0_and_gradient_match_jax(ranks):
    """E0 and dE0/dg (n = 8, k = 60), and dE0/dg whole and equal bit for
    bit on every rank: the replicated g is summed over the ranks."""
    p, results = ranks
    want = _jax_tfim(p)()
    for res in results:
        assert _rel(res["e0"], want["e0"]) <= 1e-9
        assert _rel(res["de0"], want["de0"]) <= 1e-7
    assert len({res["de0"] for res in results}) == 1
    exact = models.tfim_exact_de0_dg(8, 0.9)
    assert _rel(results[0]["de0"], exact) <= 1e-7


def test_sharded_tfim_forward_mode_matches_jax_jvp(ranks):
    p, results = ranks
    want = _jax_tfim(p)()["de0_fwd"]
    for res in results:
        assert _rel(res["de0_fwd"], want) <= 1e-7
        assert _rel(res["de0_fwd"], res["de0"]) <= 1e-9


def test_sharded_tfim_second_derivative_matches_jax(ranks):
    """d²E0/dg² (n = 6, k = 64) through ``create_graph``: the double
    backward runs through the exchange and the gather."""
    p, results = ranks
    want = _jax_tfim(p)()["d2e0"]
    for res in results:
        assert _rel(res["d2e0"], want) <= 1e-6
        assert _rel(res["d2e0"], models.tfim_exact_d2e0_dg2(6, 1.2)) <= 1e-6


def test_sharded_tfim_block_solver_matches_jax(ranks):
    p, results = ranks
    want = _jax_tfim(p)()
    for res in results:
        assert _rel(res["multi_lams"], want["multi_lams"]) <= 1e-10
        assert _rel(res["dgap"], want["dgap"]) <= 1e-8


def test_sharded_tfim_restart_cycles_value_and_gradient(ranks):
    """Thick restart (k = 24, 6 cycles) through the sharded TFIM at
    n = 12 against Jordan-Wigner, at the JAX test's bars
    (``tests/test_parallel.py:212``), and against the port's unsharded
    restart (held against JAX in ``tests/test_torch_restart.py``)."""
    p, results = ranks
    if p == 1:
        assert all("restart" not in res for res in results)
        return
    g = torch.tensor(1.0, dtype=F64, requires_grad=True)
    lam, _ = port.dominant_eigh(models.tfim_operator(12, g, device="cpu"),
                                k=24, restart_cycles=6, device="cpu")
    (d1,) = torch.autograd.grad(lam, g)
    exact = (float(models.tfim_exact_e0(12, 1.0, device="cpu")),
             models.tfim_exact_de0_dg(12, 1.0))
    for res in results:
        e0, de0 = res["restart"]
        assert _rel(e0, exact[0]) <= 1e-10
        assert _rel(de0, exact[1]) <= 1e-8
        assert _rel(e0, float(lam)) <= 1e-12
        assert _rel(de0, float(d1)) <= 1e-9


def test_sharded_bell_second_derivative_matches_jax(ranks):
    """d²λ/dt² of A + t B (B a symmetric perturbation on A's pattern)
    through the panels, against JAX's ``grad(grad)`` at the same shard
    count (``tests/test_sharded_sparse.py:98``): the ranks' shares sum to
    it; forward-mode dλ/dt (the tangent panel product) is whole on every
    rank."""
    p, results = ranks
    want = _jax_bell(p)
    assert _rel(_total(results, "bell_d2_share"), want["bell_d2"]) <= 1e-7
    for res in results:
        assert _rel(res["bell_dlam_fwd"], want["bell_dlam_fwd"]) <= 1e-9


def test_dense_complex_hermitian_row_sharded_matches_jax(ranks):
    """λ and dλ/dt of h0 + t h1, complex Hermitian, n = 256, k = 60
    (``tests/test_parallel.py:237``): 1e-10 / 1e-8."""
    p, results = ranks
    want = _jax_dense(p)
    assert _rel(_total(results, "cx_dlam_share"), want["cx_dlam"]) <= 1e-8
    for res in results:
        assert _rel(res["cx_lam"], want["cx_lam"]) <= 1e-10
        assert _rel(res["cx_dlam_fwd"], want["cx_dlam"]) <= 1e-8


def test_dense_lobpcg_through_row_sharded_matches_jax(ranks):
    p, results = ranks
    want = _jax_dense(p)
    for res in results:
        assert _rel(res["lobpcg_lams"], want["lobpcg_lams"]) <= 1e-9
    assert _rel(_total(results, "lobpcg_grad_share"),
                want["lobpcg_grad"]) <= 1e-7


def test_dense_spectral_slice_through_row_sharded_matches_jax(ranks):
    p, results = ranks
    want = _jax_dense(p)
    for res in results:
        assert _rel(res["slice_band"], want["slice_band"]) <= 1e-9
    assert _rel(_total(results, "slice_grad_share"),
                want["slice_grad"]) <= 1e-6


def test_dense_generalized_pencil_through_row_sharded_matches_jax(ranks):
    """The sharded A's gradient comes in the ranks' shares; the replicated
    dense B's is whole on every rank."""
    p, results = ranks
    want = _jax_dense(p)
    assert _rel(_total(results, "gen_grad_a_share"),
                want["gen_grad_a"]) <= 1e-6
    for res in results:
        assert _rel(res["gen_loss"], want["gen_loss"]) <= 1e-9
        assert _rel(res["gen_grad_b"], want["gen_grad_b"]) <= 1e-6


def test_batch_axis_rows_solve_their_own_coupling(ranks):
    """``make_mesh(n_shards=p/2, n_batch=2)``: rank r is in batch row
    r // (p/2) at shard index r % (p/2), as JAX's reshape lays devices
    out; each row's E0 and dE0/dg against JAX's at the same shard count."""
    p, results = ranks
    if p == 1:
        assert all("batch" not in res for res in results)
        return
    shards = p // 2
    run = _jax_tfim(shards)
    for rank, res in enumerate(results):
        row = res["batch"]
        assert row["row"] == (rank // shards, rank % shards, shards, 2)
        want = run(g8=BATCH_G[rank // shards])
        assert _rel(row["e0"], want["e0"]) <= 1e-9
        assert _rel(row["de0"], want["de0"]) <= 1e-7
    e0s = {res["batch"]["row"][0]: res["batch"]["e0"] for res in results}
    assert e0s[0] != e0s[1]


def test_ranks_agree_bitwise_and_run_the_same_collectives(ranks):
    """Lockstep: every rank computes bitwise the same replicated numbers
    and runs the same collectives, double backwards included."""
    p, results = ranks
    first = results[0]
    dense = ("cx_lam", "cx_dlam_fwd", "slice_band", "gen_loss") \
        if p in DENSE_SHARDS else ()
    for key in ("e0", "de0", "de0_fwd", "d2e0", "dgap", "bell_dlam_fwd",
                *dense):
        assert len({res[key] for res in results}) == 1, key
    dense = ("lobpcg_lams", "gen_grad_b") if p in DENSE_SHARDS else ()
    for key in ("matvec", "multi_lams", *dense):
        assert all(np.array_equal(res[key], first[key]) for res in results)
    assert all(res["counts"] == first["counts"] for res in results)
    assert [res["group"] for res in results] == [(r, p, 0, 1)
                                                 for r in range(p)]
    if p > 1:
        assert first["counts"]["ppermute"] > 0
        assert first["counts"]["all_reduce"] > 0


def test_make_mesh_refuses_a_grid_that_is_not_the_group(ranks):
    """As JAX's ``make_mesh``: n_shards x n_batch ranks must be there."""
    p, results = ranks
    for res in results:
        assert res["mesh_error"] == (f"mesh 2x{p} needs {2 * p} ranks, the "
                                     f"group has {p}")


def test_sharded_constructor_checks_without_a_group():
    """The checks that run before any collective, on shard groups that
    stand for p = 3 and p = 4 ranks."""
    sg3 = port.ShardGroup(group=None, rank=0, size=3, backend="gloo")
    sg4 = port.ShardGroup(group=None, rank=1, size=4, backend="gloo")
    with pytest.raises(ValueError, match="must be a power of two"):
        models.tfim_sharded_operator(6, 0.5, sg3, device="cpu")
    with pytest.raises(ValueError, match="cannot split 2\\^1 states over "
                                         "2\\^2 shards"):
        models.tfim_sharded_operator(1, 0.5, sg4, device="cpu")
    op = models.tfim_sharded_operator(6, 0.5, sg4, device="cpu")
    g, diag = op.parameters()
    # The rank keeps its rows of the sharded diagonal, g whole.
    assert g.ndim == 0 and diag.shape == (16,)
    assert torch.equal(diag, models.tfim_zz_diagonal(6, device="cpu")[16:32])
    with pytest.raises(ValueError, match="requires local_rmatvec"):
        port.ShardedMatrixFreeOperator(lambda q, x: x, (), 64, sg4,
                                       symmetric=False)
    with pytest.raises(ValueError, match="not divisible by 4 shards"):
        port.ShardedMatrixFreeOperator(lambda q, x: x, (), 6, sg4,
                                       device="cpu")
    with pytest.raises(ValueError, match="does not split over 4 shards"):
        port.ShardedMatrixFreeOperator(lambda q, x: x, (torch.ones(6),), 64,
                                       sg4, param_specs=("shards",))
    with pytest.raises(ValueError, match="not a permutation"):
        port.ppermute(torch.ones(4), sg4, [(0, 1), (1, 1)])
    with pytest.raises(ValueError, match="outside"):
        port.ppermute(torch.ones(4), sg4, [(0, 4)])
