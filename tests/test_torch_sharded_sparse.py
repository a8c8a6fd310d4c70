"""The port's row-sharded tier (``parallel/``) against the JAX package's
``RowShardedBellOperator``/``RowShardedOperator`` on the 8-virtual-device
CPU mesh (f64 unless stated).

The port runs one process per rank on a gloo group: for p = 2 and 4 the
ranks are spawned once per world size by a module-scoped fixture; p = 1
runs in this process.  Every rank builds its operator from the same
global numpy arrays, computes everything below, and sends it back; the
tests compare with JAX, computed in this process.  The rank processes
import no JAX: this module imports it only inside the functions that
compute the expected values.

A complex Hermitian blocked-ELL operator (complex128, ``symmetric=False``)
runs through the same ranks: its panels' products, λ and v, and the
gradient, against the JAX ``RowShardedBellOperator`` on the same values
(PyTorch's gradient of a complex leaf is the conjugate of JAX's).
"""

import functools
import multiprocessing
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dominantsparseeigenad_tpu_torch as port

torch.set_num_threads(2)

RANK_TIMEOUT_S = 120        # a rank's whole run; each queue read and join
K_EIG = 64                  # Lanczos steps: n, so the pairs are exact
R_MULTI, K_MULTI = 3, 300   # LOBPCG block and iteration cap


# -- inputs, made in this process -------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs():
    import jax
    import jax.numpy as jnp
    from dominantsparseeigenad_tpu import BellOperator, random_bell_operator

    def bell(key, n, bpr, dtype=jnp.float64, vals_dtype=None):
        op = random_bell_operator(jax.random.PRNGKey(key), n=n, bs=8,
                                  blocks_per_row=bpr, dtype=dtype,
                                  vals_dtype=vals_dtype, use_pallas=False)
        return np.asarray(op.vals), np.asarray(op.cols), n

    rng = np.random.default_rng(3)
    # Non-symmetric: block-diagonal plus one block-band at offset +2.
    a = np.zeros((64, 64))
    for i in range(8):
        for j in (i, (i + 2) % 8):
            a[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = \
                rng.standard_normal((8, 8))
    nonsym = BellOperator.from_dense(jnp.asarray(a), bs=8, use_pallas=False)
    eig = bell(5, 64, 3)
    dense = np.asarray(BellOperator(jnp.asarray(eig[0]), jnp.asarray(eig[1]),
                                    64, use_pallas=False).to_dense())
    # Complex Hermitian, block-sparse (8 x 8 blocks of 8, about a third
    # kept, the pattern symmetric).
    rng = np.random.default_rng(29)
    keep = rng.random((8, 8)) < 0.3
    keep = keep | keep.T | np.eye(8, dtype=bool)
    c = (rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))) \
        * np.kron(keep, np.ones((8, 8)))
    cherm = BellOperator.from_dense(jnp.asarray((c + c.conj().T) / 2), bs=8,
                                    use_pallas=False)

    def cvec(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    cx, cX, cw = cvec(64), cvec(64, 3), cvec(64)
    rng = np.random.default_rng(0)
    return {
        "sym": bell(5, 128, 5),
        "nonsym": (np.asarray(nonsym.vals), np.asarray(nonsym.cols), 64),
        "bf16": bell(11, 128, 5, jnp.float32, jnp.bfloat16),
        "eig": eig,
        "multi": bell(21, 128, 5),
        "dense": dense,
        "x": rng.standard_normal(128), "X": rng.standard_normal((128, 4)),
        "x64": rng.standard_normal(64), "w64": rng.standard_normal(64),
        "x32": rng.standard_normal(128).astype(np.float32),
        "v0": rng.standard_normal(64),
        "x0": np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                           (128, R_MULTI), jnp.float64)),
        "cherm": (np.asarray(cherm.vals), np.asarray(cherm.cols), 64),
        "cx": cx, "cX": cX, "cw": cw,
        "cv0": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64,),
                                            jnp.complex128)),
    }


# -- what every rank computes (no JAX here) ----------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a))


def _sharded(spec, symmetric=True):
    vals, cols, n = spec
    return port.row_sharded_bell_operator_from_numpy(
        vals, cols, n, symmetric=symmetric, device="cpu")


def _leaf(op):
    """The operator with a leaf copy of its panel to differentiate into."""
    panel = op.parameters()[0].detach().clone().requires_grad_(True)
    return panel, op.with_vals(panel)


def _compute(inp):
    out = {}
    sop = _sharded(inp["sym"])
    x, X = _t(inp["x"]), _t(inp["X"])
    out["matvec"] = sop.matvec(x).numpy()
    out["rmatvec_sym"] = sop.rmatvec(x).numpy()
    out["matmat"] = sop.matmat(X).numpy()

    nop = _sharded(inp["nonsym"], symmetric=False)
    x64 = _t(inp["x64"])
    out["nonsym_matvec"] = nop.matvec(x64).numpy()
    out["nonsym_rmatvec"] = nop.rmatvec(x64).numpy()
    out["nonsym_rmatmat"] = nop.rmatmat(torch.stack([x64, 2 * x64],
                                                    1)).numpy()
    # A loss of y = A x, differentiated into the panel and into x.
    panel, op = _leaf(nop)
    xg = x64.clone().requires_grad_(True)
    y = op.matvec(xg)
    (torch.sin(y).sum() + torch.dot(_t(inp["w64"]), y)).backward()
    out["matvec_grad_panel"] = panel.grad.numpy()
    out["matvec_grad_x"] = xg.grad.numpy()

    bop = _sharded(inp["bf16"])
    out["bf16_dtypes"] = (str(bop.vals.dtype), str(bop.dtype))
    nb_l = bop.vals.shape[0]
    rows = slice(bop.group.rank * nb_l, (bop.group.rank + 1) * nb_l)
    out["bf16_bits_kept"] = bool(np.array_equal(
        bop.vals.view(torch.int16).numpy(),
        inp["bf16"][0][rows].view(np.int16)))
    out["bf16_matvec"] = bop.matvec(_t(inp["x32"])).numpy()

    panel, op = _leaf(_sharded(inp["eig"]))
    lam, v = port.dominant_eigh(op, k=K_EIG, tol=1e-12, v0=_t(inp["v0"]),
                                device="cpu")
    (lam + (v ** 4).sum()).backward()
    out["lam"], out["v"] = float(lam.detach()), v.detach().numpy()
    out["eig_grad_panel"] = panel.grad.numpy()

    lams, V = port.dominant_eigh_multi(_sharded(inp["multi"]), r=R_MULTI,
                                       k=K_MULTI, method="lobpcg", tol=1e-9,
                                       x0=_t(inp["x0"]), device="cpu")
    out["multi_lams"], out["multi_V"] = lams.numpy(), V.numpy()

    # The global matrix as a leaf: the gradient flows back through the
    # copy of the rank's rows into those rows of it.
    a = _t(inp["dense"]).clone().requires_grad_(True)
    dop = port.RowShardedOperator(a)
    out["dense_matvec"] = dop.matvec(x64).detach().numpy()
    out["dense_rmatvec"] = dop.rmatvec(x64).detach().numpy()
    lam_d, _ = port.dominant_eigh(dop, k=K_EIG, v0=_t(inp["v0"]),
                                  device="cpu")
    lam_d.backward()
    out["dense_lam"], out["dense_grad"] = float(lam_d), a.grad.numpy()

    # Complex values, square panels of a Hermitian operator.
    cop = _sharded(inp["cherm"], symmetric=False)
    out["cx_dtypes"] = (str(cop.vals.dtype), str(cop.dtype))
    cx = _t(inp["cx"])
    out["cx_matvec"] = cop.matvec(cx).numpy()
    out["cx_matmat"] = cop.matmat(_t(inp["cX"])).numpy()
    out["cx_rmatvec"] = cop.rmatvec(cx).numpy()
    panel, op = _leaf(cop)
    lam, v = port.dominant_eigh(op, k=K_EIG, tol=1e-12, v0=_t(inp["cv0"]),
                                device="cpu")
    (lam + torch.vdot(_t(inp["cw"]), v).abs() ** 2).backward()
    out["cx_lam"], out["cx_v"] = float(lam.detach()), v.detach().numpy()
    out["cx_grad_panel"] = panel.grad.numpy()

    out["ring_error"] = _error(lambda: port.RowShardedBellOperator(
        _t(inp["sym"][0]), _t(inp["sym"][1]), 128, mode="ring"))
    out["odd_error"] = _error(lambda: port.RowShardedBellOperator(
        torch.zeros(3, 1, 8, 8), torch.zeros(3, 1, dtype=torch.int32), 24))
    return out


def _error(build):
    """What ``build()`` raised, or None."""
    try:
        build()
    except (ValueError, NotImplementedError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


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


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"p{p}")
def ranks(request, tmp_path_factory):
    """(p, [each rank's results])."""
    p = request.param
    init_method = f"file://{tmp_path_factory.mktemp(f'store{p}')}/store"
    if p == 1:
        return p, [_rank_results(0, 1, init_method, _inputs())]
    return p, _spawn_ranks(p, init_method, _inputs())


# -- the expected values, from the JAX package --------------------------------

@functools.lru_cache(maxsize=None)
def _jax_sharded(p):
    import jax
    import jax.numpy as jnp
    from dominantsparseeigenad_tpu import (BellOperator, dominant_eigh,
                                           dominant_eigh_multi)
    from dominantsparseeigenad_tpu.parallel import (
        RowShardedBellOperator, RowShardedOperator, make_mesh, shard_vector)

    inp = _inputs()
    mesh = make_mesh(n_shards=p)

    def sharded(spec, symmetric=True):
        vals, cols, n = spec
        return RowShardedBellOperator.from_bell(
            BellOperator(jnp.asarray(vals), jnp.asarray(cols), n,
                         symmetric=symmetric, use_pallas=False), mesh)

    def vec(a):
        return shard_vector(jnp.asarray(a), mesh)

    sop, nop, bop = (sharded(inp["sym"]),
                     sharded(inp["nonsym"], symmetric=False),
                     sharded(inp["bf16"]))
    cop = sharded(inp["cherm"], symmetric=False)
    eop, dop = sharded(inp["eig"]), RowShardedOperator(
        jnp.asarray(inp["dense"]), mesh)
    x, x64, x32 = vec(inp["x"]), vec(inp["x64"]), vec(inp["x32"])
    rows = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("shards", None))
    X = jax.device_put(jnp.asarray(inp["X"]), rows)
    cx, cX = vec(inp["cx"]), jax.device_put(jnp.asarray(inp["cX"]), rows)

    def bilinear(vals, xx):
        y = nop.with_vals(vals).matvec(xx)
        return jnp.sum(jnp.sin(y)) + jnp.vdot(jnp.asarray(inp["w64"]), y)

    def products():
        # One compiled program for every product, to keep the test fast.
        g_vals, g_x = jax.grad(bilinear, argnums=(0, 1))(nop.vals, x64)
        return {"matvec": sop.matvec(x), "rmatvec_sym": sop.rmatvec(x),
                "matmat": sop.matmat(X), "nonsym_matvec": nop.matvec(x64),
                "nonsym_rmatvec": nop.rmatvec(x64),
                "matvec_grad_vals": g_vals, "matvec_grad_x": g_x,
                "bf16_matvec": bop.matvec(x32),
                "dense_matvec": dop.matvec(x64),
                "dense_rmatvec": dop.rmatvec(x64),
                "cx_matvec": cop.matvec(cx), "cx_matmat": cop.matmat(cX),
                "cx_rmatvec": cop.rmatvec(cx)}

    def eig_loss(vals):
        lam, v = dominant_eigh(eop.with_vals(vals), k=K_EIG, tol=1e-12)
        return lam + jnp.sum(v ** 4), (lam, v)

    def cx_loss(vals):
        lam, v = dominant_eigh(cop.with_vals(vals), k=K_EIG, tol=1e-12)
        return lam + jnp.abs(jnp.vdot(jnp.asarray(inp["cw"]), v)) ** 2, \
            (lam, v)

    def dense_lam(a):
        return dominant_eigh(RowShardedOperator(a, mesh), k=K_EIG)[0]

    out = jax.jit(products)()
    out["eig_grad"], (out["lam"], out["v"]) = jax.jit(
        jax.grad(eig_loss, has_aux=True))(eop.vals)
    out["cx_grad"], (out["cx_lam"], out["cx_v"]) = jax.jit(
        jax.grad(cx_loss, has_aux=True))(cop.vals)
    out["multi_lams"], out["multi_V"] = dominant_eigh_multi(
        sharded(inp["multi"]), r=R_MULTI, k=K_MULTI, method="lobpcg",
        tol=1e-9)
    out["dense_lam"], out["dense_grad"] = jax.jit(jax.value_and_grad(
        dense_lam))(jnp.asarray(inp["dense"]))
    return {k: np.asarray(v) for k, v in out.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _each_rank(results, key):
    return [res[key] for res in results]


# -- the tests ---------------------------------------------------------------

def test_matvec_matmat_match_jax(ranks):
    p, results = ranks
    want = _jax_sharded(p)
    for res in results:
        # f64 sums in another order.
        assert _rel(res["matvec"], want["matvec"]) <= 1e-12
        assert _rel(res["rmatvec_sym"], want["rmatvec_sym"]) <= 1e-12
        assert _rel(res["matmat"], want["matmat"]) <= 1e-12


def test_nonsymmetric_rmatvec_matches_jax(ranks):
    p, results = ranks
    want = _jax_sharded(p)
    for res in results:
        assert _rel(res["nonsym_matvec"], want["nonsym_matvec"]) <= 1e-12
        assert _rel(res["nonsym_rmatvec"], want["nonsym_rmatvec"]) <= 1e-12
        # The block transpose: columns x and 2x.
        assert _rel(res["nonsym_rmatmat"],
                    np.stack([want["nonsym_rmatvec"],
                              2 * want["nonsym_rmatvec"]], 1)) <= 1e-12


def test_matvec_gradients_match_jax(ranks):
    """Through the gather (own rows back) and the replicated input (summed
    over ranks): a gradient off by a factor p, or missing other ranks'
    rows, fails here."""
    p, results = ranks
    want = _jax_sharded(p)
    grad_vals = np.concatenate(_each_rank(results, "matvec_grad_panel"))
    assert _rel(grad_vals, want["matvec_grad_vals"]) <= 1e-10
    for res in results:
        assert _rel(res["matvec_grad_x"], want["matvec_grad_x"]) <= 1e-10


def test_bf16_values_match_jax(ranks):
    p, results = ranks
    want = _jax_sharded(p)
    for res in results:
        assert res["bf16_dtypes"] == ("torch.bfloat16", "torch.float32")
        assert res["bf16_bits_kept"]
        # The same bf16 storage upcast, f32 sums in another order.
        assert _rel(res["bf16_matvec"], want["bf16_matvec"]) <= 1e-5


def test_dominant_eigh_matches_jax(ranks):
    p, results = ranks
    want = _jax_sharded(p)
    for res in results:
        # Exact f64 Lanczos (k = n) on both sides; v after the sign gauge.
        assert abs(res["lam"] - want["lam"]) <= 1e-10 * abs(want["lam"])
        np.testing.assert_allclose(res["v"], want["v"], atol=1e-8)


def test_eigh_gradient_matches_jax(ranks):
    """∂(λ + Σ v⁴)/∂vals: the rank panels, concatenated in rank order,
    against ``jax.grad`` with respect to the global values."""
    p, results = ranks
    want = _jax_sharded(p)
    grad = np.concatenate(_each_rank(results, "eig_grad_panel"))
    # Both CGs stop at a 1e-12 residual, times the deflated system's κ.
    assert _rel(grad, want["eig_grad"]) <= 1e-6


def test_dominant_eigh_multi_lobpcg_matches_jax(ranks):
    p, results = ranks
    want = _jax_sharded(p)
    for res in results:
        # Converged f64 LOBPCG from the same start block.
        np.testing.assert_allclose(res["multi_lams"], want["multi_lams"],
                                   rtol=1e-9)
        np.testing.assert_allclose(res["multi_V"], want["multi_V"],
                                   atol=1e-6)


def test_ranks_agree_bitwise(ranks):
    """Lockstep: every rank computes bitwise the same eigenpairs."""
    _, results = ranks
    first = results[0]
    for res in results[1:]:
        assert res["lam"] == first["lam"]
        assert np.array_equal(res["v"], first["v"])
        assert np.array_equal(res["multi_lams"], first["multi_lams"])
        assert np.array_equal(res["matvec"], first["matvec"])


def test_dense_row_sharded_operator_matches_jax(ranks):
    p, results = ranks
    want = _jax_sharded(p)
    for res in results:
        assert _rel(res["dense_matvec"], want["dense_matvec"]) <= 1e-12
        assert _rel(res["dense_rmatvec"], want["dense_rmatvec"]) <= 1e-12
        assert abs(res["dense_lam"] - want["dense_lam"]) <= \
            1e-10 * abs(want["dense_lam"])
    # ∂λ/∂a = v vᵀ: each rank's gradient lands in its own rows of the
    # global matrix, and only there.
    n_l = 64 // p
    for rank, res in enumerate(results):
        own = slice(rank * n_l, (rank + 1) * n_l)
        assert _rel(res["dense_grad"][own], want["dense_grad"][own]) <= 1e-8
        assert not np.delete(res["dense_grad"], own, axis=0).any()


def test_complex_bell_matches_jax(ranks):
    """Complex128 panels of a Hermitian operator built with
    ``symmetric=False`` (the values carried across by
    ``row_sharded_bell_operator_from_numpy`` in their dtype): A x, A X
    and the bilinear A^T x; λ and v (pivot gauge); and
    ∂(λ + |<w, v>|²)/∂vals, the rank panels concatenated, against
    conj(jax.grad)."""
    p, results = ranks
    want = _jax_sharded(p)
    for res in results:
        assert res["cx_dtypes"] == ("torch.complex128", "torch.complex128")
        for key in ("cx_matvec", "cx_matmat", "cx_rmatvec"):
            err = np.abs(res[key] - want[key]).max()
            assert err <= 1e-12 * np.abs(want[key]).max(), key
        assert abs(res["cx_lam"] - want["cx_lam"]) <= \
            1e-10 * abs(want["cx_lam"])
        assert np.abs(res["cx_v"] - want["cx_v"]).max() <= 1e-8
    grad = np.concatenate(_each_rank(results, "cx_grad_panel"))
    assert np.abs(grad - np.conj(want["cx_grad"])).max() <= \
        1e-6 * np.abs(want["cx_grad"]).max()


def test_construction_errors(ranks):
    p, results = ranks
    for res in results:
        # Ring mode runs over sharded vectors; over the default replicated
        # ones it is refused, naming why.
        assert res["ring_error"].startswith(
            "ValueError: mode='ring' needs vectors='sharded'")
        # 3 block-rows split over p ranks.
        assert res["odd_error"] == (None if p == 1 else
                                    f"ValueError: 3 block-rows not divisible "
                                    f"by {p} shards")


def test_constructor_checks_without_a_group():
    vals = torch.zeros(4, 2, 8, 8)
    cols = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="square"):
        port.RowShardedBellOperator(torch.zeros(4, 2, 8, 4), cols, 32)
    with pytest.raises(ValueError, match="!= n"):
        port.RowShardedBellOperator(vals, cols, 40)
    with pytest.raises(ValueError, match="vectors='sharded'"):
        port.RowShardedOperator(torch.eye(8), mode="ring")
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="init_distributed"):
            port.RowShardedBellOperator(vals, cols, 32)
        # The batch axis needs the process group its rows split.
        with pytest.raises(RuntimeError, match="init_distributed"):
            port.make_mesh(n_batch=2)
