"""K4b, the banded slot plan: the port's ``detect_slot_plan``, its plain
banded products, the drop rule and ``BellOperator(slot_plan=...)``
against the JAX package's ``detect_slot_plan`` and its banded Pallas
kernel in interpret mode (CPU, f64).

The banded CUDA kernels run only on the card (``chip_smoke.py``, where
they are also held bit for bit against the gather kernels); here the
products take their plain versions because the tensors lie on the CPU,
and the wrappers' argument checks are exercised on ``meta`` tensors.
The main shape has nb = 24 block-rows, so the JAX kernel runs three row
groups of 8 and its ring-wrapped slabs, with the x padding, are
exercised.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu import (dominant_eigh as jax_dominant_eigh,
                                       dominant_eigh_multi as jax_multi)
from dominantsparseeigenad_tpu.ops.pallas_spmv import (
    _bell_spmv_xla, _pick_row_group, bell_spmm as jax_bell_spmm,
    bell_spmv as jax_bell_spmv, detect_slot_plan as jax_detect)
from dominantsparseeigenad_tpu.ops.sparse import (
    BellOperator as JaxBell, random_bell_operator as jax_random_bell)

import dominantsparseeigenad_tpu_torch as port

spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.bell_spmv")

torch.set_num_threads(2)

N, BS, BPR = 192, 8, 5


@functools.lru_cache(maxsize=None)
def _jax_operator(n=N, bs=BS, bpr=BPR, seed=13):
    op = jax_random_bell(jax.random.PRNGKey(seed), n=n, bs=bs,
                         blocks_per_row=bpr, dtype=jnp.float64,
                         use_pallas=False)
    return np.array(op.vals), np.array(op.cols), op.slot_plan


def _port_operator(**kw):
    vals, cols, _ = _jax_operator(**kw)
    n = vals.shape[0] * vals.shape[2]
    return port.bell_operator_from_numpy(vals, cols, n, symmetric=True,
                                         device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _rhs(n, r, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) if r is None \
        else rng.standard_normal((n, r))


def _mixed_pattern(nb=24, bs=8, seed=5):
    """A hand-made pattern: a band at offset 0, a gather slot, a band at
    offset 5, and a padding slot (zero blocks pointing at column 0)."""
    rng = np.random.default_rng(seed)
    i = np.arange(nb)
    cols = np.stack([i, rng.permutation(nb), (i + 5) % nb,
                     np.zeros(nb, np.int64)], axis=1).astype(np.int32)
    vals = rng.standard_normal((nb, 4, bs, bs))
    vals[:, 3] = 0.0
    return vals, cols


@pytest.mark.parametrize("shape", [(192, 8, 5), (256, 32, 5), (512, 32, 7)],
                         ids=lambda s: "n{}_bs{}_bpr{}".format(*s))
def test_detect_matches_jax_on_random_bell(shape):
    n, bs, bpr = shape
    vals, cols, jax_plan = _jax_operator(n, bs, bpr)
    nb = n // bs
    plan = port.detect_slot_plan(cols, nb)
    assert plan == jax_plan == jax_detect(cols, nb)
    assert len(plan) == bpr and all(kind == "band" for kind, _ in plan)
    # The operator binds it from its own cols (a host copy of a tensor).
    assert _port_operator(n=n, bs=bs, bpr=bpr).slot_plan == jax_plan
    assert port.detect_slot_plan(torch.from_numpy(cols), nb) == jax_plan
    # The port's own random_bell_operator makes JAX's cols, all bands.
    assert port.random_bell_operator(n, bs, bpr, device="cpu").slot_plan \
        == jax_plan


def test_detect_matches_jax_on_an_irregular_pattern():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((128, 128)) * (rng.random((128, 128)) < 0.2)
    a = (a + a.T) / 2
    jax_op = JaxBell.from_dense(a, bs=16, use_pallas=False)
    op = port.BellOperator.from_dense(a, bs=16, device="cpu")
    assert op.slot_plan == jax_op.slot_plan
    assert op.slot_plan is None or any(kind == "gather"
                                       for kind, _ in op.slot_plan)


def test_detect_matches_jax_on_a_mixed_plan():
    vals, cols = _mixed_pattern()
    expect = (("band", 0), ("gather", 0), ("band", 5), ("gather", 0))
    assert port.detect_slot_plan(cols, 24) == jax_detect(cols, 24) == expect
    op = port.BellOperator(torch.from_numpy(vals), torch.from_numpy(cols),
                           24 * 8)
    assert op.slot_plan == expect
    x = _rhs(24 * 8, None, 6)
    y_j = jax_bell_spmv(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x),
                        True, expect)
    # f64 sums of 4 blocks x 8 terms in another order.
    assert _rel(op.matvec(torch.from_numpy(x)), y_j) <= 1e-12
    y = spmv._bell_spmv_banded_torch(torch.from_numpy(vals),
                                     torch.from_numpy(cols),
                                     torch.from_numpy(x), expect)
    assert _rel(y, y_j) <= 1e-12


def test_no_band_gives_no_plan():
    cols = np.zeros((6, 2), np.int32)
    cols[:, 1] = [3, 1, 4, 1, 5, 0]
    assert port.detect_slot_plan(cols, 6) is None
    assert jax_detect(cols, 6) is None


def test_jax_runs_its_banded_kernel_at_the_main_shape():
    """The JAX side of these tests is the slab-DMA kernel, not the XLA
    fallback: three row groups, and rows whose band wraps the ring."""
    _, cols, plan = _jax_operator()
    nb = cols.shape[0]
    assert _pick_row_group(nb, BS, 8) == 8 and nb // 8 == 3
    # Rows i >= nb - o of a band at offset o > 0 wrap the ring.
    assert any(o > 0 for _, o in plan)


# Jitted once: one compile per shape, not an eager interpret-mode run.
_jax_spmv_jit = jax.jit(jax_bell_spmv, static_argnums=(3, 4))
_jax_spmm_jit = jax.jit(jax_bell_spmm, static_argnums=(3, 4))


@pytest.mark.parametrize("r", [None, 1, 3, 8, 13, 16, 40],
                         ids=["spmv", "r1", "r3", "r8", "r13", "r16", "r40"])
def test_plain_banded_matches_jax_interpret(r):
    vals, cols, plan = _jax_operator()
    x = _rhs(N, r, 7)
    jfun = _jax_spmv_jit if r is None else _jax_spmm_jit
    y_j = jfun(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x), True,
               plan)
    pfun = spmv._bell_spmv_banded_torch if r is None \
        else spmv._bell_spmm_banded_torch
    y = pfun(torch.from_numpy(vals), torch.from_numpy(cols),
             torch.from_numpy(x), plan)
    # f64 sums of 5 blocks x 8 terms in another order.
    assert _rel(y, y_j) <= 1e-12
    # The public functions with the plan take the same path on the CPU.
    pub = port.bell_spmv if r is None else port.bell_spmm
    assert _rel(pub(torch.from_numpy(vals), torch.from_numpy(cols),
                    torch.from_numpy(x), plan), y_j) <= 1e-12


@pytest.mark.parametrize("r", [None, 3], ids=["spmv", "r3"])
def test_banded_columns_equal_cols_for_a_matching_plan(r):
    vals, cols, plan = _jax_operator()
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    assert torch.equal(spmv._band_columns(c, plan), c.long())
    x = torch.from_numpy(_rhs(N, r, 8))
    plain = spmv._bell_spmv_torch if r is None else spmv._bell_spmm_torch
    banded = spmv._bell_spmv_banded_torch if r is None \
        else spmv._bell_spmm_banded_torch
    # The same columns, so the same sums in the same order.
    assert torch.equal(banded(v, c, x, plan), plain(v, c, x))


@pytest.mark.parametrize("which", ["offsets", "length"])
def test_mismatched_plan_gives_the_gather_result(which):
    """Mirrors test_sparse.py::test_bell_mismatched_slot_plan_falls_back:
    a plan that does not match cols is dropped, never applied."""
    vals, cols, plan = _jax_operator(seed=23)
    nb = cols.shape[0]
    bad = tuple(("band", (o + 1) % nb) for _, o in plan) \
        if which == "offsets" else plan[:-1]
    x = _rhs(N, None, 24)
    oracle = np.asarray(_bell_spmv_xla(jnp.asarray(vals), jnp.asarray(cols),
                                       jnp.asarray(x)))
    y_j = jax_bell_spmv(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x),
                        True, bad)
    v, c, xt = (torch.from_numpy(t) for t in (vals, cols, x))
    assert spmv._bare_plan(v, c, xt, bad) is None
    y = port.bell_spmv(v, c, xt, bad)
    assert _rel(y, oracle) <= 1e-12 and _rel(y, y_j) <= 1e-12
    # Bound to an operator, the same plan is dropped once, at binding.
    op = port.BellOperator(v, c, N, symmetric=True, slot_plan=bad)
    assert op.slot_plan is None
    assert _rel(op.matvec(xt), oracle) <= 1e-12


@pytest.mark.parametrize("r", [None, 3], ids=["spmv", "r3"])
def test_plan_on_a_row_panel_gives_the_gather_result(r):
    vals, cols, plan = _jax_operator(seed=23)
    rows = cols.shape[0] // 2
    x = _rhs(N, r, 25)
    jfun = jax_bell_spmv if r is None else jax_bell_spmm
    y_j = jfun(jnp.asarray(vals[:rows]), jnp.asarray(cols[:rows]),
               jnp.asarray(x), True, plan)
    ref = _bell_spmv_xla(jnp.asarray(vals[:rows]), jnp.asarray(cols[:rows]),
                         jnp.asarray(x))
    v, c = torch.from_numpy(vals[:rows]), torch.from_numpy(cols[:rows])
    xt = torch.from_numpy(x)
    assert spmv._bare_plan(v, c, xt, plan) is None
    pub = port.bell_spmv if r is None else port.bell_spmm
    y = pub(v, c, xt, plan)
    assert _rel(y, ref) <= 1e-12 and _rel(y, y_j) <= 1e-12


def test_operator_plan_argument():
    vals, cols, plan = _jax_operator()
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    assert port.BellOperator(v, c, N).slot_plan == plan             # auto
    assert port.BellOperator(v, c, N, slot_plan=None).slot_plan is None
    # An explicit plan that matches is kept, as a tuple of tuples.
    assert port.BellOperator(v, c, N, slot_plan=[list(p) for p in plan]) \
        .slot_plan == plan
    with pytest.raises(ValueError, match="slot_plan"):
        port.BellOperator(v, c, N, slot_plan="bands")


def test_with_vals_and_astype_vals_keep_the_plan():
    op = _port_operator()
    assert op.with_vals(op.vals * 2).slot_plan == op.slot_plan
    bf = op.astype_vals(torch.bfloat16)
    assert bf.slot_plan == op.slot_plan and bf.compute_dtype == torch.float64
    twin = port.BellOperator(op.vals, op.cols, N, slot_plan=None)
    assert twin.with_vals(op.vals).slot_plan is None
    with pytest.raises(ValueError, match="vals must be"):
        op.with_vals(op.vals[:2])


@pytest.mark.parametrize("kind", ["matvec", "matmat"])
def test_operator_products_match_the_jax_banded_operator(kind):
    vals, cols, plan = _jax_operator()
    jop = JaxBell(jnp.asarray(vals), jnp.asarray(cols), N, symmetric=True,
                  use_pallas=True, interpret=True)
    assert jop.slot_plan == plan
    op = _port_operator()
    x = _rhs(N, None if kind == "matvec" else 4, 9)
    y_j = getattr(jop, kind)(jnp.asarray(x))
    assert _rel(getattr(op, kind)(torch.from_numpy(x)), y_j) <= 1e-12


@functools.lru_cache(maxsize=None)
def _jax_banded_solves():
    vals, cols, _ = _jax_operator(n=256, bs=32, bpr=5, seed=3)
    jop = JaxBell(jnp.asarray(vals), jnp.asarray(cols), 256, symmetric=True,
                  use_pallas=True, interpret=True)
    out = {e: jax_dominant_eigh(jop, k=64, extreme=e) for e in ("min", "max")}
    out["lanczos"] = jax_multi(jop, r=3, k=64)
    # LOBPCG up to 200 iterations: at a cap of 50 the JAX solve stops
    # short of 1e-10 on its third pair (λ 8e-9 off the dense value).
    out["lobpcg"] = jax_multi(jop, r=3, k=200, method="lobpcg", tol=1e-10)
    return {k: tuple(np.asarray(t) for t in v) for k, v in out.items()}


@pytest.mark.parametrize("extreme", ["min", "max"])
def test_dominant_eigh_matches_the_jax_banded_operator(extreme):
    lam_j, v_j = _jax_banded_solves()[extreme]
    op = _port_operator(n=256, bs=32, bpr=5, seed=3)
    assert op.slot_plan is not None
    lam, v = port.dominant_eigh(op, k=64, extreme=extreme, device="cpu")
    # Converged f64 Lanczos on both sides; v after the sign gauge.
    assert abs(float(lam) - float(lam_j)) <= 1e-10 * abs(float(lam_j))
    assert np.abs(v.detach().numpy() - v_j).max() <= 1e-6


@pytest.mark.parametrize("method", ["lanczos", "lobpcg"])
def test_dominant_eigh_multi_matches_the_jax_banded_operator(method):
    lams_j, _ = _jax_banded_solves()[method]
    op = _port_operator(n=256, bs=32, bpr=5, seed=3)
    kw = dict(k=64) if method == "lanczos" else dict(k=200, tol=1e-10)
    lams, _ = port.dominant_eigh_multi(op, r=3, method=method, device="cpu",
                                       **kw)
    assert _rel(lams.detach(), lams_j) <= 1e-9


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad, match", [
    ("length", "slot plan has 2 entries"),
    ("panel", "square operator"),
    ("device", "CUDA or CPU"),
])
def test_banded_wrapper_rejects_bad_arguments(bad, match):
    vals = _meta((4, 3, 8, 8), torch.float32)
    cols = _meta((4, 3), torch.int32)
    x = _meta((32,), torch.float32)
    plan = (("band", 0), ("band", 1), ("gather", 0))
    if bad == "length":
        plan = plan[:2]
    elif bad == "panel":
        x = _meta((64,), torch.float32)
    with pytest.raises(ValueError, match=match):
        spmv._bell_spmv_banded_cuda(vals, cols, x, plan)
    if bad != "device":
        with pytest.raises(ValueError, match=match):
            spmv._bell_spmm_banded_cuda(vals, cols, x[:, None].expand(
                x.shape[0], 2).contiguous(), plan)


def test_band_offsets_are_built_once_per_plan():
    plan = (("band", 0), ("gather", 0), ("band", 29))
    off = spmv._band_offsets(plan, 24, torch.device("cpu"))
    assert off.dtype == torch.int32 and off.tolist() == [0, -1, 5]
    assert spmv._band_offsets(plan, 24, torch.device("cpu")) is off


def test_banded_kernels_have_their_own_counts():
    assert {"bell_spmv_banded_f32", "bell_spmv_banded_bf16vals",
            "bell_spmm_banded_f32", "bell_spmm_banded_bf16vals"} \
        <= set(spmv.launch_counts)
    # A banded kernel runs on a square operator only: never on a panel.
    assert not any("banded" in name for name in spmv.panel_launch_counts)
