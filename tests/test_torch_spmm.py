"""The port's blocked-ELL SpMM (``ops/bell_spmv.py``: ``bell_spmm``) and
``BellOperator.matmat``/``rmatmat`` against the JAX package's Pallas
kernel in interpret mode and its XLA path.

The CUDA kernel runs only on the card (``chip_smoke.py``); here the
wrapper takes its plain version because the tensors lie on the CPU, and
the kernel's argument checks are exercised on ``meta`` tensors.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.ops.pallas_spmv import (
    _bell_spmv_xla, bell_spmm as jax_bell_spmm)
from dominantsparseeigenad_tpu.ops.sparse import BellOperator as JaxBell
from dominantsparseeigenad_tpu.ops.sparse import random_bell_operator

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch.convert import _tensor_from_numpy

spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.bell_spmv")

torch.set_num_threads(2)

# 13: ragged inside one pass of the kernel's wide body; 16: the KPM probe
# block; 40: past one 32-column pass.
RS = [1, 3, 8, 13, 16, 40]

# Each JAX reference jitted once (one compile per shape, not an eager
# interpret-mode run per call).
_jax_spmm = jax.jit(jax_bell_spmm, static_argnums=(3, 4))
_jax_xla = jax.jit(_bell_spmv_xla)


@functools.lru_cache(maxsize=None)
def _banded(r):
    """A config-#5-like banded operator (so JAX detects a slot plan) and
    an (N, r) block, n = 256, bs = 32, 5 blocks per row."""
    op = random_bell_operator(jax.random.PRNGKey(17), n=256, bs=32,
                              blocks_per_row=5, dtype=jnp.float64,
                              use_pallas=False)
    X = np.random.default_rng(r).standard_normal((256, r))
    return np.array(op.vals), np.array(op.cols), X, op.slot_plan


def _irregular(n=128, bs=16, density=0.1, seed=3, r=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    op = JaxBell.from_dense(a, bs=bs)
    return np.array(op.vals), np.array(op.cols), rng.standard_normal((n, r))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _plain(vals, cols, X):
    return spmv._bell_spmm_torch(torch.from_numpy(vals),
                                 torch.from_numpy(cols), torch.from_numpy(X))


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("jax_path", ["interpret_plan", "interpret_gather",
                                      "xla"])
def test_plain_version_matches_jax_f64(jax_path, r):
    vals, cols, X, plan = _banded(r)
    assert plan is not None
    args = (jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(X))
    if jax_path == "xla":
        y_jax = _jax_xla(*args)
    else:
        y_jax = _jax_spmm(*args, True,
                          plan if jax_path == "interpret_plan" else None)
    y = _plain(vals, cols, X)
    assert y.shape == (256, r)
    # f64 sums of 5 blocks x 32 terms in another order.
    assert _rel(y, y_jax) <= 1e-12


def test_plain_version_matches_jax_on_an_irregular_pattern():
    vals, cols, X = _irregular()
    y_jax = jax_bell_spmm(jnp.asarray(vals), jnp.asarray(cols),
                          jnp.asarray(X), True, None)
    assert _rel(_plain(vals, cols, X), y_jax) <= 1e-12


@pytest.mark.parametrize("r", RS)
def test_wrapper_on_cpu_matches_jax_interpret_f32(r):
    vals, cols, X, plan = _banded(r)
    vals, X = vals.astype(np.float32), X.astype(np.float32)
    y_jax = _jax_spmm(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(X),
                      True, plan)
    before = dict(spmv.launch_counts)
    y = port.bell_spmm(torch.from_numpy(vals), torch.from_numpy(cols),
                       torch.from_numpy(X))
    assert y.dtype == torch.float32
    # f32 round-off of two summation orders.
    assert _rel(y, y_jax) <= 1e-5
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert spmv.launch_counts == before


@pytest.mark.parametrize("r", [3, 8])
def test_bf16_values_match_jax_bf16_path(r):
    vals, cols, X, plan = _banded(r)
    vals_bf = jnp.asarray(vals, jnp.bfloat16)
    X32 = X.astype(np.float32)
    y_jax = jax_bell_spmm(vals_bf, jnp.asarray(cols), jnp.asarray(X32), True,
                          plan)
    vals_t = _tensor_from_numpy(np.asarray(vals_bf))
    y = port.bell_spmm(vals_t, torch.from_numpy(cols), torch.from_numpy(X32))
    assert y.dtype == torch.float32
    # Both upcast the same bf16 storage and accumulate in f32.
    assert _rel(y, y_jax) <= 1e-5


@pytest.mark.parametrize("r", RS)
def test_backward_matches_jax_grad(r):
    vals, cols, X = _irregular(n=64, bs=8, density=0.2, seed=6, r=r)
    w = np.random.default_rng(7).standard_normal(X.shape)

    def f_jax(v, xx):
        y = jax_bell_spmm(v, jnp.asarray(cols), xx, True, None)
        return jnp.sum(jnp.sin(y)) + jnp.vdot(jnp.asarray(w), y)

    gv_j, gx_j = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(vals),
                                                   jnp.asarray(X))
    vt = torch.from_numpy(vals).requires_grad_(True)
    xt = torch.from_numpy(X).requires_grad_(True)
    y = port.bell_spmm(vt, torch.from_numpy(cols), xt)
    (torch.sin(y).sum() + (torch.from_numpy(w) * y).sum()).backward()
    # f64, the same bilinear products.
    assert _rel(vt.grad, gv_j) <= 1e-10
    assert _rel(xt.grad, gx_j) <= 1e-10


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("r", RS)
def test_operator_matmat_rmatmat_match_jax(symmetric, r):
    vals, cols, X = _irregular(seed=8, r=r)
    if symmetric:
        vals, cols, X, _ = _banded(r)
    n = X.shape[0]
    op_j = JaxBell(jnp.asarray(vals), jnp.asarray(cols), n,
                   symmetric=symmetric, use_pallas=False)
    op = port.bell_operator_from_numpy(vals, cols, n, symmetric=symmetric,
                                       device="cpu")
    Xt = torch.from_numpy(X)
    assert _rel(op.matmat(Xt), op_j.matmat(jnp.asarray(X))) <= 1e-12
    assert _rel(op.rmatmat(Xt), op_j.rmatmat(jnp.asarray(X))) <= 1e-12
    # The column loop of the base class gives the same block.
    base = port.LinearOperator.rmatmat(op, Xt)
    assert _rel(op.rmatmat(Xt), base) <= 1e-12


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


_GOOD = dict(vals=((4, 3, 8, 8), torch.float32), cols=((4, 3), torch.int32),
             X=((32, 3), torch.float32))


@pytest.mark.parametrize("bad, match", [
    ({"vals": ((4, 3, 8, 8), torch.float64)}, "float32 or bfloat16"),
    ({"vals": ((4, 3, 8, 4), torch.float32)}, "nb, max_blk, bs, bs"),
    ({"cols": ((4, 3), torch.int64)}, "int32"),
    ({"cols": ((4, 2), torch.int32)}, "cols must be"),
    ({"X": ((33, 3), torch.float32)}, "X must be"),
    ({"X": ((32, 0), torch.float32)}, "r >= 1"),
    ({"X": ((32, 3), torch.float64)}, "float32 x"),
    ({"vals": ((1, 1, 1032, 1032), torch.float32),
      "cols": ((1, 1), torch.int32), "X": ((1032, 2), torch.float32)},
     "bs <= 1024"),
])
def test_kernel_wrapper_rejects_bad_arguments(bad, match):
    args = {k: _meta(*v) for k, v in {**_GOOD, **bad}.items()}
    with pytest.raises(ValueError, match=match):
        port.bell_spmm(args["vals"], args["cols"], args["X"])


def test_kernel_wrapper_rejects_non_contiguous_and_wrong_rank():
    X = _meta((3, 32), torch.float32).T
    with pytest.raises(ValueError, match="contiguous"):
        spmv._check_kernel_args(_meta(*_GOOD["vals"]), _meta(*_GOOD["cols"]),
                                X)
    with pytest.raises(ValueError, match=r"\(N, r\)"):
        port.bell_spmm(_meta(*_GOOD["vals"]), _meta(*_GOOD["cols"]),
                       _meta((32,), torch.float32))
    with pytest.raises(ValueError, match=r"\(N,\)"):
        port.bell_spmv(_meta(*_GOOD["vals"]), _meta(*_GOOD["cols"]),
                       _meta(*_GOOD["X"]))


@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_non_cpu_tensor_launches_or_raises(vals_dtype):
    """A tensor off the CPU never takes the plain version: valid
    arguments on a non-CUDA device raise instead of falling back."""
    args = {k: _meta(*v) for k, v in _GOOD.items()}
    with pytest.raises(ValueError, match="bell_spmm runs on CUDA or CPU"):
        port.bell_spmm(_meta((4, 3, 8, 8), vals_dtype), args["cols"],
                       args["X"])


def test_build_hashes_every_source(tmp_path, monkeypatch):
    assert [p.name for p in spmv._sources()] == ["bell_spmm.cu",
                                                 "bell_spmv.cu"]
    assert "arch=compute_90a,code=sm_90a" in spmv.NVCC_FLAGS
    assert set(spmv.launch_counts) == {
        "bell_spmv_f32", "bell_spmv_bf16vals", "bell_spmv_c64",
        "bell_spmm_f32", "bell_spmm_bf16vals", "bell_spmm_c64",
        "bell_spmv_banded_f32", "bell_spmv_banded_bf16vals",
        "bell_spmv_banded_c64", "bell_spmm_banded_f32",
        "bell_spmm_banded_bf16vals", "bell_spmm_banded_c64"}
    # An edit to either source names another library, so it is rebuilt.
    for src in spmv._sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(spmv, "_CSRC", tmp_path)
    paths = {spmv._library_path()}
    for name in ("bell_spmm.cu", "bell_spmv.cu"):
        with open(tmp_path / name, "a") as f:
            f.write("// edited\n")
        paths.add(spmv._library_path())
    assert len(paths) == 3
