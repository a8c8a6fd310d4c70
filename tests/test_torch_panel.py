"""The blocked-ELL products on a rectangular row panel (K4a): nb_l
block-rows of an operator against an x of all nb_cols block-columns, as
one rank of the row-sharded operator runs them.  The port's plain
versions and their backward against the JAX package's Pallas kernel in
interpret mode on the same panel (``bell_spmv(op.vals[:rows],
op.cols[:rows], x, True)``, as ``tests/test_sparse.py`` runs it) and its
XLA path.

The CUDA kernels run only on the card (``chip_smoke.py``, phase
``panel``); here the wrappers take their plain versions because the
tensors lie on the CPU, and the kernel wrappers' panel handling is
exercised on ``meta`` tensors.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.ops.pallas_spmv import (
    _bell_spmv_xla, bell_spmm as jax_bell_spmm, bell_spmv as jax_bell_spmv)
from dominantsparseeigenad_tpu.ops.sparse import random_bell_operator

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch.convert import _tensor_from_numpy

spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.bell_spmv")

torch.set_num_threads(2)

N, BS, BPR = 256, 16, 5          # nb_cols = 16 block-columns
ROWS = [4, 8]                    # nb_l: the panels of p = 4 and p = 2


@functools.lru_cache(maxsize=None)
def _operator(dtype=np.float64):
    op = random_bell_operator(jax.random.PRNGKey(3), n=N, bs=BS,
                              blocks_per_row=BPR, dtype=jnp.float64,
                              use_pallas=False)
    return np.asarray(op.vals).astype(dtype), np.array(op.cols)


def _x(r=None, dtype=np.float64, seed=0):
    shape = (N,) if r is None else (N, r)
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _port_product(vals, cols, x):
    """The public product the row-sharded operator calls on its panel."""
    fn = port.bell_spmv if x.ndim == 1 else port.bell_spmm
    return fn(vals, cols, x)


# Jitted once: one compile per shape, not an eager interpret-mode run.
_JAX_SPMV = jax.jit(jax_bell_spmv, static_argnums=(3,))
_JAX_SPMM = jax.jit(jax_bell_spmm, static_argnums=(3,))
_JAX_XLA = jax.jit(_bell_spmv_xla)


def _jax_product(vals, cols, x):
    fn = _JAX_SPMV if x.ndim == 1 else _JAX_SPMM
    return fn(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x), True)


@pytest.mark.parametrize("r", [None, 1, 3, 8, 16], ids=lambda r: f"r{r}")
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("jax_path", ["pallas_interpret", "xla"])
def test_plain_panel_matches_jax_f64(jax_path, rows, r):
    vals, cols = _operator()
    vals, cols, x = vals[:rows], cols[:rows], _x(r)
    plain = spmv._bell_spmv_torch if r is None else spmv._bell_spmm_torch
    y = plain(torch.from_numpy(vals), torch.from_numpy(cols),
              torch.from_numpy(x))
    assert tuple(y.shape) == (rows * BS,) + (() if r is None else (r,))
    if jax_path == "xla":
        y_jax = _JAX_XLA(jnp.asarray(vals), jnp.asarray(cols),
                               jnp.asarray(x))
    else:
        y_jax = _jax_product(vals, cols, x)
    # f64 sums of 5 blocks x 16 terms in another order.
    assert _rel(y, y_jax) <= 1e-12


@pytest.mark.parametrize("r", [None, 3], ids=lambda r: f"r{r}")
@pytest.mark.parametrize("rows", ROWS)
def test_wrapper_panel_on_cpu_matches_jax_interpret_f32(rows, r):
    vals, cols = _operator(np.float32)
    vals, cols, x = vals[:rows], cols[:rows], _x(r, np.float32, seed=1)
    y_jax = _jax_product(vals, cols, x)
    before = (dict(spmv.launch_counts), dict(spmv.panel_launch_counts))
    y = _port_product(torch.from_numpy(vals), torch.from_numpy(cols),
                      torch.from_numpy(x))
    assert y.dtype == torch.float32
    # f32 round-off of two summation orders.
    assert _rel(y, y_jax) <= 1e-5
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert (spmv.launch_counts, spmv.panel_launch_counts) == before


@pytest.mark.parametrize("r", [None, 8], ids=lambda r: f"r{r}")
def test_bf16_panel_matches_jax_bf16_path(r):
    vals, cols = _operator(np.float32)
    vals_bf = jnp.asarray(vals[:4], jnp.bfloat16)
    x = _x(r, np.float32, seed=2)
    y_jax = _jax_product(vals_bf, cols[:4], x)
    y = _port_product(_tensor_from_numpy(np.asarray(vals_bf)),
                      torch.from_numpy(cols[:4]), torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape[0] == 4 * BS
    # Both upcast the same bf16 storage and accumulate in f32.
    assert _rel(y, y_jax) <= 1e-5


@pytest.mark.parametrize("r", [None, 3], ids=lambda r: f"r{r}")
def test_panel_backward_matches_jax_grad(r):
    vals, cols = _operator()
    vals, cols, x = vals[:4], cols[:4], _x(r, seed=3)
    w = np.random.default_rng(4).standard_normal((4 * BS,) + x.shape[1:])

    def f_jax(v, xx):
        y = _jax_product(v, cols, xx)
        return jnp.sum(jnp.sin(y)) + jnp.vdot(jnp.asarray(w), y)

    gv_j, gx_j = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(vals),
                                                   jnp.asarray(x))
    vt = torch.from_numpy(vals).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = _port_product(vt, torch.from_numpy(cols), xt)
    (torch.sin(y).sum() + (torch.from_numpy(w) * y).sum()).backward()
    # f64, the same bilinear products; x's gradient spans all nb_cols
    # block-columns, the panel's rows only some of them.
    assert xt.grad.shape == xt.shape
    assert _rel(vt.grad, gv_j) <= 1e-10
    assert _rel(xt.grad, gx_j) <= 1e-10


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("x_shape", [(48,), (48, 3), (16,), (16, 8)],
                         ids=["spmv_wide", "spmm_wide", "spmv_narrow",
                              "spmm_narrow"])
def test_kernel_output_takes_the_panel_rows(x_shape):
    """The kernels' output has the panel's rows, not x's: 4 block-rows of
    bs = 8 against x of 6 or 2 block-columns."""
    vals = _meta((4, 3, 8, 8))
    y = spmv._output(vals, _meta(x_shape))
    assert tuple(y.shape) == (32,) + tuple(x_shape[1:])
    assert y.dtype == torch.float32


def test_panel_launches_are_counted_apart():
    vals = _meta((4, 3, 8, 8))
    saved = (dict(spmv.launch_counts), dict(spmv.panel_launch_counts))
    try:
        spmv.reset_launch_counts()
        spmv._count_launch("bell_spmv_f32", vals, _meta((48,)))
        spmv._count_launch("bell_spmm_f32", vals, _meta((48, 3)))
        spmv._count_launch("bell_spmv_f32", vals, _meta((32,)))
        assert spmv.panel_launch_counts == {
            "bell_spmv_f32": 1, "bell_spmv_bf16vals": 0, "bell_spmv_c64": 0,
            "bell_spmm_f32": 1, "bell_spmm_bf16vals": 0, "bell_spmm_c64": 0}
        assert spmv.launch_counts["bell_spmv_f32"] == 1
        spmv.reset_launch_counts()
        assert not any(spmv.panel_launch_counts.values())
    finally:
        spmv.launch_counts.update(saved[0])
        spmv.panel_launch_counts.update(saved[1])


@pytest.mark.parametrize("x_shape, match", [
    ((44,), "x must be"), ((0,), "x must be"), ((44, 3), "X must be"),
    ((48, 0), "r >= 1")])
def test_kernel_wrapper_rejects_bad_panel_x(x_shape, match):
    """x of any positive multiple of bs rows is a panel's; others raise."""
    with pytest.raises(ValueError, match=match):
        _port_product(_meta((4, 3, 8, 8)), _meta((4, 3), torch.int32),
                      _meta(x_shape))


@pytest.mark.parametrize("x_shape", [(48,), (48, 3), (16,)])
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_valid_panel_off_the_cpu_launches_or_raises(x_shape, vals_dtype):
    """A valid panel on a non-CUDA device raises instead of taking the
    plain version."""
    with pytest.raises(ValueError, match="CUDA or CPU"):
        _port_product(_meta((4, 3, 8, 8), vals_dtype),
                      _meta((4, 3), torch.int32), _meta(x_shape))
