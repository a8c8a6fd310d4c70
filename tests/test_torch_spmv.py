"""The port's blocked-ELL SpMV (``ops/bell_spmv.py``) against the JAX
package's Pallas kernel in interpret mode and its XLA path.

The CUDA kernel runs only on the card (``chip_smoke.py``); here the
wrapper takes its plain version because the tensors lie on the CPU, and
the kernel's argument checks are exercised on ``meta`` tensors.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dominantsparseeigenad_tpu.ops.pallas_spmv import (
    _bell_spmv_xla, bell_spmv as jax_bell_spmv)
from dominantsparseeigenad_tpu.ops.sparse import BellOperator as JaxBell

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch.convert import _tensor_from_numpy

spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.bell_spmv")

torch.set_num_threads(2)


def _operator(n=256, bs=32, density=0.08, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    op = JaxBell.from_dense((a + a.T) / 2, bs=bs)
    x = rng.standard_normal(n)
    return np.array(op.vals), np.array(op.cols), x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("jax_path", ["pallas_interpret", "xla"])
def test_plain_version_matches_jax_f64(jax_path):
    vals, cols, x = _operator()
    if jax_path == "xla":
        y_jax = _bell_spmv_xla(jnp.asarray(vals), jnp.asarray(cols),
                               jnp.asarray(x))
    else:
        y_jax = jax_bell_spmv(jnp.asarray(vals), jnp.asarray(cols),
                              jnp.asarray(x), True)
    y = spmv._bell_spmv_torch(torch.from_numpy(vals), torch.from_numpy(cols),
                              torch.from_numpy(x))
    # f64 sums of <= 8 blocks x 32 terms in another order.
    assert _rel(y, y_jax) <= 1e-12


def test_wrapper_on_cpu_matches_jax_interpret_f32():
    vals, cols, x = _operator(seed=4)
    vals, x = vals.astype(np.float32), x.astype(np.float32)
    y_jax = jax_bell_spmv(jnp.asarray(vals), jnp.asarray(cols),
                          jnp.asarray(x), True)
    before = dict(spmv.launch_counts)
    y = port.bell_spmv(torch.from_numpy(vals), torch.from_numpy(cols),
                       torch.from_numpy(x))
    assert y.dtype == torch.float32
    # f32 round-off of two summation orders.
    assert _rel(y, y_jax) <= 1e-5
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert spmv.launch_counts == before


def test_bf16_values_match_jax_bf16_path():
    vals, cols, x = _operator(seed=5)
    vals_bf = jnp.asarray(vals, jnp.bfloat16)
    x32 = x.astype(np.float32)
    y_jax = jax_bell_spmv(vals_bf, jnp.asarray(cols), jnp.asarray(x32), True)
    vals_t = _tensor_from_numpy(np.asarray(vals_bf))
    assert vals_t.dtype == torch.bfloat16
    y = port.bell_spmv(vals_t, torch.from_numpy(cols), torch.from_numpy(x32))
    assert y.dtype == torch.float32
    # Both upcast the same bf16 storage and accumulate in f32.
    assert _rel(y, y_jax) <= 1e-5


def test_backward_matches_jax_grad():
    vals, cols, x = _operator(n=64, bs=8, density=0.2, seed=6)
    w = np.random.default_rng(7).standard_normal(x.shape[0])

    def f_jax(v, xx):
        y = jax_bell_spmv(v, jnp.asarray(cols), xx, True)
        return jnp.sum(jnp.sin(y)) + jnp.vdot(jnp.asarray(w), y)

    gv_j, gx_j = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(vals),
                                                   jnp.asarray(x))
    vt = torch.from_numpy(vals).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port.bell_spmv(vt, torch.from_numpy(cols), xt)
    (torch.sin(y).sum() + torch.dot(torch.from_numpy(w), y)).backward()
    # f64, the same bilinear products.
    assert _rel(vt.grad, gv_j) <= 1e-10
    assert _rel(xt.grad, gx_j) <= 1e-10


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


_GOOD = dict(vals=((4, 3, 8, 8), torch.float32), cols=((4, 3), torch.int32),
             x=((32,), torch.float32))


@pytest.mark.parametrize("bad, match", [
    ({"vals": ((4, 3, 8, 8), torch.float64)}, "float32 or bfloat16"),
    ({"vals": ((4, 3, 8, 4), torch.float32)}, "nb, max_blk, bs, bs"),
    ({"cols": ((4, 3), torch.int64)}, "int32"),
    ({"cols": ((4, 2), torch.int32)}, "cols must be"),
    ({"x": ((33,), torch.float32)}, "x must be"),
    ({"x": ((32,), torch.float64)}, "float32 x"),
])
def test_kernel_wrapper_rejects_bad_arguments(bad, match):
    args = {k: _meta(*v) for k, v in {**_GOOD, **bad}.items()}
    with pytest.raises(ValueError, match=match):
        port.bell_spmv(args["vals"], args["cols"], args["x"])


def test_kernel_wrapper_rejects_non_contiguous():
    vals = _meta((4, 3, 8, 8), torch.float32).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        spmv._check_kernel_args(vals, _meta(*_GOOD["cols"]),
                                _meta(*_GOOD["x"]))


@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_non_cpu_tensor_launches_or_raises(vals_dtype):
    """A tensor off the CPU never takes the plain version: valid
    arguments on a non-CUDA device raise instead of falling back."""
    args = {k: _meta(*v) for k, v in _GOOD.items()}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        port.bell_spmv(_meta((4, 3, 8, 8), vals_dtype), args["cols"],
                       args["x"])


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vals, cols, _ = _operator(n=64, bs=8, seed=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.bell_operator_from_numpy(vals, cols, 64, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.random_bell_operator(64, 8, 3, device="cuda")


def test_build_targets_sm90a():
    assert "arch=compute_90a,code=sm_90a" in spmv.NVCC_FLAGS
    assert spmv._SRC.name == "bell_spmv.cu" and spmv._SRC.exists()
    assert spmv._BUILD_DIR.parts[-2:] == ("build", "torch_kernels")


def _routed(case, vals, cols, x, dvals, dx):
    """The wrapper's product under ``case``, and the same quantity from the
    plain version under PyTorch's own autograd."""
    plain = spmv._bell_spmv_torch
    if case == "no_grad":
        with torch.no_grad():
            return port.bell_spmv(vals.requires_grad_(), cols, x), \
                plain(vals.detach(), cols, x)
    if case == "nothing_requires_grad":
        return port.bell_spmv(vals, cols, x), plain(vals, cols, x)
    if case == "reverse":
        got, want = [], []
        for fn, out in ((port.bell_spmv, got), (plain, want)):
            v, xx = vals.clone().requires_grad_(), x.clone().requires_grad_()
            (fn(v, cols, xx) * dx).sum().backward()
            out.extend([v.grad, xx.grad])
        return torch.cat([t.reshape(-1) for t in got]), \
            torch.cat([t.reshape(-1) for t in want])
    if case == "forward_ad":
        import torch.autograd.forward_ad as fwAD
        with fwAD.dual_level():
            y = port.bell_spmv(fwAD.make_dual(vals, dvals), cols,
                               fwAD.make_dual(x, dx))
            tangent = fwAD.unpack_dual(y).tangent
        return tangent, plain(dvals, cols, x) + plain(vals, cols, dx)
    if case == "vmap":
        xs = torch.stack([x, dx, x - dx])
        return torch.func.vmap(lambda z: port.bell_spmv(vals, cols, z))(xs), \
            torch.stack([plain(vals, cols, z) for z in xs])
    assert case == "jvp"
    return torch.func.jvp(lambda v: port.bell_spmv(v, cols, x),
                          (vals,), (dvals,))[1], plain(dvals, cols, x)


@pytest.mark.parametrize("case, through_function", [
    ("no_grad", False), ("nothing_requires_grad", False), ("reverse", True),
    ("forward_ad", True), ("vmap", True), ("jvp", True)])
def test_product_skips_the_function_only_where_nothing_is_differentiated(
        monkeypatch, case, through_function):
    """``_bell_product`` goes straight to the product when no derivative
    can be taken of it, and through ``_BellProduct`` for reverse mode,
    forward mode and ``torch.func``; the value or derivative is the plain
    version's."""
    calls = []

    class Counted(spmv._BellProduct):
        @classmethod
        def apply(cls, *args):
            calls.append(1)
            return super().apply(*args)

    monkeypatch.setattr(spmv, "_BellProduct", Counted)
    vals, cols, x = _operator(n=64, bs=8, seed=11)
    rng = np.random.default_rng(12)
    vals, cols, x = (torch.from_numpy(a) for a in (vals, cols, x))
    dvals = torch.from_numpy(rng.standard_normal(tuple(vals.shape)))
    dx = torch.from_numpy(rng.standard_normal(x.shape[0]))
    got, want = _routed(case, vals, cols, x, dvals, dx)
    assert bool(calls) == through_function
    # f64 sums of <= 8 blocks x 8 terms in another order.
    assert _rel(got.detach(), want.detach()) <= 1e-12
