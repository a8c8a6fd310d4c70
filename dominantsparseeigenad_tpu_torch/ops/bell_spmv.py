"""Blocked-ELL SpMV: the hand-written Hopper kernel and its plain version.

Counterpart of ``dominantsparseeigenad_tpu/ops/pallas_spmv.py``, for its
SpMV entry ``bell_spmv``:

    y[i*bs + a] = sum_j vals[i, j, a, b] @ x[cols[i, j]*bs + b]

``vals`` is (nb, max_blk, bs, bs) in float32/float64, or bfloat16
storage that is upcast at the product; ``cols`` is (nb, max_blk) int32;
``x`` and ``y`` are (nb*bs,) in the compute dtype.

* On a CUDA tensor :func:`bell_spmv` launches the CUDA kernel in
  ``csrc/bell_spmv.cu`` (float32 ``x``; float32 or bfloat16 values), or
  raises.  There is no fallback.
* On a CPU tensor it takes :func:`_bell_spmv_torch`, the plain PyTorch
  version, which is also what the kernel is checked against on the card.

The kernel runs forward only.  Gradients come from the plain math in
:class:`_BellSpmv`'s backward, as the JAX kernel's JVP goes through XLA.

The kernel is compiled on first use with ``nvcc`` into a shared library
with a plain C interface under ``build/torch_kernels/`` of the checkout
and loaded with ``ctypes``; the library name carries a hash of the source,
so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "bell_spmv.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launches of each kernel, counted by the wrapper where it launches.
launch_counts = {"bell_spmv_f32": 0, "bell_spmv_bf16vals": 0}

# What the last build did: seconds spent in nvcc (0.0 when the library was
# already built) and nvcc's output (register and shared-memory use).
build_info = {"seconds": None, "log": "", "path": None}

_lib = None


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernel is built on first "
                       "use and needs the CUDA toolkit")


def build_library() -> Path:
    """Compile ``csrc/bell_spmv.cu`` unless this source is already built."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libbell_spmv_{digest}.so"
    build_info["path"] = str(out)
    if out.exists():
        build_info["seconds"] = 0.0
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{build_info['log']}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        for name in launch_counts:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bell_spmv_error_string.argtypes = [ctypes.c_int]
        lib.bell_spmv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_kernel_args(vals, cols, x) -> str:
    """Validate what the CUDA kernel takes; return its name."""
    if vals.ndim != 4 or vals.shape[2] != vals.shape[3]:
        raise ValueError(f"vals must be (nb, max_blk, bs, bs), got "
                         f"{tuple(vals.shape)}")
    nb, max_blk, bs, _ = vals.shape
    if nb == 0 or max_blk == 0 or bs == 0:
        raise ValueError(f"empty vals {tuple(vals.shape)}")
    if tuple(cols.shape) != (nb, max_blk):
        raise ValueError(f"cols must be {(nb, max_blk)}, got "
                         f"{tuple(cols.shape)}")
    if x.shape != (nb * bs,):
        raise ValueError(f"x must be ({nb * bs},), got {tuple(x.shape)}")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    if x.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 x, got {x.dtype}")
    if vals.dtype == torch.float32:
        name = "bell_spmv_f32"
    elif vals.dtype == torch.bfloat16:
        name = "bell_spmv_bf16vals"
    else:
        raise ValueError(f"the kernel takes float32 or bfloat16 values, "
                         f"got {vals.dtype}")
    for t, what in ((vals, "vals"), (cols, "cols"), (x, "x")):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{what} on {t.device}, x on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"bell_spmv runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return name


def _bell_spmv_cuda(vals, cols, x):
    name = _check_kernel_args(vals, cols, x)
    nb, max_blk, bs, _ = vals.shape
    vec = 16 // vals.element_size()
    if bs % vec or any(t.data_ptr() % 16 for t in (vals, x)):
        vec = 1
    y = torch.empty_like(x)
    err = getattr(_library(), name)(
        vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), nb,
        max_blk, bs, vec, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = _library().bell_spmv_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (error {err})")
    launch_counts[name] += 1
    return y


def _bell_spmv_torch(vals, cols, x):
    """Plain PyTorch version: a batched block GEMV over the gathered x
    segments, values upcast to ``x``'s dtype at the product."""
    nb, max_blk, bs, _ = vals.shape
    xg = x.reshape(-1, bs)[cols.long()]                 # (nb, max_blk, bs)
    y = torch.matmul(vals.to(x.dtype), xg.unsqueeze(-1)).squeeze(-1)
    return y.sum(dim=1).reshape(-1)


def _bell_rmatvec_torch(vals, cols, y, n_cols):
    """``A^T y`` in plain PyTorch: each block's transpose product,
    scattered onto its block-column (``n_cols`` block-columns)."""
    nb, max_blk, bs, _ = vals.shape
    contrib = torch.matmul(y.reshape(nb, 1, 1, bs),
                           vals.to(y.dtype)).squeeze(-2)   # (nb, max_blk, bs)
    out = torch.zeros(n_cols, bs, dtype=y.dtype, device=y.device)
    return out.index_add(0, cols.reshape(-1).long(),
                         contrib.reshape(-1, bs)).reshape(-1)


class _BellSpmv(torch.autograd.Function):
    """Kernel forward; backward in plain PyTorch (the map is bilinear in
    ``vals`` and ``x``)."""

    @staticmethod
    def forward(ctx, vals, cols, x):
        ctx.save_for_backward(vals, cols, x)
        if x.device.type == "cpu":
            return _bell_spmv_torch(vals, cols, x)
        return _bell_spmv_cuda(vals, cols, x)

    @staticmethod
    def backward(ctx, y_bar):
        vals, cols, x = ctx.saved_tensors
        nb, max_blk, bs, _ = vals.shape
        yb = y_bar.reshape(nb, bs)
        vals_bar = x_bar = None
        if ctx.needs_input_grad[0]:
            # vals_bar[i, j, a, b] = y_bar[i*bs + a] * x[cols[i, j]*bs + b]
            xg = x.reshape(-1, bs)[cols.long()]
            vals_bar = (yb[:, None, :, None] * xg[:, :, None, :]).to(
                vals.dtype)
        if ctx.needs_input_grad[2]:
            x_bar = _bell_rmatvec_torch(vals, cols, y_bar, x.numel() // bs)
        return vals_bar, None, x_bar


def bell_spmv(vals, cols, x):
    """``y = A x`` for a blocked-ELL matrix (see the module docstring)."""
    return _BellSpmv.apply(vals, cols, x)
