"""Blocked-ELL SpMV and SpMM: the hand-written Hopper kernels and their
plain versions.

Counterpart of ``dominantsparseeigenad_tpu/ops/pallas_spmv.py``, for its
entries ``bell_spmv`` and ``bell_spmm``:

    y[i*bs + a]    = sum_j vals[i, j, a, b] @ x[cols[i, j]*bs + b]
    Y[i*bs + a, c] = sum_j vals[i, j, a, b] @ X[cols[i, j]*bs + b, c]

``vals`` is (nb, max_blk, bs, bs) in float32/float64, complex64/
complex128, or bfloat16 storage that is upcast at the product; ``cols``
is (nb, max_blk) int32 in [0, nb_cols); ``x`` is (nb_cols*bs,) and ``y``
(nb*bs,), ``X`` (nb_cols*bs, r) and ``Y`` (nb*bs, r) row-major, in the
compute dtype.
A square operator has nb_cols = nb; a rectangular row panel (one rank's
block-rows of a row-sharded operator, ``parallel/sharded_sparse.py``)
has nb block-rows against an x of any nb_cols block-columns.  Nothing
here checks the range of ``cols`` (that would read it back from the
card): the operators check it once, when they are built.

* On a CUDA tensor :func:`bell_spmv` launches the CUDA kernel in
  ``csrc/bell_spmv.cu`` and :func:`bell_spmm` the one in
  ``csrc/bell_spmm.cu`` (float32 vectors with float32 or bfloat16
  values; complex64 vectors with complex64 values, K5 and K6; any
  r >= 1: for real values r <= 4 in one body, wider blocks in another
  that streams the values once for up to 32 columns, which complex
  values take at every r), or raise.  There is no fallback.
* Real (float32 or bfloat16) values with a complex64 vector run the
  real kernels on ``torch.view_as_real``: x (N,) as an (N, 2) block, X
  (N, r) as (N, 2r), so one SpMM (K3, or K4b under a plan) gives the real
  and imaginary parts at once, exactly as two real products would.
* On a CPU tensor they take :func:`_bell_spmv_torch` /
  :func:`_bell_spmm_torch`, the plain PyTorch versions, which are also
  what the kernels are checked against on the card.

The banded slot plan (K4b), JAX's ``slot_plan``: :func:`detect_slot_plan`
marks slot j a band ``("band", o)`` when ``cols[:, j] == (arange(nb) + o)
% nb``, else ``("gather", 0)``.  With a plan, each kernel runs in its
banded mode: a band slot takes its column from ``(i + o) % nb`` and never
reads ``cols``; the loop order is the gather mode's, so the two give the
same y bit for bit.  The plan is dropped, and the gather kernel runs, as
JAX drops it: when its length is not ``max_blk``, on a row panel (x not
nb*bs long), or when it does not match ``cols``.  A bare call with a plan
checks the match on a host copy of ``cols``; ``BellOperator`` checks it
once, when it binds the plan, and its products never read ``cols`` back.

The kernels run forward only.  Gradients come from the plain math in the
backward of :class:`_BellProduct`, as the JAX kernels' JVPs go through
XLA; its forward-mode ``jvp`` runs the kernels on the tangents (the map is
bilinear), to any order, and its ``vmap`` turns a batch of vectors into
one SpMM, as JAX's ``bell_spmm`` is the batched ``bell_spmv``.  Where no
derivative can be taken, the products skip the Function
(:func:`_bell_product`).

Complex values: the product is holomorphic in ``vals`` and ``x``, so the
``jvp`` is the same bilinear rule.  PyTorch's backward takes the
conjugate cotangent ∂L/∂ȳ and returns ``x̄ = A^H ȳ`` and ``vals̄ = ȳ x^H``
(the JAX cotangents' conjugates); :func:`_bell_rmatmat_torch` stays the
bilinear ``A^T``, which an operator's ``rmatvec`` is.

The kernels are compiled on first use with ``nvcc``, one process per
source started together, and linked into one shared library with a plain
C interface under ``build/torch_kernels/`` of the checkout, loaded with
``ctypes``; the library name carries a hash of every source, so an edited
source is rebuilt.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .operators import _per_lane, nestable_jvp, transforms_active

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SRC = _CSRC / "bell_spmv.cu"          # the SpMV kernel's source
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launches of each kernel, counted by the wrapper where it launches: on a
# square operator (x as long as y) in launch_counts, on a rectangular row
# panel (x longer or shorter than y) in panel_launch_counts, a ring
# bucket's in ring_launch_counts.  The banded kernels run on square
# operators only.
_SPMV_NAMES = ("bell_spmv_f32", "bell_spmv_bf16vals", "bell_spmv_c64")
_SPMM_NAMES = ("bell_spmm_f32", "bell_spmm_bf16vals", "bell_spmm_c64")
_BANDED_SPMV_NAMES = ("bell_spmv_banded_f32", "bell_spmv_banded_bf16vals",
                      "bell_spmv_banded_c64")
_BANDED_SPMM_NAMES = ("bell_spmm_banded_f32", "bell_spmm_banded_bf16vals",
                      "bell_spmm_banded_c64")
launch_counts = dict.fromkeys(_SPMV_NAMES + _SPMM_NAMES + _BANDED_SPMV_NAMES
                              + _BANDED_SPMM_NAMES, 0)
panel_launch_counts = dict.fromkeys(_SPMV_NAMES + _SPMM_NAMES, 0)
# The ring mode's bucket products (``parallel/sharded_sparse.py``): the
# gather kernels on one offset's bucket against the segment in hand,
# counted here and in neither count above (see ring_launches).
ring_launch_counts = dict.fromkeys(_SPMV_NAMES + _SPMM_NAMES, 0)
_ring_depth = 0

# What the last build did: seconds spent in nvcc (0.0 when the library was
# already built) and nvcc's output (register and shared-memory use).
build_info = {"seconds": None, "log": "", "path": None}

_lib = None


def reset_launch_counts():
    for counts in (launch_counts, panel_launch_counts, ring_launch_counts):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def ring_launches():
    """Count the launches made inside the block (a ring bucket's product,
    with its forward-mode tangents, which run at the call) in
    :data:`ring_launch_counts`."""
    global _ring_depth
    _ring_depth += 1
    try:
        yield
    finally:
        _ring_depth -= 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernel is built on first "
                       "use and needs the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _library_path() -> Path:
    """The library's path, named by a hash of the flags and of every
    source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + src.read_bytes())
    return _BUILD_DIR / f"libbell_kernels_{h.hexdigest()[:12]}.so"


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` unless these sources are already built:
    one nvcc per source, all started together, then one link."""
    sources = _sources()
    out = _library_path()
    build_info["path"] = str(out)
    if out.exists():
        build_info["seconds"] = 0.0
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [out.with_suffix(f".{src.stem}.{os.getpid()}.o")
            for src in sources]
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        logs.append(f"== {src.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_info['log']}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        # (vals, cols[, band_off], x, y, nb, mb, bs[, r], vec, device,
        # stream)
        for names, n_ptr, n_int in ((_SPMV_NAMES, 4, 4), (_SPMM_NAMES, 4, 5),
                                    (_BANDED_SPMV_NAMES, 5, 4),
                                    (_BANDED_SPMM_NAMES, 5, 5)):
            for name in names:
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong]
                               + [ctypes.c_int] * n_int + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
        lib.bell_spmv_error_string.argtypes = [ctypes.c_int]
        lib.bell_spmv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# The SpMM kernel's narrow body (r <= 4) stages X segments in shared
# memory, 4 columns of about bs floats per slot in at most 100 KiB: a
# bound on bs that leaves room for several slots a tile.  The wide body
# (r > 4) stages 128-row, 128-byte slices of a slot, whatever bs is.
SPMM_MAX_BS = 1024

# The value dtypes each vector dtype's kernels take, by entry suffix.
_KERNEL_VALS = {torch.float32: {torch.float32: "f32",
                                torch.bfloat16: "bf16vals"},
                torch.complex64: {torch.complex64: "c64",
                                  torch.float32: "f32",
                                  torch.bfloat16: "bf16vals"}}


def _dtype_suffix(vals, x) -> str:
    """The kernel entry's dtype suffix for ``vals`` and ``x``, or raise
    naming both dtypes.  Real values with a complex64 x name the real
    entry, which runs on ``view_as_real(x)``."""
    takes = _KERNEL_VALS.get(x.dtype)
    if takes is None:
        raise ValueError(f"the kernel takes float32 x (float32 or bfloat16 "
                         f"values) or complex64 x (complex64, float32 or "
                         f"bfloat16 values), got {x.dtype} x with "
                         f"{vals.dtype} values")
    if vals.dtype not in takes:
        raise ValueError(
            f"the kernel takes float32 or bfloat16 values with a {x.dtype} x"
            + (" (complex64 values too)" if x.dtype.is_complex
               else " (complex64 values take a complex64 x)")
            + f", got {vals.dtype} values")
    return takes[vals.dtype]


def _check_kernel_args(vals, cols, x, plan=None) -> str:
    """Validate what the CUDA kernels take; return the kernel's name.

    ``x`` of shape (N,) goes to the SpMV kernel, (N, r) to the SpMM one;
    N may be any positive multiple of bs (a row panel's x), or exactly
    nb*bs for the banded kernels (``plan`` given, one entry per slot).
    Real values with a complex64 x name the real SpMM, which runs on the
    (re, im) columns.
    """
    kind = "bell_spmm" if x.ndim == 2 else "bell_spmv"
    if plan is not None:
        kind += "_banded"
    if vals.ndim != 4 or vals.shape[2] != vals.shape[3]:
        raise ValueError(f"vals must be (nb, max_blk, bs, bs), got "
                         f"{tuple(vals.shape)}")
    nb, max_blk, bs, _ = vals.shape
    if nb == 0 or max_blk == 0 or bs == 0:
        raise ValueError(f"empty vals {tuple(vals.shape)}")
    if tuple(cols.shape) != (nb, max_blk):
        raise ValueError(f"cols must be {(nb, max_blk)}, got "
                         f"{tuple(cols.shape)}")
    if x.shape[0] == 0 or x.shape[0] % bs:
        what = "X must be (nb_cols*bs, r)" if x.ndim == 2 \
            else "x must be (nb_cols*bs,)"
        raise ValueError(f"{what}, a positive multiple of bs={bs} rows, got "
                         f"{tuple(x.shape)}")
    if plan is not None:
        if len(plan) != max_blk:
            raise ValueError(f"the slot plan has {len(plan)} entries, the "
                             f"operator {max_blk} slots")
        if x.shape[0] != nb * bs:
            raise ValueError(f"the banded kernels take a square operator: x "
                             f"must have nb*bs = {nb * bs} rows, got "
                             f"{x.shape[0]}")
    if x.ndim == 2:
        if x.shape[1] < 1:
            raise ValueError(f"X must be (nb_cols*bs, r) with r >= 1, got "
                             f"{tuple(x.shape)}")
        if bs > SPMM_MAX_BS:
            raise ValueError(f"the SpMM kernel takes bs <= {SPMM_MAX_BS}, "
                             f"got {bs}")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    suffix = _dtype_suffix(vals, x)
    if x.is_complex() and not vals.is_complex():
        kind = kind.replace("bell_spmv", "bell_spmm")   # (N, 2) columns
    name = f"{kind}_{suffix}"
    for t, what in ((vals, "vals"), (cols, "cols"), (x, "x")):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{what} on {t.device}, x on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"{kind} runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return name


def _vec_width(vals, *aligned) -> int:
    """16 bytes of values per load where the block size and the pointers
    allow it, else 1."""
    vec = 16 // vals.element_size()
    if vals.shape[-1] % vec or any(t.data_ptr() % 16
                                   for t in (vals, *aligned)):
        return 1
    return vec


def _raise_on_error(name, err):
    if err != 0:
        msg = _library().bell_spmv_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (error {err})")


def _output(vals, x):
    """The product's output: (nb*bs,) or (nb*bs, r), the rows of ``vals``
    (a row panel's y is shorter or longer than its x)."""
    nb, _, bs, _ = vals.shape
    return torch.empty((nb * bs, *x.shape[1:]), dtype=x.dtype,
                       device=x.device)


def _count_launch(name, vals, x):
    if _ring_depth:
        ring_launch_counts[name] += 1
        return
    square = x.shape[0] == vals.shape[0] * vals.shape[2]
    (launch_counts if square else panel_launch_counts)[name] += 1


@functools.lru_cache(maxsize=64)
def _band_offsets(plan, nb, device):
    """The plan as the banded kernels take it: an int32 (max_blk,) tensor
    on ``device`` holding ``o % nb`` for a band slot and -1 for a gather
    slot.  Built once per plan, size and device, never per product."""
    return torch.tensor([int(o) % nb if kind == "band" else -1
                         for kind, o in plan], dtype=torch.int32,
                        device=device)


def _launch(vals, cols, x, plan):
    """Launch the SpMV (x (N,)) or SpMM (X (N, r)) kernel, banded when
    ``plan`` is given; return the output.  A lazily conjugated or
    negated view (``x.conj()``) is materialized first: the kernels read
    the storage, which holds the unconjugated values."""
    vals, x = (t.resolve_conj().resolve_neg() for t in (vals, x))
    name = _check_kernel_args(vals, cols, x, plan)
    if x.is_complex() and not vals.is_complex():
        return _on_real_columns(_launch, vals, cols, x, plan)
    nb, max_blk, bs, _ = vals.shape
    y = _output(vals, x)
    band = () if plan is None else \
        (_band_offsets(plan, nb, x.device).data_ptr(),)
    # The SpMM stages X through shared memory with scalar loads: only the
    # values' alignment picks its vector width.
    shape = (nb, max_blk, bs, _vec_width(vals, x)) if x.ndim == 1 else \
        (nb, max_blk, bs, x.shape[1], _vec_width(vals))
    err = getattr(_library(), name)(
        vals.data_ptr(), cols.data_ptr(), *band, x.data_ptr(), y.data_ptr(),
        *shape, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(name, err)
    _count_launch(name, vals, x)
    return y


def _on_real_columns(product, vals, cols, x, plan):
    """Real values times a complex ``x`` by one real ``product`` on its
    (re, im) columns: (N,) as (N, 2), (N, r) as (N, 2r); exactly the real
    products of the two parts."""
    y = product(vals, cols, torch.view_as_real(x).reshape(x.shape[0], -1),
                plan)
    return torch.view_as_complex(y.reshape(*y.shape[:1], *x.shape[1:], 2))


def _bell_spmv_cuda(vals, cols, x):
    return _launch(vals, cols, x, None)


def _bell_spmm_cuda(vals, cols, X):
    return _launch(vals, cols, X, None)


def _bell_spmv_banded_cuda(vals, cols, x, plan):
    """The SpMV kernel in its banded mode (``plan`` of one entry per
    slot, matching ``cols``: the caller checks the match)."""
    return _launch(vals, cols, x, plan)


def _bell_spmm_banded_cuda(vals, cols, X, plan):
    """The SpMM kernel in its banded mode (see
    :func:`_bell_spmv_banded_cuda`)."""
    return _launch(vals, cols, X, plan)


def _bell_spmv_torch(vals, cols, x):
    """Plain PyTorch version: a batched block GEMV over the gathered x
    segments, values upcast to ``x``'s dtype at the product."""
    nb, max_blk, bs, _ = vals.shape
    xg = x.reshape(-1, bs)[cols.long()]                 # (nb, max_blk, bs)
    y = torch.matmul(vals.to(x.dtype), xg.unsqueeze(-1)).squeeze(-1)
    return y.sum(dim=1).reshape(-1)


def _bell_spmm_torch(vals, cols, X):
    """Plain PyTorch version: a batched (bs, bs) x (bs, r) GEMM over the
    gathered X segments, values upcast to ``X``'s dtype at the product."""
    nb, max_blk, bs, _ = vals.shape
    r = X.shape[1]
    xg = X.reshape(-1, bs, r)[cols.long()]          # (nb, max_blk, bs, r)
    return torch.matmul(vals.to(X.dtype), xg).sum(dim=1).reshape(-1, r)


def _band_columns(cols, plan):
    """The (nb, max_blk) block-columns the plan reads: ``(i + o) % nb`` for
    a band slot, ``cols[:, j]`` for a gather slot."""
    nb = cols.shape[0]
    i = torch.arange(nb, dtype=torch.int64, device=cols.device)
    out = cols.long().clone()
    for j, (kind, o) in enumerate(plan):
        if kind == "band":
            out[:, j] = (i + int(o)) % nb
    return out


def _bell_spmv_banded_torch(vals, cols, x, plan):
    """Plain PyTorch version of the banded SpMV: band columns from the
    plan, gather columns from ``cols``."""
    return _bell_spmv_torch(vals, _band_columns(cols, plan), x)


def _bell_spmm_banded_torch(vals, cols, X, plan):
    """Plain PyTorch version of the banded SpMM (see
    :func:`_bell_spmv_banded_torch`)."""
    return _bell_spmm_torch(vals, _band_columns(cols, plan), X)


def _host(cols) -> np.ndarray:
    if isinstance(cols, torch.Tensor):
        return cols.detach().cpu().numpy()
    return np.asarray(cols)


def detect_slot_plan(cols, nb: int):
    """Per-slot fetch plan from the block-column indices, JAX's
    ``detect_slot_plan`` on a host copy of ``cols``: a tuple of
    ``("band", o)`` (``cols[:, j] == (arange(nb) + o) % nb``) and
    ``("gather", 0)`` entries, or None when no slot is a band."""
    cs = _host(cols)
    i = np.arange(nb)
    plan = []
    for j in range(cs.shape[1]):
        o = int(cs[0, j]) % nb
        band = np.array_equal(cs[:, j], (i + o) % nb)
        plan.append(("band", o) if band else ("gather", 0))
    return tuple(plan) if any(k == "band" for k, _ in plan) else None


def _slot_plan_matches(cols, nb: int, plan) -> bool:
    """Whether every band slot of ``plan`` matches ``cols`` (a host
    copy); a mismatched plan would read the wrong x segments."""
    cs = _host(cols)
    i = np.arange(nb)
    return all(kind != "band" or np.array_equal(cs[:, j], (i + int(o)) % nb)
               for j, (kind, o) in enumerate(plan))


def _bell_rmatmat_torch(vals, cols, Y, n_cols):
    """``A^T Y`` for an (nb*bs, r) block in plain PyTorch: each block's
    transpose product, scattered onto its block-column (``n_cols``
    block-columns)."""
    nb, max_blk, bs, _ = vals.shape
    r = Y.shape[1]
    contrib = torch.matmul(vals.to(Y.dtype).transpose(-1, -2),
                           Y.reshape(nb, 1, bs, r))   # (nb, max_blk, bs, r)
    out = torch.zeros(n_cols, bs, r, dtype=Y.dtype, device=Y.device)
    return out.index_add(0, cols.reshape(-1).long(),
                         contrib.reshape(-1, bs, r)).reshape(-1, r)


def _bell_rmatvec_torch(vals, cols, y, n_cols):
    """``A^T y`` in plain PyTorch (see :func:`_bell_rmatmat_torch`)."""
    return _bell_rmatmat_torch(vals, cols, y[:, None], n_cols)[:, 0]


def _product(vals, cols, x, plan):
    """The product, without autograd: the plain version on a CPU tensor,
    else the kernel; banded when ``plan`` is given (checked by the
    caller)."""
    if x.device.type == "cpu":
        if plan is None:
            plain = _bell_spmv_torch if x.ndim == 1 else _bell_spmm_torch
            return plain(vals, cols, x)
        plain = _bell_spmv_banded_torch if x.ndim == 1 \
            else _bell_spmm_banded_torch
        return plain(vals, cols, x, plan)
    return _launch(vals, cols, x, plan)


class _BellProduct(torch.autograd.Function):
    """Kernel forward for ``x`` (N,) or ``X`` (N, r); backward in plain
    PyTorch; forward mode on the kernels, ``dy = A(dvals) x + A(vals) dx``
    (the map is bilinear in ``vals`` and ``x``), each term this Function
    again, so an outer jvp level differentiates it too.  Under
    ``torch.func.vmap`` a batch of vectors over shared values is one
    SpMM: B vectors x (N,) become X (N, B) (an (N, r) block, (N, r B)),
    the call ``matmat`` makes; batched values go lane by lane."""

    @staticmethod
    def forward(vals, cols, x, plan):
        return _product(vals, cols, x, plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        vals, cols, x, plan = inputs
        ctx.save_for_backward(vals, cols, x)
        ctx.save_for_forward(vals, cols, x)
        ctx.plan = plan

    @staticmethod
    @nestable_jvp
    def jvp(ctx, dvals, _, dx, __):
        vals, cols, x = ctx.saved_tensors
        dy = None
        if dvals is not None:
            dy = _BellProduct.apply(dvals.contiguous(), cols, x, ctx.plan)
        if dx is not None:
            term = _BellProduct.apply(vals, cols, dx.contiguous(), ctx.plan)
            dy = term if dy is None else dy + term
        return torch.zeros_like(_output(vals, x)) if dy is None else dy

    @staticmethod
    def backward(ctx, y_bar):
        # y_bar is ∂L/∂ȳ: x_bar = A^H y_bar, vals_bar = y_bar x^H (for
        # real tensors the conjugations are no-ops).  A real input takes
        # the real part of its complex gradient, as PyTorch's own
        # real-to-complex products do.
        vals, cols, x = ctx.saved_tensors
        nb, max_blk, bs, _ = vals.shape
        yb = y_bar.reshape(nb, bs, -1)                  # (nb, bs, r)
        vals_bar = x_bar = None
        if ctx.needs_input_grad[0]:
            # vals_bar[i, j, a, b] = sum_c y_bar[i*bs + a, c]
            #                              * conj(x[cols[i, j]*bs + b, c])
            xg = x.reshape(-1, bs, yb.shape[-1])[cols.long()]
            vals_bar = _as_input(torch.matmul(
                yb[:, None], xg.conj().transpose(-1, -2)), vals)
        if ctx.needs_input_grad[2]:
            x_bar = _as_input(_bell_rmatmat_torch(
                vals.conj(), cols, y_bar.reshape(nb * bs, -1),
                x.shape[0] // bs).reshape(x.shape), x)
        return vals_bar, None, x_bar, None

    @staticmethod
    def vmap(info, in_dims, vals, cols, x, plan):
        vals_dim, cols_dim, x_dim, _ = in_dims
        if vals_dim is not None or cols_dim is not None:
            return _per_lane(_BellProduct, info, in_dims,
                             (vals, cols, x, plan))
        lanes = x.movedim(x_dim, -1)            # (N, B) or (N, r, B)
        y = _BellProduct.apply(
            vals, cols, lanes.reshape(lanes.shape[0], -1).contiguous(), plan)
        return y.reshape(y.shape[0], *lanes.shape[1:]), lanes.ndim - 1


def _bell_product(vals, cols, x, plan):
    """The product through :class:`_BellProduct` where a derivative can be
    taken of it (a ``torch.func`` transform is active, a forward-mode
    dual level is open, or grad mode is on and ``vals`` or ``x``
    requires grad), else straight to :func:`_product`: the Function's
    own dispatch (a signature bind and a ctx a call) is host time that a
    loop under ``torch.no_grad`` would pay at every product."""
    if (transforms_active() or fwAD._current_level >= 0
            or (torch.is_grad_enabled()
                and (vals.requires_grad or x.requires_grad))):
        return _BellProduct.apply(vals, cols, x, plan)
    return _product(vals, cols, x, plan)


def _as_input(grad, inp):
    """A gradient in ``inp``'s dtype: the real part for a real input
    (PyTorch's rule for a real tensor that meets a complex one)."""
    if grad.is_complex() and not inp.is_complex():
        grad = grad.real
    return grad.to(inp.dtype)


def _bare_plan(vals, cols, x, slot_plan):
    """A bare call's plan after JAX's drop rule (one entry per slot, a
    square operator, bands that match ``cols``, checked on a host copy);
    None where the gather kernel runs."""
    if slot_plan is None or vals.ndim != 4:
        return None
    plan = tuple((str(kind), int(o)) for kind, o in slot_plan)
    if (len(plan) == vals.shape[1]
            and x.shape[0] == vals.shape[0] * vals.shape[2]
            and _slot_plan_matches(cols, vals.shape[0], plan)):
        return plan
    return None


def bell_spmv(vals, cols, x, slot_plan=None):
    """``y = A x`` for a blocked-ELL matrix, square or a row panel (see
    the module docstring); ``slot_plan`` as JAX's, dropped where it does
    not apply."""
    if x.ndim != 1:
        raise ValueError(f"bell_spmv takes x of shape (N,), got "
                         f"{tuple(x.shape)}")
    return _bell_product(vals, cols, x,
                         _bare_plan(vals, cols, x, slot_plan))


def bell_spmm(vals, cols, X, slot_plan=None):
    """``Y = A X`` for a blocked-ELL matrix, square or a row panel, and an
    (nb_cols*bs, r) block (see the module docstring): the values are
    streamed once for all r columns; ``slot_plan`` as in
    :func:`bell_spmv`."""
    if X.ndim != 2:
        raise ValueError(f"bell_spmm takes X of shape (N, r), got "
                         f"{tuple(X.shape)}")
    return _bell_product(vals, cols, X,
                         _bare_plan(vals, cols, X, slot_plan))
