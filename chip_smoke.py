#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``).  It imports nothing of JAX.  Phases, one JSON
line each:

1. ``build``: compiles ``csrc/bell_spmv.cu`` with nvcc (timed), reads the
   card's name and power limit, measures the device-to-device copy rate.
2. ``spmv``: the blocked-ELL kernel against its plain PyTorch version, in
   float32 and bfloat16 values, at the BASELINE config-#5 shape (n = 2^19,
   bs = 128, 17 blocks per row) and at small odd shapes; kernel, plain,
   bound and library (cuSPARSE BSR, float32 only) times.
3. ``eigh``: the main path at the config-#5 shape.  ``dominant_eigh`` with
   k = 100 and the gradient of ``λ + Σ c⊙v`` with respect to the stored
   values, on float32 values and on bfloat16 values; the SpMV launch
   counts of that run; then the checks (λ against a plain-SpMV solve from
   the same start vector, ∂λ/∂vals against v⊗v on the pattern, a
   dot-product test of the full gradient against the forward IFT tangent).

Then a ``kernels`` line, the ``nvidia-smi`` name and power-limit line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the exit code is not 0.  Without a CUDA device it exits with
code 1 before printing any result.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch

# Published H100 SXM peaks at the 700 W limit (NVIDIA data sheet):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

CONFIG5 = (1 << 19, 128, 17)          # n, bs, blocks per row
SMALL_SHAPES = ((4096, 32, 5), (4000, 20, 5))
K = 100
DEVICE = "cuda"
CG_TOL = 1e-6                          # clamped to 50 eps(f32) = 6e-6
CG_MAXITER = 3000


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, samples=10, batch=1, warmup=2):
    """Median over ``samples`` of the CUDA-event time of ``batch`` calls
    of ``fn``, per call, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_build(spmv):
    spmv.build_library()
    log = spmv.build_info["log"]
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    n_copy = 1 << 30                                   # 4 GiB of float32
    src = torch.empty(n_copy, dtype=torch.float32, device=DEVICE)
    src.fill_(1.0)
    dst = torch.empty_like(src)
    copy_ms = event_ms(lambda: dst.copy_(src), samples=10)
    del src, dst
    copy_gbps = 2 * n_copy * 4 / (copy_ms * 1e-3) / 1e9
    emit({"phase": "build", "nvcc_s": spmv.build_info["seconds"],
          "library": spmv.build_info["path"], "ptxas": ptxas,
          "gpu": nvidia_smi_name_power(),
          "copy_ms": copy_ms, "copy_gbps": copy_gbps})
    return copy_gbps


def bsr_library_call(vals, cols, n):
    """One PyTorch call for the same product: a cuSPARSE BSR matrix, with
    each row's slots sorted by column.  A yardstick only."""
    nb, max_blk, bs, _ = vals.shape
    order = cols.argsort(dim=1)
    cols_s = cols.gather(1, order)
    vals_s = vals[torch.arange(nb, device=vals.device)[:, None], order]
    crow = torch.arange(nb + 1, dtype=torch.int32,
                        device=vals.device) * max_blk
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = torch.sparse_bsr_tensor(crow, cols_s.reshape(-1),
                                    vals_s.reshape(-1, bs, bs), size=(n, n),
                                    check_invariants=False)
    return lambda x: a @ x


def spmv_case(spmv, sparse, n, bs, bpr, copy_gbps, seed, unaligned=False):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    op = sparse.random_bell_operator(n, bs, bpr, generator=gen,
                                     device=DEVICE)
    x = torch.randn(n, generator=gen, device=DEVICE)
    if unaligned:
        # An x that is not 16-byte aligned drives the scalar-load path.
        buf = torch.empty(n + 1, device=DEVICE)
        buf[1:] = x
        x = buf[1:]
    results = {}
    for name, vals in (("bell_spmv_f32", op.vals),
                       ("bell_spmv_bf16vals", op.vals.to(torch.bfloat16))):
        cols = op.cols
        y_k = spmv._bell_spmv_cuda(vals, cols, x)
        y_p = spmv._bell_spmv_torch(vals, cols, x)
        torch.cuda.synchronize()
        err = rel_err(y_k, y_p)
        max_abs = float((y_k - y_p).abs().max())
        if not (math.isfinite(err) and err <= 1e-5):
            raise AssertionError(f"{name} at n={n} bs={bs}: rel err {err}")
        big = n >= CONFIG5[0]
        batch_k = 5 if big else 100
        kernel_ms = event_ms(lambda: spmv._bell_spmv_cuda(vals, cols, x),
                             samples=12, batch=batch_k)
        plain_ms = event_ms(lambda: spmv._bell_spmv_torch(vals, cols, x),
                            samples=12, batch=batch_k // 5 or 1)
        library_ms = lib_err = None
        if vals.dtype == torch.float32 and not unaligned:
            lib = bsr_library_call(vals, cols, n)
            lib_err = rel_err(lib(x), y_p)
            library_ms = event_ms(lambda: lib(x), samples=12,
                                  batch=batch_k // 5 or 1)
            del lib
        nb, max_blk = cols.shape
        nnz = vals.numel()
        # Least bytes: each input once (values, cols, x), y once.
        bytes_min = nnz * vals.element_size() + cols.numel() * 4 + 2 * n * 4
        bound_ms = max(bytes_min / PEAK_BYTES_PER_S,
                       2 * nnz / PEAK_F32_FLOP_PER_S) * 1e3
        bound_by = ("bytes" if bytes_min / PEAK_BYTES_PER_S
                    >= 2 * nnz / PEAK_F32_FLOP_PER_S else "operations")
        # The same stream with every x gather counted, over the measured
        # copy rate.
        bytes_gather = nnz * vals.element_size() + nb * max_blk * bs * 4 \
            + n * 4
        copy_bound_ms = bytes_gather / (copy_gbps * 1e9) * 1e3
        row = {"phase": "spmv", "kernel": name, "n": n, "bs": bs,
               "blocks_per_row": bpr, "x_aligned": not unaligned,
               "rel_err": err, "max_abs_err": max_abs,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_rel_err": lib_err,
               "bytes_min": bytes_min, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes_with_gathers": bytes_gather,
               "copy_bound_ms": copy_bound_ms,
               "achieved_gbps": bytes_min / (kernel_ms * 1e-3) / 1e9}
        emit(row)
        results[name] = row
        del vals, y_k, y_p
    del op, x
    torch.cuda.empty_cache()
    return results


def phase_eigh(pkg, spmv):
    from dominantsparseeigenad_tpu_torch.ops.cg import solve_deflated_info
    n, bs, bpr = CONFIG5
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    op = pkg.random_bell_operator(n, bs, bpr, generator=gen, device=DEVICE)
    op.vals.requires_grad_(True)
    op_bf = pkg.BellOperator(op.vals.detach().to(torch.bfloat16)
                             .requires_grad_(True), op.cols, n,
                             symmetric=True)
    v0 = torch.randn(n, generator=gen, device=DEVICE)
    c = torch.randn(n, generator=gen, device=DEVICE) / math.sqrt(n)
    solve = dict(k=K, extreme="min", tol=CG_TOL, maxiter=CG_MAXITER, v0=v0,
                 device=DEVICE)

    # Warm-up on a small operator through the same calls, so that one-time
    # costs (library loads, first kernel launches) stay out of the times.
    t0 = time.perf_counter()
    small = pkg.random_bell_operator(1 << 14, bs, bpr, generator=gen,
                                     device=DEVICE)
    for o in (small, small.astype_vals(torch.bfloat16)):
        o.vals.requires_grad_(True)
        lam_w, v_w = pkg.dominant_eigh(o, k=20, maxiter=20, device=DEVICE)
        (lam_w + v_w.sum()).backward()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    del small, o, lam_w, v_w
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted ----------------------------------------
    spmv.reset_launch_counts()
    t0 = time.perf_counter()
    lam, v = pkg.dominant_eigh(op, **solve)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    fwd_launches = spmv.launch_counts["bell_spmv_f32"]
    t0 = time.perf_counter()
    (g_lam,) = torch.autograd.grad(lam, op.vals, retain_graph=True)
    torch.cuda.synchronize()
    t_bwd_lam = time.perf_counter() - t0
    before = spmv.launch_counts["bell_spmv_f32"]
    t0 = time.perf_counter()
    (lam + (c * v).sum()).backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    bwd_launches = spmv.launch_counts["bell_spmv_f32"] - before
    t0 = time.perf_counter()
    lam_bf, v_bf = pkg.dominant_eigh(op_bf, **solve)
    (g_lam_bf,) = torch.autograd.grad(lam_bf, op_bf.vals)
    torch.cuda.synchronize()
    t_bf = time.perf_counter() - t0
    counts = dict(spmv.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # ---- end of the counted run -----------------------------------------

    lam, v = lam.detach(), v.detach()
    lam_f, lam_bf_f = float(lam), float(lam_bf.detach())
    vals_d, cols = op.vals.detach(), op.cols

    def deflated(z):
        """P (A - λ) P z, P = I - v v^T."""
        pz = z - v * torch.dot(v, z)
        az = op.matvec(pz) - lam * pz
        return az - v * torch.dot(v, az)

    with torch.no_grad():
        ritz_res = float(torch.linalg.vector_norm(op.matvec(v) - lam * v)
                         / abs(lam_f))
        # The backward's CG, re-run on the same right-hand side; the
        # kernels are deterministic, so it gives the backward's x.
        b = -(c - v * torch.dot(v, c))
        x, cg_its, cg_res = solve_deflated_info(
            op, lam, v, b, definite_sign=1.0, tol=CG_TOL,
            maxiter=CG_MAXITER, device=DEVICE)

        # λ against the same solve through the plain SpMV, same v0.
        mf = pkg.MatrixFreeOperator(
            lambda p, z: spmv._bell_spmv_torch(p, cols, z), vals_d, n)
        lam_mf, _ = pkg.lanczos_eigh(mf, K, extreme="min", v0=v0,
                                     device=DEVICE)
        lam_mf_err = abs(lam_f - float(lam_mf)) / abs(lam_f)

        # ∂λ/∂vals = v[i*bs+a] v[cols[i,j]*bs+b] on the pattern.
        vb = v.reshape(-1, bs)
        expect = vb[:, None, :, None] * vb[cols.long()][:, :, None, :]
        dlam_err = rel_err(g_lam, expect)
        del expect

        # Dot-product test of the full gradient: <grad, dvals> against the
        # forward IFT tangent dλ + c^T dv, dv = solve_deflated(A, λ, v,
        # -(I - v v^T) dA v).  With residuals r_x = P(-c) - M x and
        # r_d = -P dA v - M dv of the two solves (M the deflated operator),
        # <grad, dvals> - (dλ + c^T dv) = <r_x, dv> - <x, r_d> exactly, so
        # the test holds at any CG stopping point, up to round-off.
        g_full = op.vals.grad
        dvals = torch.randn(vals_d.shape, generator=gen, device=DEVICE)
        lhs = sum(float(torch.dot(g.reshape(-1).double(),
                                  d.reshape(-1).double()))
                  for g, d in zip(g_full.split(256), dvals.split(256)))
        dav = spmv.bell_spmv(dvals, cols, v)
        del dvals
        dlam = torch.dot(v, dav)
        rhs_d = -(dav - dlam * v)
        dv, dv_its, dv_res = solve_deflated_info(
            op, lam, v, rhs_d, definite_sign=1.0, tol=CG_TOL,
            maxiter=CG_MAXITER, device=DEVICE)
        r_x = (b - v * torch.dot(v, b)) - deflated(x)
        r_d = (rhs_d - v * torch.dot(v, rhs_d)) - deflated(dv)
        terms = [float(dlam), float(torch.dot(c, dv)),
                 float(torch.dot(r_x, dv)), -float(torch.dot(x, r_d))]
        rhs = terms[0] + terms[1]
        dot_err = abs(lhs - rhs - terms[2] - terms[3]) / (
            abs(lhs) + sum(abs(t) for t in terms))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (v, g_full, g_lam_bf, v_bf.detach()))
    bf_err = abs(lam_bf_f - lam_f) / abs(lam_f)
    emit({"phase": "eigh", "n": n, "bs": bs, "blocks_per_row": bpr, "k": K,
          "lam": lam_f, "ritz_residual": ritz_res, "warmup_s": t_warm,
          "forward_s": t_fwd, "backward_lam_s": t_bwd_lam,
          "backward_s": t_bwd, "bf16_forward_backward_s": t_bf,
          "cg_iterations": cg_its, "cg_rel_residual": cg_res,
          "launches": counts, "forward_launches": fwd_launches,
          "backward_launches": bwd_launches,
          "lam_vs_plain_rel": lam_mf_err, "dlam_dvals_rel_err": dlam_err,
          "dot_test_lhs": lhs, "dot_test_terms": terms,
          "dot_test_rel_err": dot_err, "tangent_cg_iterations": dv_its,
          "tangent_cg_rel_residual": dv_res,
          "lam_bf16vals": lam_bf_f, "lam_bf16vals_rel": bf_err,
          "peak_mem_gib": peak_gib})

    checks = {
        # The forward is k SpMVs; the backward one per CG iteration plus
        # the one matvec autograd differentiates.
        "forward launches == k": fwd_launches == K,
        "backward launches == CG iterations + 1": bwd_launches == cg_its + 1,
        "f32 launches >= k + CG iterations":
            counts["bell_spmv_f32"] >= K + cg_its,
        "bf16 launches >= k + 1": counts["bell_spmv_bf16vals"] >= K + 1,
        # Two f32 Lanczos runs whose SpMVs sum in different orders.
        "λ vs plain-SpMV λ, rel 1e-4": lam_mf_err <= 1e-4,
        # The same products as the backward's, formed directly.
        "∂λ/∂vals vs v⊗v, rel 1e-5": dlam_err <= 1e-5,
        # An exact identity up to f32 round-off in products of vectors
        # whose norms the ill-conditioned solves inflate.
        "dot-product test, rel 1e-3": dot_err <= 1e-3,
        # Weyl: bf16 storage moves λ by at most 2^-8 ||A|| ≈ 2^-8 |λ_min|.
        "bf16-values λ within 2^-8 rel": bf_err <= 2.0 ** -8,
        "finite": finite,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"eigh phase failed: {failed}")
    return counts


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import importlib
    import dominantsparseeigenad_tpu_torch as pkg
    # The module, not the function of the same name that ops exports.
    spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                   "bell_spmv")
    sparse = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                     "sparse")

    copy_gbps = phase_build(spmv)
    big = spmv_case(spmv, sparse, *CONFIG5, copy_gbps, seed=1)
    spmv_case(spmv, sparse, *SMALL_SHAPES[0], copy_gbps, seed=2)
    spmv_case(spmv, sparse, *SMALL_SHAPES[1], copy_gbps, seed=3,
              unaligned=True)
    counts = phase_eigh(pkg, spmv)

    src = "dominantsparseeigenad_tpu_torch/csrc/bell_spmv.cu"
    tpu = "dominantsparseeigenad_tpu/ops/pallas_spmv.py:161"
    kernels = []
    for name in ("bell_spmv_f32", "bell_spmv_bf16vals"):
        row = big[name]
        if counts[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": counts[name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    print(nvidia_smi_name_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
