"""Row-sharded blocked-ELL eigensolver driver (BASELINE config #5 as
written), the counterpart of ``examples/sharded_sparse.py``.

The blocked-ELL matrix's block-rows are split over ranks
(``RowShardedBellOperator``, one process a rank on ``torch.distributed``);
each rank's panel product runs the hand-written kernels on a row panel
on the card, and the dominant eigenpair and its matrix-entry gradient
come through the Lanczos forward and the implicit backward.  The
single-device ``BellOperator`` path (on the card, the banded kernels) is
the oracle, printed beside it, and a parity gate exits with an error if
the two disagree.

The JAX driver fakes eight CPU devices in one process.  This one spawns
``--ranks`` processes (default 2; one runs in this process) that join
one gloo group on this machine and share its one card (or its CPU with
``--device cpu``): a check of the sharded program, not a multi-GPU run.
``--mode ring`` runs over vectors sharded across the ranks (the JAX
layout), each offset's bucket on the hand-written kernels; the default
``all_gather`` keeps them replicated.

Run: python -m dominantsparseeigenad_tpu_torch.examples.sharded_sparse --n 4096
"""

import argparse
import math
import multiprocessing
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch

from ..ops import dominant_eigh, random_bell_operator, resolve_device
from ..ops.bell_spmv import (launch_counts, panel_launch_counts,
                             ring_launch_counts)
from ..parallel import RowShardedBellOperator, init_distributed, make_mesh

# How long the parent waits for a rank's result, in seconds.
RANK_TIMEOUT_S = 600


def _rank(rank, world, init_method, args, out_queue, solve):
    """One rank (a spawned process) running ``solve``: sends (rank,
    results, None), or (rank, None, traceback) if it failed."""
    try:
        out_queue.put((rank, solve(rank, world, init_method, args), None))
    except Exception:  # the parent raises it; this rank exits non-zero
        out_queue.put((rank, None, traceback.format_exc()))
        sys.exit(1)


def _counted(fn):
    """``(fn(), square launches, panel launches, ring bucket launches)``:
    the kernel launches the call made, by kernel name."""
    counts = (launch_counts, panel_launch_counts, ring_launch_counts)
    before = [dict(c) for c in counts]
    out = fn()
    return (out, *({k: c[k] - b[k] for k in c if c[k] != b[k]}
                   for c, b in zip(counts, before)))


def _solve(rank, world, init_method, args):
    dev = resolve_device(args["device"])
    init_distributed("gloo", init_method, rank, world)
    try:
        sg = make_mesh()
        # Every rank builds the same global operator from the same seed
        # and keeps its block-rows.
        gen = torch.Generator(device=dev).manual_seed(0)
        op = random_bell_operator(args["n"], args["bs"], args["bpr"],
                                  generator=gen, dtype=torch.float32,
                                  device=dev)
        vectors = "sharded" if args["mode"] == "ring" else "replicated"
        sop = RowShardedBellOperator.from_bell(op, sg, mode=args["mode"],
                                               vectors=vectors)

        # d lambda_min / d vals is v v^T on the pattern: exact, and no
        # dense matrix is built.
        def lam_grad(operator):
            vals = operator.vals.detach().clone().requires_grad_(True)
            lam, _ = dominant_eigh(operator.with_vals(vals), k=args["k"],
                                   extreme="min", device=dev)
            grad, = torch.autograd.grad(lam, vals)
            return lam.item(), grad

        (lam_s, grad_s), sq_s, pan_s, ring_s = _counted(
            lambda: lam_grad(sop))
        (lam_l, grad_l), sq_l, pan_l, _ = _counted(lambda: lam_grad(op))
        nb_l = sop.vals.shape[0]
        grad_l = grad_l[rank * nb_l:(rank + 1) * nb_l]
        return {"rank": rank, "lam_sharded": lam_s, "lam_local": lam_l,
                "grad_max_abs_diff": float((grad_s - grad_l).abs().max()),
                "grad_sharded_sq": float((grad_s ** 2).sum()),
                "grad_local_sq": float((grad_l ** 2).sum()),
                "nnz": op.nnz, "sharded_square_launches": sq_s,
                "sharded_panel_launches": pan_s,
                "sharded_ring_launches": ring_s,
                "ring_offsets": list(sop.ring_offsets),
                "local_square_launches": sq_l,
                "local_panel_launches": pan_l}
    finally:
        torch.distributed.destroy_process_group()


def _run_ranks(world, args, solve):
    """Spawn the ranks over a file store, each running ``solve(rank,
    world, init_method, args)`` (a module-level function), and collect
    their results; one rank runs in this process."""
    store = tempfile.mkdtemp(prefix="ranks_")
    if world == 1:
        try:
            return [solve(0, 1, f"file://{store}/store", args)]
        finally:
            shutil.rmtree(store, ignore_errors=True)
    ctx = multiprocessing.get_context("spawn")
    out_queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(rank, world,
                                             f"file://{store}/store", args,
                                             out_queue, solve))
             for rank in range(world)]
    env = os.environ.get("GLOO_SOCKET_IFNAME")
    # The ranks reach each other over the loopback interface.
    os.environ["GLOO_SOCKET_IFNAME"] = env or "lo"
    try:
        for proc in procs:
            proc.start()
        got = {}
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while len(got) < world:
            try:
                rank, res, err = out_queue.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"a rank sent nothing (exit codes {dead}, "
                        f"{RANK_TIMEOUT_S} s allowed)") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            got[rank] = res
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive() or proc.exitcode != 0:
                raise RuntimeError(f"a rank did not exit cleanly (exit "
                                   f"code {proc.exitcode})")
    finally:
        if env is None:
            os.environ.pop("GLOO_SOCKET_IFNAME", None)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        shutil.rmtree(store, ignore_errors=True)
    return [got[rank] for rank in range(world)]


def _sum_counts(dicts):
    out = {}
    for d in dicts:
        for k, c in d.items():
            out[k] = out.get(k, 0) + c
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096, help="matrix dimension")
    ap.add_argument("--bs", type=int, default=32, help="block size")
    ap.add_argument("--bpr", type=int, default=5,
                    help="stored blocks per block-row (odd)")
    ap.add_argument("--k", type=int, default=60, help="Lanczos steps")
    ap.add_argument("--mode", choices=("all_gather", "ring"),
                    default="all_gather",
                    help="vector-segment exchange strategy")
    ap.add_argument("--ranks", type=int, default=2,
                    help="processes to spawn, one gloo group on this "
                         "machine sharing its one card (not a multi-GPU "
                         "run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"ranks: {args.ranks} processes over gloo sharing {dev} (not a "
          f"multi-GPU run), exchange mode: {args.mode}")
    ranks = _run_ranks(args.ranks, {"n": args.n, "bs": args.bs,
                                    "bpr": args.bpr, "k": args.k,
                                    "mode": args.mode,
                                    "device": args.device}, _solve)
    first = ranks[0]
    nnz = first["nnz"]
    print(f"operator: n={args.n}, {nnz:,} stored entries "
          f"({nnz / args.n**2:.2%} dense)")
    lam_s, lam_l = first["lam_sharded"], first["lam_local"]
    gdiff = max(r["grad_max_abs_diff"] for r in ranks)
    gnorm_s = math.sqrt(sum(r["grad_sharded_sq"] for r in ranks))
    gnorm_l = math.sqrt(sum(r["grad_local_sq"] for r in ranks))
    print(f"lambda_min  sharded: {lam_s:+.8f}")
    print(f"lambda_min  local  : {lam_l:+.8f}")
    print(f"matrix-entry gradient: max |sharded - local| = {gdiff:.2e}")
    print(f"||d lambda / d vals|| = {gnorm_s:.6f}"
          "  (= ||v v^T on the pattern|| <= 1)")
    out = {"ranks": args.ranks, "nnz": nnz, "lam_sharded": lam_s,
           "lam_local": lam_l, "grad_max_abs_diff": gdiff,
           "grad_norm": gnorm_s,
           "lam_sharded_by_rank": [r["lam_sharded"] for r in ranks],
           "panel_launches": _sum_counts(r["sharded_panel_launches"]
                                         for r in ranks),
           "ring_launches": _sum_counts(r["sharded_ring_launches"]
                                        for r in ranks),
           "ring_offsets": first["ring_offsets"],
           "sharded_square_launches": _sum_counts(
               r["sharded_square_launches"] for r in ranks),
           "local_square_launches": _sum_counts(
               r["local_square_launches"] for r in ranks)}
    # A hard parity gate: a silent divergence between the sharded and the
    # local gradient must fail.  float32 sums in another order bound the
    # legitimate gap well under this threshold.
    tol = 1e-4 * max(1.0, gnorm_l)
    if not (gdiff <= tol and abs(lam_s - lam_l) <= 1e-4 * abs(lam_l)):
        raise SystemExit(f"PARITY FAILURE: sharded vs local gradient "
                         f"max-diff {gdiff:.2e} exceeds {tol:.2e}")
    return out


if __name__ == "__main__":
    main()
