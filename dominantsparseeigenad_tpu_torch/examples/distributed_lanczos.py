"""Distributed Lanczos driver: the row-sharded TFIM ground state, the
counterpart of ``examples/distributed_lanczos.py``.

The 2^n-dimensional state is split over ``--ranks`` processes
(``tfim_sharded_operator``: a rank holds the amplitudes whose top bits
are its index; the high-bit spin flips swap whole segments between XOR
partner ranks).  Every rank runs the same Lanczos solve, and E0 and
dE0/dg come from its forward and the implicit backward through the
exchange; the Jordan-Wigner E0 is printed beside it.

The JAX driver fakes eight CPU devices in one process.  This one spawns
``--ranks`` processes (default 2, a power of two) that join one gloo
group on this machine and share its one card (or its CPU with
``--device cpu``): a check of the sharded program, not a multi-GPU run.

Run: python -m dominantsparseeigenad_tpu_torch.examples.distributed_lanczos --n 12
"""

import argparse
import os

import torch

from ..models import tfim_exact_e0, tfim_sharded_operator
from ..ops import dominant_eigh, resolve_device
from ..parallel import init_distributed, make_mesh
from ..parallel.collectives import collective_counts
from ..utils import timeit
from .sharded_sparse import _run_ranks


def _solve(rank, world, init_method, args):
    dev = resolve_device(args["device"])
    # Each rank takes its share of the host's cores (a spawned process
    # would take them all, and the ranks would contend).
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed("gloo", init_method, rank, world)
    try:
        sg = make_mesh()
        dtype = torch.float64 if args["dtype"] == "f64" else torch.float32
        tol = 1e-10 if args["dtype"] == "f64" else 1e-5

        def solve(g):
            op = tfim_sharded_operator(args["n"], g, sg, dtype=dtype,
                                       device=dev)
            return dominant_eigh(op, k=args["k"], extreme="min", tol=tol,
                                 device=dev)[0]

        g = torch.tensor(args["g"], dtype=dtype, device=dev,
                         requires_grad=True)
        lam = solve(g)
        (grad,) = torch.autograd.grad(lam, g)
        with torch.no_grad():
            t = timeit(solve, torch.tensor(args["g"], dtype=dtype,
                                           device=dev), repeats=3)
        return {"rank": rank, "shards": sg.size, "e0": lam.item(),
                "de0_dg": grad.item(), "best_s": t.best,
                "collectives": dict(collective_counts)}
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--g", type=float, default=1.0)
    ap.add_argument("--k", type=int, default=80)
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f64")
    ap.add_argument("--ranks", type=int, default=2,
                    help="processes to spawn (a power of two), one gloo "
                         "group on this machine sharing its one card (not "
                         "a multi-GPU run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"# group: {{'batch': 1, 'shards': {args.ranks}}} over "
          f"{args.ranks} gloo ranks sharing {dev} (not a multi-GPU run)")
    ranks = _run_ranks(args.ranks, {"n": args.n, "g": args.g, "k": args.k,
                                    "dtype": args.dtype,
                                    "device": args.device}, _solve)
    first = ranks[0]
    val, grad = first["e0"], first["de0_dg"]
    exact = float(tfim_exact_e0(args.n, args.g, device="cpu"))
    print(f"E0 = {val:.8f}  (exact {exact:.8f}, "
          f"err {abs(val - exact):.1e})")
    print(f"dE0/dg = {grad:.8f}")
    best = max(r["best_s"] for r in ranks)
    print(f"steady-state: {best * 1e3:.1f} ms")
    return {"ranks": args.ranks, "n": args.n, "g": args.g, "e0": val,
            "exact": exact, "de0_dg": grad, "steady_ms": best * 1e3,
            "e0_by_rank": [r["e0"] for r in ranks],
            "de0_dg_by_rank": [r["de0_dg"] for r in ranks],
            "collectives_by_rank": [r["collectives"] for r in ranks]}


if __name__ == "__main__":
    main()
