"""TFIM matrix-free driver: the fidelity susceptibility at large N
(BASELINE config #3, the paper's flagship figure), the counterpart of
``examples/tfim_sparse.py``.

The 2^N-dimensional Hamiltonian is never built: Lanczos forward and the
deflated-CG implicit tangent (one ``torch.func.jvp`` pass) give E0,
dE0/dg and chi_F(g) = ||dpsi/dg||^2 a sweep point.  The default dtype is
float64, on the card too; ``--dtype f32`` is the fast one.

Run: python -m dominantsparseeigenad_tpu_torch.examples.tfim_sparse --n 16 --points 21
"""

import argparse

import numpy as np
import torch

from ..models import tfim_exact_e0, tfim_observables_sweep, tfim_operator
from ..ops import dominant_eigh, hdot, resolve_device
from ..utils import JsonlLogger, timeit


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--points", type=int, default=11)
    ap.add_argument("--gmin", type=float, default=0.5)
    ap.add_argument("--gmax", type=float, default=1.5)
    ap.add_argument("--k", type=int, default=100, help="Lanczos steps")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f64")
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--batched", action="store_true",
                    help="compute the whole chi_F(g) curve by one "
                         "torch.func.vmap of the pass "
                         "(tfim_observables_sweep) instead of a Python "
                         "loop over the points")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    tol = 1e-10 if args.dtype == "f64" else 1e-5

    def observables(g):
        def ground(gg):
            return dominant_eigh(
                tfim_operator(args.n, gg, dtype=dtype, device=dev),
                k=args.k, extreme="min", tol=tol, maxiter=400, device=dev)

        (lam, _), (dlam, dv) = torch.func.jvp(ground, (g,),
                                              (torch.ones_like(g),))
        return torch.stack([lam, dlam, hdot(dv, dv).real])

    def row(g, lam, dlam, chi):
        exact = float(tfim_exact_e0(args.n, g, device="cpu"))
        err = abs(lam - exact) / abs(exact)
        print(f"  {g:6.3f} {lam / args.n:12.8f} {dlam:12.6f} "
              f"{chi:12.6f} {err:9.1e}")
        log.log("tfim_sparse", g=g, e0=lam, de0=dlam, chi=chi)
        return {"g": g, "e0": lam, "de0": dlam, "chi": chi,
                "exact_e0": exact, "rel_err_e0": err}

    print(f"# TFIM sparse  N={args.n}  dim={1 << args.n}  "
          f"device={dev}  dtype={args.dtype}  "
          f"{'batched' if args.batched else 'pointwise'}")
    print(f"# {'g':>6} {'E0/N':>12} {'dE0/dg':>12} {'chi_F':>12} "
          f"{'err(E0)':>9}")
    gs = np.linspace(args.gmin, args.gmax, args.points)
    with JsonlLogger(args.log) as log:
        if args.batched:
            def sweep(z):
                return tfim_observables_sweep(args.n, z, k=args.k, tol=tol,
                                              maxiter=400, dtype=dtype,
                                              device=dev)

            gt = torch.tensor(gs, dtype=dtype, device=dev)
            vals = sweep(gt).cpu().tolist()
            rows = [row(float(g), *v) for g, v in zip(gs, vals)]
            t = timeit(sweep, gt, repeats=3)
            per_point_ms = t.best / args.points * 1e3
            print(f"# steady-state per point (whole-curve dispatch): "
                  f"{per_point_ms:.1f} ms")
        else:
            rows = []
            for g in gs:
                vals = observables(torch.tensor(g, dtype=dtype, device=dev))
                rows.append(row(float(g), *vals.cpu().tolist()))
            t = timeit(observables, torch.tensor(1.0, dtype=dtype,
                                                 device=dev), repeats=3)
            per_point_ms = t.best * 1e3
            print(f"# steady-state per point: {per_point_ms:.1f} ms")
    return {"rows": rows, "per_point_ms": per_point_ms}


if __name__ == "__main__":
    main()
