"""TFIM exact diagonalization driver (BASELINE config #2), the
counterpart of ``examples/tfim_ed.py``.

Sweeps the transverse field g, computing the ground energy and its first
and second derivatives through the dominant eigensolver's implicit
derivative rules (one forward and two backwards a point, float64), and
compares them with the exact Jordan-Wigner values.

Run: python -m dominantsparseeigenad_tpu_torch.examples.tfim_ed --n 10 --points 21
"""

import argparse

import numpy as np
import torch

from ..models import (tfim_dense_hamiltonian, tfim_exact_d2e0_dg2,
                      tfim_exact_de0_dg, tfim_exact_e0)
from ..ops import DenseOperator, dominant_eigh, resolve_device
from ..utils import JsonlLogger


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10, help="number of spins")
    ap.add_argument("--points", type=int, default=21)
    ap.add_argument("--gmin", type=float, default=0.2)
    ap.add_argument("--gmax", type=float, default=1.8)
    ap.add_argument("--log", type=str, default=None, help="JSONL path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    k = min(120, 1 << args.n)

    def derivatives(g):
        g = torch.tensor(g, dtype=torch.float64, device=dev,
                         requires_grad=True)
        h = tfim_dense_hamiltonian(args.n, g, device=dev)
        lam, _ = dominant_eigh(DenseOperator(h), k=k, extreme="min",
                               tol=1e-12, device=dev)
        d1, = torch.autograd.grad(lam, g, create_graph=True)
        d2, = torch.autograd.grad(d1, g)
        return lam.item(), d1.item(), d2.item()

    rows = []
    print(f"# TFIM ED  N={args.n}   E0/dE0/d2E0 vs exact Jordan-Wigner")
    print(f"# {'g':>6} {'E0':>12} {'dE0/dg':>12} {'d2E0/dg2':>12} "
          f"{'err(E0)':>9} {'err(d1)':>9} {'err(d2)':>9}")
    with JsonlLogger(args.log) as log:
        for g in np.linspace(args.gmin, args.gmax, args.points):
            g = float(g)
            val, dv, ddv = derivatives(g)
            ev = float(tfim_exact_e0(args.n, g, device=dev))
            ed = tfim_exact_de0_dg(args.n, g)
            edd = tfim_exact_d2e0_dg2(args.n, g)
            errs = (abs(val - ev), abs(dv - ed), abs(ddv - edd))
            print(f"  {g:6.3f} {val:12.6f} {dv:12.6f} {ddv:12.6f} "
                  f"{errs[0]:9.1e} {errs[1]:9.1e} {errs[2]:9.1e}")
            log.log("tfim_ed", g=g, e0=val, de0=dv, d2e0=ddv)
            rows.append({"g": g, "e0": val, "de0": dv, "d2e0": ddv,
                         "exact": [ev, ed, edd], "abs_err": list(errs)})
    return {"rows": rows}


if __name__ == "__main__":
    main()
