"""2D Ising transfer-matrix spectrum driver: the gap and the correlation
length across the phase transition, differentiable (float64); the
counterpart of ``examples/transfer_spectrum.py``.

The top-m transfer eigenvalues come from ``dominant_eig_multi``
(Arnoldi-seeded Wielandt deflation) on the converged CTMRG environment;
xi = 1/ln(lam1/|lam2|) diverges at beta_c ~ 0.4407, and dxi/dbeta comes
through the whole chain.

Run: python -m dominantsparseeigenad_tpu_torch.examples.transfer_spectrum --points 7
"""

import argparse
import math

import numpy as np
import torch

from ..models import correlation_length, ctmrg_environment, transfer_operator
from ..ops import dominant_eig_multi, resolve_device
from ..utils import JsonlLogger


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chi", type=int, default=12)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--m", type=int, default=3, help="eigenvalues to track")
    ap.add_argument("--points", type=int, default=7)
    ap.add_argument("--bmin", type=float, default=0.30)
    ap.add_argument("--bmax", type=float, default=0.42)
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def spectrum(beta):
        c, e, t = ctmrg_environment(beta, chi=args.chi, n_steps=args.steps,
                                    device=dev)
        op = transfer_operator(c, e, t, device=dev)
        lams, _, _ = dominant_eig_multi(op, m=args.m, device=dev)
        return lams.tolist()

    rows = []
    print(f"# 2D Ising transfer spectrum  chi={args.chi}  "
          f"(beta_c = {0.5 * math.log(1 + math.sqrt(2)):.6f})")
    print(f"# {'beta':>7} {'lam1':>12} {'lam2/lam1':>10} {'lam3/lam1':>10}"
          f" {'xi':>10} {'dxi/dbeta':>11}")
    with JsonlLogger(args.log) as log:
        for b in np.linspace(args.bmin, args.bmax, args.points):
            with torch.no_grad():
                lams = spectrum(float(b))
            bt = torch.tensor(b, dtype=torch.float64, device=dev,
                              requires_grad=True)
            xi = correlation_length(bt, chi=args.chi, n_steps=args.steps,
                                    device=dev)
            dxi, = torch.autograd.grad(xi, bt)
            row = [float(b), lams[0], lams[1] / lams[0],
                   (lams[2] / lams[0]) if args.m > 2 else float("nan"),
                   xi.item(), dxi.item()]
            print(f"  {row[0]:7.4f} {row[1]:12.6f} {row[2]:10.6f} "
                  f"{row[3]:10.6f} {row[4]:10.4f} {row[5]:11.4f}")
            log.log("transfer_spectrum", beta=row[0], lam1=row[1],
                    ratio2=row[2], ratio3=row[3], xi=row[4], dxi=row[5])
            rows.append(dict(zip(("beta", "lam1", "ratio2", "ratio3", "xi",
                                  "dxi"), row), lams=lams))
    return {"rows": rows}


if __name__ == "__main__":
    main()
