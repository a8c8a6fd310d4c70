"""XXZ (Heisenberg) chain driver: the ground energy and its anisotropy
derivative through the eigensolver, the counterpart of
``examples/heisenberg.py`` (float64).

Run: python -m dominantsparseeigenad_tpu_torch.examples.heisenberg --n 14 --points 7
"""

import argparse
import math

import numpy as np
import torch

from ..models import heisenberg_ground_energy
from ..ops import resolve_device
from ..utils import JsonlLogger


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--points", type=int, default=7)
    ap.add_argument("--zmin", type=float, default=-1.5)
    ap.add_argument("--zmax", type=float, default=1.5)
    ap.add_argument("--k", type=int, default=150)
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = []
    print(f"# XXZ chain N={args.n}  (isotropic thermo limit "
          f"E0/N -> 1/4 - ln2 = {0.25 - math.log(2):.6f})")
    print(f"# {'Jz':>7} {'E0/N':>12} {'d(E0/N)/dJz':>13}")
    with JsonlLogger(args.log) as log:
        for jz in np.linspace(args.zmin, args.zmax, args.points):
            jzt = torch.tensor(jz, dtype=torch.float64, device=dev,
                               requires_grad=True)
            e0 = heisenberg_ground_energy(args.n, 1.0, jzt, k=args.k,
                                          device=dev)
            de0, = torch.autograd.grad(e0, jzt)
            val, dv = e0.item() / args.n, de0.item() / args.n
            print(f"  {float(jz):7.3f} {val:12.8f} {dv:13.8f}")
            log.log("xxz", jz=float(jz), e0_per_site=val, de0=dv)
            rows.append({"jz": float(jz), "e0_per_site": val, "de0": dv})
    return {"rows": rows}


if __name__ == "__main__":
    main()
