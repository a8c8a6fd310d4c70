"""2D classical Ising driver: the free energy, energy and specific heat
by TRG or CTMRG, differentiated through the renormalization flow
(BASELINE config #4), against Onsager; the counterpart of
``examples/ising2d.py``.  Onsager's values are computed in float64 for
either flow dtype.

Run: python -m dominantsparseeigenad_tpu_torch.examples.ising2d --method ctmrg --chi 30
"""

import argparse

import numpy as np
import torch

from ..models import ising_observables, onsager_free_energy
from ..ops import resolve_device
from ..utils import JsonlLogger


def onsager_observables(beta, device):
    """Onsager's (ln Z/N, u, c_v) at ``beta`` (n_quad = 256, float64),
    the exact u and c_v by autograd through the quadrature."""
    b = torch.tensor(beta, dtype=torch.float64, device=device,
                     requires_grad=True)
    lnz = onsager_free_energy(b, n_quad=256, device=device)
    d1, = torch.autograd.grad(lnz, b, create_graph=True)
    d2, = torch.autograd.grad(d1, b)
    return lnz.item(), -d1.item(), beta ** 2 * d2.item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", choices=["trg", "ctmrg"], default="ctmrg")
    ap.add_argument("--chi", type=int, default=30)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--points", type=int, default=11)
    ap.add_argument("--bmin", type=float, default=0.30)
    ap.add_argument("--bmax", type=float, default=0.60)
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--f32", action="store_true",
                    help="run the flow in float32 (the subspace split "
                         "keeps it near float64)")
    ap.add_argument("--vmap", action="store_true",
                    help="batch all beta points through torch.func.vmap "
                         "(lnZ, u, c_v at order 2 for the whole curve in "
                         "one transformed call)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64

    def obs(b):
        return ising_observables(b, method=args.method, chi=args.chi,
                                 n_steps=args.steps, dtype=dtype, device=dev)

    print(f"# 2D Ising {args.method}  chi={args.chi}  steps={args.steps}")
    print(f"# {'beta':>7} {'lnZ/N':>12} {'u':>10} {'c_v':>10} "
          f"{'err(lnZ)':>9} {'err(u)':>9} {'err(c_v)':>9}")
    betas = np.linspace(args.bmin, args.bmax, args.points)
    if args.vmap:
        batch = torch.func.vmap(lambda b: torch.stack(obs(b)))(
            torch.tensor(betas, dtype=dtype, device=dev))
        results = [(float(b), *row) for b, row in
                   zip(betas, batch.cpu().tolist())]
    else:
        results = [(float(b), *(float(x) for x in obs(float(b))))
                   for b in betas]

    rows = []
    with JsonlLogger(args.log) as log:
        for b, lnz, u, cv in results:
            lnz_e, u_e, cv_e = onsager_observables(b, dev)
            errs = (abs(lnz - lnz_e), abs(u - u_e), abs(cv - cv_e))
            print(f"  {b:7.4f} {lnz:12.8f} {u:10.6f} "
                  f"{cv:10.6f} {errs[0]:9.1e} "
                  f"{errs[1]:9.1e} {errs[2]:9.1e}")
            log.log("ising2d", beta=b, lnz=lnz, u=u, cv=cv)
            rows.append({"beta": b, "lnz": lnz, "u": u, "cv": cv,
                         "onsager": [lnz_e, u_e, cv_e],
                         "abs_err": list(errs)})
    return {"rows": rows}


if __name__ == "__main__":
    main()
