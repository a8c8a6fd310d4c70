"""Dynamic structure factor of the TFIM by differentiable resolvent
solves, the counterpart of ``examples/spectral.py`` (float64).

Computes S(omega) = -(1/pi) Im <psi0| O (omega+E0+i eta - H)^{-1} O |psi0>
for the transverse probe O = sum_i sigma^x_i on the matrix-free
Hamiltonian: one batched real CG over the frequencies.

Run: python -m dominantsparseeigenad_tpu_torch.examples.spectral --n 12 --points 25
"""

import argparse

import torch

from ..models import flip_sum, tfim_operator
from ..ops import dominant_eigh, resolve_device, spectral_function
from ..utils import JsonlLogger


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--g", type=float, default=1.2)
    ap.add_argument("--eta", type=float, default=0.2)
    ap.add_argument("--points", type=int, default=25)
    ap.add_argument("--wmax", type=float, default=12.0)
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    op = tfim_operator(args.n, args.g, device=dev)
    e0, psi0 = dominant_eigh(op, k=min(150, 1 << args.n), extreme="min",
                             tol=1e-10, device=dev)
    probe = flip_sum(psi0, args.n)          # sum_i sx_i |psi0>
    # Frequencies measured from the ground state: omega_abs = E0 + omega.
    omegas = e0 + torch.linspace(0.0, args.wmax, args.points,
                                 dtype=torch.float64, device=dev)
    s = spectral_function(op, probe, omegas, args.eta, tol=1e-10,
                          device=dev)

    rows = []
    print(f"# TFIM N={args.n} g={args.g}: S(omega) for O = sum sx_i  "
          f"(eta={args.eta})")
    print(f"# {'omega-E0':>9} {'S(omega)':>12}")
    with JsonlLogger(args.log) as log:
        for w, sv in zip(omegas.tolist(), s.tolist()):
            rel = w - float(e0)
            print(f"  {rel:9.4f} {sv:12.6f}")
            log.log("spectral", omega=rel, s=sv)
            rows.append({"omega": rel, "s": sv})
    return {"n": args.n, "g": args.g, "e0": float(e0), "rows": rows}


if __name__ == "__main__":
    main()
