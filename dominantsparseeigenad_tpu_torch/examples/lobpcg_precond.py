"""Preconditioned block eigensolve of the TFIM with LOBPCG, the
counterpart of ``examples/lobpcg_precond.py`` (float64).

In the weak-field regime the TFIM Hamiltonian is diagonally dominant in
the z basis, so the Jacobi preconditioner ``z = r / (H_zz - sigma)``
approximates ``(H - sigma)^{-1}`` well and cuts LOBPCG's iterations
several-fold.  The same ``precond`` also serves the deflated tangent
solves of the derivative rule, so dE0/dg reuses it.  For n <= 12 the
driver checks itself against dense ED (eigenvalues rtol 1e-8, dE0/dg
against a central difference rtol 1e-6) and exits with an error on a
miss.

Run: python -m dominantsparseeigenad_tpu_torch.examples.lobpcg_precond --n 12 --g 0.2
"""

import argparse

import numpy as np
import torch

from ..models import tfim_dense_hamiltonian, tfim_operator, tfim_zz_diagonal
from ..ops import (dominant_eigh_multi, jacobi_precond, lobpcg_eigh,
                   resolve_device)


def _close(a, b, rtol) -> bool:
    return bool(np.all(np.abs(np.asarray(a) - np.asarray(b))
                       <= rtol * np.abs(np.asarray(b))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--g", type=float, default=0.2)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--maxiter", type=int, default=400)
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    f64 = torch.float64

    n, g, r = args.n, args.g, args.r
    op = tfim_operator(n, g, device=dev)
    # The TFIM operator is matrix-free, so its analytic diagonal (the zz
    # term) is passed explicitly; the shift sits below the spectrum
    # (min(H_zz) minus the field-strength bound).  One callable serves
    # the block solver, the tangent solves and the multi wrapper below.
    diag = tfim_zz_diagonal(n, device=dev)
    precond = jacobi_precond(diag=diag,
                             shift=float(torch.min(diag)) - abs(g) * n)

    lams_p, _, info_p = lobpcg_eigh(op, r, tol=args.tol,
                                    maxiter=args.maxiter, precond=precond,
                                    with_info=True, device=dev)
    lams_0, _, info_0 = lobpcg_eigh(op, r, tol=args.tol,
                                    maxiter=args.maxiter, with_info=True,
                                    device=dev)
    print(f"TFIM n={n} g={g}: lowest {r} eigenvalues")
    print("  preconditioned:", lams_p.cpu().numpy(),
          f"({int(info_p.iterations)} iters, converged="
          f"{bool(info_p.converged)})")
    print("  plain:         ", lams_0.cpu().numpy(),
          f"({int(info_0.iterations)} iters, converged="
          f"{bool(info_0.converged)})")

    # The differentiable ground energy through the preconditioned solver
    # (in the ordered phase the E1-E0 doublet splitting is exponentially
    # small: a good preconditioning demo, a hopeless FD target, so the
    # derivative check is on E0).
    gv = torch.tensor(g, dtype=f64, device=dev, requires_grad=True)
    ls, _ = dominant_eigh_multi(tfim_operator(n, gv, device=dev), r=2,
                                k=args.maxiter, method="lobpcg",
                                tol=args.tol, precond=precond, device=dev)
    de0, = torch.autograd.grad(ls[0], gv)
    e0_val, de0 = ls[0].item(), de0.item()
    split = (lams_p[1] - lams_p[0]).item()
    print(f"  E0 = {e0_val:.12f}, dE0/dg = {de0:.10f}, "
          f"doublet splitting = {split:.3e}")
    out = {"lams_precond": lams_p.tolist(), "lams_plain": lams_0.tolist(),
           "iters_precond": int(info_p.iterations),
           "iters_plain": int(info_0.iterations), "e0": e0_val,
           "de0_dg": de0, "doublet_splitting": split}

    if n <= 12:  # dense oracle
        def lowest(gg):
            return torch.linalg.eigvalsh(
                tfim_dense_hamiltonian(n, gg, device=dev)).cpu().numpy()

        ew = lowest(g)
        eps = 1e-5
        fd = (lowest(g + eps)[0] - lowest(g - eps)[0]) / (2 * eps)
        out.update(dense=ew[:r].tolist(), fd=fd)
        if not _close(lams_p.cpu().numpy(), ew[:r], 1e-8):
            raise SystemExit(f"EIGENVALUE PARITY FAILURE vs dense ED: "
                             f"{lams_p.tolist()} vs {ew[:r].tolist()}")
        if not _close(de0, fd, 1e-6):
            raise SystemExit(f"GRADIENT PARITY FAILURE: dE0/dg {de0} vs "
                             f"FD {fd}")
        print(f"  checked vs dense ED (eigenvalues rtol 1e-8, "
              f"dE0/dg vs FD {fd:.10f})")
    return out


if __name__ == "__main__":
    main()
