"""Vibrational normal modes of a mass-spring chain: the generalized
pencil ``K x = omega^2 M x`` by the differentiable B-metric LOBPCG
solver, with the sensitivities d(omega^2)/dm (float64); the counterpart
of ``examples/vibrational_modes.py``.

The preconditioner for the low modes is the static stiffness solve
``K^{-1}`` (Jacobi is useless on a Laplacian-like K).  For n <= 200 the
driver checks itself against ``scipy.linalg.eigh(K, M)`` (rtol 1e-9)
and the sensitivity against a central difference (rtol 1e-5), and exits
with an error on a miss.

Run: python -m dominantsparseeigenad_tpu_torch.examples.vibrational_modes --n 150
"""

import argparse

import numpy as np
import torch

from ..ops import DenseOperator, dominant_eigh_gen, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=150)
    ap.add_argument("--r", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, r = args.n, args.r
    rng = np.random.default_rng(0)
    # A fixed-end chain: spring constants k_i, masses m_i.
    ks = 1.0 + rng.random(n + 1)
    kmat = (np.diag(ks[:-1] + ks[1:]) - np.diag(ks[1:-1], 1)
            - np.diag(ks[1:-1], -1))
    masses = 0.5 + rng.random(n)
    kt = torch.tensor(kmat, device=dev)
    kinv = torch.tensor(np.linalg.inv(kmat), device=dev)

    mj = torch.tensor(masses, device=dev, requires_grad=True)
    lams, _, info = dominant_eigh_gen(
        DenseOperator(kt), DenseOperator(torch.diag(mj)), r=r,
        maxiter=args.maxiter, tol=1e-12, precond=lambda v: kinv @ v,
        with_info=True, device=dev)
    omega2 = lams.detach().cpu().numpy()
    print(f"chain n={n}: lowest {r} omega^2 =", omega2,
          f"({int(info.effective_k)} LOBPCG iters, "
          f"converged={bool(info.converged)})")
    print("  frequencies omega =", np.sqrt(omega2))

    # The sensitivity of the fundamental to every mass (one reverse pass).
    grad, = torch.autograd.grad(lams[0], mj)
    j_star = int(torch.argmin(grad))
    g_star = float(grad[j_star])
    print(f"  d(omega0^2)/dm peaks at site {j_star} "
          f"(value {g_star:.3e}) — the fundamental's antinode")
    out = {"omega2": omega2.tolist(), "iterations": int(info.effective_k),
           "converged": bool(info.converged), "site": j_star,
           "grad": g_star}

    if n <= 200:  # oracle
        import scipy.linalg
        ew = scipy.linalg.eigh(kmat, np.diag(masses), eigvals_only=True)
        eps = 1e-4
        mp, mm = masses.copy(), masses.copy()
        mp[j_star] += eps
        mm[j_star] -= eps
        fd = (scipy.linalg.eigh(kmat, np.diag(mp), eigvals_only=True)[0]
              - scipy.linalg.eigh(kmat, np.diag(mm),
                                  eigvals_only=True)[0]) / (2 * eps)
        out.update(scipy=ew[:r].tolist(), fd=fd)
        if np.any(np.abs(omega2 - ew[:r]) > 1e-9 * np.abs(ew[:r])):
            raise SystemExit(f"EIGENVALUE PARITY FAILURE vs scipy: "
                             f"{omega2.tolist()} vs {ew[:r].tolist()}")
        if abs(g_star - fd) > 1e-5 * abs(fd):
            raise SystemExit(f"SENSITIVITY PARITY FAILURE: {g_star} vs FD "
                             f"{fd}")
        print(f"  checked vs scipy.linalg.eigh (values rtol 1e-9, "
              f"sensitivity vs FD {fd:.3e})")
    return out


if __name__ == "__main__":
    main()
