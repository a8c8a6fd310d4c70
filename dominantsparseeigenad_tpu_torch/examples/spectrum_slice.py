"""Interior spectrum workflow: a KPM density-of-states scan, then a
differentiable polynomial slice of the TFIM excitation band (float64);
the counterpart of ``examples/spectrum_slice.py``.

The cheap stochastic DOS locates the spectral gaps; ``spectral_slice``
then extracts every eigenpair in the chosen window with its derivatives
(the interior-block deflated-MINRES rule).  For n <= 10 the driver
checks itself against dense ED (the state count, the band energies rtol
1e-8, the centroid's derivative against a central difference rtol 1e-5)
and exits with an error on a miss.

Run: python -m dominantsparseeigenad_tpu_torch.examples.spectrum_slice --n 10 --g 0.3
"""

import argparse

import numpy as np
import torch

from ..models import tfim_dense_hamiltonian, tfim_operator
from ..ops import (dominant_eigh, resolve_device, spectral_bounds,
                   spectral_density, spectral_slice)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--g", type=float, default=0.3)
    ap.add_argument("--r", type=int, default=14)
    ap.add_argument("--degree", type=int, default=200)
    ap.add_argument("--dos-points", type=int, default=40)
    ap.add_argument("--maxiter", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    f64 = torch.float64

    n, g = args.n, args.g
    op = tfim_operator(n, g, device=dev)

    # 1. The cheap DOS scan: where do the states live?
    lo, hi = (float(x) for x in spectral_bounds(op, device=dev))
    es = torch.linspace(lo * 0.98, hi * 0.98, args.dos_points, dtype=f64,
                        device=dev)
    rho = spectral_density(op, es, degree=100, n_probe=16, bounds=(lo, hi),
                           device=dev)
    peak = float(es[int(torch.argmax(rho))])
    print(f"TFIM n={n} g={g}: spectrum in [{lo:.2f}, {hi:.2f}], "
          f"DOS peak near E={peak:.2f}")

    # 2. Slice the single-flip excitation band (the first cluster above
    # the ground doublet).  The window is anchored to the solver's own
    # E0; the offsets put both edges inside the weak-field spectral gaps
    # (the 2.9-wide gap above the doublet, and the gap after the lower
    # half of the band at ~E0 + 3.37 for g = 0.3).
    e0, _ = dominant_eigh(op, k=80, extreme="min", tol=1e-10, device=dev)
    e0 = float(e0)
    lo_e, hi_e = e0 + 1.5, e0 + 3.37

    # 3. The band centroid and its derivative in the transverse field.
    gv = torch.tensor(g, dtype=f64, device=dev, requires_grad=True)
    lams, _, info = spectral_slice(
        tfim_operator(n, gv, device=dev), lo_e, hi_e, r=args.r,
        degree=args.degree, maxiter=args.maxiter, tol=1e-9, device=dev)
    msk = (lams >= lo_e) & (lams <= hi_e)
    c = torch.where(msk, lams, torch.zeros_like(lams)).sum() \
        / torch.clamp(msk.sum(), min=1)
    dc, = torch.autograd.grad(c, gv)
    lams = lams.detach().cpu().numpy()
    inside = (lams >= lo_e) & (lams <= hi_e)
    print(f"slice [{lo_e:.2f}, {hi_e:.2f}]: {int(info.n_inside)} states, "
          f"max residual {float(info.residual):.2e}, "
          f"converged={bool(info.converged)}")
    print("  band energies:", lams[inside].round(6))
    print(f"  band centroid {c.item():.8f}, d(centroid)/dg = "
          f"{float(dc):.8f}")
    out = {"bounds": [lo, hi], "dos_peak": peak, "e0": e0,
           "window": [lo_e, hi_e], "n_inside": int(info.n_inside),
           "residual": float(info.residual),
           "band": np.sort(lams[inside]).tolist(), "centroid": c.item(),
           "dcentroid_dg": float(dc)}

    if n <= 10:  # dense oracle
        def band(gg):
            e = torch.linalg.eigvalsh(
                tfim_dense_hamiltonian(n, gg, device=dev)).cpu().numpy()
            return e[(e >= lo_e) & (e <= hi_e)]

        truth = band(g)
        eps = 1e-5
        fd = (band(g + eps).mean() - band(g - eps).mean()) / (2 * eps)
        out.update(dense_band=truth.tolist(), fd=fd)
        if int(info.n_inside) != len(truth):
            raise SystemExit(f"SLICE FAILURE: {int(info.n_inside)} states "
                             f"inside, dense ED has {len(truth)}")
        if np.any(np.abs(np.sort(lams[inside]) - truth)
                  > 1e-8 * np.abs(truth)):
            raise SystemExit("BAND PARITY FAILURE vs dense ED")
        if abs(float(dc) - fd) > 1e-5 * abs(fd):
            raise SystemExit(f"GRADIENT PARITY FAILURE: d(centroid)/dg "
                             f"{float(dc)} vs FD {fd}")
        print(f"  checked vs dense ED (band rtol 1e-8, FD {fd:.8f})")
    return out


if __name__ == "__main__":
    main()
