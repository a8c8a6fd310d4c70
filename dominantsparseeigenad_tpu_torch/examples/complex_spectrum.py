"""Complex transfer-spectrum driver: incommensurate (oscillating)
correlations from a real non-symmetric operator, by
``dominant_eig_spectrum`` (float64); the counterpart of
``examples/complex_spectrum.py``.

A complex pair lam = |lam| e^{+-i theta} below the dominant eigenvalue
means correlations decay as ``(|lam|/lam_1)^x cos(theta x)``: a decay
length and a modulation wavelength 2 pi / theta.  The driver builds a
minimal non-reversible transfer operator whose bias rotates the
sub-dominant pair, extracts the top-m mixed real/complex spectrum,
reports xi = 1/ln(lam_1/|lam_2|) and the wavelength, and differentiates
the phase theta(bias) through the fixed-structure cascade (exactly 1).
It exits with an error if the gradient misses 1 by more than 1e-6 or
the spectrum misses numpy's ``eigvals`` (rtol 1e-6).

Run: python -m dominantsparseeigenad_tpu_torch.examples.complex_spectrum --n 64 --m 5
"""

import argparse

import numpy as np
import torch

from ..ops import dominant_eig_spectrum, resolve_device


def biased_transfer(n: int, bias, seed=0, device=None):
    """A non-reversible transfer operator with well-separated moduli: a
    real Perron root 2 above a block that ``bias`` rotates into the
    complex pair 1.5 e^{+-i bias} (two real eigenvalues at bias = 0), the
    level 1.05 and a bulk 0.6 U(0, 1), in a random orthogonal basis.
    ``bias`` may be a tensor (the operator is differentiable in it)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    blk = np.zeros((n, n))
    blk[0, 0] = 2.0                                   # Perron root
    blk[3, 3] = 1.05                                  # next real level
    blk[4:, 4:] = np.diag(0.6 * rng.random(n - 4))
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    b = torch.as_tensor(bias, dtype=torch.float64, device=dev)
    c, s = torch.cos(b), torch.sin(b)
    sub = 1.5 * torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    a = torch.tensor(blk, device=dev)
    a = torch.cat([a[:1], torch.cat([a[1:3, :1], sub, a[1:3, 3:]], dim=1),
                   a[3:]])
    qt = torch.tensor(q, device=dev)
    return qt @ a @ qt.T


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--m", type=int, default=5)
    ap.add_argument("--bias", type=float, default=0.25)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    a = biased_transfer(args.n, args.bias, device=dev)
    lams, _, _, structure = dominant_eig_spectrum(
        a, m=args.m, num_iters=1500, power_tol=1e-12, device=dev)
    print(f"stage structure: {structure}")
    w = np.linalg.eigvals(a.cpu().numpy())
    # lams can carry m+1 entries when the m-th slot lands on the first
    # member of a conjugate pair (the solver never splits a pair).
    lams = lams.cpu().numpy().astype(complex)
    m_got = len(lams)
    w = w[np.argsort(-np.abs(w))][:m_got]
    for j in range(m_got):
        lam, ref = lams[j], w[j]
        print(f"lam_{j} = {lam.real:+.6f}{lam.imag:+.6f}i  |lam| = "
              f"{abs(lam):.6f}  (numpy {ref.real:+.6f}{ref.imag:+.6f}i)")
    lam1, lam2 = lams[0], lams[1]
    xi = 1.0 / np.log(abs(lam1) / abs(lam2))
    print(f"correlation length xi = {xi:.4f}")
    wavelength = None
    if abs(lam2.imag) > 1e-10:
        wavelength = 2 * np.pi / abs(np.angle(lam2))
        print(f"modulation wavelength 2*pi/arg(lam2) = {wavelength:.4f} "
              f"sites")

    # The modulation phase differentiated through the fixed structure
    # (theta(bias) = bias by construction, so the gradient is exactly 1).
    b0 = torch.tensor(args.bias, dtype=torch.float64, device=dev,
                      requires_grad=True)
    lams_b, _, _, _ = dominant_eig_spectrum(
        biased_transfer(args.n, b0, device=dev), m=args.m, num_iters=1500,
        power_tol=1e-12, structure=structure, device=dev)
    theta = torch.atan2(torch.abs(lams_b[1].imag), lams_b[1].real)
    g, = torch.autograd.grad(theta, b0)
    g = float(g)
    print(f"d(theta)/d(bias) = {g:+.8f}  (exact +1)")
    out = {"structure": list(structure),
           "lams": [[x.real, x.imag] for x in lams],
           "numpy": [[x.real, x.imag] for x in w], "xi": xi,
           "wavelength": wavelength, "dtheta_dbias": g}
    if abs(g - 1.0) > 1e-6:
        raise SystemExit("GRADIENT PARITY FAILURE vs exact d(theta)/db")
    if not np.allclose(np.sort_complex(lams), np.sort_complex(w),
                       rtol=1e-6):
        raise SystemExit("SPECTRUM PARITY FAILURE vs numpy")
    return out


if __name__ == "__main__":
    main()
