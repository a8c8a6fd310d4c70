#!/usr/bin/env python3
"""The JAX package's own errors on the inputs of ``chip_smoke.py``'s
``complex`` phase, on a CPU.

    python3 tools/jax_complex_errors.py [dense] [spectrum] [eig]

Runs the JAX reference package (not the PyTorch port) on the CPU, in
float64 and complex128, on the very inputs the card's ``complex`` phase
builds (``chip_smoke.complex_hermitian_input``, ``biased_transfer_input``
and ``complex_nonsymmetric_input``, numpy and seeded), at its settings:

* ``dense``: the n = 4096 complex Hermitian matrix.  ``dominant_eigh``
  (k = 100, CG tol 1e-12): λ against ``numpy.linalg.eigh``, 1 - |<v, v*>|,
  the dot-product identity of the gradient of ``λ + Re<c, v>`` against
  its forward-mode derivative along D (relative to ||G|| ||D||), and the
  gradient of the phase-sensitive ``Im v[5] + Re v[3]`` against a central
  difference (ε = 1e-5); LOBPCG (r = 8, at most 100 iterations): the
  eigenvalues against eigh.
* ``spectrum``: the biased transfer operator, n = 2048: the structure and
  values of ``dominant_eig_spectrum(m=5)`` against ``numpy.linalg.eigvals``
  and d arg λ₂ / db against its exact value 1.
* ``eig``: the complex non-symmetric matrix, n = 2048: λ of
  ``dominant_eig`` against eigvals, and the gradients of ``|λ|² +
  |Σ w r|² + |Σ w l|²`` by BiCGStab, GMRES and CGNR against each other.

It prints one JSON line per case with the values, the errors and the
seconds taken, compile included.  The card's bars in ``chip_smoke.py``
are set from these errors (about 8 times each).  A CPU run: no device
number.
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import dominantsparseeigenad_tpu as jx  # noqa: E402


def dense():
    n, r, k, seed = cs.CX_DENSE
    t0 = time.perf_counter()
    h, d, c = cs.complex_hermitian_input(n, seed)
    w_all, v_all = np.linalg.eigh(h)
    hj, dj, cj = (jnp.asarray(x) for x in (h, d, c))

    def solve(a):
        return jx.dominant_eigh(a, k=k, tol=cs.CX_TOL)

    def loss(a):
        lam, v = solve(a)
        return lam + jnp.real(jnp.vdot(cj, v))

    (lam, v), grad = jax.jit(lambda a: (solve(a), jax.grad(loss)(a)))(hj)
    _, dl = jax.jit(lambda a, t: jax.jvp(loss, (a,), (t,)))(hj, dj)
    g = np.asarray(grad)
    gd = float(np.real(np.sum(g * d)))   # JAX's cotangent: no conj
    dot = abs(gd - float(dl)) / (np.linalg.norm(g) * np.linalg.norm(d))

    def comp(t):
        v = solve(hj + t * dj)[1]
        return jnp.imag(v[5]) + jnp.real(v[3])

    comp_j = jax.jit(comp)
    g_comp = float(jax.jit(jax.grad(comp))(0.0))
    eps = cs.CX_FD_EPS
    fd = (float(comp_j(eps)) - float(comp_j(-eps))) / (2 * eps)
    lams, _, info = jax.jit(lambda a: jx.dominant_eigh_multi(
        a, r=r, k=k, method="lobpcg", tol=cs.CX_TOL, with_info=True))(hj)
    lams = np.asarray(lams)
    return {"case": "dense", "n": n, "lam": float(lam),
            "lam_eigh": float(w_all[0]),
            "lam_rel": abs(float(lam) - w_all[0]) / abs(w_all[0]),
            "overlap_defect": 1.0 - abs(np.vdot(v_all[:, 0], np.asarray(v))),
            "dot_rel": dot, "phase_grad": g_comp, "phase_fd": fd,
            "phase_grad_vs_fd_rel": abs(g_comp - fd) / abs(fd),
            "lobpcg_rel": float(np.max(np.abs(lams - w_all[:r])
                                       / np.abs(w_all[:r]))),
            "lobpcg_iterations": float(info.effective_k),
            "lobpcg_residual": float(info.residual),
            "seconds": time.perf_counter() - t0}


def spectrum():
    n, m, bias, iters = cs.CX_SPECTRUM
    t0 = time.perf_counter()
    blk, q = cs.biased_transfer_input(n)

    def a_of(b):
        c, s = jnp.cos(b), jnp.sin(b)
        a = jnp.asarray(blk).at[1:3, 1:3].set(
            1.5 * jnp.array([[c, -s], [s, c]]))
        return jnp.asarray(q) @ a @ jnp.asarray(q.T)

    a = a_of(jnp.float64(bias))
    lams, _, _, structure = jx.dominant_eig_spectrum(
        a, m=m, num_iters=iters, power_tol=1e-12)
    got = np.asarray(lams)
    w = np.linalg.eigvals(np.asarray(a))
    w = w[np.argsort(-np.abs(w))][:got.size]
    errs = np.abs(np.sort_complex(got) - np.sort_complex(w)) / np.abs(
        np.sort_complex(w))

    def phase(b):
        lam2 = jx.dominant_eig_spectrum(a_of(b), m=m, num_iters=iters,
                                        power_tol=1e-12,
                                        structure=structure)[0][1]
        return jnp.arctan2(jnp.abs(jnp.imag(lam2)), jnp.real(lam2))

    g = float(jax.grad(phase)(jnp.float64(bias)))
    return {"case": "spectrum", "n": n, "m": m, "structure": structure,
            "lams": [[z.real, z.imag] for z in got.tolist()],
            "rel_err_vs_eigvals": errs.tolist(), "dtheta_db": g,
            "dtheta_db_err": abs(g - 1.0),
            "seconds": time.perf_counter() - t0}


def eig():
    n, seed = cs.CX_EIG
    t0 = time.perf_counter()
    a, wv = cs.complex_nonsymmetric_input(n, seed)
    aj, wj = jnp.asarray(a), jnp.asarray(wv)
    w = np.linalg.eigvals(a)
    lam_ref = w[np.argmax(np.abs(w))]
    grads = {}
    for solver in ("bicgstab", "gmres", "cgnr"):
        def loss(x, solver=solver):
            lam, l, r = jx.dominant_eig(x, solver=solver)
            return (jnp.abs(lam) ** 2 + jnp.abs(jnp.sum(wj * r)) ** 2
                    + jnp.abs(jnp.sum(wj * l)) ** 2)

        grads[solver] = np.asarray(jax.jit(jax.grad(loss))(aj))
    lam = complex(jax.jit(lambda x: jx.dominant_eig(x)[0])(aj))
    base = grads["bicgstab"]
    diff = {s: float(np.linalg.norm(g - base) / np.linalg.norm(base))
            for s, g in grads.items() if s != "bicgstab"}
    diff["gmres_vs_cgnr"] = float(np.linalg.norm(grads["gmres"]
                                                 - grads["cgnr"])
                                  / np.linalg.norm(base))
    return {"case": "eig", "n": n, "lam": [lam.real, lam.imag],
            "lam_rel": abs(lam - lam_ref) / abs(lam_ref),
            "grad_rel_to_bicgstab": diff,
            "seconds": time.perf_counter() - t0}


def main():
    cases = {"dense": dense, "spectrum": spectrum, "eig": eig}
    for name in sys.argv[1:] or list(cases):
        print(json.dumps(cases[name]()), flush=True)


if __name__ == "__main__":
    main()
