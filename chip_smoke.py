#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``).  It imports nothing of JAX.  Phases, one JSON
line each:

1. ``build``: compiles ``csrc/bell_spmv.cu`` and ``csrc/bell_spmm.cu``
   with nvcc (one process each, started together; timed), reads the
   card's name and power limit, measures the device-to-device copy rate.
2. ``spmv``: the blocked-ELL kernel against its plain PyTorch version, in
   float32 and bfloat16 values, at the BASELINE config-#5 shape (n = 2^19,
   bs = 128, 17 blocks per row) and at small odd shapes; then the same
   kernel in its banded mode (K4b, the operator's slot plan: every slot a
   ring band) against the plain banded version and against the gather
   mode on the same inputs (equal bit for bit); kernel (gather and banded
   timed in turns), plain, bound and library (cuSPARSE BSR, float32 only)
   times.
3. ``eigh``: the main path at the config-#5 shape, on the operator as the
   JAX package builds it (banded slot plan).  ``dominant_eigh`` with
   k = 100 and the gradient of ``λ + Σ c⊙v`` with respect to the stored
   values, on float32 values and on bfloat16 values; the twin solves (the
   same operators with ``slot_plan=None``, the gather kernels, forwards
   from the same start: λ equal bit for bit); one forward-mode tangent of
   λ for random dvals (``torch.autograd.forward_ad``); the launch counts
   of that run; then the checks (λ against a plain-SpMV solve from the
   same start vector, ∂λ/∂vals against v⊗v on the pattern, a dot-product
   test of the full gradient against the forward IFT tangent, the
   forward-mode dλ against ⟨dvals, ∂λ/∂vals⟩, the launches of each part).
   In the same counted run: the forward again with the float32
   basis and with the bfloat16 basis and ``reorth_chunks=4`` (the time and
   the peak memory each adds; the bf16 Ritz value against the float32 λ,
   the polished pair's λ and Ritz residual; the extra peak below the size
   of a float32 basis: no float32 copy made), the gradient with
   ``precond=jacobi_precond(op, shift=λ)`` (its CG's iterations, time and
   dot-product identity beside the plain one's), and MINRES against CG
   on one definite deflated system (shift λ - 1); then the block-Jacobi
   build (4096 batched ``eigh``s of 128 x 128) and one apply, timed.
4. ``spmm``: the blocked-ELL SpMM kernel against its plain version and
   against r chained SpMV launches, float32 and bfloat16 values, at
   config #5 with r = 8 and r = 4, and at small odd shapes (r = 8; r = 3
   with an X that is not 16-byte aligned); then its banded mode as in
   ``spmv``; kernel, plain, chained-SpMV, bound and library (cuSPARSE BSR,
   float32 only) times.
5. ``eigh_multi``: the block path at the config-#5 shape, banded.
   ``dominant_eigh_multi`` with r = 8, LOBPCG capped at 100 iterations,
   and the gradient of ``Σ c_i λ_i + <C, V>`` with the backward's batched
   CG capped at 1000 iterations, on float32 values; a bfloat16-values
   LOBPCG forward; the twin LOBPCG forwards on the gather kernels (the 8 λ
   equal bit for bit); a Lanczos forward with its info residual; the
   launch counts of that run; then the checks (launch counts against the
   iterations, the pairs against an independent SpMV, ∂Σλ/∂vals against
   Σ v_i⊗v_i on the pattern, a dot-product test of the full gradient
   against the forward block IFT tangent, bf16 against f32 eigenvalues).
6. ``panel``: the same two kernels on rectangular row panels (K4a), the
   block-rows one rank of a p = 2 and a p = 4 sharding of config #5 keeps
   (2048 and 1024 block-rows against all 4096 block-columns), SpMV and
   SpMM (r = 8), float32 and bfloat16 values: against the plain version
   and against the matching rows of the square product (expected equal
   bit for bit); kernel, plain, bound and library (cuSPARSE BSR on the
   panel, float32 only) times.
7. ``sharded``: the row-sharded tier, two ranks sharing the one card over
   a gloo group (NCCL refuses two ranks on one card), spawned after the
   kernel library is built.  Each rank builds config #5 from the same
   seed, keeps its panel (``RowShardedBellOperator``, gather kernels: a
   panel binds no slot plan) and runs ``dominant_eigh`` (k = 100) with
   the gradient of ``λ + Σ c⊙v`` (CG capped at 1000),
   ``dominant_eigh_multi`` (LOBPCG, r = 8, capped at 100 iterations) with
   ∂Σλ, and bfloat16-values forwards of both, counted; then the checks
   (the ranks' λ equal bit for bit, λ against the unsharded solve from
   the same start, the gradients against v⊗v on the panel's pattern and
   by the dot-product identity, panel launches against the products the
   solvers made, bf16 against f32).  Its times are those of two ranks
   sharing one card over gloo, not a multi-GPU number.
8. ``tfim``: the paper's flagship at the bench's headline settings
   (``bench.py:36-43``, ``:87-91``): the matrix-free TFIM at N = 20,
   g = 1.2, f32, ``dominant_eigh`` with k = 60, one reorthogonalization
   pass, CG tol 1e-5 and at most 150 iterations, and one forward-mode
   pass giving E0, dE0/dg and χ_F, against the Jordan-Wigner closed
   forms: with the bench's bfloat16 basis and ``reorth_chunks=4``, and
   with the float32 basis as its twin (each pass timed twice, with the
   peak memory it adds); the plain forward's time, the Lanczos step in
   restart mode "cond" (a host read of β per step) and "carry" (none),
   with either basis; the tangent's CG time and iterations without and
   with a Jacobi preconditioner on H's diagonal (the zz term); the same
   pass at N = 10 against a dense ``torch.linalg.eigh`` (ED) in float64.
9. ``sweep``: ``tfim_observables_sweep`` at the bench's sweep tier
   (``bench.py:113-120``): N = 20, 8 couplings in [1.1, 1.45], k = 60,
   the bfloat16 basis, 8 chunks, restart mode "carry"; each point's E0,
   dE0/dg and χ_F against Jordan-Wigner at the ``tfim`` bars; the whole
   time and the time per point, twice.

10. ``second_order``: derivatives of the second order through the IFT
   rules, and forward mode of the block solver.  (a) ``energy_curvature``
   of the TFIM at N = 20, g = 1.2, f32, k = 60 (CG tol 1e-5, at most 150
   iterations): E0, dE0/dg and d²E0/dg² against the Jordan-Wigner closed
   forms, the reverse route timed as its forward, first backward
   (``create_graph``) and second backward, the second backward's solve
   re-run for its iterations and residual; ``energy_curvature`` itself
   (a jvp of a jvp) against that route (E equal, the rest 1e-4).
   (b) config #5 as a user's sparse
   Hamiltonian with one coupling, H(g) = A0 + g A1 over two banded
   operators (every product two K4b SpMVs), ``energy_curvature`` at
   k = 100 with the CG capped at 3000: the launches of each step against
   2 k, 2 and 2 (CG iterations + 1); dE/dg against v^T A1 v; and, since
   the capped CG does not converge there, exact identities on the one
   solve the second backward runs (recorded as it runs): its right-hand
   side against the rule's, its x reproduced by the same CG, d²E/dg²
   against <P x, A1 v>; peak memory, and the time of the plain transposed
   product the second backward runs on the card.  (c) config #5,
   ``dominant_eigh_multi`` (LOBPCG, r = 8, capped at 100) in forward mode
   along random dvals with its tangent CG capped at 300: dΣλ against
   <dvals, Σ v_i⊗v_i> on the pattern, the SpMM launches against LOBPCG's,
   the tangent product and the CG's; then the Hessian-vector product of
   Σλ_i + ΣV⁴ along dvals at the small shape (n = 4096, bs = 32, r = 3,
   three spiked eigenvalues), kernel against plain banded SpMM.

11. ``forward_n``: forward mode to any order, the ``torch.func``
   transforms and ``vmap``.  (a) TFIM N = 20 (the ``tfim`` phase's
   settings): ``energy_curvature``, now a jvp of a jvp, against the
   Jordan-Wigner closed forms (2e-5 / 1e-3 / 5e-4), its d²E0/dg² against
   the reverse-over-reverse route of the same settings (1e-4), both
   timed, with the iterations of each deflated solve.  (b) The sweep at
   the bench's settings (4 of its couplings) by ``vmap`` of one jvp pass
   against the per-point loop of the same pass, in restart modes "cond"
   and "carry", each at the ``tfim`` bars and timed a point.  (c) Config
   #5's H(g) = A0 + g A1: one nested pass (its CGs capped at 3000, as the
   reverse route's; d² printed beside the reverse route's with the
   iterations of every solve, not gated), its K4b SpMV launches counted
   (> 0), dE/dg against the first-order jvp's (1e-6), its time beside the
   reverse route's.  (d) A small spiked shape (n = 4096, bs = 32, the
   inputs of ``tools/jax_forward_n_errors.py``): E, dE/dg and d²E/dg² by
   one nested pass against the float64 sum over states of its dense H,
   at ~8x the JAX package's own float32 CPU errors.  (e) ``vmap`` of a
   config-#5 matvec over 8 vectors: ``matmat`` bit for bit, exactly one
   ``bell_spmm_banded_f32`` launch and no SpMV; ``vmap`` of
   ``solve_deflated`` over 8 right-hand sides and shifts against the
   block solve (1e-5).  The card's name and power limit on the line.

12. ``ising2d``: BASELINE config #4, the 2D classical Ising model at
   β = 0.5 (``benchmarks/ising2d_bench.py:32-35``) against Onsager's
   ln Z, u = -d lnZ/dβ and c_v = β² d² lnZ/dβ² (the port's quadrature on
   the card, held against the JAX package's chip-test constants).  (a)
   TRG, chi = 30, 20 steps, float64, the gram split: forward, first
   backward (``create_graph``) and second backward timed apart, then
   ``ising_observables`` whole; one 900 x 900 float64 ``eigh_safe``
   timed.  (b) the same in float32 with the subspace split.  (c) the
   lanczos split (``dominant_svd``, the block IFT rule; its CG capped at
   1000 iterations), float64: ln Z and u against (a), every solve of the
   backward recorded; u is read only if every solve converged.  (d) CTMRG, chi = 30, 30 steps,
   float64, with the truncated and the lanczos corner solvers
   (``dominant_eigh_multi`` on the 60 x 60 corner): ln Z, u, c_v and
   their agreement.  Bars: ~8x the JAX package's own CPU errors
   (``tools/jax_ising2d_errors.py``).  This path launches no
   hand-written kernel (checked: the launch counts stay 0).

13. ``eig``: the non-symmetric solver (``dominant_eig``,
   ``dominant_eig_multi``), float64 unless stated.  (a) Config #4's
   transfer observables at chi = 30, 30 CTMRG steps: at β = 0.35
   ``correlation_length`` and dξ/dβ (forward and backward timed, with
   their matvecs and BiCGStab iterations and the peak memory) against
   Onsager's row-to-row ξ = 1 / (-ln tanh β - 2β), ξ against
   ``torch.linalg.eigvals`` of the same 1800 x 1800 transfer matrix, and
   d/dβ of ``transfer_spectral_gap`` against a central difference; at
   β = 0.5 (ordered) ξ > 100 and against eigvals, at chi = 30 and at
   chi = 10 (the JAX test's size).  Bars: ~8x the JAX package's own CPU
   errors (``tools/jax_transfer_errors.py``).  (b) A dense positive
   matrix, n = 2048, float64 and float32: λ against eigvals; the
   gradient of ``λ + <c_l, l> + <c_r, r>`` against the forward-mode
   derivative along a random D (dot-product identity, relative to
   ||G|| ||D||); the second derivative along D, in float64 against a
   central difference of the first, in float32 against the float64 one
   of the same inputs.
   (c) ``dominant_eig(method="arnoldi", arnoldi_k=64)`` on a
   non-symmetric BellOperator with positive values (n = 4096, bs = 32, 5
   ring bands; |λ2|/λ1 = 0.9964), float32: its report, both
   one-sided residuals, λ against a twin through the plain product,
   ∂λ/∂vals against l⊗r on the pattern; its matvecs run the banded SpMV
   kernel (K4b), counted (the counts join the ``kernels`` line).

14. ``complex``: complex operators through the solvers and derivative
   rules, at full width.  (a) The TFIM N = 20 headline (the ``tfim``
   phase's settings) in a complex gauge, H' = D H D^H with D = diag(e^{iφ})
   and φ from a seeded generator, a complex64 ``MatrixFreeOperator``
   around ``tfim_matvec``: complex Hermitian with the real spectrum, so
   E0, dE0/dg and χ_F (one forward-mode pass) must meet the ``tfim``
   phase's Jordan-Wigner bars; χ_F is gauge-invariant only if the rule's
   pivot-phase projection is right.  Its ground state against D ψ of the
   real pass (|<D ψ, ψ'>| >= 1 - 1e-5), and ``energy_curvature``'s
   d²E0/dg² at the ``second_order`` phase's bar.  (b) A dense complex
   Hermitian matrix, n = 4096, complex128 (ten spiked eigenvalues below a
   Gaussian bulk): ``dominant_eigh`` (k = 100) and the gradient of
   ``λ + Re<c, v>`` (CG tol 1e-12), held against ``torch.linalg.eigh``
   (an oracle in the check, not on the path), by the dot-product
   identity against the forward-mode derivative along a Hermitian D, and
   the phase-sensitive ``Im v[5] + Re v[3]``'s gradient against a central
   difference; ``dominant_eigh_multi`` by LOBPCG (r = 8).  (c)
   ``examples/complex_spectrum.py``'s biased transfer operator, n = 2048,
   float64: ``dominant_eig_spectrum(m=5)`` and ``spectrum_structure``
   against ``eigvals``, and d arg λ₂ / db = 1 (exact) through the replayed
   cascade.  (d) ``dominant_eig`` on a complex non-symmetric matrix,
   n = 2048, complex128: λ against eigvals, and the gradient of
   ``|λ|² + |Σ w r|² + |Σ w l|²`` by BiCGStab, GMRES and CGNR, each
   against the others.  Forward and backward times, peak memory and
   product counts; the card's name and power limit on the phase's line.
   Bars (b)-(d): ~8x the JAX package's own CPU errors on the same inputs
   (``tools/jax_complex_errors.py``).  This path launches no hand-written
   kernel (checked: the launch counts stay 0).

15. ``formats``: the COO, CSR and BCOO formats and the operator algebra.
   (a) The TFIM N = 20 as sparse matrices built from host COO triplets
   (the zz diagonal, 2^20 entries, and the transverse term, 20 · 2^20),
   H(g) = CSR_zz + (-g) CSR_x through ``SumOperator`` and
   ``ScaledOperator``, at the ``tfim`` phase's settings: E0 and dE0/dg
   (forward and backward timed, with the peak memory), dE0/dg by
   ``torch.func.jvp``, ``energy_curvature`` and ``fidelity_susceptibility``
   against the Jordan-Wigner closed forms at the ``tfim`` and
   ``second_order`` bars; E0 against the matrix-free run and the COO
   form's run; the COO, BCOO, matrix-free and cuSPARSE CSR matvecs
   against the CSR one; each matvec timed beside its least bytes over
   3.35 TB/s; whether ten CSR matvecs equal the first bit for bit
   (``index_add`` adds with atomics).  (b) Config #5 (the ``eigh``
   phase's operator and start vector) through the composites: each
   composite's ``matmat`` one ``bell_spmm_banded_f32`` launch a Bell
   child (no SpMV); ``dominant_eigh`` of A - σ and of c A against the
   ``eigh`` phase's λ; H(g) = A0 + g A1 by the algebra against the
   coupled ``MatrixFreeOperator`` route (dE/dg); LOBPCG (r = 8) on A - σ
   (1 + 2 x iterations SpMMs, no SpMV; λ against the Rayleigh
   quotients); ``operator_diagonal`` and ``jacobi_precond`` of A - σ.
   (c) ``dominant_eig`` of the ``eig`` phase's non-symmetric Bell and of
   its transpose: λ at that phase's bars, A.T's vectors A's swapped (by
   their residuals).  (d) Config #5 as one CSR (1.14e9 entries, built on
   the card from the Bell's values): its matvec against K4b, timed in
   turns with K4b and cuSPARSE CSR on the same arrays, with each one's
   bound and the peak memory.  Its K4b launches join the ``kernels``
   line.

16. ``restart``: thick-restart Lanczos.  (a) Config #5, the ``eigh``
   phase's operator and start vector: ``dominant_eigh`` with a window of
   k = 32 and 8 restart cycles, λ and ∂λ/∂vals; its K4b SpMV launches
   against 32 + 1 + 8 × 24 = 225 and one for ∂λ; λ against the plain
   k = 100 forward within the sum of the two Ritz residual norms (both
   printed), the peak memory of each (a 33-row window against a 101-row
   basis); ``restart_init``, 3 cycles, ``utils.save_pytree``,
   ``load_pytree`` into a fresh state, 5 more cycles: bit for bit the
   uninterrupted 8-cycle state.  (b) ``benchmarks/restart_bench.py``'s
   default cell, the matrix-free TFIM at N = 24, g = 1.2, f32, k = 32,
   8 cycles, one reorthogonalization pass, E0 and dE0/dg through
   ``dominant_eigh`` (run twice, timed) against Jordan-Wigner at that
   script's bars (rel 1e-4 / 1e-3).  (c) N = 27 (134M dimensions, a
   16.5 GiB window) by the cycle-stepped driver (``restart_init``,
   ``restart_cycle``, ``restart_extract``), dE0/dg by Hellmann-Feynman,
   the same bars; the time of each cycle, a matvec's, the peak memory.

17. ``gen``: the generalized pencil.  (a) Config #5's A with B = diag(m),
   m in [1, 2) from a seed, a ``MatrixFreeOperator`` in m:
   ``dominant_eigh_gen`` (r = 8, at most 100 LOBPCG iterations,
   preconditioner M^{-1}) and the gradient of Σ c_i λ_i + <C, X> in the
   values and in m (its pencil CG capped at 1000, recorded as it runs):
   the K4b SpMM launches against the iterations (1 + 2 a LOBPCG
   iteration, CG iterations + 1 for the backward), X^T B X = I within
   1e-5, the residual; against the standard problem D A D, D = M^{-1/2}
   by ``ComposedOperator``, unpreconditioned LOBPCG from M^{1/2} x0 (the
   routes' iterates correspond in exact arithmetic): λ and ∂Σλ/∂m (with
   the term an unconverged block leaves between the two rules).  (b)
   ``examples/vibrational_modes.py``'s chain (n = 150, r = 3, float64,
   K^{-1} preconditioner) against ``scipy.linalg.eigh(K, M)`` and
   d(ω0²)/dm against a central difference.  (c)
   ``dominant_eigh_multi(reorth_chunks=4)`` at config #5 against the
   unchunked run.  Both phases' K4b launches join the ``kernels`` line.

Then a ``kernels`` line, the ``nvidia-smi`` name and power-limit line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the exit code is not 0.  Without a CUDA device it exits with
code 1 before printing any result.
"""

import contextlib
import importlib
import json
import math
import os
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.multiprocessing

# Published H100 SXM peaks at the 700 W limit (NVIDIA data sheet):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

CONFIG5 = (1 << 19, 128, 17)          # n, bs, blocks per row
SMALL_SHAPES = ((4096, 32, 5), (4000, 20, 5))
K = 100
DEVICE = "cuda"
CG_TOL = 1e-6                          # clamped to 50 eps(f32) = 6e-6
CG_MAXITER = 3000
SPMM_SHAPES = ((CONFIG5, 8, False), (CONFIG5, 4, False),
               (SMALL_SHAPES[0], 8, False), (SMALL_SHAPES[1], 3, True))
MULTI_R = 8
LOBPCG_ITERS = 100
MULTI_CG_MAXITER = 1000
LANCZOS_K = 50
PANEL_SHARDS = (2, 4)                  # the panels of these shardings
PANEL_R = 8
SHARDED_RANKS = 2                      # ranks sharing the one card
SHARDED_CG_MAXITER = 1000
SHARDED_TIMEOUT_S = 600                # a rank's whole run
FWD_CG_MAXITER = 300                   # the forward-mode tangent's CG
# The bf16 basis's polish held against a float64 Newton step from the same
# Ritz pair: both CGs capped at this many iterations, where a float32 CG
# on the step's indefinite system still tracks a float64 one (at the full
# cap it does not; see the eigh phase).
POLISH_CHECK_MAXITER = 20
POLISH_CHECK_RTOL = 1e-6
# The TFIM headline (bench.py:36-43), f32, and its tolerances against the
# Jordan-Wigner closed forms (the JAX package's own f32 errors at these
# settings, on a CPU: 6.7e-7, 1.2e-4, 6.3e-4).
TFIM_N, TFIM_N_ED, TFIM_G, TFIM_K = 20, 10, 1.2, 60
TFIM_CG_TOL, TFIM_CG_MAXITER, TFIM_REORTH_PASSES = 1e-5, 150, 1
TFIM_RTOL = {"e0": 2e-5, "de0_dg": 1e-3, "chi_f": 5e-3}
# The bench's headline options (bench.py:87-91): chunked reorthogonalization
# and the bfloat16 basis; its sweep tier (bench.py:113-120): 8 couplings in
# [1.1, 1.45], 8 chunks, the same basis, held at TFIM_RTOL too.
TFIM_HEADLINE = {"reorth_chunks": 4, "basis_dtype": torch.bfloat16}
SWEEP_G, SWEEP_POINTS, SWEEP_CHUNKS = (1.1, 1.45), 8, 8
# The second_order phase.  (a) TFIM N = 20 through energy_curvature at
# the tfim phase's k and CG settings, against the Jordan-Wigner closed
# forms, at ~8x the JAX package's own float32 CPU errors at the same
# settings (tools/jax_f32_curvature_errors.py: 7.3e-7, 4.6e-6, 6.0e-5).
# (b) H(g) = A0 + g A1 at config #5.  (c) the small block HVP on three
# spiked eigenvalues.
SO_TFIM_RTOL = {"e0": 6e-6, "de0_dg": 4e-5, "d2e0_dg2": 5e-4}
SO_G = 0.5
SO_SMALL_R = 3
SO_SPIKES = (4.0, 8.0, 12.0)
# The forward_n phase.  (a) TFIM N = 20 by forward over forward at the
# tfim and second_order phases' Jordan-Wigner bars, and its d²E0/dg²
# against the reverse route of the same settings (the same CG on the same
# system, its right-hand side scaled by 2).  (b) the sweep (the bench's
# settings, 4 of its couplings) by vmap against the per-point loop, at
# TFIM_RTOL.  (c) config #5's H(g) by one nested pass: its CGs run to the
# 3000 cap there (PERF.md §7), so d² is printed, not gated; dE/dg against
# the first-order jvp's.  (d) the small spiked shape, whose inputs
# tools/jax_forward_n_errors.py builds the same way: d² gated at ~8x the
# JAX package's own float32 CPU errors there (E 1.8e-7, dE/dg 6.8e-7,
# d²E/dg² 7.5e-7).  (e) vmap of a matvec and of a deflated solve on config #5.
FWDN_TFIM_RTOL = {"e0": 2e-5, "de0_dg": 1e-3, "d2e0_dg2": 5e-4}
FWDN_ROUTE_RTOL = 1e-4
FWDN_SWEEP_POINTS = 4
FWDN_SMALL = (4096, 32, 5)
FWDN_SEEDS = (21, 22)
FWDN_SMALL_RTOL = {"e": 1.5e-6, "de_dg": 5.5e-6, "d2e_dg2": 6e-6}
FWDN_D1_RTOL = 1e-6
FWDN_VMAP_R = 8
FWDN_SOLVE_MAXITER = 200
FWDN_SOLVE_RTOL = 1e-5
# The ising2d phase (BASELINE config #4) at the bench's point, β = 0.5,
# TRG chi = 30 and 20 steps (benchmarks/ising2d_bench.py:32-35), CTMRG
# chi = 30 and 30 steps.  Onsager's ln Z, u and c_v there (the JAX
# package's chip-test constants, tests/test_tpu.py:194-196).  The bars are
# ~8x the JAX package's own errors at the same settings on a CPU
# (tools/jax_ising2d_errors.py): TRG gram 6.1e-7 / 8.5e-7 / 1.2e-4, CTMRG
# (either solver) 5.6e-8 / 6.6e-6 / 8.0e-4; in float32 the JAX package's
# u is off 1.3e-3 and its c_v is not finite-valued in any useful sense
# (7e11 relative), so the float32 bars are capped at its own float32
# chip-test bars (1e-3 / 1e-3 / 1e-2, tests/test_tpu.py:172-174).  The
# agreement bars are ~8x JAX's lanczos-against-gram (5.3e-14, 4.5e-12)
# and lanczos-against-truncated differences (0, 2.0e-15, 2.9e-14); the
# latter floored at 1e-12 (c_v 1e-11), float64 round-off carried through
# 30 steps and two derivatives (the port's CPU run at chi = 8: c_v 4.5e-13).
ISING_BETA = 0.5
ISING_TRG = (30, 20)                    # chi, n_steps
ISING_CTMRG = (30, 30)
ISING_KEYS = ("lnz", "u", "cv")
ISING_ONSAGER = (1.0257928127, -1.7455645753, 0.7248714486)
ISING_RTOL = {
    "trg_gram": {"lnz": 5e-6, "u": 7e-6, "cv": 1e-3},
    "trg_subspace_f32": {"lnz": 4e-6, "u": 1e-3, "cv": 1e-2},
    "ctmrg_truncated": {"lnz": 5e-7, "u": 5e-5, "cv": 6.4e-3},
    "ctmrg_lanczos": {"lnz": 5e-7, "u": 5e-5, "cv": 6.4e-3},
}
ISING_AGREE = {
    "trg_lanczos_vs_gram": {"lnz": 4.3e-13, "u": 3.6e-11},
    "ctmrg_lanczos_vs_truncated": {"lnz": 1e-12, "u": 1e-12, "cv": 1e-11},
}
# The lanczos split's u is read only if every column of every backward
# solve converged to this bar (the block CG's tolerance is 1e-8).  Its CG
# is capped at 1000 iterations: the resolved columns converge in 10-50,
# and the null columns of the early, rank-deficient splits (indefinite
# shifted systems) ran to the default cap of 18000 in 44.5 s of a 63.7 s
# phase on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
ISING_RESIDUAL_BAR = 1e-6
ISING_LANCZOS_MAXITER = 1000

# The eig phase: config #4's transfer observables at its BASELINE width
# (CTMRG chi = 30, 30 steps, float64) in the disordered phase (β = 0.35)
# and at the bench's β = 0.5 (ordered), then the non-symmetric solver on a
# dense positive matrix and on a non-symmetric BellOperator.  The Onsager
# bars are ~8x the JAX package's own CPU errors at the same chi, steps and
# β (tools/jax_transfer_errors.py: ξ 1.24e-2, dξ/dβ 2.35e-2, both the
# finite-chi truncation).  ξ against eigvals of the same transfer matrix:
# 1e-6 at β = 0.35 (the JAX test's bar); at β = 0.5 and chi = 30 (ξ ~ 4e6,
# a gap of ~2e-7 between the top moduli) the JAX package itself is
# 1.19e-4 from eigvals, so the bar there is 1e-3 (~8x), and the JAX
# test's 1e-4 is held at that test's own size, chi = 10 and 15 steps.
EIG_CHI, EIG_STEPS = 30, 30
EIG_BETA_DISORDERED = 0.35
EIG_ONSAGER_RTOL = {"xi": 0.1, "dxi": 0.19}
EIG_EIGVALS_RTOL = {"disordered": 1e-6, "ordered": 1e-3,
                    "ordered_chi10": 1e-4}
EIG_GAP_FD = (1e-4, 1e-2)               # central-difference step, rtol
EIG_DENSE_N = 2048
# The dot-product identity is held relative to ||G||_F ||D||_F (its
# Cauchy-Schwarz scale): <G, D> sums 4.2M terms of both signs to ~1e-3
# of that scale for a random D, so an error relative to <G, D> itself
# measures the cancellation, not the rule.
EIG_DENSE_RTOL = {torch.float64: {"lam": 1e-10, "dot": 1e-10, "d2": 1e-5},
                  torch.float32: {"lam": 1e-5, "dot": 1e-6, "d2": 1e-4}}
EIG_BELL = (4096, 32, 5)                # n, bs, blocks per row
# Its ring of 128 block-rows gives a near-degenerate transfer-like top
# (|λ2|/λ1 = 0.9964 on the CPU, numpy eigvals): 32 Arnoldi steps leave
# the polish 500 power steps short of float32's residual floor, 64 do not.
EIG_BELL_ARNOLDI_K = 64
EIG_BELL_RESIDUAL = 1e-4                # relative, float32
EIG_BELL_TWIN_RTOL = 1e-5
# The formats phase: the COO, CSR and BCOO formats and the operator algebra
# on the card.  (a) The TFIM N = 20 as sparse matrices at the tfim phase's
# settings, H(g) = CSR_zz + (-g) CSR_x, against Jordan-Wigner at the tfim
# and second_order phases' bars, and against the matrix-free run of the
# same point (E0 within FMT_ROUTE_RTOL); its COO and BCOO forms against
# the CSR one (matvec within FMT_ROUTE_RTOL, atomics' order apart).  (b)
# config #5 through the composites: A - σ and c A against the eigh phase's
# λ (the same operator and start vector; a shifted or scaled Krylov space
# is the same space, so only round-off differs), H(g) = A0 + g A1 by the
# algebra against the coupled MatrixFreeOperator route (dE/dg within
# FMT_ROUTE_RTOL), LOBPCG on A - σ, one SpMM per block product.  (c) the
# eig phase's non-symmetric Bell transposed, at the eig phase's bars.  (d)
# config #5 as one CSR: its matvec against K4b (f32 sums of 2176 products
# a row in another order).
FMT_ROUTE_RTOL = 1e-6
FMT_SHIFT, FMT_SCALE = 0.5, 1.5
FMT_COMPOSITE_RTOL = 1e-5
FMT_CSR_RTOL = 1e-5
# What the triplet product (ops/sparse.py::_segment_product) moves for
# each entry as written: the gather reads an index and x and writes a
# temporary, the product reads it and the value and writes another, the
# index_add reads an index and that (its atomics on y stay in L2 here).
TRIPLET_CODE_BYTES_PER_NNZ = 32
# The complex phase, at full width: (a) the TFIM N = 20 headline
# (tfim-phase settings and bars) in a complex gauge H' = D H D^H, D =
# diag(e^{iφ}) with φ from this seed, complex64; the overlap of its ground
# state with D ψ of the real pass, and d²E0/dg² at the second_order
# phase's bar; (b) a dense complex Hermitian matrix, complex128: ``r``
# pairs by LOBPCG (at most ``k`` iterations) and one by Lanczos (``k``
# steps), the deflated CG at ``CX_TOL``; (c) ``examples/complex_spectrum.py``'s
# biased transfer operator, float64, the top ``m`` by
# ``dominant_eig_spectrum``; (d) ``dominant_eig`` on a complex
# non-symmetric matrix, complex128, its gradient by each tangent solver.
CX_GAUGE_SEED = 61
CX_OVERLAP_BAR = 1e-5                   # 1 - |<D ψ, ψ'>|
CX_DENSE = (4096, 8, 100, 62)           # n, r, k, seed
CX_TOL = 1e-12
CX_FD_EPS = 1e-5
CX_SPECTRUM = (2048, 5, 0.25, 1500)     # n, m, bias, power budget
CX_EIG = (2048, 63)                     # n, seed
# Bars: ~8x the JAX package's own CPU errors on the same inputs
# (tools/jax_complex_errors.py): dense λ 1.0e-15, 1 - |<v, v*>| 1.3e-15,
# dot identity 7.6e-18, phase-sensitive gradient vs the central
# difference 1.9e-9, LOBPCG λ 1.2e-15 (29 iterations); spectrum 3.4e-5
# (the fifth, a "pair_real" stage whose subspace iteration does not
# converge within 1500 steps: its top moduli are 0.9986 apart), dθ/db
# 2.2e-16; complex dominant_eig λ 1.2e-15, gradients by GMRES and CGNR
# 5.2e-11 and 9.1e-11 from BiCGStab's.  Where JAX's error is float64
# round-off the bar is floored: 1e-13 for eigenvalues and overlaps (two
# float64 eigensolvers of the same matrix), 1e-12 for the dot identity
# (the CG tolerance) and for dθ/db.
CX_RTOL = {
    "dense": {"lam_rel": 1e-13, "overlap_defect": 1e-13, "dot_rel": 1e-12,
              "phase_grad_vs_fd_rel": 1.5e-8, "lobpcg_rel": 1e-13},
    "spectrum": {"max_rel_err_vs_eigvals": 2.7e-4, "dtheta_db_err": 1e-12},
    "eig": {"lam_rel": 1e-13, "grad": 8e-10},
}

# The restart phase: thick-restart Lanczos.  (a) Config #5 (the eigh
# phase's operator and start vector): dominant_eigh with a window of
# RESTART_K and RESTART_CYCLES cycles, its λ and ∂λ/∂vals, against the
# plain k = K forward (the two λ within the sum of their Ritz residual
# norms), the peak memory of each; the cycle-stepped driver checkpointed
# after RESTART_RESUME_AT cycles, reloaded into a fresh state and
# finished, against an uninterrupted run (bit for bit).  (b) The TFIM
# cell of benchmarks/restart_bench.py (its defaults: g = 1.2, f32,
# k = 32, 8 cycles, one reorthogonalization pass) at N = RESTART_TFIM_N
# through dominant_eigh: E0 and dE0/dg against Jordan-Wigner at that
# script's bars; (c) N = RESTART_STEPPED_N by the stepped driver
# (restart_init, restart_cycle, restart_extract), dE0/dg by
# Hellmann-Feynman, the same bars.
RESTART_K, RESTART_CYCLES, RESTART_RESUME_AT = 32, 8, 3
RESTART_TFIM_N, RESTART_STEPPED_N = 24, 27
RESTART_TFIM = dict(g=1.2, k=32, cycles=8, reorth_passes=1)
RESTART_RTOL = {"e0": 1e-4, "de0_dg": 1e-3}   # restart_bench.py:106-107
# The gen phase: the generalized pencil.  (a) Config #5's A (the eigh
# phase's operator) with B = diag(m), m in [1, 2) from GEN_SEED, a
# MatrixFreeOperator in m: dominant_eigh_gen with r = MULTI_R, at most
# LOBPCG_ITERS iterations, precond M^{-1}, the gradient of Σ c_i λ_i +
# <C, X> in the values and in m (its pencil CG capped at
# MULTI_CG_MAXITER); X^T B X = I; against the standard problem D A D,
# D = M^{-1/2} by the operator algebra, LOBPCG unpreconditioned from
# M^{1/2} x0 (the two routes' iterates correspond in exact arithmetic):
# λ and ∂Σλ/∂m within GEN_ROUTE_RTOL, the latter once the term an
# unconverged block leaves between the two rules is added.  Measured on
# the H100 (100 iterations each, f32): λ 8.4e-7 apart, ∂Σλ/∂m 3.0e-4 (a
# Ritz vector is first-order accurate where its value is second-order:
# the square root of λ's gap).  (b) examples/vibrational_modes.py's
# chain (n = 150, r = 3, f64, K^{-1} preconditioner) against
# scipy.linalg.eigh(K, M) and a central difference.  (c)
# dominant_eigh_multi(reorth_chunks=4) at config #5 against the
# unchunked run.
GEN_SEED = 23
GEN_ROUTE_RTOL = {"lam": 1e-5, "dsumlam_dm": 1e-3}
GEN_BORTHO_BAR = 1e-5
VIB = dict(n=150, r=3, maxiter=100, fd_eps=1e-4)
VIB_RTOL = {"omega2": 1e-9, "grad_vs_fd": 1e-5}


def emit(obj):
    print(json.dumps(obj), flush=True)


# The complex phase's inputs, numpy and seeded, built the same way by
# tools/jax_complex_errors.py, which measures the JAX package's own errors
# on them.

def complex_hermitian_input(n, seed):
    """``(H, D, c)``: H = W + P S P^H, W a complex Hermitian Gaussian
    matrix scaled to the spectrum [-1, 1], P (n, 10) orthonormal, S =
    -(1.5, 2.0, ..., 6.0): ten eigenvalues below the bulk about 0.5
    apart (θ + 1/(4θ) for a spike θ).  D a Hermitian direction of the
    same scale as W, c a complex vector."""
    rng = np.random.default_rng(seed)

    def gauss(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2.0)

    def wigner():
        b = gauss(n, n)
        return (b + b.conj().T) / (2.0 * np.sqrt(2.0 * n))

    p, _ = np.linalg.qr(gauss(n, 10))
    spikes = -np.arange(1.5, 6.01, 0.5)
    h = wigner() + (p * spikes[None, :]) @ p.conj().T
    return h, wigner(), gauss(n)


def biased_transfer_input(n, seed=0):
    """``examples/complex_spectrum.py``'s ``biased_transfer`` as ``(blk,
    Q)``: A(b) = Q blk(b) Qᵀ with the Perron root 2, the pair 1.5 e^{±ib}
    in blk[1:3, 1:3] (set by the caller), the level 1.05 and the bulk
    0.6 U(0, 1), drawn in the example's order."""
    rng = np.random.default_rng(seed)
    blk = np.zeros((n, n))
    blk[0, 0] = 2.0
    blk[3, 3] = 1.05
    blk[4:, 4:] = np.diag(0.6 * rng.random(n - 4))
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return blk, q


def complex_nonsymmetric_input(n, seed):
    """``(A, w)``: a complex non-symmetric A with an isolated dominant
    eigenvalue near 3 + 0.7i (the diagonal 3 + 0.7i, then 0.4 times
    complex Gaussians, plus a Gaussian of spectral radius ~0.5), and a
    complex probe vector w."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([[3.0 + 0.7j], 0.4 * (rng.standard_normal(n - 1)
                                             + 1j * rng.standard_normal(
                                                 n - 1))])
    noise = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    a = np.diag(d) + noise * (0.5 / np.sqrt(2.0 * n))
    return a, rng.standard_normal(n) + 1j * rng.standard_normal(n)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, samples=10, batch=1, warmup=2):
    """Median over ``samples`` of the CUDA-event time of ``batch`` calls
    of ``fn``, per call, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_build(spmv):
    spmv.build_library()
    log = spmv.build_info["log"]
    ptxas = [ln.strip() for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln]
    n_copy = 1 << 30                                   # 4 GiB of float32
    src = torch.empty(n_copy, dtype=torch.float32, device=DEVICE)
    src.fill_(1.0)
    dst = torch.empty_like(src)
    copy_ms = event_ms(lambda: dst.copy_(src), samples=10)
    del src, dst
    copy_gbps = 2 * n_copy * 4 / (copy_ms * 1e-3) / 1e9
    emit({"phase": "build", "nvcc_s": spmv.build_info["seconds"],
          "library": spmv.build_info["path"], "ptxas": ptxas,
          "gpu": nvidia_smi_name_power(),
          "copy_ms": copy_ms, "copy_gbps": copy_gbps})
    return copy_gbps


def bsr_library_call(vals, cols, n):
    """One PyTorch call for the same product: a cuSPARSE BSR matrix of
    nb*bs rows and n columns, with each row's slots sorted by column.  A
    yardstick only."""
    nb, max_blk, bs, _ = vals.shape
    order = cols.argsort(dim=1)
    cols_s = cols.gather(1, order)
    vals_s = vals[torch.arange(nb, device=vals.device)[:, None], order]
    crow = torch.arange(nb + 1, dtype=torch.int32,
                        device=vals.device) * max_blk
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = torch.sparse_bsr_tensor(crow, cols_s.reshape(-1),
                                    vals_s.reshape(-1, bs, bs),
                                    size=(nb * bs, n),
                                    check_invariants=False)
    return lambda x: a @ x


def bound(nnz, val_bytes, other_bytes, r=1):
    """Least time (ms) for the product and what bounds it: each input read
    once and each output written once at the published memory rate, or
    2 r operations per value at the float32 rate."""
    bytes_min = nnz * val_bytes + other_bytes
    t_bytes = bytes_min / PEAK_BYTES_PER_S
    t_ops = 2 * nnz * r / PEAK_F32_FLOP_PER_S
    return (bytes_min, max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def banded_case(gather_row, kernel, banded, plain_banded, vals, cols, x, plan,
                y_gather, batch_k):
    """K4b: the kernel's banded mode on the inputs of ``gather_row``,
    against the plain banded version (1e-5) and against the gather mode's
    ``y_gather`` (equal bit for bit), timed in turns with the gather mode
    (gather, banded, banded, gather).  Emits and returns its row."""
    name = gather_row["kernel"].replace("bell_spmv", "bell_spmv_banded") \
        .replace("bell_spmm", "bell_spmm_banded")
    if plan is None or any(kind != "band" for kind, _ in plan):
        raise AssertionError(f"{name}: the operator's slots are not all "
                             f"bands: {plan}")
    y_b = banded(vals, cols, x, plan)
    y_p = plain_banded(vals, cols, x, plan)
    torch.cuda.synchronize()
    err = rel_err(y_b, y_p)
    max_abs = float((y_b - y_p).abs().max())
    diff = float((y_b - y_gather).abs().max())
    if not (math.isfinite(err) and err <= 1e-5 and diff == 0.0):
        raise AssertionError(f"{name} at n={gather_row['n']} "
                             f"bs={gather_row['bs']}: rel err {err} (plain "
                             f"banded), max |banded - gather| {diff}")

    def timed(fn):
        return event_ms(fn, samples=12, batch=batch_k)

    t_g1 = timed(lambda: kernel(vals, cols, x))
    t_b1 = timed(lambda: banded(vals, cols, x, plan))
    t_b2 = timed(lambda: banded(vals, cols, x, plan))
    t_g2 = timed(lambda: kernel(vals, cols, x))
    plain_ms = event_ms(lambda: plain_banded(vals, cols, x, plan),
                        samples=12, batch=batch_k // 5 or 1)
    kernel_ms = (t_b1 + t_b2) / 2
    row = {key: gather_row[key] for key in
           ("phase", "n", "bs", "blocks_per_row", "r", "x_aligned",
            "library_ms", "bytes_min", "bound_ms", "bound_by")
           if key in gather_row}
    row.update({"kernel": name, "slot_plan": "all bands",
                "rel_err": err, "max_abs_err": max_abs,
                "vs_gather_max_abs_diff": diff, "kernel_ms": kernel_ms,
                "kernel_ms_turns": [t_b1, t_b2],
                "gather_kernel_ms_turns": [t_g1, t_g2],
                "banded_over_gather": kernel_ms / ((t_g1 + t_g2) / 2),
                "plain_ms": plain_ms,
                "achieved_gbps": row["bytes_min"] / (kernel_ms * 1e-3) / 1e9})
    emit(row)
    return row


def spmv_case(spmv, sparse, n, bs, bpr, copy_gbps, seed, unaligned=False):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    op = sparse.random_bell_operator(n, bs, bpr, generator=gen,
                                     device=DEVICE)
    x = torch.randn(n, generator=gen, device=DEVICE)
    if unaligned:
        # An x that is not 16-byte aligned drives the scalar-load path.
        buf = torch.empty(n + 1, device=DEVICE)
        buf[1:] = x
        x = buf[1:]
    results = {}
    for name, vals in (("bell_spmv_f32", op.vals),
                       ("bell_spmv_bf16vals", op.vals.to(torch.bfloat16))):
        cols = op.cols
        y_k = spmv._bell_spmv_cuda(vals, cols, x)
        y_p = spmv._bell_spmv_torch(vals, cols, x)
        torch.cuda.synchronize()
        err = rel_err(y_k, y_p)
        max_abs = float((y_k - y_p).abs().max())
        if not (math.isfinite(err) and err <= 1e-5):
            raise AssertionError(f"{name} at n={n} bs={bs}: rel err {err}")
        big = n >= CONFIG5[0]
        batch_k = 5 if big else 100
        kernel_ms = event_ms(lambda: spmv._bell_spmv_cuda(vals, cols, x),
                             samples=12, batch=batch_k)
        plain_ms = event_ms(lambda: spmv._bell_spmv_torch(vals, cols, x),
                            samples=12, batch=batch_k // 5 or 1)
        library_ms = lib_err = None
        if vals.dtype == torch.float32 and not unaligned:
            lib = bsr_library_call(vals, cols, n)
            lib_err = rel_err(lib(x), y_p)
            library_ms = event_ms(lambda: lib(x), samples=12,
                                  batch=batch_k // 5 or 1)
            del lib
        nb, max_blk = cols.shape
        nnz = vals.numel()
        # Least bytes: each input once (values, cols, x), y once.
        bytes_min, bound_ms, bound_by = bound(
            nnz, vals.element_size(), cols.numel() * 4 + 2 * n * 4)
        # The same stream with every x gather counted, over the measured
        # copy rate.
        bytes_gather = nnz * vals.element_size() + nb * max_blk * bs * 4 \
            + n * 4
        copy_bound_ms = bytes_gather / (copy_gbps * 1e9) * 1e3
        row = {"phase": "spmv", "kernel": name, "n": n, "bs": bs,
               "blocks_per_row": bpr, "x_aligned": not unaligned,
               "rel_err": err, "max_abs_err": max_abs,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_rel_err": lib_err,
               "bytes_min": bytes_min, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes_with_gathers": bytes_gather,
               "copy_bound_ms": copy_bound_ms,
               "achieved_gbps": bytes_min / (kernel_ms * 1e-3) / 1e9}
        emit(row)
        results[name] = row
        brow = banded_case(row, spmv._bell_spmv_cuda,
                           spmv._bell_spmv_banded_cuda,
                           spmv._bell_spmv_banded_torch, vals, cols, x,
                           op.slot_plan, y_k, batch_k)
        results[brow["kernel"]] = brow
        del vals, y_k, y_p
    del op, x
    torch.cuda.empty_cache()
    return results


def spmm_case(spmv, sparse, n, bs, bpr, r, seed, unaligned=False):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    op = sparse.random_bell_operator(n, bs, bpr, generator=gen,
                                     device=DEVICE)
    X = torch.randn(n, r, generator=gen, device=DEVICE)
    if unaligned:
        # An X that is not 16-byte aligned: the kernel stages X with
        # scalar loads, so only the values' alignment matters.
        buf = torch.empty(n * r + 1, device=DEVICE)
        buf[1:] = X.reshape(-1)
        X = buf[1:].view(n, r)
    x_cols = X.T.contiguous()                 # the r columns, for chained K1
    big = n >= CONFIG5[0]
    results = {}
    for name, spmv_name, vals in (
            ("bell_spmm_f32", "bell_spmv_f32", op.vals),
            ("bell_spmm_bf16vals", "bell_spmv_bf16vals",
             op.vals.to(torch.bfloat16))):
        cols = op.cols
        y_k = spmv._bell_spmm_cuda(vals, cols, X)
        y_p = spmv._bell_spmm_torch(vals, cols, X)

        def chained():
            return [spmv._bell_spmv_cuda(vals, cols, x_cols[c])
                    for c in range(r)]

        y_c = torch.stack(chained(), dim=1)
        torch.cuda.synchronize()
        err, chained_err = rel_err(y_k, y_p), rel_err(y_k, y_c)
        max_abs = float((y_k - y_p).abs().max())
        if not (math.isfinite(err) and err <= 1e-5 and chained_err <= 1e-5):
            raise AssertionError(f"{name} at n={n} bs={bs} r={r}: rel err "
                                 f"{err} (plain), {chained_err} (chained)")
        batch_k = 5 if big else 100
        kernel_ms = event_ms(lambda: spmv._bell_spmm_cuda(vals, cols, X),
                             samples=12, batch=batch_k)
        plain_ms = event_ms(lambda: spmv._bell_spmm_torch(vals, cols, X),
                            samples=12, batch=batch_k // 5 or 1)
        chained_ms = event_ms(chained, samples=12, batch=batch_k // 5 or 1)
        library_ms = lib_err = None
        if vals.dtype == torch.float32 and not unaligned:
            lib = bsr_library_call(vals, cols, n)
            lib_err = rel_err(lib(X), y_p)
            library_ms = event_ms(lambda: lib(X), samples=12,
                                  batch=batch_k // 5 or 1)
            del lib
        # Least bytes: values, cols, X once, Y once.
        bytes_min, bound_ms, bound_by = bound(
            vals.numel(), vals.element_size(),
            cols.numel() * 4 + 2 * n * r * 4, r)
        row = {"phase": "spmm", "kernel": name, "n": n, "bs": bs,
               "blocks_per_row": bpr, "r": r, "x_aligned": not unaligned,
               "rel_err": err, "max_abs_err": max_abs,
               "chained_spmv_rel_err": chained_err,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_rel_err": lib_err,
               "chained_spmv_ms": chained_ms, "bytes_min": bytes_min,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "achieved_gbps": bytes_min / (kernel_ms * 1e-3) / 1e9}
        emit(row)
        results[name] = row
        brow = banded_case(row, spmv._bell_spmm_cuda,
                           spmv._bell_spmm_banded_cuda,
                           spmv._bell_spmm_banded_torch, vals, cols, X,
                           op.slot_plan, y_k, batch_k)
        results[brow["kernel"]] = brow
        del vals, y_k, y_p, y_c
    del op, X, x_cols
    torch.cuda.empty_cache()
    return results


def ift_dot_test(op, lam, v, c, b, x, lhs, dav, maxiter):
    """Dot-product test of the gradient of ``λ + cᵀv``: ``lhs`` =
    <grad, dvals> against the forward IFT tangent dλ + cᵀdv, dv =
    solve_deflated(A, λ, v, -(I - v vᵀ) dA v), ``dav`` = dA v.  With
    residuals r_x = P b - M x and r_d = -P dA v - M dv of the two solves
    (``b`` = -(I - v vᵀ) c and ``x`` the backward's solution, M the
    deflated operator), lhs - (dλ + cᵀdv) = <r_x, dv> - <x, r_d> exactly,
    so the test holds at any CG stopping point, up to round-off.  Returns
    (terms, relative error, the tangent solve's iterations and
    residual)."""
    from dominantsparseeigenad_tpu_torch.ops.cg import solve_deflated_info

    def deflated(z):
        """P (A - λ) P z, P = I - v v^T."""
        pz = z - v * torch.dot(v, z)
        az = op.matvec(pz) - lam * pz
        return az - v * torch.dot(v, az)

    dlam = torch.dot(v, dav)
    rhs_d = -(dav - dlam * v)
    dv, dv_its, dv_res = solve_deflated_info(
        op, lam, v, rhs_d, definite_sign=1.0, tol=CG_TOL, maxiter=maxiter,
        device=DEVICE)
    r_x = (b - v * torch.dot(v, b)) - deflated(x)
    r_d = (rhs_d - v * torch.dot(v, rhs_d)) - deflated(dv)
    terms = [float(dlam), float(torch.dot(c, dv)),
             float(torch.dot(r_x, dv)), -float(torch.dot(x, r_d))]
    dot_err = abs(lhs - terms[0] - terms[1] - terms[2] - terms[3]) / (
        abs(lhs) + sum(abs(t) for t in terms))
    return terms, dot_err, dv_its, dv_res


def grad_dot(g, d) -> float:
    """<g, d> in float64, in chunks (config-#5 gradients are GBs)."""
    return sum(float(torch.dot(a.reshape(-1).double(), b.reshape(-1).double()))
               for a, b in zip(g.split(256), d.split(256)))


def phase_eigh(pkg, spmv):
    from dominantsparseeigenad_tpu_torch.ops.cg import solve_deflated_info
    n, bs, bpr = CONFIG5
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    # The operator as the JAX package builds it: every slot a ring band,
    # so the products run the banded kernels (K4b).
    op = pkg.random_bell_operator(n, bs, bpr, generator=gen, device=DEVICE)
    op.vals.requires_grad_(True)
    op_bf = pkg.BellOperator(op.vals.detach().to(torch.bfloat16)
                             .requires_grad_(True), op.cols, n,
                             symmetric=True)
    # The twins: the same values with slot_plan=None (gather kernels).
    twin = pkg.BellOperator(op.vals.detach(), op.cols, n, symmetric=True,
                            slot_plan=None)
    twin_bf = pkg.BellOperator(op_bf.vals.detach(), op.cols, n,
                               symmetric=True, slot_plan=None)
    v0 = torch.randn(n, generator=gen, device=DEVICE)
    c = torch.randn(n, generator=gen, device=DEVICE) / math.sqrt(n)
    dvals = torch.randn(op.vals.shape, generator=gen, device=DEVICE)
    solve = dict(k=K, extreme="min", tol=CG_TOL, maxiter=CG_MAXITER, v0=v0,
                 device=DEVICE)

    # Warm-up on a small operator through the same calls, so that one-time
    # costs (library loads, first kernel launches) stay out of the times.
    t0 = time.perf_counter()
    small = pkg.random_bell_operator(1 << 14, bs, bpr, generator=gen,
                                     device=DEVICE)
    for o in (small, small.astype_vals(torch.bfloat16)):
        o.vals.requires_grad_(True)
        lam_w, v_w = pkg.dominant_eigh(o, k=20, maxiter=20, device=DEVICE)
        (lam_w + v_w.sum()).backward()
        with torch.no_grad():
            pkg.dominant_eigh(pkg.BellOperator(o.vals.detach(), o.cols,
                                               o.n, symmetric=True,
                                               slot_plan=None),
                              k=20, device=DEVICE)
    with fwAD.dual_level():
        pkg.dominant_eigh(small.with_vals(fwAD.make_dual(
            small.vals.detach(), torch.ones_like(small.vals))), k=20,
            maxiter=20, device=DEVICE)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    del small, o, lam_w, v_w
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted ----------------------------------------
    spmv.reset_launch_counts()
    counts = spmv.launch_counts
    t0 = time.perf_counter()
    lam, v = pkg.dominant_eigh(op, **solve)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    fwd_launches = counts["bell_spmv_banded_f32"]
    t0 = time.perf_counter()
    (g_lam,) = torch.autograd.grad(lam, op.vals, retain_graph=True)
    torch.cuda.synchronize()
    t_bwd_lam = time.perf_counter() - t0
    before = counts["bell_spmv_banded_f32"]
    t0 = time.perf_counter()
    (lam + (c * v).sum()).backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    bwd_launches = counts["bell_spmv_banded_f32"] - before
    t0 = time.perf_counter()
    lam_bf, v_bf = pkg.dominant_eigh(op_bf, **solve)
    (g_lam_bf,) = torch.autograd.grad(lam_bf, op_bf.vals)
    torch.cuda.synchronize()
    t_bf = time.perf_counter() - t0
    # The twins, forward only, from the same start.
    t0 = time.perf_counter()
    with torch.no_grad():
        lam_twin, _ = pkg.dominant_eigh(twin, **solve)
        lam_twin_bf, _ = pkg.dominant_eigh(twin_bf, **solve)
    torch.cuda.synchronize()
    t_twins = time.perf_counter() - t0
    # One forward-mode tangent of λ along dvals: k banded SpMVs, one for
    # dA v, one per iteration of the tangent's CG.
    before = counts["bell_spmv_banded_f32"]
    t0 = time.perf_counter()
    with torch.no_grad(), fwAD.dual_level():
        lam_fm, v_fm = pkg.dominant_eigh(
            op.with_vals(fwAD.make_dual(op.vals.detach(), dvals)),
            **dict(solve, maxiter=FWD_CG_MAXITER))
        dlam_fm = float(fwAD.unpack_dual(lam_fm).tangent)
        dv_fm = fwAD.unpack_dual(v_fm).tangent
    torch.cuda.synchronize()
    t_fm = time.perf_counter() - t0
    fm_launches = counts["bell_spmv_banded_f32"] - before
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    krylov = eigh_krylov_options(pkg, spmv, op, solve, c, counts)
    counts = dict(counts)
    # ---- end of the counted run -----------------------------------------

    lam, v = lam.detach(), v.detach()
    lam_f, lam_bf_f = float(lam), float(lam_bf.detach())
    vals_d, cols = op.vals.detach(), op.cols

    with torch.no_grad():
        ritz_res = float(torch.linalg.vector_norm(op.matvec(v) - lam * v)
                         / abs(lam_f))
        # The backward's CG, re-run on the same right-hand side; the
        # kernels are deterministic, so it gives the backward's x.
        b = -(c - v * torch.dot(v, c))
        x, cg_its, cg_res = solve_deflated_info(
            op, lam, v, b, definite_sign=1.0, tol=CG_TOL,
            maxiter=CG_MAXITER, device=DEVICE)

        # λ against the same solve through the plain SpMV, same v0.
        mf = pkg.MatrixFreeOperator(
            lambda p, z: spmv._bell_spmv_torch(p, cols, z), vals_d, n)
        lam_mf, _ = pkg.lanczos_eigh(mf, K, extreme="min", v0=v0,
                                     device=DEVICE)
        lam_mf_err = abs(lam_f - float(lam_mf)) / abs(lam_f)

        # ∂λ/∂vals = v[i*bs+a] v[cols[i,j]*bs+b] on the pattern.
        vb = v.reshape(-1, bs)
        expect = vb[:, None, :, None] * vb[cols.long()][:, :, None, :]
        dlam_err = rel_err(g_lam, expect)
        del expect

        # Forward mode against reverse mode: both are v^T dA v.
        dlam_rev = grad_dot(g_lam, dvals)
        fm_err = abs(dlam_fm - dlam_rev) / abs(dlam_rev)
        # The tangent's CG, re-run on its right-hand side: its iterations
        # and time (the rest of the forward-mode pass is the forward).
        dav = spmv.bell_spmv(dvals, cols, v, op.slot_plan)
        rhs_fm = -(dav - torch.dot(v, dav) * v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, fm_cg_its, fm_cg_res = solve_deflated_info(
            op, lam, v, rhs_fm, definite_sign=1.0, tol=CG_TOL,
            maxiter=FWD_CG_MAXITER, device=DEVICE)
        torch.cuda.synchronize()
        t_fm_cg = time.perf_counter() - t0

        # Dot-product test of the full gradient (see ift_dot_test), and
        # of the preconditioned backward's (its x by the same solve).
        g_full = op.vals.grad
        lhs = grad_dot(g_full, dvals)
        lhs_pc = grad_dot(krylov.pop("grad"), dvals)
        del dvals
        terms, dot_err, dv_its, dv_res = ift_dot_test(
            op, lam, v, c, b, x, lhs, dav, CG_MAXITER)
        x_pc, pc_its, pc_res = solve_deflated_info(
            op, lam, v, b, definite_sign=1.0, tol=CG_TOL,
            maxiter=CG_MAXITER, precond=krylov.pop("jacobi"), device=DEVICE)
        _, pc_dot_err, _, _ = ift_dot_test(op, lam, v, c, b, x_pc, lhs_pc,
                                           dav, CG_MAXITER)
        del x_pc
        # Block-Jacobi at this size (not on any default path): one batched
        # eigh of the 4096 diagonal blocks, 128 x 128, then one apply.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = pkg.block_jacobi_precond(op, shift=lam)
        torch.cuda.synchronize()
        krylov["block_jacobi_build_s"] = time.perf_counter() - t0
        krylov["block_jacobi_apply_ms"] = event_ms(lambda: block(v),
                                                   samples=5)
        del block
        finite = all(bool(torch.isfinite(t).all())
                     for t in (v, g_full, g_lam_bf, v_bf.detach(), dv_fm))
    bf_err = abs(lam_bf_f - lam_f) / abs(lam_f)
    twins_equal = (float(lam_twin).hex() == lam_f.hex()
                   and float(lam_twin_bf).hex() == lam_bf_f.hex())
    emit({"phase": "eigh", "n": n, "bs": bs, "blocks_per_row": bpr, "k": K,
          "slot_plan": "all bands", "lam": lam_f, "ritz_residual": ritz_res,
          "warmup_s": t_warm, "forward_s": t_fwd, "backward_lam_s": t_bwd_lam,
          "backward_s": t_bwd, "bf16_forward_backward_s": t_bf,
          "cg_iterations": cg_its, "cg_rel_residual": cg_res,
          "launches": counts, "forward_launches": fwd_launches,
          "backward_launches": bwd_launches,
          "twin_lam_hex": [float(lam_twin).hex(), float(lam_twin_bf).hex()],
          "lam_hex": [lam_f.hex(), lam_bf_f.hex()],
          "twins_forward_s": t_twins,
          "forward_mode_s": t_fm, "forward_mode_launches": fm_launches,
          "forward_mode_cg_iterations": fm_cg_its,
          "forward_mode_cg_rel_residual": fm_cg_res,
          "forward_mode_cg_s": t_fm_cg,
          "forward_mode_minus_cg_s": t_fm - t_fm_cg,
          "dlam_forward_mode": dlam_fm, "dlam_reverse": dlam_rev,
          "dlam_forward_vs_reverse_rel": fm_err,
          "lam_vs_plain_rel": lam_mf_err, "dlam_dvals_rel_err": dlam_err,
          "dot_test_lhs": lhs, "dot_test_terms": terms,
          "dot_test_rel_err": dot_err, "tangent_cg_iterations": dv_its,
          "tangent_cg_rel_residual": dv_res,
          "lam_bf16vals": lam_bf_f, "lam_bf16vals_rel": bf_err,
          "peak_mem_gib": peak_gib,
          "precond_backward_cg_iterations": pc_its,
          "precond_backward_cg_rel_residual": pc_res,
          "precond_dot_test_rel_err": pc_dot_err, **krylov})

    checks = {
        # The forward is k SpMVs; the backward one per CG iteration plus
        # the one matvec autograd differentiates; all banded.
        "forward launches == k": fwd_launches == K,
        "backward launches == CG iterations + 1": bwd_launches == cg_its + 1,
        "f32 banded launches >= k + CG iterations":
            counts["bell_spmv_banded_f32"] >= K + cg_its,
        "bf16 banded launches >= k + 1":
            counts["bell_spmv_banded_bf16vals"] >= K + 1,
        # The twins ran the gather kernels, k SpMVs each, and found the
        # same λ bit for bit (the same sums in the same order).
        "twin gather launches == k": counts["bell_spmv_f32"] == K
            and counts["bell_spmv_bf16vals"] == K,
        "twins' λ bitwise equal to the banded λ": twins_equal,
        # Forward mode: k SpMVs (the Lanczos loop carries no tangent), one
        # for dA v, one per CG iteration.
        "forward-mode launches == k + 1 + CG iterations":
            fm_launches == K + 1 + fm_cg_its,
        # Both are v^T dA v: f32 sums of 2176 products per row.
        "forward-mode dλ vs <dvals, ∂λ/∂vals>, rel 1e-5": fm_err <= 1e-5,
        # Two f32 Lanczos runs whose SpMVs sum in different orders.
        "λ vs plain-SpMV λ, rel 1e-4": lam_mf_err <= 1e-4,
        # The same products as the backward's, formed directly.
        "∂λ/∂vals vs v⊗v, rel 1e-5": dlam_err <= 1e-5,
        # An exact identity up to f32 round-off in products of vectors
        # whose norms the ill-conditioned solves inflate.
        "dot-product test, rel 1e-3": dot_err <= 1e-3,
        # Weyl: bf16 storage moves λ by at most 2^-8 ||A|| ≈ 2^-8 |λ_min|.
        "bf16-values λ within 2^-8 rel": bf_err <= 2.0 ** -8,
        "finite": finite,
        # The bf16 basis: its forward is k SpMVs, two of the
        # polish's Rayleigh quotients and its CG's; the preconditioned
        # backward one per CG iteration plus one; both solves of the
        # MINRES/CG pair converge on their definite shifted system.
        "bf16-basis forward launches in k + 2 + [0, CG cap]":
            K + 2 <= krylov["bf16_basis_forward_launches"]
            <= K + 2 + CG_MAXITER,
        # What the basis storage decides is the Ritz value (T is
        # accumulated in float32 either way).
        "bf16-basis Ritz value vs f32-basis λ, rel 1e-5":
            krylov["bf16_basis_ritz_value_rel"] <= 1e-5,
        # The polish is one Newton step on an indefinite deflated system
        # (this k = 100 Ritz value lies above other eigenvalues).  At
        # POLISH_CHECK_MAXITER CG iterations it must be the float64 step
        # from the same Ritz pair; that step moves λ by far more than the
        # bar.  (At the full cap the float32 CG fails where the float64
        # one converges: read, not checked; ROADMAP.md queue 3, F6.)
        "polish vs float64 Newton step: λ within POLISH_CHECK_RTOL":
            krylov["polish_vs_f64_step_lam_rel"] <= POLISH_CHECK_RTOL,
        "polish vs float64 Newton step: 1 - |<v, v64>| <= POLISH_CHECK_RTOL":
            krylov["polish_vs_f64_step_one_minus_overlap"]
            <= POLISH_CHECK_RTOL,
        "the checked step moves λ by > 10 POLISH_CHECK_RTOL":
            krylov["polish_check_moved_rel"] > 10 * POLISH_CHECK_RTOL,
        "no float32 copy of the basis: bf16 run's extra peak < f32 basis":
            krylov["bf16_basis_extra_peak_mib"]
            < krylov["f32_basis_mib"],
        "preconditioned backward launches == k + CG iterations + 1":
            krylov["precond_launches"] == K + pc_its + 1,
        "preconditioned dot-product test, rel 1e-3": pc_dot_err <= 1e-3,
        "MINRES x vs CG x, rel 1e-4":
            krylov["shifted_minres_vs_cg_rel"] <= 1e-4,
        "MINRES and CG converged":
            max(krylov["shifted_minres_rel_residual"],
                krylov["shifted_cg_rel_residual"])
            <= 2 * tol_floor_f32(CG_TOL),
        # MINRES on the indefinite block system diag(A - s, s - A): its
        # true residual at the target, its x the definite solve's [x; -x].
        "indefinite MINRES converged":
            krylov["indefinite_minres_rel_residual"]
            <= 2 * tol_floor_f32(CG_TOL),
        "indefinite MINRES x vs [x_cg; -x_cg], rel 1e-4":
            krylov["indefinite_minres_vs_cg_rel"] <= 1e-4,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"eigh phase failed: {failed}")
    return counts, lam_f


def tol_floor_f32(tol):
    """A solver's relative tolerance as float32 clamps it (50 eps)."""
    return max(tol, 50.0 * float(torch.finfo(torch.float32).eps))


def newton_step_f64(spmv, op, u, maxiter, tol):
    """One Newton step of the polish from the unit vector ``u``, written
    out in float64 through the plain SpMV: the Rayleigh quotient λ0, a
    plain CG on ``P (A - λ0) P x = -P (A u - λ0 u)``, ``P = I - u u^T``,
    stopped at ``||r|| <= tol ||b||`` or ``maxiter``, then ``v = u + P x``
    normalized and its Rayleigh quotient.  Returns (λ, v, iterations,
    the relative Ritz residual of (λ, v))."""
    vals = op.vals.detach().double()
    a_mv = lambda z: spmv._bell_spmv_torch(vals, op.cols, z)  # noqa: E731
    u = u.double() / torch.linalg.vector_norm(u.double())

    def proj(x):
        return x - u * torch.dot(u, x)

    au = a_mv(u)
    lam0 = torch.dot(u, au)
    b = proj(lam0 * u - au)
    x, r = torch.zeros_like(b), b.clone()
    p, rr = r.clone(), torch.dot(r, r)
    target, its = tol * tol * torch.dot(b, b), 0
    while its < maxiter and bool(rr > target):
        px = proj(p)
        ap = proj(a_mv(px) - lam0 * px)
        alpha = rr / torch.dot(p, ap)
        x, r = x + alpha * p, r - alpha * ap
        rr_new = torch.dot(r, r)
        p, rr, its = r + (rr_new / rr) * p, rr_new, its + 1
    v = u + proj(x)
    v = v / torch.linalg.vector_norm(v)
    av = a_mv(v)
    lam = torch.dot(v, av)
    resid = torch.linalg.vector_norm(av - lam * v) / lam.abs()
    return float(lam), v, its, float(resid)


def eigh_krylov_options(pkg, spmv, op, solve, c, counts):
    """The eigh phase's runs of the Krylov options on config #5, inside
    its counted run (K4b): the bf16 basis with reorth_chunks=4 beside the
    float32 basis (λ, time, the peak memory each adds over what was
    allocated before it, the polished pair's Ritz residual); the polish
    against a float64 Newton step from the same Ritz pair, at a short CG
    cap (checked) and at the full one (read); the gradient of
    λ + Σ c⊙v with a Jacobi preconditioner in the backward's CG; MINRES
    against CG on one definite deflated system (the eigenvector
    deflated, λ - 1 as the shift, the backward's right-hand side); and
    MINRES on the indefinite block system diag(A - s, s - A) built from
    the same operator, shift and right-hand side."""
    name = "bell_spmv_banded_f32"
    n = op.dim
    out = {"f32_basis_mib": (K + 1) * n * 4 / 2**20}
    with torch.no_grad():
        runs = {}
        for basis, kw in (("f32", {}),
                          ("bf16", {"basis_dtype": torch.bfloat16,
                                    "reorth_chunks": 4})):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = counts[name]
            t0 = time.perf_counter()
            lam_b, v_b = pkg.dominant_eigh(op, **solve, **kw)
            torch.cuda.synchronize()
            out[f"{basis}_basis_forward_s"] = time.perf_counter() - t0
            out[f"{basis}_basis_extra_peak_mib"] = (
                torch.cuda.max_memory_allocated() - base) / 2**20
            out[f"{basis}_basis_forward_launches"] = counts[name] - before
            out[f"{basis}_basis_ritz_residual"] = float(
                torch.linalg.vector_norm(op.matvec(v_b) - lam_b * v_b)
                / lam_b.abs())
            runs[basis] = float(lam_b)
        # The bf16 basis's own Ritz pair, before the polish.
        theta, u = pkg.lanczos_eigh(op, K, extreme="min", v0=solve["v0"],
                                    basis_dtype=torch.bfloat16,
                                    reorth_chunks=4, device=DEVICE)
        # The polish against the float64 step from the same pair (the
        # Lanczos run is deterministic, so the polish starts from u).
        lam_s, v_s = pkg.dominant_eigh(
            op, **dict(solve, maxiter=POLISH_CHECK_MAXITER),
            basis_dtype=torch.bfloat16, reorth_chunks=4)
        lam_r, v_r, its_r, _ = newton_step_f64(spmv, op, u,
                                               POLISH_CHECK_MAXITER,
                                               tol_floor_f32(CG_TOL))
        out["polish_check_lam"], out["polish_check_f64_lam"] = (
            float(lam_s), lam_r)
        out["polish_check_f64_cg_iterations"] = its_r
        out["polish_vs_f64_step_lam_rel"] = abs(float(lam_s) - lam_r) / abs(
            lam_r)
        out["polish_vs_f64_step_one_minus_overlap"] = 1.0 - abs(float(
            torch.dot(v_s.double(), v_r)))
        out["polish_check_moved_rel"] = abs(float(lam_s) - float(theta)) / abs(
            lam_r)
        # The same float64 step at the polish's full cap: where the
        # float32 CG of the polish above ends unconverged.
        t0 = time.perf_counter()
        (out["f64_step_full_cap_lam"], _,
         out["f64_step_full_cap_cg_iterations"],
         out["f64_step_full_cap_ritz_residual"]) = newton_step_f64(
            spmv, op, u, CG_MAXITER, tol_floor_f32(CG_TOL))
        out["f64_step_full_cap_s"] = time.perf_counter() - t0
        del v_r, v_s
    out["f32_basis_lam"], out["bf16_basis_lam"] = runs["f32"], runs["bf16"]
    out["bf16_basis_ritz_value"] = float(theta)
    out["bf16_basis_ritz_value_rel"] = abs(float(theta) - runs["f32"]) / abs(
        runs["f32"])
    out["bf16_basis_lam_rel"] = abs(runs["bf16"] - runs["f32"]) / abs(
        runs["f32"])

    lam = torch.tensor(runs["f32"], device=DEVICE)
    out["jacobi"] = pkg.jacobi_precond(op, shift=lam)
    before = counts[name]
    t0 = time.perf_counter()
    lam_p, v_p = pkg.dominant_eigh(op, precond=out["jacobi"], **solve)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (out["grad"],) = torch.autograd.grad(lam_p + (c * v_p).sum(), op.vals)
    torch.cuda.synchronize()
    out["precond_backward_s"] = time.perf_counter() - t1
    out["precond_forward_s"] = t1 - t0
    out["precond_launches"] = counts[name] - before
    del lam_p, v_p

    with torch.no_grad():
        lam_v, v = pkg.dominant_eigh(op, **solve)
        shift = lam_v - 1.0
        b = -(c - v * torch.dot(v, c))
        mv = importlib.import_module(
            "dominantsparseeigenad_tpu_torch.ops.cg")._deflated_mv(
            op, shift, v, 1.0, False)
        xs = {}
        for method in ("cg", "minres"):
            before = counts[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xs[method] = pkg.solve_deflated(op, shift, v, b, tol=CG_TOL,
                                            maxiter=CG_MAXITER,
                                            method=method, device=DEVICE)
            torch.cuda.synchronize()
            out[f"shifted_{method}_s"] = time.perf_counter() - t0
            out[f"shifted_{method}_launches"] = counts[name] - before
            pb = b - v * torch.dot(v, b)
            out[f"shifted_{method}_rel_residual"] = float(
                torch.linalg.vector_norm(pb - mv(xs[method]))
                / torch.linalg.vector_norm(pb))
        out["shifted_minres_vs_cg_rel"] = float(
            torch.linalg.vector_norm(xs["minres"] - xs["cg"])
            / torch.linalg.vector_norm(xs["cg"]))

        # diag(A, 2s - A) shifted by s is diag(A - s, s - A): indefinite,
        # as well conditioned as the definite system, solved by [x; -x].
        blk = pkg.MatrixFreeOperator(
            lambda p, z: torch.cat([op.matvec(z[:n]),
                                    2 * shift * z[n:] - op.matvec(z[n:])]),
            op.vals.detach(), 2 * n)
        v2 = torch.zeros(2 * n, 2, device=DEVICE)
        v2[:n, 0], v2[n:, 1] = v, v
        b2 = torch.cat([b, b])
        before = counts[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x2 = pkg.solve_deflated(blk, shift, v2, b2, tol=CG_TOL,
                                maxiter=CG_MAXITER, method="minres",
                                device=DEVICE)
        torch.cuda.synchronize()
        out["indefinite_minres_s"] = time.perf_counter() - t0
        out["indefinite_minres_launches"] = counts[name] - before
        mv2 = importlib.import_module(
            "dominantsparseeigenad_tpu_torch.ops.cg")._deflated_mv(
            blk, shift, v2, 1.0, False)
        pb2 = b2 - v2 @ (v2.T @ b2)
        out["indefinite_minres_rel_residual"] = float(
            torch.linalg.vector_norm(pb2 - mv2(x2))
            / torch.linalg.vector_norm(pb2))
        out["indefinite_minres_vs_cg_rel"] = float(
            torch.linalg.vector_norm(x2 - torch.cat([xs["cg"], -xs["cg"]]))
            / (math.sqrt(2.0) * torch.linalg.vector_norm(xs["cg"])))
    return out


def phase_eigh_multi(pkg, spmv):
    from dominantsparseeigenad_tpu_torch.ops.cg import (CHECK_EVERY,
                                                        solve_deflated_info)
    n, bs, bpr = CONFIG5
    r = MULTI_R
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    # As the JAX package builds it: every slot a band (banded SpMMs).
    op = pkg.random_bell_operator(n, bs, bpr, generator=gen, device=DEVICE)
    op.vals.requires_grad_(True)
    op_bf = op.with_vals(op.vals.detach().to(torch.bfloat16))
    # The twins, on the gather kernels.
    twins = [pkg.BellOperator(o.vals.detach(), op.cols, n, symmetric=True,
                              slot_plan=None) for o in (op, op_bf)]
    x0 = torch.randn(n, r, generator=gen, device=DEVICE)
    c = torch.randn(r, generator=gen, device=DEVICE)
    C = torch.randn(n, r, generator=gen, device=DEVICE) / math.sqrt(n)
    solve = dict(r=r, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL,
                 maxiter=MULTI_CG_MAXITER, x0=x0, with_info=True,
                 device=DEVICE)

    # Warm-up on a small operator through the same calls, so that one-time
    # costs (library loads, first launches of each kernel) stay out.
    t0 = time.perf_counter()
    small = pkg.random_bell_operator(1 << 14, bs, bpr, generator=gen,
                                     device=DEVICE)
    for o in (small, small.astype_vals(torch.bfloat16)):
        o.vals.requires_grad_(True)
        lams_w, v_w = pkg.dominant_eigh_multi(o, r=r, k=10, method="lobpcg",
                                              maxiter=10, device=DEVICE)
        (lams_w.sum() + v_w.sum()).backward()
        with torch.no_grad():
            pkg.dominant_eigh_multi(
                pkg.BellOperator(o.vals.detach(), o.cols, o.n,
                                 symmetric=True, slot_plan=None),
                r=r, k=10, method="lobpcg", device=DEVICE)
    pkg.dominant_eigh_multi(small, r=r, k=20, with_info=True, device=DEVICE)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    del small, o, lams_w, v_w
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted ----------------------------------------
    spmv.reset_launch_counts()
    t0 = time.perf_counter()
    lams, V, info = pkg.dominant_eigh_multi(op, **solve)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    fwd = dict(spmv.launch_counts)
    before = spmv.launch_counts["bell_spmm_banded_f32"]
    t0 = time.perf_counter()
    (g_sum,) = torch.autograd.grad(lams.sum(), op.vals, retain_graph=True)
    torch.cuda.synchronize()
    t_bwd_lam = time.perf_counter() - t0
    bwd_lam_launches = spmv.launch_counts["bell_spmm_banded_f32"] - before
    before = spmv.launch_counts["bell_spmm_banded_f32"]
    t0 = time.perf_counter()
    ((c * lams).sum() + (C * V).sum()).backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    bwd_launches = spmv.launch_counts["bell_spmm_banded_f32"] - before
    t0 = time.perf_counter()
    lams_bf, V_bf, info_bf = pkg.dominant_eigh_multi(op_bf, **solve)
    torch.cuda.synchronize()
    t_bf = time.perf_counter() - t0
    # The twins' LOBPCG forwards, from the same start block.
    t0 = time.perf_counter()
    with torch.no_grad():
        twin_out = [pkg.dominant_eigh_multi(o, **solve) for o in twins]
    torch.cuda.synchronize()
    t_twins = time.perf_counter() - t0
    twin_its = [int(out[2].effective_k) for out in twin_out]
    before = dict(spmv.launch_counts)
    t0 = time.perf_counter()
    with torch.no_grad():
        lams_lz, _, info_lz = pkg.dominant_eigh_multi(
            op, r=r, k=LANCZOS_K, method="lanczos", with_info=True,
            v0=x0[:, 0], device=DEVICE)
    torch.cuda.synchronize()
    t_lz = time.perf_counter() - t0
    counts = dict(spmv.launch_counts)
    lz = {k: counts[k] - before[k] for k in counts}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # ---- end of the counted run -----------------------------------------

    its = int(info.effective_k)
    lams, V = lams.detach(), V.detach()
    vals_d, cols = op.vals.detach(), op.cols
    lam_scale = float(lams.abs().max())

    def deflated(Z):
        """P (A P Z - P Z diag(λ)), P = I - V V^T (the unsigned system)."""
        pz = Z - V @ (V.T @ Z)
        az = op.matmat(pz) - pz * lams[None, :]
        return az - V @ (V.T @ az)

    with torch.no_grad():
        # The pairs, with A applied by the SpMV kernel (independent of K3).
        rq = torch.stack([torch.dot(V[:, i], spmv._bell_spmv_cuda(
            vals_d, cols, V[:, i].contiguous())) for i in range(r)])
        pair_err = float((lams - rq).abs().max()) / lam_scale
        orth_err = float((V.T @ V - torch.eye(r, device=DEVICE)).abs().max())

        # The backward's batched CG, re-run on the same right-hand side;
        # the kernels are deterministic, so it gives the backward's X.
        b = -(C - V @ (V.T @ C))
        before = spmv.launch_counts["bell_spmm_banded_f32"]
        x, x_its, x_res = solve_deflated_info(
            op, lams, V, b, tol=CG_TOL, maxiter=MULTI_CG_MAXITER,
            device=DEVICE)
        cg_loop = spmv.launch_counts["bell_spmm_banded_f32"] - before - 1
        cg_loop_expect = min(MULTI_CG_MAXITER,
                             -(-max(x_its) // CHECK_EVERY) * CHECK_EVERY)

        # ∂Σλ/∂vals = Σ_i v_i[i*bs+a] v_i[cols[i,j]*bs+b] on the pattern.
        vb = V.reshape(-1, bs, r)
        expect = torch.matmul(vb[:, None], vb[cols.long()].transpose(-1, -2))
        dlam_err = rel_err(g_sum, expect)
        del expect

        # Dot-product test of the full gradient: <grad, dvals> against the
        # forward block IFT tangent Σ c_i dλ_i + <C, dV>, with
        # M = V^T dA V, dλ = diag(M), dV = V (F∘M) + dV_out, dV_out the
        # batched deflated solve of -(I - V V^T) dA V.  With residuals
        # r_x = P b - D_i x_i and r_d = P rhs_i - D_i dv_i per column
        # (D_i = P (A - λ_i) P), the two sides differ by
        # Σ_i (<r_x_i, dv_i> - <x_i, r_d_i>) exactly, at any CG stopping
        # point, up to round-off.
        g_full = op.vals.grad
        dvals = torch.randn(vals_d.shape, generator=gen, device=DEVICE)
        lhs = grad_dot(g_full, dvals)
        dav = spmv.bell_spmm(dvals, cols, V)
        del dvals
        m = V.T @ dav
        gap = lams[None, :] - lams[:, None]
        f = gap / (gap * gap + 1e-24) * (1 - torch.eye(r, device=DEVICE))
        rhs_d = -(dav - V @ m)
        dv, dv_its, dv_res = solve_deflated_info(
            op, lams, V, rhs_d, tol=CG_TOL, maxiter=MULTI_CG_MAXITER,
            device=DEVICE)
        r_x = (b - V @ (V.T @ b)) - deflated(x)
        r_d = (rhs_d - V @ (V.T @ rhs_d)) - deflated(dv)
        col_terms = [[float(torch.dot(r_x[:, i], dv[:, i])),
                      -float(torch.dot(x[:, i], r_d[:, i]))]
                     for i in range(r)]
        tangent = [float(torch.dot(c, torch.diagonal(m))),
                   float((C * (V @ (f * m))).sum()), float((C * dv).sum())]
        resid_sum = sum(sum(t) for t in col_terms)
        dot_err = abs(lhs - sum(tangent) - resid_sum) / (
            abs(lhs) + sum(abs(t) for t in tangent)
            + sum(abs(t) for ts in col_terms for t in ts))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (lams, V, g_full, g_sum, lams_bf, V_bf,
                               lams_lz))
    # What a LOBPCG iteration spends besides its two SpMMs: two 3r x 3r
    # and one r x r symmetric eigenproblems on the card, and the host read
    # of the block residual.
    g = torch.randn(3 * r, 3 * r, generator=gen, device=DEVICE)
    g = g + g.T
    g_r = g[:r, :r].contiguous()
    eigh_3r_ms = event_ms(lambda: torch.linalg.eigh(g), samples=12, batch=10)
    eigh_r_ms = event_ms(lambda: torch.linalg.eigh(g_r), samples=12,
                         batch=10)
    t0 = time.perf_counter()
    for _ in range(100):
        float(g[0, 0] + 1.0)
    host_read_ms = (time.perf_counter() - t0) * 10
    bf_err = float((lams_bf - lams).abs().max()) / lam_scale
    lams_hex = [[float(t).hex() for t in out] for out in (lams, lams_bf)]
    twin_hex = [[float(t).hex() for t in out[0]] for out in twin_out]
    emit({"phase": "eigh_multi", "n": n, "bs": bs, "blocks_per_row": bpr,
          "r": r, "method": "lobpcg", "k": LOBPCG_ITERS,
          "slot_plan": "all bands", "lams_hex": lams_hex,
          "twin_lams_hex": twin_hex, "twin_lobpcg_iterations": twin_its,
          "twins_forward_s": t_twins,
          "lams": lams.tolist(), "lobpcg_iterations": its,
          "block_residual": float(info.residual),
          "converged": float(info.converged), "warmup_s": t_warm,
          "forward_s": t_fwd, "backward_lam_s": t_bwd_lam,
          "backward_s": t_bwd, "bf16_forward_s": t_bf,
          "lanczos_k": LANCZOS_K, "lanczos_forward_s": t_lz,
          "lanczos_residual": float(info_lz.residual),
          "lanczos_launches": lz,
          "cg_loop_iterations": cg_loop, "cg_iterations": x_its,
          "cg_rel_residuals": x_res, "launches": counts,
          "forward_launches": fwd, "backward_lam_launches": bwd_lam_launches,
          "backward_launches": bwd_launches, "pair_rel_err": pair_err,
          "orthonormality_err": orth_err, "dsumlam_dvals_rel_err": dlam_err,
          "dot_test_lhs": lhs, "dot_test_tangent": tangent,
          "dot_test_column_terms": col_terms, "dot_test_rel_err": dot_err,
          "tangent_cg_iterations": dv_its,
          "tangent_cg_rel_residuals": dv_res,
          "lams_bf16vals": lams_bf.tolist(),
          "bf16_lobpcg_iterations": int(info_bf.effective_k),
          "lams_bf16vals_rel": bf_err, "peak_mem_gib": peak_gib,
          "eigh_3r_ms": eigh_3r_ms, "eigh_r_ms": eigh_r_ms,
          "host_read_ms": host_read_ms})

    checks = {
        # lobpcg.py: one SpMM for A X0, then A W and A P every iteration;
        # with_info adds none (LOBPCG reports its own residual).
        "forward banded SpMM launches == 1 + 2 x iterations":
            fwd["bell_spmm_banded_f32"] == 1 + 2 * its,
        "forward SpMV launches == 0":
            fwd["bell_spmv_f32"] == fwd["bell_spmv_banded_f32"] == 0,
        # V̄ = 0: the batched CG takes no iteration; one SpMM for ∂(A V).
        "∂Σλ backward SpMM launches == 1": bwd_lam_launches == 1,
        "backward SpMM launches == block-CG iterations + 1":
            bwd_launches == cg_loop + 1,
        "block-CG loop == its columns' iterations, rounded up":
            cg_loop == cg_loop_expect,
        "bf16 banded SpMM launches == 1 + 2 x iterations":
            counts["bell_spmm_banded_bf16vals"]
            == 1 + 2 * int(info_bf.effective_k),
        # The twins: the gather SpMMs, the same iterations, the same 8 λ
        # bit for bit (the same sums in the same order).
        "twin gather SpMM launches == 1 + 2 x iterations":
            counts["bell_spmm_f32"] == 1 + 2 * twin_its[0]
            and counts["bell_spmm_bf16vals"] == 1 + 2 * twin_its[1],
        "twins' λ bitwise equal to the banded λ": twin_hex == lams_hex,
        # The Lanczos forward: k SpMVs, and one SpMM for its info residual.
        "lanczos forward: k banded SpMVs + 1 banded SpMM":
            lz["bell_spmv_banded_f32"] == LANCZOS_K
            and lz["bell_spmm_banded_f32"] == 1,
        # Ritz values are Rayleigh quotients of their vectors.
        "|λ_i - v_i^T A v_i| <= 1e-5 max|λ|": pair_err <= 1e-5,
        "||V^T V - I||_max <= 1e-5": orth_err <= 1e-5,
        # The same products as the backward's, formed directly.
        "∂Σλ/∂vals vs Σ v_i⊗v_i, rel 1e-5": dlam_err <= 1e-5,
        # An exact identity up to f32 round-off in products of vectors
        # whose norms the ill-conditioned solves inflate.
        "dot-product test, rel 1e-3": dot_err <= 1e-3,
        # Weyl: bf16 storage moves each eigenvalue by at most 2^-8 ||A||.
        "bf16-values λ within 2^-8 rel": bf_err <= 2.0 ** -8,
        "finite": finite,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"eigh_multi phase failed: {failed}")
    return counts


def phase_panel(spmv, sparse):
    """K4a: the kernels on the row panels one rank of a p-way sharding of
    config #5 keeps (the last rank's, so that vals, cols and y start past
    the operator's first rows), against the plain version and against the
    same rows of the square product."""
    n, bs, bpr = CONFIG5
    nb = n // bs
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    op = sparse.random_bell_operator(n, bs, bpr, generator=gen, device=DEVICE)
    rhs = {"spmv": torch.randn(n, generator=gen, device=DEVICE),
           "spmm": torch.randn(n, PANEL_R, generator=gen, device=DEVICE)}
    kernels = {"spmv": (spmv._bell_spmv_cuda, spmv._bell_spmv_torch),
               "spmm": (spmv._bell_spmm_cuda, spmv._bell_spmm_torch)}
    results = {}
    for suffix, vals in (("f32", op.vals),
                         ("bf16vals", op.vals.to(torch.bfloat16))):
        for kind, (kernel, plain) in kernels.items():
            x = rhs[kind]
            r = 1 if x.ndim == 1 else x.shape[1]
            square = kernel(vals, op.cols, x)
            for p in PANEL_SHARDS:
                nb_l = nb // p
                rows = slice((p - 1) * nb_l, p * nb_l)
                vals_p, cols_p = vals[rows], op.cols[rows]
                y_k = kernel(vals_p, cols_p, x)
                y_p = plain(vals_p, cols_p, x)
                torch.cuda.synchronize()
                err = rel_err(y_k, y_p)
                max_abs = float((y_k - y_p).abs().max())
                square_diff = float((y_k - square[rows.start * bs:
                                                  rows.stop * bs]).abs().max())
                name = f"bell_{kind}_{suffix}"
                if not (math.isfinite(err) and err <= 1e-5
                        and square_diff == 0.0):
                    raise AssertionError(
                        f"{name} panel p={p}: rel err {err} (plain), max "
                        f"|panel - square rows| {square_diff}")
                kernel_ms = event_ms(lambda: kernel(vals_p, cols_p, x),
                                     samples=12, batch=5)
                plain_ms = event_ms(lambda: plain(vals_p, cols_p, x),
                                    samples=12)
                library_ms = lib_err = None
                if vals.dtype == torch.float32:
                    lib = bsr_library_call(vals_p, cols_p, n)
                    lib_err = rel_err(lib(x), y_p)
                    library_ms = event_ms(lambda: lib(x), samples=12)
                    del lib
                # Least bytes: the panel's values and cols, x once (all of
                # it), the panel's y once.
                bytes_min, bound_ms, bound_by = bound(
                    vals_p.numel(), vals_p.element_size(),
                    cols_p.numel() * 4 + x.numel() * 4 + y_k.numel() * 4, r)
                row = {"phase": "panel", "kernel": name, "shards": p,
                       "panel_block_rows": nb_l, "block_cols": nb, "n": n,
                       "bs": bs, "blocks_per_row": bpr, "r": r,
                       "rel_err": err, "max_abs_err": max_abs,
                       "square_rows_max_abs_diff": square_diff,
                       "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "library_rel_err": lib_err,
                       "bytes_min": bytes_min, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       "achieved_gbps": bytes_min / (kernel_ms * 1e-3) / 1e9}
                emit(row)
                results[(name, p)] = row
                del y_k, y_p
            del square
        del vals
    del op, rhs
    torch.cuda.empty_cache()
    return results


def _sharded_rank(rank, world, init_method, out_queue):
    """One rank of the ``sharded`` phase (a spawned process): sends
    (rank, results, None), or (rank, None, traceback) if it failed."""
    try:
        out_queue.put((rank, _sharded_run(rank, world, init_method), None))
    except Exception:  # the parent raises it; this rank exits non-zero
        out_queue.put((rank, None, traceback.format_exc()))
        sys.exit(1)


def _sharded_run(rank, world, init_method):
    from dominantsparseeigenad_tpu_torch import init_distributed, make_mesh
    init_distributed("gloo", init_method, rank, world)
    try:
        return _sharded_solves(make_mesh())
    finally:
        torch.distributed.destroy_process_group()


def _sharded_solves(sg):
    import importlib
    import dominantsparseeigenad_tpu_torch as pkg
    from dominantsparseeigenad_tpu_torch.ops.cg import solve_deflated_info
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                   "bell_spmv")
    n, bs, bpr = CONFIG5
    r = MULTI_R
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    op = pkg.random_bell_operator(n, bs, bpr, generator=gen, device=DEVICE)
    v0 = torch.randn(n, generator=gen, device=DEVICE)
    c = torch.randn(n, generator=gen, device=DEVICE) / math.sqrt(n)
    x0 = torch.randn(n, r, generator=gen, device=DEVICE)
    solve = dict(k=K, extreme="min", tol=CG_TOL, maxiter=SHARDED_CG_MAXITER,
                 v0=v0, device=DEVICE)
    lam_unsharded = None
    if sg.rank == 0:
        # The unsharded solve from the same start, for the check.
        with torch.no_grad():
            lam_unsharded = float(pkg.dominant_eigh(op, **solve)[0])
    # The rank keeps its block-rows; the global operator goes.
    sop = pkg.RowShardedBellOperator.from_bell(op, sg)
    del op
    torch.cuda.empty_cache()
    panel = sop.vals.requires_grad_(True)
    cols_l = sop.cols
    nb_l = panel.shape[0]

    # Warm-up on a small sharded operator through the same calls, so that
    # one-time costs stay out of the times.
    t0 = time.perf_counter()
    small = pkg.RowShardedBellOperator.from_bell(pkg.random_bell_operator(
        1 << 14, bs, bpr, generator=gen, device=DEVICE), sg)
    for o in (small, small.astype_vals(torch.bfloat16)):
        w = o.with_vals(o.vals.detach().clone().requires_grad_(True))
        lam_w, v_w = pkg.dominant_eigh(w, k=20, maxiter=20, device=DEVICE)
        (lam_w + v_w.sum()).backward()
        lams_w, _ = pkg.dominant_eigh_multi(w, r=r, k=10, method="lobpcg",
                                            maxiter=10, device=DEVICE)
        lams_w.sum().backward()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    del small, o, w, lam_w, v_w, lams_w
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted ----------------------------------------
    spmv.reset_launch_counts()
    counts = spmv.panel_launch_counts
    t0 = time.perf_counter()
    lam, v = pkg.dominant_eigh(sop, **solve)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    fwd_launches = counts["bell_spmv_f32"]
    t0 = time.perf_counter()
    (g_lam,) = torch.autograd.grad(lam, panel, retain_graph=True)
    torch.cuda.synchronize()
    t_bwd_lam = time.perf_counter() - t0
    before = counts["bell_spmv_f32"]
    t0 = time.perf_counter()
    (lam + (c * v).sum()).backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    bwd_launches = counts["bell_spmv_f32"] - before
    t0 = time.perf_counter()
    lams, V, info = pkg.dominant_eigh_multi(
        sop, r=r, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL, x0=x0,
        with_info=True, device=DEVICE)
    torch.cuda.synchronize()
    t_multi = time.perf_counter() - t0
    multi_launches = counts["bell_spmm_f32"]
    (g_sum,) = torch.autograd.grad(lams.sum(), panel)
    torch.cuda.synchronize()
    sum_launches = counts["bell_spmm_f32"] - multi_launches
    t0 = time.perf_counter()
    with torch.no_grad():
        sop_bf = sop.astype_vals(torch.bfloat16)
        lam_bf, _ = pkg.dominant_eigh(sop_bf, **solve)
        torch.cuda.synchronize()
        t_bf = time.perf_counter() - t0
        lams_bf, _, info_bf = pkg.dominant_eigh_multi(
            sop_bf, r=r, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL,
            x0=x0, with_info=True, device=DEVICE)
        del sop_bf
    torch.cuda.synchronize()
    t_bf_multi = time.perf_counter() - t0 - t_bf
    launches = dict(counts)
    square_launches = dict(spmv.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # ---- end of the counted run -----------------------------------------

    lam, v, lams, V = lam.detach(), v.detach(), lams.detach(), V.detach()
    its = int(info.effective_k)
    rows = slice(sg.rank * nb_l * bs, (sg.rank + 1) * nb_l * bs)
    with torch.no_grad():
        b = -(c - v * torch.dot(v, c))
        x, cg_its, cg_res = solve_deflated_info(
            sop, lam, v, b, definite_sign=1.0, tol=CG_TOL,
            maxiter=SHARDED_CG_MAXITER, device=DEVICE)
        # ∂λ/∂panel = v[rows] ⊗ v[cols] on the panel's pattern.
        vb = v.reshape(-1, bs)
        expect = vb[rows.start // bs:rows.stop // bs][:, None, :, None] \
            * vb[cols_l.long()][:, :, None, :]
        dlam_err = rel_err(g_lam, expect)
        Vb = V.reshape(-1, bs, r)
        expect = torch.matmul(Vb[rows.start // bs:rows.stop // bs][:, None],
                              Vb[cols_l.long()].transpose(-1, -2))
        dsum_err = rel_err(g_sum, expect)
        del expect
        # Dot-product test of the full gradient: <grad, dvals> summed over
        # the ranks' panels, dA v by the sharded operator on dvals.
        dvals = torch.randn(panel.shape, device=DEVICE,
                            generator=torch.Generator(device=DEVICE)
                            .manual_seed(100 + sg.rank))
        lhs = collectives.all_reduce_sum(torch.tensor(
            [grad_dot(panel.grad, dvals)], dtype=torch.float64), sg)
        dav = sop.with_vals(dvals).matvec(v)
        del dvals
        terms, dot_err, dv_its, dv_res = ift_dot_test(
            sop, lam, v, c, b, x, float(lhs), dav, SHARDED_CG_MAXITER)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (v, panel.grad, g_lam, lams, V, g_sum))

        # The split of a sharded matvec (both ranks in step, so the two
        # ranks' launches share the card): the panel kernel alone, the
        # gather of the panel outputs through the host, the whole matvec.
        y_l = spmv._bell_spmv_cuda(panel.detach(), cols_l, v)
        panel_ms = event_ms(lambda: spmv._bell_spmv_cuda(panel.detach(),
                                                         cols_l, v),
                            samples=12, batch=5)
        gather_ms = event_ms(lambda: collectives.all_gather_rows(y_l, sg),
                             samples=12, batch=5)
        matvec_ms = event_ms(lambda: sop.matvec(v), samples=12, batch=5)
    lam_f = float(lam)
    return {
        "rank": sg.rank, "world": sg.size, "backend": sg.backend,
        "panel_block_rows": nb_l, "lam": lam_f, "lam_hex": lam_f.hex(),
        "lams_hex": [float(t).hex() for t in lams], "lams": lams.tolist(),
        "lam_unsharded": lam_unsharded, "lam_bf16vals": float(lam_bf),
        "lams_bf16vals": lams_bf.tolist(),
        "bf16_lobpcg_iterations": int(info_bf.effective_k),
        "lobpcg_iterations": its, "block_residual": float(info.residual),
        "warmup_s": t_warm, "forward_s": t_fwd, "backward_lam_s": t_bwd_lam,
        "backward_s": t_bwd, "multi_forward_s": t_multi,
        "bf16_forward_s": t_bf, "bf16_multi_forward_s": t_bf_multi,
        "launches": launches,
        "square_launches": square_launches, "forward_launches": fwd_launches,
        "backward_launches": bwd_launches, "multi_launches": multi_launches,
        "dsumlam_launches": sum_launches, "cg_iterations": cg_its,
        "cg_rel_residual": cg_res, "dlam_dpanel_rel_err": dlam_err,
        "dsumlam_dpanel_rel_err": dsum_err, "dot_test_lhs": float(lhs),
        "dot_test_terms": terms, "dot_test_rel_err": dot_err,
        "tangent_cg_iterations": dv_its, "tangent_cg_rel_residual": dv_res,
        "finite": finite, "panel_spmv_ms": panel_ms,
        "gather_ms": gather_ms, "matvec_ms": matvec_ms,
        "peak_mem_gib": peak_gib}


def phase_sharded():
    """Spawn the ranks, collect what each sends, check them together."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    store = tempfile.mkdtemp(prefix="sharded_store_", dir=build)
    # The ranks reach each other over the loopback interface.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = torch.multiprocessing.get_context("spawn")
    out_queue = ctx.Queue()
    procs = [ctx.Process(target=_sharded_rank,
                         args=(rank, SHARDED_RANKS,
                               f"file://{store}/store", out_queue))
             for rank in range(SHARDED_RANKS)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    try:
        got = {}
        for _ in procs:
            try:
                rank, res, err = out_queue.get(timeout=SHARDED_TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError(f"sharded phase: a rank sent nothing in "
                                   f"{SHARDED_TIMEOUT_S} s") from None
            if err is not None:
                raise RuntimeError(f"sharded phase: rank {rank} failed:\n"
                                   f"{err}")
            got[rank] = res
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive() or proc.exitcode != 0:
                raise RuntimeError(f"sharded phase: a rank did not exit "
                                   f"cleanly (exit code {proc.exitcode})")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        shutil.rmtree(store, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    ranks = [got[rank] for rank in range(SHARDED_RANKS)]
    first = ranks[0]
    lam_ref = first["lam_unsharded"]
    unsharded_err = abs(first["lam"] - lam_ref) / abs(lam_ref)
    bf_err = max(
        abs(first["lam_bf16vals"] - first["lam"]) / abs(first["lam"]),
        max(abs(a - b) for a, b in zip(first["lams_bf16vals"],
                                        first["lams"]))
        / max(abs(a) for a in first["lams"]))
    total = {name: sum(res["launches"][name] for res in ranks)
             for name in first["launches"]}
    emit({"phase": "sharded", "note": "2 ranks sharing one card over gloo; "
          "not a multi-GPU or scaling number", "n": CONFIG5[0],
          "bs": CONFIG5[1], "blocks_per_row": CONFIG5[2], "k": K,
          "r": MULTI_R, "lobpcg_cap": LOBPCG_ITERS,
          "cg_cap": SHARDED_CG_MAXITER, "wall_s": wall_s,
          "lam_vs_unsharded_rel": unsharded_err,
          "lam_bf16vals_rel": bf_err, "launches_total": total,
          "ranks": ranks})

    checks = {
        # Lockstep: bit for bit the same eigenvalues on every rank.
        "ranks' λ bitwise equal": all(
            res["lam_hex"] == first["lam_hex"]
            and res["lams_hex"] == first["lams_hex"]
            and res["lams_bf16vals"] == first["lams_bf16vals"]
            for res in ranks),
        # The same Lanczos from the same start, sums in another order.
        "λ vs unsharded λ, rel 1e-4": unsharded_err <= 1e-4,
        "bf16-values λ within 2^-8 rel": bf_err <= 2.0 ** -8,
    }
    for res in ranks:
        rk, cnt = res["rank"], res["launches"]
        checks.update({
            # Every A x and A X of the solvers ran a panel kernel.
            f"rank {rk}: forward panel SpMVs == k":
                res["forward_launches"] == K,
            f"rank {rk}: backward panel SpMVs == CG iterations + 1":
                res["backward_launches"] == res["cg_iterations"] + 1,
            f"rank {rk}: LOBPCG panel SpMMs == 1 + 2 x iterations":
                res["multi_launches"] == 1 + 2 * res["lobpcg_iterations"],
            f"rank {rk}: ∂Σλ panel SpMMs == 1": res["dsumlam_launches"] == 1,
            f"rank {rk}: bf16 panel SpMVs == k":
                cnt["bell_spmv_bf16vals"] == K,
            f"rank {rk}: bf16 LOBPCG panel SpMMs == 1 + 2 x iterations":
                cnt["bell_spmm_bf16vals"]
                == 1 + 2 * res["bf16_lobpcg_iterations"],
            f"rank {rk}: no square launch":
                not any(res["square_launches"].values()),
            f"rank {rk}: ∂λ/∂panel vs v⊗v, rel 1e-5":
                res["dlam_dpanel_rel_err"] <= 1e-5,
            f"rank {rk}: ∂Σλ/∂panel vs Σ v_i⊗v_i, rel 1e-5":
                res["dsumlam_dpanel_rel_err"] <= 1e-5,
            f"rank {rk}: dot-product test, rel 1e-3":
                res["dot_test_rel_err"] <= 1e-3,
            f"rank {rk}: finite": res["finite"],
        })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sharded phase failed: {failed}")
    return total


def tfim_pass(pkg, models, n, dtype, **extra):
    """One forward-mode pass at the headline settings (``extra``: more
    ``dominant_eigh`` options): (E0, dE0/dg, χ_F, ψ), with
    χ_F = <∂ψ|∂ψ> - <ψ|∂ψ>² from the tangent of ψ."""
    with torch.no_grad(), fwAD.dual_level():
        g = fwAD.make_dual(torch.tensor(TFIM_G, dtype=dtype, device=DEVICE),
                           torch.ones((), dtype=dtype, device=DEVICE))
        lam, v = pkg.dominant_eigh(
            models.tfim_operator(n, g, dtype=dtype, device=DEVICE),
            k=min(TFIM_K, 1 << n), extreme="min", tol=TFIM_CG_TOL,
            maxiter=TFIM_CG_MAXITER, reorth_passes=TFIM_REORTH_PASSES,
            device=DEVICE, **extra)
        e0, de0 = fwAD.unpack_dual(lam)
        psi, dpsi = fwAD.unpack_dual(v)
    chi = torch.dot(dpsi, dpsi) - torch.dot(psi, dpsi) ** 2
    return float(e0), float(de0), float(chi), psi


def jw_errors(models, n, g, e0, de0, chi):
    """Relative errors of (E0, dE0/dg, χ_F) against the Jordan-Wigner
    closed forms at ``g``, and those values."""
    jw = (float(models.tfim_exact_e0(n, g, device=DEVICE)),
          models.tfim_exact_de0_dg(n, g), models.tfim_exact_chi_f(n, g))
    return dict(zip(TFIM_RTOL, (abs(a - b) / abs(b) for a, b in
                                zip((e0, de0, chi), jw)))), jw


def phase_tfim(pkg):
    """The TFIM flagship (see the module docstring, phase 8)."""
    from dominantsparseeigenad_tpu_torch import models
    from dominantsparseeigenad_tpu_torch.ops.cg import solve_deflated_info
    f32 = torch.float32

    # N = 10 first: the oracle checks, and the warm-up of every call.
    t0 = time.perf_counter()
    small = tfim_pass(pkg, models, TFIM_N_ED, f32)
    tfim_pass(pkg, models, TFIM_N_ED, f32, **TFIM_HEADLINE)
    ed = [float(t) for t in models.tfim_ed_observables(
        TFIM_N_ED, TFIM_G, dtype=torch.float64, device=DEVICE)]
    torch.cuda.synchronize()
    t_small = time.perf_counter() - t0
    _, jw_small = jw_errors(models, TFIM_N_ED, TFIM_G, *small[:3])
    ed_vs_jw = max(abs(a - b) / abs(b) for a, b in
                   zip((ed[0], ed[1], ed[3]), jw_small))
    small_vs_ed = dict(zip(TFIM_RTOL, (abs(a - b) / abs(b) for a, b in
                                       zip(small[:3], (ed[0], ed[1], ed[3])))))

    # N = 20, the headline: forward-mode passes with the float32 basis and
    # with the bench's bf16 basis and chunked reorthogonalization, each
    # twice (the first at this size carries one-time costs), with the
    # peak device memory each adds over what was allocated before it.
    n = TFIM_N
    passes = {"f32_basis": {}, "bf16_basis": TFIM_HEADLINE}
    t_passes = {name: [] for name in passes}
    peak_mib = {name: [] for name in passes}
    out = {}
    for name in ("f32_basis", "f32_basis", "bf16_basis", "bf16_basis"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[name] = tfim_pass(pkg, models, n, f32, **passes[name])
        torch.cuda.synchronize()
        t_passes[name].append(time.perf_counter() - t0)
        peak_mib[name].append(
            (torch.cuda.max_memory_allocated() - base) / 2**20)
    errs = {name: jw_errors(models, n, TFIM_G, *o[:3])[0]
            for name, o in out.items()}
    _, jw = jw_errors(models, n, TFIM_G, *out["f32_basis"][:3])

    # Where the pass's time goes: the plain forward, the Lanczos step in
    # restart mode "cond" (a host read of β every step) and "carry" (no
    # host read), with either basis, one matvec, the tangent's CG with
    # and without a Jacobi preconditioner (H's diagonal is the zz term).
    op = models.tfim_operator(n, TFIM_G, dtype=f32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    v0 = torch.randn(op.dim, generator=gen, device=DEVICE)
    forward = dict(k=TFIM_K, extreme="min", reorth_passes=TFIM_REORTH_PASSES,
                   v0=v0, device=DEVICE)
    variants = {f"{basis}_{mode}": dict(basis_kw, restart_mode=mode)
                for basis, basis_kw in (("f32", {}),
                                        ("bf16", TFIM_HEADLINE))
                for mode in ("cond", "carry")}
    with torch.no_grad():
        coeffs = {name: pkg.lanczos(op, TFIM_K, v0=v0, reorth_passes=1,
                                    device=DEVICE, **kw)
                  for name, kw in variants.items()}
        step_ms = {name: [] for name in variants}
        for name in [*variants, *reversed(variants)] * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pkg.lanczos(op, TFIM_K, v0=v0, reorth_passes=1, device=DEVICE,
                        **variants[name])
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) / TFIM_K * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lam, v = pkg.dominant_eigh(op, **forward)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        matvec_ms = event_ms(lambda: op.matvec(v), samples=12, batch=10)
        dav = op.tangent_matvec(v, [torch.ones((), device=DEVICE), None])
        rhs = -(dav - torch.dot(v, dav) * v)
        jacobi = pkg.jacobi_precond(
            diag=models.tfim_zz_diagonal(n, dtype=f32, device=DEVICE),
            shift=lam)
        tangent = {}
        for name, precond in (("plain", None), ("jacobi", jacobi)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, its, res = solve_deflated_info(
                op, lam, v, rhs, definite_sign=1.0, tol=TFIM_CG_TOL,
                maxiter=TFIM_CG_MAXITER, precond=precond, device=DEVICE)
            torch.cuda.synchronize()
            tangent[name] = {"s": time.perf_counter() - t0,
                             "iterations": its, "rel_residual": res}
    step = {name: statistics.median(t) for name, t in step_ms.items()}
    e0, de0, chi, psi = out["f32_basis"]
    emit({"phase": "tfim", "n": n, "g": TFIM_G, "dtype": "float32",
          "k": TFIM_K, "reorth_passes": TFIM_REORTH_PASSES,
          "cg_tol": TFIM_CG_TOL, "cg_maxiter": TFIM_CG_MAXITER,
          "headline_options": {k: str(v) for k, v in TFIM_HEADLINE.items()},
          "e0": e0, "de0_dg": de0, "chi_f": chi,
          "bf16_basis": dict(zip(TFIM_RTOL, out["bf16_basis"][:3])),
          "jordan_wigner": dict(zip(TFIM_RTOL, jw)), "rel_err": errs,
          "rtol": TFIM_RTOL, "pass_s": t_passes, "pass_peak_mib": peak_mib,
          "forward_s": t_fwd, "forward_step_ms": t_fwd / TFIM_K * 1e3,
          "matvec_ms": matvec_ms, "lanczos_step_ms": step_ms,
          "lanczos_step_ms_median": step,
          "host_read_ms_per_step": {
              basis: step[f"{basis}_cond"] - step[f"{basis}_carry"]
              for basis in ("f32", "bf16")},
          "tangent_cg": tangent,
          "n_ed": TFIM_N_ED, "small_pass_and_ed_s": t_small,
          "small": dict(zip(TFIM_RTOL, small[:3])),
          "ed": {"e0": ed[0], "de0_dg": ed[1], "d2e0_dg2": ed[2],
                 "chi_f": ed[3]},
          "small_rel_err_vs_ed": small_vs_ed, "ed_vs_jw_rel": ed_vs_jw})

    checks = {f"N={n} {basis} {name} vs Jordan-Wigner, rel "
              f"{TFIM_RTOL[name]}": errs[basis][name] <= TFIM_RTOL[name]
              for basis in errs for name in TFIM_RTOL}
    checks.update({f"N={TFIM_N_ED} {name} vs ED, rel {TFIM_RTOL[name]}":
                   small_vs_ed[name] <= TFIM_RTOL[name] for name in TFIM_RTOL})
    checks.update({
        # Two float64 oracles of the same quantities.
        f"N={TFIM_N_ED} ED vs Jordan-Wigner, rel 1e-10": ed_vs_jw <= 1e-10,
        # No breakdown in these runs: the carried restart direction is
        # never selected, so carry gives cond's α and β bit for bit.
        "carry α, β == cond α, β (each basis)": all(
            torch.equal(coeffs[f"{b}_carry"].alphas, coeffs[f"{b}_cond"].alphas)
            and torch.equal(coeffs[f"{b}_carry"].betas,
                            coeffs[f"{b}_cond"].betas)
            for b in ("f32", "bf16")),
        "bf16 basis stored narrow": coeffs["bf16_cond"].basis.dtype
            == torch.bfloat16,
        "finite": all(math.isfinite(t) for o in out.values()
                      for t in o[:3])
        and all(bool(torch.isfinite(o[3]).all()) for o in out.values()),
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"tfim phase failed: {failed}")


def phase_sweep(pkg):
    """χ_F(g) over the bench's sweep (see the module docstring, phase 9)."""
    from dominantsparseeigenad_tpu_torch import models
    f32 = torch.float32
    gs = torch.linspace(*SWEEP_G, SWEEP_POINTS, dtype=f32)
    kw = dict(k=TFIM_K, tol=TFIM_CG_TOL, maxiter=TFIM_CG_MAXITER, dtype=f32,
              reorth_passes=TFIM_REORTH_PASSES, reorth_chunks=SWEEP_CHUNKS,
              basis_dtype=torch.bfloat16, device=DEVICE)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = models.tfim_observables_sweep(TFIM_N, gs, **kw).cpu()
        times.append(time.perf_counter() - t0)
    errs = [jw_errors(models, TFIM_N, g, *map(float, row))[0]
            for g, row in zip(gs.tolist(), rows)]
    emit({"phase": "sweep", "n": TFIM_N, "gs": gs.tolist(),
          "k": TFIM_K, "reorth_chunks": SWEEP_CHUNKS,
          "basis_dtype": "bfloat16", "restart_mode": "carry",
          "rows": rows.tolist(), "rel_err": errs, "rtol": TFIM_RTOL,
          "sweep_s": times,
          "per_point_s": [t / SWEEP_POINTS for t in times]})
    checks = {f"g={g:.4f} {name} vs Jordan-Wigner, rel {TFIM_RTOL[name]}":
              err[name] <= TFIM_RTOL[name]
              for g, err in zip(gs.tolist(), errs) for name in TFIM_RTOL}
    checks["finite"] = bool(torch.isfinite(rows).all())
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sweep phase failed: {failed}")


def curvature_split(pkg, spmv, make, g0, **kw):
    """The three steps of ``value_d1_d2`` through ``dominant_eigh``, timed
    apart: the forward, the first backward (``create_graph``) and the
    second.  Returns ``(λ, v, d1, d2, op, [forward_s, backward1_s,
    backward2_s], [SpMV launches of each step])``."""
    g = torch.tensor(g0, dtype=torch.float64, device=DEVICE,
                     requires_grad=True)
    counts = spmv.launch_counts
    times, launches = [], []

    def step(fn):
        before = counts["bell_spmv_banded_f32"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(counts["bell_spmv_banded_f32"] - before)
        return out

    op = make(g)
    lam, v = step(lambda: pkg.dominant_eigh(op, device=DEVICE, **kw))
    (d1,) = step(lambda: torch.autograd.grad(lam, g, create_graph=True))
    (d2,) = step(lambda: torch.autograd.grad(d1, g))
    return lam, v, d1, d2, op, times, launches


def second_order_tfim(pkg, spmv, models):
    """Part (a): TFIM N = 20, f32, d²E0/dg² against Jordan-Wigner."""
    from dominantsparseeigenad_tpu_torch.ops.cg import solve_deflated_info
    n = TFIM_N

    def make(g):
        return models.tfim_operator(n, g, dtype=torch.float32, device=DEVICE)

    kw = dict(k=TFIM_K, tol=TFIM_CG_TOL, maxiter=TFIM_CG_MAXITER)
    # Warm-up at N = 10 through the same calls.
    pkg.energy_curvature(lambda g: models.tfim_operator(
        TFIM_N_ED, g, dtype=torch.float32, device=DEVICE), TFIM_G,
        device=DEVICE, **kw)
    lam, v, d1, d2, op, times, _ = curvature_split(pkg, spmv, make, TFIM_G,
                                                   **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [float(t) for t in pkg.energy_curvature(make, TFIM_G,
                                                  device=DEVICE, **kw)]
    torch.cuda.synchronize()
    t_api = time.perf_counter() - t0
    split = [float(t.detach()) for t in (lam, d1, d2)]
    with torch.no_grad():
        # The second backward's solve, by hand: its right-hand side is
        # -(I - v v^T) v̄ with v̄ = 2 (dH/dg) v.
        lam, v = lam.detach(), v.detach()
        dav = op.tangent_matvec(v, [torch.ones((), device=DEVICE), None])
        rhs = -2.0 * (dav - torch.dot(v, dav) * v)
        _, cg_its, cg_res = solve_deflated_info(
            op, lam, v, rhs, tol=TFIM_CG_TOL, maxiter=TFIM_CG_MAXITER,
            device=DEVICE)
    exact = (float(models.tfim_exact_e0(n, TFIM_G, device=DEVICE)),
             models.tfim_exact_de0_dg(n, TFIM_G),
             models.tfim_exact_d2e0_dg2(n, TFIM_G))
    errs = dict(zip(SO_TFIM_RTOL, (abs(a - b) / abs(b)
                                   for a, b in zip(got, exact))))
    out = {"n": n, "g": TFIM_G, "dtype": "float32", "k": TFIM_K,
           "cg_tol": TFIM_CG_TOL, "cg_maxiter": TFIM_CG_MAXITER,
           "values": dict(zip(SO_TFIM_RTOL, got)),
           "jordan_wigner": dict(zip(SO_TFIM_RTOL, exact)), "rel_err": errs,
           "rtol": SO_TFIM_RTOL, "energy_curvature_s": t_api,
           "forward_s": times[0], "backward1_s": times[1],
           "backward2_s": times[2], "second_solve_cg_iterations": cg_its,
           "second_solve_cg_rel_residual": cg_res}
    api_vs_split = max(abs(a - b) / abs(b) for a, b in zip(got, split))
    out["split_values"] = split
    out["energy_curvature_vs_split_rel"] = api_vs_split
    checks = {f"TFIM N={n} {name} vs Jordan-Wigner, rel {SO_TFIM_RTOL[name]}":
              errs[name] <= SO_TFIM_RTOL[name] for name in SO_TFIM_RTOL}
    # energy_curvature is forward over forward, the split reverse over
    # reverse: the same forward (E0 equal), and the same CG on the same
    # system (its right-hand side scaled by 2), which converges here.
    checks["TFIM energy_curvature (forward over forward) vs the timed "
           f"reverse split, rel {FWDN_ROUTE_RTOL}"] = \
        api_vs_split <= FWDN_ROUTE_RTOL and got[0] == split[0]
    return out, checks


@contextlib.contextmanager
def recorded_solves():
    """Record ``(rhs, x, op, sign, λ, V)`` of every differentiable
    deflated solve that runs inside the block (the forward of
    ``ops/cg.py::_DeflatedSolve``, wrapped for the duration)."""
    # The module, not the function of the same name that ops exports.
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    forward = cg._DeflatedSolve.forward
    records = []

    def record(op, sign, tol, maxiter, method, precond, rhs, lam, V, *rest):
        x = forward(op, sign, tol, maxiter, method, precond, rhs, lam, V,
                    *rest)
        records.append((rhs.detach().clone(), x.detach().clone(), op, sign,
                        lam.detach(), V.detach()))
        return x

    cg._DeflatedSolve.forward = staticmethod(record)
    try:
        yield records
    finally:
        cg._DeflatedSolve.forward = staticmethod(forward)


def second_order_config5(pkg, spmv):
    """Part (b): config #5, H(g) = A0 + g A1 over two banded operators."""
    # The module, not the function of the same name that ops exports.
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    n, bs, bpr = CONFIG5
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # A0 is the eigh phase's operator (the same seed), A1 another one.
    a0 = pkg.random_bell_operator(
        n, bs, bpr, generator=torch.Generator(device=DEVICE).manual_seed(7),
        device=DEVICE)
    a1 = pkg.random_bell_operator(
        n, bs, bpr, generator=torch.Generator(device=DEVICE).manual_seed(8),
        device=DEVICE)

    def make(g):
        return pkg.MatrixFreeOperator(
            lambda g, x: a0.matvec(x) + g * a1.matvec(x), g, n,
            dtype=torch.float32)

    kw = dict(k=K, tol=CG_TOL, maxiter=CG_MAXITER)
    # Warm-up: the same calls with a short CG.
    curvature_split(pkg, spmv, make, SO_G, k=10, tol=CG_TOL, maxiter=10)
    spmv.reset_launch_counts()
    with recorded_solves() as solves:
        lam, v, d1, d2, op, times, launches = curvature_split(
            pkg, spmv, make, SO_G, **kw)
    counts = dict(spmv.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [float(t) for t in pkg.energy_curvature(make, SO_G, device=DEVICE,
                                                  **kw)]
    torch.cuda.synchronize()
    t_api = time.perf_counter() - t0
    split = [float(t.detach()) for t in (lam, d1, d2)]
    with torch.no_grad():
        lam, v = lam.detach(), v.detach()
        a1v = a1.matvec(v)
        d1_rule = float(torch.dot(v, a1v))
        # The one solve of the second backward: its right-hand side
        # against the rule written out, -(I - v v^T) 2 (A1 v - d1 v) (λ̄ v
        # and A1 v bring v̄ = A1 v + A1^T v, the second by the plain
        # transposed product); the CG run again on that right-hand side
        # (no graph, the same iterations: the same x); and d2 = <P x, A1 v>,
        # the rule's product.  Exact identities, whether the capped CG
        # converged or not.
        (rhs, x, *_), = solves
        rhs_rule = -2.0 * (a1v - d1_rule * v)
        rhs_rule = rhs_rule - v * torch.dot(v, rhs_rule)
        rhs_err = rel_err(rhs, rhs_rule)
        x_again, cg_its = cg._deflated_solve(op, lam, v, rhs, 1.0, CG_TOL,
                                             CG_MAXITER)
        px = x - v * torch.dot(v, x)
        d2_rule = float(torch.dot(px, a1v))
        d2_scale = float((px * a1v).abs().sum())
        mv = cg._deflated_mv(op, lam, v, 1.0, False)
        cg_res = float(torch.linalg.vector_norm(rhs - mv(x))
                       / torch.linalg.vector_norm(rhs))
        # The plain transposed product the second backward runs on the
        # card: A1^T u (u = λ̄ v) through _bell_rmatmat_torch.
        nb = a1.vals.shape[0]
        rmat_ms = event_ms(lambda: spmv._bell_rmatmat_torch(
            a1.vals, a1.cols, v[:, None], nb), samples=5)
        spmv_ms = event_ms(lambda: op.matvec(v), samples=5)
        ritz = float(torch.linalg.vector_norm(op.matvec(v) - lam * v)
                     / abs(float(lam)))
    d1_err = abs(split[1] - d1_rule) / abs(d1_rule)
    # Relative to the sum of the terms' magnitudes: a capped CG's x can be
    # large, and the f32 sum cancels.
    d2_err = abs(split[2] - d2_rule) / d2_scale
    # Every product of H is two banded SpMVs: k in the forward, one in the
    # first backward (the rule's product; λ brings no eigenvector
    # cotangent, so no solve), and in the second backward the CG's
    # iterations and the rule's product.
    out = {"n": n, "bs": bs, "blocks_per_row": bpr, "g": SO_G, "k": K,
           "cg_tol": CG_TOL, "cg_maxiter": CG_MAXITER,
           "values": dict(zip(("e", "de_dg", "d2e_dg2"), split)),
           "energy_curvature": got, "energy_curvature_s": t_api,
           "ritz_residual": ritz, "forward_s": times[0],
           "backward1_s": times[1], "backward2_s": times[2],
           "launches_per_step": launches, "launches": counts,
           "second_backward_cg_iterations": cg_its,
           "second_backward_cg_rel_residual": cg_res,
           "rhs_vs_rule_rel_err": rhs_err, "d1_rule": d1_rule,
           "d1_rel_err": d1_err, "d2_rule": d2_rule,
           "d2_terms_abs_sum": d2_scale, "d2_err_of_terms": d2_err,
           "peak_mem_gib": peak_gib, "h_matvec_ms": spmv_ms,
           "plain_rmatmat_torch_ms": rmat_ms}
    checks = {
        "forward SpMV launches == 2 k": launches[0] == 2 * K,
        "first backward SpMV launches == 2 (the rule's product)":
            launches[1] == 2,
        "second backward SpMV launches == 2 (CG iterations + 1)":
            launches[2] == 2 * (cg_its + 1),
        "no other kernel ran": all(
            c == 0 for name, c in counts.items()
            if name != "bell_spmv_banded_f32"),
        "one deflated solve in the pass": len(solves) == 1,
        # f32 products in another order (the plain transposed product
        # against the kernel).
        "second solve's rhs vs the rule's, rel 1e-5": rhs_err <= 1e-5,
        "second solve's x reproduced bitwise": torch.equal(x_again, x),
        # Both are v^T A1 v, and <P x, A1 v>: f32 sums in another order.
        "d1 vs v^T A1 v, rel 1e-5": d1_err <= 1e-5,
        "d2 vs <P x, A1 v>, 1e-5 of the sum of |terms|": d2_err <= 1e-5,
        # The forward is deterministic: E bit for bit.  dE/dg is v^T A1 v
        # both ways, a forward-mode dot against a reverse product: float32
        # sums in other orders.  The second derivative is not compared
        # (the capped CGs do not converge).
        "energy_curvature's E equals the split's, bitwise":
            got[0].hex() == split[0].hex(),
        "energy_curvature's dE/dg vs the split's, rel 1e-5":
            abs(got[1] - split[1]) <= 1e-5 * abs(split[1]),
        "config #5 values finite": all(math.isfinite(t)
                                       for t in split + got),
    }
    return out, checks, counts


def second_order_block(pkg, spmv):
    """Part (c): forward mode of dominant_eigh_multi at config #5, and a
    second-order block loss on the small shape, kernel against plain."""
    from dominantsparseeigenad_tpu_torch.ops.cg import (CHECK_EVERY,
                                                        solve_deflated_info)
    n, bs, bpr = CONFIG5
    r = MULTI_R
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    op = pkg.random_bell_operator(n, bs, bpr, generator=gen, device=DEVICE)
    x0 = torch.randn(n, r, generator=gen, device=DEVICE)
    dvals = torch.randn(op.vals.shape, generator=gen, device=DEVICE)
    solve = dict(r=r, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL,
                 maxiter=FWD_CG_MAXITER, x0=x0, with_info=True,
                 device=DEVICE)
    spmv.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), fwAD.dual_level():
        lams_d, V_d, info = pkg.dominant_eigh_multi(
            op.with_vals(fwAD.make_dual(op.vals, dvals)), **solve)
        lams, dlams = fwAD.unpack_dual(lams_d)
        V, dV = fwAD.unpack_dual(V_d)
    torch.cuda.synchronize()
    t_fm = time.perf_counter() - t0
    counts = dict(spmv.launch_counts)
    its = int(info.effective_k)
    cols = op.cols
    with torch.no_grad():
        # The tangent's batched CG, by hand on the same right-hand side
        # (the same products, so the same iterations), timed.
        dav = spmv.bell_spmm(dvals, cols, V, op.slot_plan)
        m = V.T @ dav
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cg_its, cg_res = solve_deflated_info(
            op, lams, V, -(dav - V @ m), tol=CG_TOL, maxiter=FWD_CG_MAXITER,
            device=DEVICE)
        torch.cuda.synchronize()
        t_cg = time.perf_counter() - t0
        loop = min(FWD_CG_MAXITER, -(-max(cg_its) // CHECK_EVERY)
                   * CHECK_EVERY)
        # <dvals, Σ_i v_i⊗v_i> on the pattern, formed a chunk of
        # block-rows at a time, in float64.
        vb = V.reshape(-1, bs, r)
        expect = 0.0
        for rows in torch.arange(n // bs, device=DEVICE).split(256):
            outer = torch.matmul(vb[rows][:, None],
                                 vb[cols[rows].long()].transpose(-1, -2))
            expect += float((dvals[rows].double() * outer.double()).sum())
        dsum = float(dlams.sum())
        finite = bool(torch.isfinite(dV).all())
    del op, dvals, dav
    dsum_err = abs(dsum - expect) / abs(expect)

    # The second-order block loss, kernel against plain, on the small
    # shape.  Its three lowest eigenvalues are pulled apart by diagonal
    # spikes: at the random operator's own block gap (8e-4) a 3e-7 change
    # of the values moves this HVP by 5e-3 (a float32 CPU measurement),
    # and the check would measure that condition, not the kernel.
    sn, sbs, sbpr = SMALL_SHAPES[0]
    sgen = torch.Generator(device=DEVICE).manual_seed(12)
    small = pkg.random_bell_operator(sn, sbs, sbpr, generator=sgen,
                                     device=DEVICE)
    small.vals[0, 0, [0, 1, 2], [0, 1, 2]] -= torch.tensor(
        SO_SPIKES, device=DEVICE)
    sx0 = torch.randn(sn, SO_SMALL_R, generator=sgen, device=DEVICE)
    sdv = torch.randn(small.vals.shape, generator=sgen, device=DEVICE)

    class PlainBanded(pkg.MatrixFreeOperator):
        """The small operator on the plain banded products (no kernel)."""

        def matmat(self, X):
            return spmv._bell_spmm_banded_torch(self.params, small.cols, X,
                                                small.slot_plan)

    def plain(vals):
        return PlainBanded(lambda p, x: spmv._bell_spmv_banded_torch(
            p, small.cols, x, small.slot_plan), vals, sn)

    def hvp(make):
        vals = small.vals.detach().clone().requires_grad_(True)
        lams_s, V_s = pkg.dominant_eigh_multi(
            make(vals), r=SO_SMALL_R, k=LOBPCG_ITERS, method="lobpcg",
            tol=CG_TOL, maxiter=MULTI_CG_MAXITER, x0=sx0, device=DEVICE)
        loss = lams_s.sum() + (V_s ** 4).sum()
        (grad,) = torch.autograd.grad(loss, vals, create_graph=True)
        (h,) = torch.autograd.grad(grad, vals, grad_outputs=sdv)
        return h

    t0 = time.perf_counter()
    h_kernel = hvp(small.with_vals)
    torch.cuda.synchronize()
    t_hvp = time.perf_counter() - t0
    h_plain = hvp(plain)
    hvp_err = rel_err(h_kernel, h_plain)
    out = {"n": n, "r": r, "lobpcg_iterations": its,
           "forward_mode_s": t_fm, "tangent_cg_s": t_cg,
           "forward_mode_minus_cg_s": t_fm - t_cg,
           "tangent_cg_iterations": cg_its, "tangent_cg_loop": loop,
           "tangent_cg_rel_residuals": cg_res, "launches": counts,
           "dsumlam_forward_mode": dsum, "dsumlam_expected": expect,
           "dsumlam_rel_err": dsum_err, "small_n": sn, "small_r": SO_SMALL_R,
           "small_hvp_kernel_s": t_hvp, "small_hvp_rel_err": hvp_err}
    checks = {
        # LOBPCG: 1 + 2 x iterations; one SpMM on the tangent values; one
        # per iteration of the tangent's batched CG.
        "forward-mode SpMM launches == 1 + 2 its + 1 + CG loop":
            counts["bell_spmm_banded_f32"] == 1 + 2 * its + 1 + loop,
        "forward-mode SpMV launches == 0":
            counts["bell_spmv_banded_f32"] == counts["bell_spmv_f32"] == 0,
        # Both are Σ_i v_i^T A(dvals) v_i: f32 sums in other orders.
        "dΣλ vs <dvals, Σ v_i⊗v_i>, rel 1e-5": dsum_err <= 1e-5,
        # The same solves on products that differ by f32 rounding.
        "small block HVP kernel vs plain, rel 1e-4": hvp_err <= 1e-4,
        "block tangents and HVP finite":
            finite and bool(torch.isfinite(h_kernel).all()),
    }
    return out, checks, counts


def phase_second_order(pkg, spmv):
    """Second order through the IFT rules, and forward mode of the block
    solver (see the module docstring, phase 10)."""
    from dominantsparseeigenad_tpu_torch import models
    t0 = time.perf_counter()
    tfim, checks = second_order_tfim(pkg, spmv, models)
    c5, c5_checks, c5_counts = second_order_config5(pkg, spmv)
    block, block_checks, block_counts = second_order_block(pkg, spmv)
    checks.update(c5_checks)
    checks.update(block_checks)
    emit({"phase": "second_order", "tfim": tfim, "config5": c5,
          "block": block, "phase_s": time.perf_counter() - t0})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"second_order phase failed: {failed}")
    reverse_c5 = {"s": c5["forward_s"] + c5["backward1_s"]
                  + c5["backward2_s"], "d2e_dg2": c5["values"]["d2e_dg2"],
                  "cg_iterations": c5["second_backward_cg_iterations"]}
    return {k: c5_counts[k] + block_counts[k] for k in c5_counts}, reverse_c5


def spiked_bell(n, bs, bpr, seed, spikes=()):
    """``(vals, cols)`` of a symmetric ring-banded blocked-ELL operator,
    as ``tools/jax_forward_n_errors.py`` builds it (line for line): the
    pattern of ``random_bell_operator``, values from
    ``numpy.random.default_rng(seed)`` scaled by ``1/sqrt(bpr bs)``, the
    diagonal block symmetrized and its first entries lowered by
    ``spikes``; float32 values, int32 columns."""
    nb, n_off = n // bs, (bpr - 1) // 2
    offs = np.random.default_rng(7).permutation(np.arange(1, nb))[:n_off]
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(bpr * bs)
    i = np.arange(nb)
    d = rng.standard_normal((nb, bs, bs)) * scale
    vals, cols = [(d + d.transpose(0, 2, 1)) / 2], [i]
    for o in offs:
        b = rng.standard_normal((nb, bs, bs)) * scale
        vals += [b, b[(i - o) % nb].transpose(0, 2, 1)]
        cols += [(i + o) % nb, (i - o) % nb]
    vals = np.stack(vals, axis=1)
    for j, sp in enumerate(spikes):
        vals[0, 0, j, j] -= sp
    return vals.astype(np.float32), np.stack(cols, axis=1).astype(np.int32)


def coupled(pkg, a0, a1):
    """``g -> H(g) = A0 + g A1``, a ``MatrixFreeOperator`` over two
    operators (every product two SpMVs)."""
    def make(g):
        return pkg.MatrixFreeOperator(
            lambda g, x: a0.matvec(x) + g * a1.matvec(x), g, a0.dim,
            dtype=torch.float32)
    return make


@contextlib.contextmanager
def solve_iterations():
    """Record the iteration count of every deflated solve inside the
    block (``ops/cg.py::_deflated_solve``, wrapped for the duration)."""
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    solve = cg._deflated_solve
    its = []

    def counted(*args, **kw):
        x, n = solve(*args, **kw)
        its.append(n)
        return x, n

    cg._deflated_solve = counted
    try:
        yield its
    finally:
        cg._deflated_solve = solve


def tfim_point(pkg, models, g, **kw):
    """One coupling's (E0, dE0/dg, χ_F) by one ``torch.func.jvp`` pass
    (the sweep's per-lane computation, called alone)."""
    g = torch.tensor(g, dtype=torch.float32, device=DEVICE)

    def ground(gg):
        return pkg.dominant_eigh(models.tfim_operator(
            TFIM_N, gg, dtype=torch.float32, device=DEVICE), extreme="min",
            device=DEVICE, **kw)

    (lam, v), (dlam, dv) = torch.func.jvp(ground, (g,), (torch.ones_like(g),))
    return torch.stack([lam, dlam, torch.dot(dv, dv) - torch.dot(v, dv) ** 2])


def forward_n_tfim(pkg, spmv, models):
    """Part (a): TFIM N = 20 by forward over forward, and the reverse
    route of the same settings, each timed."""
    n = TFIM_N

    def make(g):
        return models.tfim_operator(n, g, dtype=torch.float32, device=DEVICE)

    kw = dict(k=TFIM_K, tol=TFIM_CG_TOL, maxiter=TFIM_CG_MAXITER)
    # Warm-up at N = 10 through the same call.
    pkg.energy_curvature(lambda g: models.tfim_operator(
        TFIM_N_ED, g, dtype=torch.float32, device=DEVICE), TFIM_G,
        device=DEVICE, **kw)
    with solve_iterations() as its:
        got, t_fwd = timed(lambda: [float(t) for t in pkg.energy_curvature(
            make, TFIM_G, device=DEVICE, **kw)])
    fwd_its = [int(i) for i in its]
    lam, _, d1, d2, _, times, _ = curvature_split(pkg, spmv, make, TFIM_G,
                                                  **kw)
    rev = [float(t.detach()) for t in (lam, d1, d2)]
    exact = (float(models.tfim_exact_e0(n, TFIM_G, device=DEVICE)),
             models.tfim_exact_de0_dg(n, TFIM_G),
             models.tfim_exact_d2e0_dg2(n, TFIM_G))
    errs = dict(zip(FWDN_TFIM_RTOL, (abs(a - b) / abs(b)
                                     for a, b in zip(got, exact))))
    route = abs(got[2] - rev[2]) / abs(rev[2])
    out = {"n": n, "g": TFIM_G, "k": TFIM_K, "cg_tol": TFIM_CG_TOL,
           "cg_maxiter": TFIM_CG_MAXITER,
           "forward_over_forward": dict(zip(FWDN_TFIM_RTOL, got)),
           "reverse_over_reverse": dict(zip(FWDN_TFIM_RTOL, rev)),
           "jordan_wigner": dict(zip(FWDN_TFIM_RTOL, exact)),
           "rel_err": errs, "d2_forward_vs_reverse_rel": route,
           "forward_over_forward_s": t_fwd,
           "reverse_over_reverse_s": sum(times),
           "reverse_steps_s": times, "forward_solve_iterations": fwd_its}
    checks = {f"TFIM N={n} forward over forward {name} vs Jordan-Wigner, "
              f"rel {FWDN_TFIM_RTOL[name]}": errs[name] <= FWDN_TFIM_RTOL[name]
              for name in FWDN_TFIM_RTOL}
    checks[f"TFIM d2 forward over forward vs reverse over reverse, rel "
           f"{FWDN_ROUTE_RTOL}"] = route <= FWDN_ROUTE_RTOL
    # The same forward: E0 is the reverse route's bit for bit.
    checks["TFIM E0 of both routes equal"] = got[0] == rev[0]
    return out, checks


def forward_n_sweep(pkg, models):
    """Part (b): the sweep by vmap against the per-point loop, in both
    restart modes, each timed."""
    gs = torch.linspace(*SWEEP_G, FWDN_SWEEP_POINTS, dtype=torch.float32)
    kw = dict(k=TFIM_K, tol=TFIM_CG_TOL, maxiter=TFIM_CG_MAXITER,
              reorth_passes=TFIM_REORTH_PASSES, reorth_chunks=SWEEP_CHUNKS,
              basis_dtype=torch.bfloat16)
    # Warm-up of the transforms at N = 10.
    models.tfim_observables_sweep(TFIM_N_ED, gs[:2], dtype=torch.float32,
                                  device=DEVICE, **kw)
    out, checks = {}, {}
    for mode in ("cond", "carry"):
        rows, t_vmap = timed(lambda: models.tfim_observables_sweep(
            TFIM_N, gs, dtype=torch.float32, device=DEVICE,
            restart_mode=mode, **kw))
        loop, t_loop = timed(lambda: torch.stack([
            tfim_point(pkg, models, g, restart_mode=mode, **kw)
            for g in gs.tolist()]))
        rows, loop = rows.cpu(), loop.cpu()
        vs_loop = {name: float(((rows[:, j] - loop[:, j]).abs()
                                / loop[:, j].abs()).max())
                   for j, name in enumerate(TFIM_RTOL)}
        errs = [jw_errors(models, TFIM_N, g, *map(float, row))[0]
                for g, row in zip(gs.tolist(), rows)]
        out[mode] = {"vmap_per_point_s": t_vmap / len(gs),
                     "loop_per_point_s": t_loop / len(gs),
                     "vmap_vs_loop_rel": vs_loop,
                     "max_rel_err_vs_jw": {
                         name: max(e[name] for e in errs)
                         for name in TFIM_RTOL},
                     "bitwise_equal": bool(torch.equal(rows, loop))}
        checks.update({
            f"sweep {mode} vmap vs loop {name}, rel {TFIM_RTOL[name]}":
            vs_loop[name] <= TFIM_RTOL[name] for name in TFIM_RTOL})
        checks.update({
            f"sweep {mode} {name} vs Jordan-Wigner, rel {TFIM_RTOL[name]}":
            max(e[name] for e in errs) <= TFIM_RTOL[name]
            for name in TFIM_RTOL})
    out["gs"] = gs.tolist()
    return out, checks


def forward_n_config5(pkg, spmv, reverse):
    """Parts (c) and (e): config #5's H(g) by one nested pass, and vmap
    on its operator."""
    n, bs, bpr = CONFIG5
    torch.cuda.empty_cache()
    a0 = pkg.random_bell_operator(
        n, bs, bpr, generator=torch.Generator(device=DEVICE).manual_seed(7),
        device=DEVICE)
    a1 = pkg.random_bell_operator(
        n, bs, bpr, generator=torch.Generator(device=DEVICE).manual_seed(8),
        device=DEVICE)
    make = coupled(pkg, a0, a1)
    kw = dict(k=K, tol=CG_TOL, maxiter=CG_MAXITER)
    before = dict(spmv.launch_counts)
    with solve_iterations() as its:
        got, t_nested = timed(lambda: [float(t) for t in
                                            pkg.energy_curvature(
                                                make, SO_G, device=DEVICE,
                                                **kw)])
    nested_its = [int(i) for i in its]
    launches = {k: spmv.launch_counts[k] - before[k] for k in before}
    # The first-order jvp's dE/dg (v^T A1 v, formed before its solve, which
    # is capped short: the tangent of v is not read).
    g = torch.tensor(SO_G, dtype=torch.float64, device=DEVICE)
    _, d1_first = torch.func.jvp(
        lambda gg: pkg.dominant_eigh(make(gg), k=K, tol=CG_TOL, maxiter=10,
                                     device=DEVICE)[0],
        (g,), (torch.ones_like(g),))
    d1_first = float(d1_first)
    d1_err = abs(got[1] - d1_first) / abs(d1_first)

    # (e) vmap of a matvec: one SpMM launch, matmat bit for bit.
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    X = torch.randn(FWDN_VMAP_R, n, generator=gen, device=DEVICE)
    before = dict(spmv.launch_counts)
    Y = torch.func.vmap(a0.matvec)(X)
    torch.cuda.synchronize()
    vmap_launches = {k: spmv.launch_counts[k] - before[k] for k in before}
    Z = a0.matmat(X.T.contiguous())
    # Timed apart: these launches are not the path's, and are not counted.
    counted = dict(spmv.launch_counts)
    vmap_ms = event_ms(lambda: torch.func.vmap(a0.matvec)(X), samples=5)
    loop_ms = event_ms(lambda: [a0.matvec(x) for x in X], samples=5)
    spmv.launch_counts.update(counted)
    # vmap of a deflated solve over right-hand sides and shifts: the block
    # CG over columns, against the block solve.
    lam, v = pkg.dominant_eigh(a0, k=K, device=DEVICE)
    lams = lam - 1e-2 * torch.arange(1, FWDN_VMAP_R + 1, device=DEVICE)
    B = torch.randn(FWDN_VMAP_R, n, generator=gen, device=DEVICE)
    solve = dict(tol=CG_TOL, maxiter=FWDN_SOLVE_MAXITER, device=DEVICE)
    xs, t_vsolve = timed(lambda: torch.func.vmap(
        lambda b, s: pkg.solve_deflated(a0, s, v, b, **solve))(B, lams))
    block, t_block = timed(lambda: pkg.solve_deflated(
        a0, lams, v[:, None], B.T.contiguous(), **solve).T)
    solve_err = rel_err(xs, block)
    out = {"n": n, "bs": bs, "blocks_per_row": bpr, "g": SO_G, "k": K,
           "cg_tol": CG_TOL, "cg_maxiter": CG_MAXITER,
           "nested": dict(zip(("e", "de_dg", "d2e_dg2"), got)),
           "nested_s": t_nested, "nested_solve_iterations": nested_its,
           "nested_launches": launches,
           "reverse": reverse, "de_dg_first_order_jvp": d1_first,
           "de_dg_rel_err": d1_err,
           "vmap_matvec_launches": vmap_launches,
           "vmap_matvec_ms": vmap_ms, "loop_of_matvecs_ms": loop_ms,
           "vmap_solve_s": t_vsolve, "block_solve_s": t_block,
           "vmap_solve_vs_block_rel": solve_err}
    checks = {
        "config #5 nested pass launched the banded SpMV (K4b)":
            launches["bell_spmv_banded_f32"] > 0,
        f"config #5 nested dE/dg vs the first-order jvp's, rel "
        f"{FWDN_D1_RTOL}": d1_err <= FWDN_D1_RTOL,
        "config #5 nested values finite": all(math.isfinite(t) for t in got),
        "vmap(matvec) == matmat bit for bit": torch.equal(Y, Z.T),
        "vmap(matvec) is one bell_spmm_banded_f32 launch and no SpMV":
            vmap_launches["bell_spmm_banded_f32"] == 1 and all(
                c == 0 for name, c in vmap_launches.items()
                if name != "bell_spmm_banded_f32"),
        f"vmap(solve_deflated) vs the block solve, rel {FWDN_SOLVE_RTOL}":
            solve_err <= FWDN_SOLVE_RTOL,
    }
    del a0, a1, make
    return out, checks


def forward_n_small(pkg):
    """Part (d): the small spiked shape by one nested pass against the
    float64 sum over states of its dense H."""
    n, bs, bpr = FWDN_SMALL
    ops = [pkg.bell_operator_from_numpy(*spiked_bell(
        n, bs, bpr, seed, SO_SPIKES if i == 0 else ()), n, symmetric=True,
        device=DEVICE) for i, seed in enumerate(FWDN_SEEDS)]
    got, t = timed(lambda: [float(x) for x in pkg.energy_curvature(
        coupled(pkg, *ops), SO_G, k=K, tol=CG_TOL, maxiter=CG_MAXITER,
        device=DEVICE)])
    with torch.no_grad():
        h0, h1 = (o.to_dense().double() for o in ops)
        w, vec = torch.linalg.eigh(h0 + SO_G * h1)
        m = vec.T @ (h1 @ vec[:, 0])
        want = (float(w[0]), float(m[0]),
                float(2.0 * torch.sum(m[1:] ** 2 / (w[0] - w[1:]))))
    errs = dict(zip(FWDN_SMALL_RTOL, (abs(a - b) / abs(b)
                                      for a, b in zip(got, want))))
    out = {"n": n, "bs": bs, "blocks_per_row": bpr, "seeds": FWDN_SEEDS,
           "spikes": SO_SPIKES, "nested": dict(zip(FWDN_SMALL_RTOL, got)),
           "float64_sum_over_states": dict(zip(FWDN_SMALL_RTOL, want)),
           "rel_err": errs, "rtol": FWDN_SMALL_RTOL, "nested_s": t}
    checks = {f"small spiked {name} vs float64 sum over states, rel "
              f"{FWDN_SMALL_RTOL[name]}": errs[name] <= FWDN_SMALL_RTOL[name]
              for name in FWDN_SMALL_RTOL}
    return out, checks


def phase_forward_n(pkg, spmv, reverse_c5):
    """Forward mode to any order, torch.func and vmap (see the module
    docstring, phase 11); ``reverse_c5`` is the second_order phase's
    reverse route at config #5 (time, d², CG iterations), printed beside
    the nested pass.  Returns the phase's kernel launch counts."""
    from dominantsparseeigenad_tpu_torch import models
    t0 = time.perf_counter()
    spmv.reset_launch_counts()
    tfim, checks = forward_n_tfim(pkg, spmv, models)
    sweep, sweep_checks = forward_n_sweep(pkg, models)
    c5, c5_checks = forward_n_config5(pkg, spmv, reverse_c5)
    small, small_checks = forward_n_small(pkg)
    counts = dict(spmv.launch_counts)
    for part in (sweep_checks, c5_checks, small_checks):
        checks.update(part)
    emit({"phase": "forward_n", "card": nvidia_smi_name_power(),
          "tfim": tfim, "sweep": sweep, "config5": c5, "small": small,
          "launches": counts, "phase_s": time.perf_counter() - t0})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"forward_n phase failed: {failed}")
    return counts


def ising_split(fn, dtype, beta=None, **kw):
    """``(ln Z, u, c_v)`` of the flow ``fn`` (``trg_free_energy`` or
    ``ctmrg_free_energy``) at ``beta`` (ISING_BETA when None), the three
    steps of ``value_d1_d2`` timed apart: the forward, the first backward
    (``create_graph``) and the second.  Returns the values, the times in
    s and the peak device memory in GiB."""
    b = torch.tensor(ISING_BETA if beta is None else beta, dtype=dtype,
                     device=DEVICE, requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []

    def step(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    lnz = step(lambda: fn(b, dtype=dtype, device=DEVICE, **kw))
    (d1,) = step(lambda: torch.autograd.grad(lnz, b, create_graph=True))
    (d2,) = step(lambda: torch.autograd.grad(d1, b))
    vals = (float(lnz.detach()), -float(d1.detach()),
            float((b * b * d2).detach()))
    return vals, times, torch.cuda.max_memory_allocated() / 2**30


def ising_errors(vals, exact):
    return {k: abs(a - e) / abs(e) for k, a, e in zip(ISING_KEYS, vals,
                                                     exact)}


def ising_lanczos_split(models, cg):
    """Part (c): TRG with the lanczos split (``dominant_svd``, the block
    IFT rule) at chi = 30, float64: ln Z and one backward for u, every
    deflated solve of the backward recorded.  Returns the values, the
    times and the solves' report."""
    chi, n_steps = ISING_TRG
    b = torch.tensor(ISING_BETA, dtype=torch.float64, device=DEVICE,
                     requires_grad=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lnz = models.trg_free_energy(b, chi=chi, n_steps=n_steps,
                                 split_method="lanczos",
                                 lanczos_maxiter=ISING_LANCZOS_MAXITER,
                                 device=DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with recorded_solves() as solves:
        (d1,) = torch.autograd.grad(lnz, b)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # Each solve's relative residual per column on its own deflated
    # system.  A column whose shift (its singular value) is below 1e-8 of
    # the top one is a null column of a rank-deficient split: no singular
    # triplet (ops/svd.py), and its shifted system is indefinite.
    resolved, null, n_null_cols = 0.0, 0.0, 0
    with torch.no_grad():
        for rhs, x, op, sign, lam, V in solves:
            mv = cg._deflated_mv(op, lam, V, sign, True)
            prhs = cg._project_out(V, rhs)
            res = (torch.linalg.vector_norm(prhs - mv(x), dim=0)
                   / torch.linalg.vector_norm(prhs, dim=0).clamp_min(
                       torch.finfo(rhs.dtype).tiny))
            is_null = lam.abs() <= 1e-8 * lam.abs().max()
            n_null_cols += int(is_null.sum())
            if bool((~is_null).any()):
                resolved = max(resolved, float(res[~is_null].max()))
            if bool(is_null.any()):
                null = max(null, float(res[is_null].max()))
    report = {"solves": len(solves), "null_columns": n_null_cols,
              "resolved_columns_max_rel_residual": resolved,
              "null_columns_max_rel_residual": null}
    return ((float(lnz.detach()), -float(d1)), [t1 - t0, t2 - t1],
            report)


def phase_ising2d(pkg, spmv):
    """BASELINE config #4 (see the module docstring, phase 12)."""
    from dominantsparseeigenad_tpu_torch import models
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    t_phase = time.perf_counter()
    spmv.reset_launch_counts()
    chi, n_steps = ISING_TRG
    ctm_chi, ctm_steps = ISING_CTMRG
    f64, f32 = torch.float64, torch.float32
    # Onsager's values on the card (the port's quadrature, float64),
    # against the JAX package's chip-test constants.
    exact = tuple(float(t) for t in pkg.value_d1_d2(
        lambda x: models.onsager_free_energy(x, n_quad=256, device=DEVICE),
        ISING_BETA, device=DEVICE))
    exact = (exact[0], -exact[1], ISING_BETA ** 2 * exact[2])
    # Warm-up: the same calls at a small chi (library handles, first
    # launches).
    for dtype in (f64, f32):
        ising_split(models.trg_free_energy, dtype, chi=8, n_steps=4)
    ising_split(models.ctmrg_free_energy, f64, chi=4, n_steps=3,
                eigh_solver="lanczos")
    out, checks = {"exact": dict(zip(ISING_KEYS, exact))}, {}
    checks["Onsager on the card vs the JAX chip-test constants, rel 1e-9"] = \
        all(e <= 1e-9 for e in ising_errors(exact, ISING_ONSAGER).values())
    # (a) TRG, float64, the gram split; the API call after the split.
    vals, times, peak = ising_split(models.trg_free_energy, f64, chi=chi,
                                    n_steps=n_steps, split_method="gram")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api = [float(t) for t in models.ising_observables(
        ISING_BETA, method="trg", chi=chi, n_steps=n_steps, device=DEVICE)]
    torch.cuda.synchronize()
    t_api = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    a = torch.randn((chi * chi, chi * chi), dtype=f64, device=DEVICE,
                    generator=gen)
    eigh_ms = event_ms(lambda: pkg.eigh_safe(a, device=DEVICE), samples=5)
    out["trg_gram"] = {
        "chi": chi, "n_steps": n_steps, "dtype": "float64",
        "values": dict(zip(ISING_KEYS, vals)),
        "rel_err": ising_errors(vals, exact),
        "rtol": ISING_RTOL["trg_gram"], "forward_s": times[0],
        "backward1_s": times[1], "backward2_s": times[2],
        "peak_mem_gib": peak, "ising_observables_s": t_api,
        "ising_observables_vs_split_rel": max(
            abs(x - y) / abs(y) for x, y in zip(api, vals)),
        "eigh_safe_900_f64_ms": eigh_ms}
    gram = vals
    # (b) TRG, float32, the subspace split ("auto" in float32).
    vals, times, peak = ising_split(models.trg_free_energy, f32, chi=chi,
                                    n_steps=n_steps, split_method="auto")
    out["trg_subspace_f32"] = {
        "chi": chi, "n_steps": n_steps, "dtype": "float32",
        "values": dict(zip(ISING_KEYS, vals)),
        "rel_err": ising_errors(vals, exact),
        "rtol": ISING_RTOL["trg_subspace_f32"], "forward_s": times[0],
        "backward1_s": times[1], "backward2_s": times[2],
        "peak_mem_gib": peak}
    # (c) TRG, float64, the lanczos split: ln Z and u against (a).
    (lnz, u), times, report = ising_lanczos_split(models, cg)
    u_determined = max(report["resolved_columns_max_rel_residual"],
                       report["null_columns_max_rel_residual"]) \
        <= ISING_RESIDUAL_BAR
    diff = {"lnz": abs(lnz - gram[0]) / abs(gram[0]),
            "u": abs(u - gram[1]) / abs(gram[1])}
    out["trg_lanczos"] = {
        "chi": chi, "n_steps": n_steps, "dtype": "float64",
        "cg_maxiter": ISING_LANCZOS_MAXITER,
        "values": {"lnz": lnz, "u": u}, "rel_diff_vs_gram": diff,
        "rtol_vs_gram": ISING_AGREE["trg_lanczos_vs_gram"],
        "forward_s": times[0], "backward_s": times[1],
        "residual_bar": ISING_RESIDUAL_BAR, "u_determined": u_determined,
        **report}
    # (d) CTMRG, float64, both corner solvers.
    ctm = {}
    for solver in ("truncated", "lanczos"):
        vals, times, peak = ising_split(
            models.ctmrg_free_energy, f64, chi=ctm_chi, n_steps=ctm_steps,
            eigh_solver=solver)
        ctm[solver] = vals
        out[f"ctmrg_{solver}"] = {
            "chi": ctm_chi, "n_steps": ctm_steps, "dtype": "float64",
            "values": dict(zip(ISING_KEYS, vals)),
            "rel_err": ising_errors(vals, exact),
            "rtol": ISING_RTOL[f"ctmrg_{solver}"], "forward_s": times[0],
            "backward1_s": times[1], "backward2_s": times[2],
            "peak_mem_gib": peak}
    agree = ising_errors(ctm["lanczos"], ctm["truncated"])
    out["ctmrg_lanczos_vs_truncated"] = {
        "rel_diff": agree, "rtol": ISING_AGREE["ctmrg_lanczos_vs_truncated"]}
    launched = sum(spmv.launch_counts.values()) + sum(
        spmv.panel_launch_counts.values())
    out["hand_written_kernel_launches"] = launched
    out["note"] = ("config #4 runs no hand-written kernel: dense eigh, "
                   "svd, qr and einsum only")
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "ising2d", "beta": ISING_BETA, **out})
    for part in ("trg_gram", "trg_subspace_f32", "ctmrg_truncated",
                 "ctmrg_lanczos"):
        errs, rtol = out[part]["rel_err"], ISING_RTOL[part]
        for key in ISING_KEYS:
            checks[f"{part} {key} vs Onsager, rel {rtol[key]}"] = \
                errs[key] <= rtol[key]
        checks[f"{part} values finite"] = all(
            math.isfinite(t) for t in out[part]["values"].values())
    # ising_observables is a jvp of a jvp, the split reverse over reverse:
    # the JAX test's bar between those two routes (tests/test_ising2d.py:
    # 312, rtol 1e-6).
    checks["ising_observables (forward over forward) vs the timed reverse "
           "split, rel 1e-6"] = \
        out["trg_gram"]["ising_observables_vs_split_rel"] <= 1e-6
    bars = ISING_AGREE["trg_lanczos_vs_gram"]
    checks[f"trg lanczos lnz vs gram, rel {bars['lnz']}"] = \
        diff["lnz"] <= bars["lnz"]
    if u_determined:
        checks[f"trg lanczos u vs gram, rel {bars['u']}"] = \
            diff["u"] <= bars["u"]
    checks["trg lanczos values finite"] = all(
        math.isfinite(t) for t in (lnz, u))
    for key, bar in ISING_AGREE["ctmrg_lanczos_vs_truncated"].items():
        checks[f"ctmrg lanczos vs truncated {key}, rel {bar}"] = \
            agree[key] <= bar
    checks["no hand-written kernel launched"] = launched == 0
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"ising2d phase failed: {failed}")


@contextlib.contextmanager
def counted_products(pkg, cg):
    """Count the products that run inside the block: every matvec and
    rmatvec of a ``DenseOperator`` or a ``BellOperator``, and the
    iterations of every BiCGStab (``ops/cg.py::_bicgstab_loop``, wrapped
    for the duration; its count stays on the device until read)."""
    counts = {"matvec": 0, "rmatvec": 0, "bicgstab_iterations": []}
    saved = []
    for cls in (pkg.DenseOperator, pkg.BellOperator):
        for name in ("matvec", "rmatvec"):
            fn = getattr(cls, name)

            def wrapped(self, x, fn=fn, name=name):
                counts[name] += 1
                return fn(self, x)
            saved.append((cls, name, fn))
            setattr(cls, name, wrapped)
    loop = cg._bicgstab_loop

    def bicgstab(*args, **kw):
        x, its = loop(*args, **kw)
        counts["bicgstab_iterations"].append(its)
        return x, its

    cg._bicgstab_loop = bicgstab
    try:
        yield counts
    finally:
        cg._bicgstab_loop = loop
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def _read_counts(counts):
    its = counts["bicgstab_iterations"]
    return {"matvecs": counts["matvec"], "rmatvecs": counts["rmatvec"],
            "bicgstab_solves": len(its),
            "bicgstab_iterations": int(sum(int(t) for t in its))}


def timed(fn):
    """``(fn(), seconds)``, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def transfer_xi_eigvals(models, beta, chi, n_steps):
    """ξ from the two leading moduli of ``torch.linalg.eigvals`` of the
    transfer matrix of the same environment (float64, on the card)."""
    c, e, t = models.ctmrg_environment(beta, chi=chi, n_steps=n_steps,
                                       device=DEVICE)
    m = models.transfer_operator(c, e, t, device=DEVICE).a
    w = torch.sort(torch.linalg.eigvals(m).abs(), descending=True).values
    return float(1.0 / torch.log(w[0] / w[1])), m.shape[0]


def eig_transfer(pkg, models, cg):
    """Part (a): ξ, dξ/dβ and the dominant transfer eigenvalue with its
    β-derivative at chi = 30, against Onsager, eigvals and a central
    difference."""
    out, checks = {}, {}
    b = EIG_BETA_DISORDERED
    xi_o = 1.0 / (-math.log(math.tanh(b)) - 2.0 * b)
    dxi_o = xi_o * xi_o * (2.0 / math.sinh(2.0 * b) + 2.0)
    beta = torch.tensor(b, dtype=torch.float64, device=DEVICE,
                        requires_grad=True)
    torch.cuda.reset_peak_memory_stats()
    with counted_products(pkg, cg) as fwd_counts:
        xi, fwd_s = timed(lambda: models.correlation_length(
            beta, chi=EIG_CHI, n_steps=EIG_STEPS, device=DEVICE))
    with counted_products(pkg, cg) as bwd_counts:
        (dxi,), bwd_s = timed(lambda: torch.autograd.grad(xi, beta))
    peak = torch.cuda.max_memory_allocated() / 2**30
    xi, dxi = float(xi.detach()), float(dxi)
    xi_dense, dim = transfer_xi_eigvals(models, b, EIG_CHI, EIG_STEPS)
    lam = models.transfer_spectral_gap(beta, chi=EIG_CHI, n_steps=EIG_STEPS,
                                       device=DEVICE)
    (dlam,) = torch.autograd.grad(lam, beta)
    eps, fd_rtol = EIG_GAP_FD
    fd = (float(models.transfer_spectral_gap(
        b + eps, chi=EIG_CHI, n_steps=EIG_STEPS, device=DEVICE))
        - float(models.transfer_spectral_gap(
            b - eps, chi=EIG_CHI, n_steps=EIG_STEPS, device=DEVICE))) \
        / (2 * eps)
    errs = {"xi_vs_onsager": abs(xi - xi_o) / xi_o,
            "dxi_vs_onsager": abs(dxi - dxi_o) / dxi_o,
            "xi_vs_eigvals": abs(xi - xi_dense) / xi_dense,
            "dlam_vs_fd": abs(float(dlam) - fd) / abs(fd)}
    out["disordered"] = {
        "beta": b, "chi": EIG_CHI, "n_steps": EIG_STEPS, "dim": dim,
        "xi": xi, "dxi_dbeta": dxi, "xi_onsager": xi_o,
        "dxi_onsager": dxi_o, "xi_eigvals": xi_dense,
        "lam": float(lam.detach()), "dlam_dbeta": float(dlam),
        "dlam_fd": fd, "rel_err": errs, "forward_s": fwd_s,
        "backward_s": bwd_s, "peak_mem_gib": peak,
        "forward_products": _read_counts(fwd_counts),
        "backward_products": _read_counts(bwd_counts)}
    checks[f"xi vs Onsager, rel {EIG_ONSAGER_RTOL['xi']}"] = \
        errs["xi_vs_onsager"] <= EIG_ONSAGER_RTOL["xi"]
    checks[f"dxi/dbeta vs Onsager, rel {EIG_ONSAGER_RTOL['dxi']}"] = \
        errs["dxi_vs_onsager"] <= EIG_ONSAGER_RTOL["dxi"]
    checks[f"xi vs eigvals (beta {b}), rel "
           f"{EIG_EIGVALS_RTOL['disordered']}"] = \
        errs["xi_vs_eigvals"] <= EIG_EIGVALS_RTOL["disordered"]
    checks[f"dlam/dbeta vs central difference, rel {fd_rtol}"] = \
        errs["dlam_vs_fd"] <= fd_rtol
    # The ordered phase, the bench's β: a quasi-degenerate top pair.
    for key, chi, n_steps in (("ordered", EIG_CHI, EIG_STEPS),
                              ("ordered_chi10", 10, 15)):
        xi, fwd_s = timed(lambda: float(models.correlation_length(
            ISING_BETA, chi=chi, n_steps=n_steps, device=DEVICE)))
        xi_dense, _ = transfer_xi_eigvals(models, ISING_BETA, chi, n_steps)
        err = abs(xi - xi_dense) / xi_dense
        out[key] = {"beta": ISING_BETA, "chi": chi, "n_steps": n_steps,
                    "xi": xi, "xi_eigvals": xi_dense,
                    "xi_vs_eigvals_rel": err, "forward_s": fwd_s}
        checks[f"{key}: xi > 100"] = xi > 100
        checks[f"{key}: xi vs eigvals, rel {EIG_EIGVALS_RTOL[key]}"] = \
            err <= EIG_EIGVALS_RTOL[key]
    return out, checks


def eig_dense(pkg, cg, dtype):
    """Part (b): a dense non-symmetric positive matrix, n = 2048: λ
    against eigvals; the reverse-mode gradient of ``λ + <c_l, l> +
    <c_r, r>`` against the forward-mode derivative along D (dot-product
    identity); in float64 also its second derivative along D against a
    central difference of the first."""
    n = EIG_DENSE_N
    bars = EIG_DENSE_RTOL[dtype]
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    a = torch.rand((n, n), dtype=dtype, device=DEVICE, generator=gen) + 0.1
    d = torch.randn((n, n), dtype=dtype, device=DEVICE, generator=gen)
    cl = torch.randn(n, dtype=dtype, device=DEVICE, generator=gen)
    cr = torch.randn(n, dtype=dtype, device=DEVICE, generator=gen)

    def loss(m, cl=cl, cr=cr):
        lam, l, r = pkg.dominant_eig(m, device=DEVICE)
        return lam + l @ cl + r @ cr, lam

    def second(m, d, **kw):
        """d²L along d (a double backward), and its seconds."""
        x = m.clone().requires_grad_(True)
        (g1,) = torch.autograd.grad(loss(x, **kw)[0], x, create_graph=True)
        (g2,), d2_s = timed(lambda: torch.autograd.grad((g1 * d).sum(), x))
        return float((g2 * d).sum()), d2_s

    torch.cuda.reset_peak_memory_stats()
    x = a.clone().requires_grad_(True)
    with counted_products(pkg, cg) as fwd_counts:
        (f, lam), fwd_s = timed(lambda: loss(x))
    with counted_products(pkg, cg) as bwd_counts:
        (g,), bwd_s = timed(lambda: torch.autograd.grad(f, x))
    peak = torch.cuda.max_memory_allocated() / 2**30
    w = torch.linalg.eigvals(a.double()).real.max()
    lam = lam.detach()
    lam_err = abs(float(lam) - float(w)) / abs(float(w))
    with fwAD.dual_level():
        (fd_, _), jvp_s = timed(lambda: loss(fwAD.make_dual(a, d)))
        df = float(fwAD.unpack_dual(fd_).tangent)
    gd = float((g * d).sum())
    scale = float(torch.linalg.matrix_norm(g) * torch.linalg.matrix_norm(d))
    dot = abs(gd - df) / scale
    out = {"n": n, "dtype": str(dtype).split(".")[-1], "lam": float(lam),
           "lam_eigvals": float(w), "lam_rel_err": lam_err,
           "grad_dot_d": gd, "forward_mode_df": df,
           "dot_rel_to_df": abs(gd - df) / abs(df),
           "grad_norm_x_d_norm": scale, "dot_rel": dot,
           "forward_s": fwd_s, "backward_s": bwd_s,
           "forward_mode_s": jvp_s, "peak_mem_gib": peak,
           "forward_products": _read_counts(fwd_counts),
           "backward_products": _read_counts(bwd_counts)}
    checks = {f"{out['dtype']} lam vs eigvals, rel {bars['lam']}":
              lam_err <= bars["lam"],
              f"{out['dtype']} grad . D vs forward-mode dL, rel to "
              f"|G| |D| {bars['dot']}": dot <= bars["dot"]}
    d2, d2_s = second(a, d)
    out.update({"d2": d2, "second_backward_s": d2_s})
    if dtype == torch.float32:
        # A central difference of float32 first derivatives is noise at
        # this size (their solves stop at 6e-6): hold d² against the
        # float64 one of the same inputs instead.
        d2_64, _ = second(a.double(), d.double(), cl=cl.double(),
                          cr=cr.double())
        out.update({"d2_float64_same_inputs": d2_64,
                    "d2_rel": abs(d2 - d2_64) / abs(d2_64)})
        checks[f"float32 d2 along D vs float64 d2 of the same inputs, "
               f"rel {bars['d2']}"] = out["d2_rel"] <= bars["d2"]
    else:
        eps = 1e-4

        def first(m):
            m = m.clone().requires_grad_(True)
            (gm,) = torch.autograd.grad(loss(m)[0], m)
            return float((gm * d).sum())

        fd = (first(a + eps * d) - first(a - eps * d)) / (2 * eps)
        out.update({"d2_fd": fd, "d2_rel": abs(d2 - fd) / abs(fd)})
        checks[f"d2 along D vs central difference, rel {bars['d2']}"] = \
            out["d2_rel"] <= bars["d2"]
    return out, checks


def positive_ring_bell(pkg, sparse):
    """A non-symmetric BellOperator with positive values on config #5's
    ring-band pattern at the small shape ``EIG_BELL`` (banded: K4b)."""
    n, bs, bpr = EIG_BELL
    base = sparse.random_bell_operator(n, bs, bpr, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    vals = torch.rand(base.vals.shape, device=DEVICE, generator=gen) + 0.01
    return pkg.BellOperator(vals, base.cols, n, symmetric=False)


def eig_bell(pkg, spmv, sparse, cg):
    """Part (c): ``dominant_eig(method="arnoldi")`` on a non-symmetric
    BellOperator with positive values (config #5's ring-band pattern at
    the small shape), float32: both one-sided residuals, λ against a
    twin solve through the plain product, ∂λ/∂vals against l⊗r on the
    pattern, and the kernel launches of that run."""
    n, bs, bpr = EIG_BELL
    op = positive_ring_bell(pkg, sparse)
    vals = op.vals
    plain = pkg.MatrixFreeOperator(
        lambda p, x: spmv._bell_spmv_torch(p, op.cols, x), vals, n,
        dtype=torch.float32, symmetric=False,
        rmatvec_fn=lambda p, x: spmv._bell_rmatvec_torch(p, op.cols, x,
                                                         vals.shape[0]))
    kw = dict(method="arnoldi", arnoldi_k=EIG_BELL_ARNOLDI_K, device=DEVICE)
    pkg.dominant_eig(op, **kw)                              # warm-up
    spmv.reset_launch_counts()
    x = vals.clone().requires_grad_(True)
    with counted_products(pkg, cg) as counts:
        (lam, l, r, info), fwd_s = timed(lambda: pkg.dominant_eig(
            op.with_vals(x), with_info=True, **kw))
        (g,), bwd_s = timed(lambda: torch.autograd.grad(lam, x))
    counted = dict(spmv.launch_counts)
    launches = {k: v for k, v in counted.items() if v}
    lam, l, r = lam.detach(), l.detach(), r.detach()
    lam_t, _, _ = pkg.dominant_eig(plain, **kw)
    res_r = float(torch.linalg.vector_norm(op.matvec(r) - lam * r)
                  / lam.abs())
    res_l = float(torch.linalg.vector_norm(op.rmatvec(l) - lam * l)
                  / (lam.abs() * torch.linalg.vector_norm(l)))
    nb = n // bs
    lr = l.reshape(nb, 1, bs, 1) * r.reshape(nb, bs)[op.cols.long()][
        :, :, None, :]
    twin = abs(float(lam) - float(lam_t)) / abs(float(lam_t))
    out = {"n": n, "bs": bs, "blocks_per_row": bpr, "lam": float(lam),
           "lam_plain_twin": float(lam_t), "twin_rel": twin,
           "residual_right": res_r, "residual_left": res_l,
           "grad_vs_l_r_rel": rel_err(g, lr), "forward_s": fwd_s,
           "backward_s": bwd_s, "launches": launches,
           "arnoldi_k": EIG_BELL_ARNOLDI_K,
           "power_iterations": float(info.iterations),
           "converged": float(info.converged),
           "rank1_defect": float(info.rank1_defect),
           "products": _read_counts(counts),
           "slot_plan_banded": op.slot_plan is not None}
    checks = {"bell power loop converged": out["converged"] == 1.0,
              f"bell residuals, rel {EIG_BELL_RESIDUAL}":
              max(res_r, res_l) <= EIG_BELL_RESIDUAL,
              f"bell lam vs plain-product twin, rel {EIG_BELL_TWIN_RTOL}":
              twin <= EIG_BELL_TWIN_RTOL,
              "bell dlam/dvals vs l r^T on the pattern, rel 1e-4":
              out["grad_vs_l_r_rel"] <= 1e-4,
              "bell solve launched the banded SpMV kernel":
              launches.get("bell_spmv_banded_f32", 0) > 0}
    return out, checks, counted


def phase_eig(pkg, spmv):
    """The non-symmetric solver (see the module docstring, phase 13).
    Returns the kernel launch counts of its counted BellOperator run."""
    from dominantsparseeigenad_tpu_torch import models
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    sparse = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                     "sparse")
    t_phase = time.perf_counter()
    # Warm-up: the same calls at a small chi (library handles, first
    # launches of eigvals, svdvals and qr).
    b = torch.tensor(EIG_BETA_DISORDERED, dtype=torch.float64, device=DEVICE,
                     requires_grad=True)
    torch.autograd.grad(models.correlation_length(b, chi=4, n_steps=3,
                                                  device=DEVICE), b)
    transfer_xi_eigvals(models, EIG_BETA_DISORDERED, 4, 3)
    for dtype in (torch.float64, torch.float32):
        a = torch.rand((64, 64), dtype=dtype, device=DEVICE) + 0.1
        x = a.clone().requires_grad_(True)
        torch.autograd.grad(pkg.dominant_eig(x, device=DEVICE)[1].sum(), x)
        with fwAD.dual_level():
            pkg.dominant_eig(fwAD.make_dual(a, torch.ones_like(a)),
                             device=DEVICE)
        torch.linalg.eigvals(a.double())
    out, checks = eig_transfer(pkg, models, cg)
    for dtype in (torch.float64, torch.float32):
        part, more = eig_dense(pkg, cg, dtype)
        out[f"dense_{part['dtype']}"] = part
        checks.update(more)
    out["bell"], more, counts = eig_bell(pkg, spmv, sparse, cg)
    checks.update(more)
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "eig", **out})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"eig phase failed: {failed}")
    return counts


def cx_tfim_operator(pkg, models, n, g, phase):
    """H' = D H(g) D^H, D = diag(phase), as a complex64 MatrixFreeOperator
    around the port's ``tfim_matvec``: complex Hermitian, with the real
    TFIM's spectrum; its ground state is D ψ up to a phase."""
    diag = models.tfim_zz_diagonal(n, dtype=torch.float32, device=DEVICE)
    g = torch.as_tensor(g, dtype=torch.float32, device=DEVICE)

    def mv(p, x):
        gg, d, ph = p
        return ph * models.tfim_matvec((gg, d), ph.conj() * x)

    return pkg.MatrixFreeOperator(mv, (g, diag, phase), dim=1 << n,
                                  dtype=torch.complex64)


def cx_tfim(pkg, models):
    """Part (a): the TFIM N = 20 headline in a complex gauge."""
    n = TFIM_N
    gen = torch.Generator(device=DEVICE).manual_seed(CX_GAUGE_SEED)
    phi = 2 * math.pi * torch.rand(1 << n, generator=gen, device=DEVICE)
    phase = torch.polar(torch.ones_like(phi), phi)
    kw = dict(k=TFIM_K, tol=TFIM_CG_TOL, maxiter=TFIM_CG_MAXITER,
              device=DEVICE)

    def forward_mode():
        with torch.no_grad(), fwAD.dual_level():
            g = fwAD.make_dual(
                torch.tensor(TFIM_G, dtype=torch.float32, device=DEVICE),
                torch.ones((), dtype=torch.float32, device=DEVICE))
            lam, v = pkg.dominant_eigh(
                cx_tfim_operator(pkg, models, n, g, phase),
                reorth_passes=TFIM_REORTH_PASSES, **kw)
            e0, de0 = fwAD.unpack_dual(lam)
            psi, dpsi = fwAD.unpack_dual(v)
        chi = (torch.vdot(dpsi, dpsi).real
               - torch.vdot(psi, dpsi).abs() ** 2)
        return float(e0), float(de0), float(chi), psi

    real = tfim_pass(pkg, models, n, torch.float32)
    times, peaks = [], []
    for _ in range(2):           # the first carries one-time costs
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, sec = timed(forward_mode)
        times.append(sec)
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20)
    e0, de0, chi, psi = out
    overlap = float(torch.vdot(phase * real[3].to(psi.dtype), psi).abs())
    errs, jw = jw_errors(models, n, TFIM_G, e0, de0, chi)
    real_errs, _ = jw_errors(models, n, TFIM_G, *real[:3])
    curv, curv_s = timed(lambda: [float(t) for t in pkg.energy_curvature(
        lambda g: cx_tfim_operator(pkg, models, n, g, phase), TFIM_G,
        **kw)])
    d2_jw = models.tfim_exact_d2e0_dg2(n, TFIM_G)
    d2_err = abs(curv[2] - d2_jw) / abs(d2_jw)
    part = {"n": n, "g": TFIM_G, "dtype": "complex64", "k": TFIM_K,
            "e0": e0, "de0_dg": de0, "chi_f": chi,
            "jordan_wigner": dict(zip(TFIM_RTOL, jw)), "rel_err": errs,
            "real_gauge_rel_err": real_errs,
            "overlap_with_gauged_real_state": overlap,
            "forward_mode_pass_s": times, "pass_peak_mib": peaks,
            "energy_curvature": dict(zip(SO_TFIM_RTOL, curv)),
            "d2e0_dg2_jordan_wigner": d2_jw, "d2e0_dg2_rel_err": d2_err,
            "energy_curvature_s": curv_s}
    checks = {f"complex gauge {name} vs Jordan-Wigner, rel "
              f"{TFIM_RTOL[name]}": errs[name] <= TFIM_RTOL[name]
              for name in TFIM_RTOL}
    checks[f"1 - |<D psi, psi'>| <= {CX_OVERLAP_BAR}"] = \
        1.0 - overlap <= CX_OVERLAP_BAR
    checks[f"complex gauge d2E0/dg2 vs Jordan-Wigner, rel "
           f"{SO_TFIM_RTOL['d2e0_dg2']}"] = d2_err <= SO_TFIM_RTOL["d2e0_dg2"]
    return part, checks


def cx_dense(pkg):
    """Part (b): a dense complex Hermitian matrix, complex128."""
    n, r, k, seed = CX_DENSE
    h, d, c = (torch.from_numpy(x).to(DEVICE)
               for x in complex_hermitian_input(n, seed))
    # The oracle, on the card: not on the path.
    (w_all, v_all), eigh_s = timed(lambda: torch.linalg.eigh(h))
    kw = dict(k=k, tol=CX_TOL, device=DEVICE)

    def loss(a):
        lam, v = pkg.dominant_eigh(a, **kw)
        return lam + torch.vdot(c, v).real, lam, v

    torch.cuda.reset_peak_memory_stats()
    x = h.clone().requires_grad_(True)
    (f, lam, v), fwd_s = timed(lambda: loss(x))
    (g,), bwd_s = timed(lambda: torch.autograd.grad(f, x))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with fwAD.dual_level():
        (fd_, _, _), jvp_s = timed(lambda: loss(fwAD.make_dual(h, d)))
        dl = float(fwAD.unpack_dual(fd_).tangent)
    dot = abs(float((g.conj() * d).sum().real) - dl) / float(
        torch.linalg.vector_norm(g) * torch.linalg.vector_norm(d))

    def comp(t):
        v = pkg.dominant_eigh(h + t * d, **kw)[1]
        return v[5].imag + v[3].real

    t = torch.zeros((), dtype=torch.float64, device=DEVICE,
                    requires_grad=True)
    (g_comp,) = torch.autograd.grad(comp(t), t)
    eps = CX_FD_EPS
    fd = (float(comp(eps)) - float(comp(-eps))) / (2 * eps)
    torch.cuda.reset_peak_memory_stats()
    (lams, vv, info), lobpcg_s = timed(lambda: pkg.dominant_eigh_multi(
        h, r=r, k=k, method="lobpcg", tol=CX_TOL, with_info=True,
        device=DEVICE))
    lobpcg_peak = torch.cuda.max_memory_allocated() / 2**30
    lam = float(lam.detach())
    part = {"n": n, "dtype": "complex128", "k": k, "r": r,
            "lam": lam, "lam_eigh": float(w_all[0]),
            "lam_rel": abs(lam - float(w_all[0])) / abs(float(w_all[0])),
            "overlap_defect": 1.0 - float(torch.vdot(v_all[:, 0],
                                                     v.detach()).abs()),
            "dot_rel": dot, "phase_grad": float(g_comp), "phase_fd": fd,
            "phase_grad_vs_fd_rel": abs(float(g_comp) - fd) / abs(fd),
            "lobpcg_rel": float(((lams - w_all[:r]).abs()
                                 / w_all[:r].abs()).max()),
            "lobpcg_iterations": float(info.effective_k),
            "lobpcg_residual": float(info.residual),
            "lobpcg_gram_defect": float((vv.mH @ vv - torch.eye(
                r, dtype=vv.dtype, device=DEVICE)).abs().max()),
            "forward_s": fwd_s, "backward_s": bwd_s,
            "forward_mode_s": jvp_s, "peak_mem_gib": peak,
            "lobpcg_s": lobpcg_s, "lobpcg_peak_mem_gib": lobpcg_peak,
            "eigh_oracle_s": eigh_s}
    bars = CX_RTOL["dense"]
    checks = {f"dense {key}, {bars[key]}": part[key] <= bars[key]
              for key in bars}
    checks["dense LOBPCG converged"] = float(info.converged) == 1.0
    return part, checks


def cx_spectrum(pkg):
    """Part (c): the biased transfer operator's mixed spectrum, float64."""
    n, m, bias, iters = CX_SPECTRUM
    blk, q = (torch.from_numpy(x).to(DEVICE)
              for x in biased_transfer_input(n))

    def a_of(b):
        cs_, sn = torch.cos(b), torch.sin(b)
        a = blk.clone()
        a[1:3, 1:3] = 1.5 * torch.stack([torch.stack([cs_, -sn]),
                                         torch.stack([sn, cs_])])
        return q @ a @ q.T

    kw = dict(m=m, num_iters=iters, power_tol=1e-12, device=DEVICE)
    b0 = torch.tensor(bias, dtype=torch.float64, device=DEVICE)
    a = a_of(b0)
    (lams, ls, rs, structure), disc_s = timed(
        lambda: pkg.dominant_eig_spectrum(a, **kw))
    structure2, struct_s = timed(lambda: pkg.spectrum_structure(a, **kw))
    w = torch.linalg.eigvals(a).cpu().numpy()
    got = lams.cpu().numpy()
    w = w[np.argsort(-np.abs(w))][:got.size]
    errs = np.abs(np.sort_complex(got) - np.sort_complex(w)) / np.abs(
        np.sort_complex(w))
    resid = max(float(torch.linalg.vector_norm(
        a.to(lams.dtype) @ rs[:, j] - lams[j] * rs[:, j])) for j in
        range(got.size))

    def phase(b):
        lam2 = pkg.dominant_eig_spectrum(a_of(b), structure=structure,
                                         **kw)[0][1]
        return torch.atan2(lam2.imag.abs(), lam2.real)

    b = b0.clone().requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()
    theta, replay_s = timed(lambda: phase(b))
    (g,), bwd_s = timed(lambda: torch.autograd.grad(theta, b))
    peak = torch.cuda.max_memory_allocated() / 2**30
    part = {"n": n, "m": m, "bias": bias, "dtype": "float64",
            "structure": structure, "structure_again": structure2,
            "lams": [[z.real, z.imag] for z in got.tolist()],
            "rel_err_vs_eigvals": errs.tolist(),
            "max_rel_err_vs_eigvals": float(errs.max()),
            "max_residual": resid, "theta": float(theta.detach()),
            "dtheta_db": float(g), "dtheta_db_err": abs(float(g) - 1.0),
            "discovery_s": disc_s, "spectrum_structure_s": struct_s,
            "replay_s": replay_s, "backward_s": bwd_s,
            "peak_mem_gib": peak}
    bars = CX_RTOL["spectrum"]
    checks = {f"spectrum {key}, {bars[key]}": part[key] <= bars[key]
              for key in bars}
    checks["spectrum_structure == the discovery's structure"] = \
        structure2 == structure
    checks["spectrum structure starts real, pair, real"] = \
        structure[:3] == ("real", "pair", "real")
    return part, checks


def cx_eig(pkg, cg):
    """Part (d): ``dominant_eig`` on a complex non-symmetric matrix,
    complex128, its gradient by each tangent solver."""
    n, seed = CX_EIG
    a, wv = (torch.from_numpy(x).to(DEVICE)
             for x in complex_nonsymmetric_input(n, seed))
    w = torch.linalg.eigvals(a)
    lam_ref = complex(w[torch.argmax(w.abs())])
    grads, timing, lam = {}, {}, None
    for solver in ("bicgstab", "gmres", "cgnr"):
        x = a.clone().requires_grad_(True)
        torch.cuda.reset_peak_memory_stats()
        with counted_products(pkg, cg) as counts:
            (lam, l, r), fwd_s = timed(lambda: pkg.dominant_eig(
                x, solver=solver, device=DEVICE))
            f = (lam.abs() ** 2 + (wv * r).sum().abs() ** 2
                 + (wv * l).sum().abs() ** 2)
            (grads[solver],), bwd_s = timed(
                lambda: torch.autograd.grad(f, x))
        timing[solver] = {"forward_s": fwd_s, "backward_s": bwd_s,
                          "peak_mem_gib":
                          torch.cuda.max_memory_allocated() / 2**30,
                          "products": _read_counts(counts)}
    base = grads["bicgstab"]
    nb = float(torch.linalg.vector_norm(base))
    diff = {s: float(torch.linalg.vector_norm(g - base)) / nb
            for s, g in grads.items() if s != "bicgstab"}
    diff["gmres_vs_cgnr"] = float(torch.linalg.vector_norm(
        grads["gmres"] - grads["cgnr"])) / nb
    lam = complex(lam.detach())
    part = {"n": n, "dtype": "complex128", "lam": [lam.real, lam.imag],
            "lam_eigvals": [lam_ref.real, lam_ref.imag],
            "lam_rel": abs(lam - lam_ref) / abs(lam_ref),
            "grad_rel_to_bicgstab": diff, "solvers": timing}
    bars = CX_RTOL["eig"]
    checks = {f"eig lam vs eigvals, rel {bars['lam_rel']}":
              part["lam_rel"] <= bars["lam_rel"]}
    checks.update({f"eig gradient {s} vs bicgstab, rel {bars['grad']}":
                   v <= bars["grad"] for s, v in diff.items()})
    return part, checks


def phase_complex(pkg, spmv):
    """Complex operators through the solvers and derivative rules (see
    the module docstring, phase 14).  Runs no hand-written kernel
    (checked: the launch counts stay 0)."""
    from dominantsparseeigenad_tpu_torch import models
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    t_phase = time.perf_counter()
    spmv.reset_launch_counts()
    # Warm-up: the complex calls at small sizes (library handles, first
    # launches of the complex kernels of eigh, eigvals, qr and GEMM).
    hw, dw, cw = (torch.from_numpy(x).to(DEVICE)
                  for x in complex_hermitian_input(64, 0))
    xw = hw.clone().requires_grad_(True)
    lw, vw = pkg.dominant_eigh(xw, k=32, device=DEVICE)
    torch.autograd.grad(lw + torch.vdot(cw, vw).real, xw)
    with fwAD.dual_level():
        pkg.dominant_eigh(fwAD.make_dual(hw, dw), k=32, device=DEVICE)
    pkg.dominant_eigh_multi(hw, r=2, k=20, method="lobpcg", device=DEVICE)
    torch.linalg.eigh(hw)
    aw = torch.from_numpy(complex_nonsymmetric_input(64, 0)[0]).to(DEVICE)
    for solver in ("bicgstab", "gmres", "cgnr"):
        xw = aw.clone().requires_grad_(True)
        torch.autograd.grad(pkg.dominant_eig(xw, solver=solver,
                                             device=DEVICE)[0].abs(), xw)
    torch.linalg.eigvals(aw)
    out, checks = {}, {}
    for name, part in (("tfim_gauge", lambda: cx_tfim(pkg, models)),
                       ("dense", lambda: cx_dense(pkg)),
                       ("spectrum", lambda: cx_spectrum(pkg)),
                       ("eig", lambda: cx_eig(pkg, cg))):
        out[name], more = part()
        checks.update(more)
    launched = sum(spmv.launch_counts.values()) + sum(
        spmv.panel_launch_counts.values())
    checks["no hand-written kernel launched"] = launched == 0
    out["hand_written_kernel_launches"] = launched
    out["card"] = nvidia_smi_name_power()
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "complex", **out})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"complex phase failed: {failed}")


def least_ms(nbytes):
    """Least time (ms) to move ``nbytes`` at the published memory rate."""
    return nbytes / PEAK_BYTES_PER_S * 1e3


def csr_library_call(indptr, indices, data, n):
    """One PyTorch call for the same product: a cuSPARSE CSR matrix on the
    same arrays.  A yardstick only."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = torch.sparse_csr_tensor(indptr, indices, data, size=(n, n),
                                    check_invariants=False)
    return lambda x: a @ x


def tfim_sparse_parts(pkg, n):
    """The N-spin TFIM's two terms as float32 sparse operators from host
    COO triplets, row-major: the zz diagonal (2^N entries) and the
    transverse term (N 2^N entries, state s to s ^ (1 << i), value 1).
    Returns ``{"csr": (zz, x), "coo": (zz, x), "bcoo": (zz, x)}`` and the
    transverse term's (rows, cols) on the card."""
    dim = 1 << n
    s = np.arange(dim, dtype=np.int64)
    bits = (s[:, None] >> np.arange(n)) & 1
    zz = (2 * (bits ^ np.roll(bits, -1, axis=1)).sum(axis=1) - n)
    flips = (s[:, None] ^ (1 << np.arange(n))).reshape(-1)

    def card(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(DEVICE)

    diag, zz = card(s), card(zz, np.float32)
    rows, cols = card(np.repeat(s, n)), card(flips)
    ones = torch.ones(n * dim, device=DEVICE)
    steps = torch.arange(dim + 1, dtype=torch.int32, device=DEVICE)
    parts = {
        "csr": (pkg.CSROperator(steps, diag, zz, dim),
                pkg.CSROperator(steps * n, cols, ones, dim)),
        "coo": (pkg.COOOperator(diag, diag, zz, dim),
                pkg.COOOperator(rows, cols, ones, dim)),
        "bcoo": tuple(pkg.BCOOOperator(torch.sparse_coo_tensor(
            torch.stack([r, c]).long(), v, (dim, dim),
            check_invariants=False))
            for r, c, v in ((diag, diag, zz), (rows, cols, ones))),
    }
    return parts, (rows, cols)


def sparse_tfim(parts):
    """``g -> H(g) = ZZ + (-g) X`` through the operator algebra, g a
    tensor (a float32 parameter of the ScaledOperator)."""
    zz, x = parts
    return lambda g: zz + (-g.to(torch.float32)) * x


def formats_tfim(pkg, models):
    """Part (a): TFIM N = 20 as sparse matrices (module docstring, phase
    15)."""
    n, f32 = TFIM_N, torch.float32
    kw = dict(k=TFIM_K, tol=TFIM_CG_TOL, maxiter=TFIM_CG_MAXITER,
              device=DEVICE)
    one = torch.ones((), device=DEVICE)

    def jvp_e0(make, g):
        return torch.func.jvp(lambda gg: pkg.dominant_eigh(
            make(gg), reorth_passes=TFIM_REORTH_PASSES, **kw)[0], (g,),
            (torch.ones_like(g),))

    # Warm-up at N = 10 through the same calls.
    small, _ = tfim_sparse_parts(pkg, TFIM_N_ED)
    for name in ("csr", "coo", "bcoo"):
        make = sparse_tfim(small[name])
        g = torch.tensor(TFIM_G, device=DEVICE, requires_grad=True)
        lam, _ = pkg.dominant_eigh(make(g), **kw)
        torch.autograd.grad(lam, g)
    make = sparse_tfim(small["csr"])
    jvp_e0(make, torch.tensor(TFIM_G, device=DEVICE))
    pkg.energy_curvature(make, TFIM_G, **kw)
    pkg.fidelity_susceptibility(make, TFIM_G, **kw)
    del small, make

    (parts, (rows, cols)), t_build = timed(lambda: tfim_sparse_parts(pkg, n))
    make_csr = sparse_tfim(parts["csr"])
    dim, nnz = 1 << n, (n + 1) << n
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g = torch.tensor(TFIM_G, dtype=f32, device=DEVICE, requires_grad=True)
    (lam, v), t_fwd = timed(lambda: pkg.dominant_eigh(
        make_csr(g), reorth_passes=TFIM_REORTH_PASSES, **kw))
    (d1,), t_bwd = timed(lambda: torch.autograd.grad(lam, g))
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    g0 = torch.tensor(TFIM_G, dtype=f32, device=DEVICE)
    (_, d1_fwd), t_jvp = timed(lambda: jvp_e0(make_csr, g0))
    curv, t_curv = timed(lambda: [float(t) for t in pkg.energy_curvature(
        make_csr, TFIM_G, **kw)])
    chi, t_chi = timed(lambda: float(pkg.fidelity_susceptibility(
        make_csr, TFIM_G, **kw)))
    e0, d1, d1_fwd = float(lam.detach()), float(d1), float(d1_fwd)
    errs, jw = jw_errors(models, n, TFIM_G, e0, d1, chi)
    errs["de0_dg_forward_mode"] = abs(d1_fwd - jw[1]) / abs(jw[1])
    d2_exact = models.tfim_exact_d2e0_dg2(n, TFIM_G)
    errs["d2e0_dg2"] = abs(curv[2] - d2_exact) / abs(d2_exact)
    errs["energy_curvature_e0"] = abs(curv[0] - jw[0]) / abs(jw[0])
    errs["energy_curvature_de0_dg"] = abs(curv[1] - jw[1]) / abs(jw[1])

    with torch.no_grad():
        h = {"csr": make_csr(g0),
             "coo": sparse_tfim(parts["coo"])(g0),
             "bcoo": sparse_tfim(parts["bcoo"])(g0),
             "matrix_free": models.tfim_operator(n, TFIM_G, dtype=f32,
                                                 device=DEVICE)}
        e0_of = {name: float(pkg.dominant_eigh(
            h[name], reorth_passes=TFIM_REORTH_PASSES, **kw)[0])
            for name in ("coo", "matrix_free")}
        v = v.detach()
        y = {name: op.matvec(v) for name, op in h.items()}
        repeats = [h["csr"].matvec(v) for _ in range(10)]
        bitwise = sum(bool(torch.equal(t, y["csr"])) for t in repeats)
        # cuSPARSE on the same matrix as one CSR: 21 entries a row.
        zz = parts["csr"][0].data
        lib = csr_library_call(
            torch.arange(dim + 1, dtype=torch.int32, device=DEVICE) * (n + 1),
            torch.cat([parts["csr"][0].indices[:, None],
                       cols.view(dim, n)], dim=1).reshape(-1),
            torch.cat([zz[:, None], torch.full((dim, n), -TFIM_G,
                                               device=DEVICE)],
                      dim=1).reshape(-1), dim)
        y["cusparse_csr"] = lib(v)
        ms = {name: event_ms(lambda op=op: op.matvec(v), samples=12,
                             batch=10) for name, op in h.items()}
        ms["cusparse_csr"] = event_ms(lambda: lib(v), samples=12, batch=10)
    triplet_bytes = nnz * 12 + 2 * dim * 4
    least = {"csr": triplet_bytes, "coo": triplet_bytes,
             "bcoo": triplet_bytes, "matrix_free": 3 * dim * 4,
             "cusparse_csr": nnz * 8 + (dim + 1) * 4 + 2 * dim * 4}
    matvec = {name: {"ms": ms[name], "least_bytes": least[name],
                     "bound_ms": least_ms(least[name]),
                     "rel_err_vs_csr": rel_err(y[name], y["csr"])}
              for name in ms}
    for name in ("csr", "coo", "bcoo"):
        matvec[name]["code_bytes"] = nnz * TRIPLET_CODE_BYTES_PER_NNZ
        matvec[name]["code_bytes_ms"] = least_ms(
            nnz * TRIPLET_CODE_BYTES_PER_NNZ)
    route = {name: abs(e0_of[name] - e0) / abs(e0_of[name])
             for name in e0_of}
    out = {"n": n, "g": TFIM_G, "dtype": "float32", "k": TFIM_K,
           "cg_tol": TFIM_CG_TOL, "cg_maxiter": TFIM_CG_MAXITER, "nnz": nnz,
           "e0": e0, "de0_dg": d1, "de0_dg_forward_mode": d1_fwd,
           "d2e0_dg2": curv[2], "chi_f": chi, "energy_curvature": curv,
           "jordan_wigner": {"e0": jw[0], "de0_dg": jw[1],
                             "d2e0_dg2": d2_exact, "chi_f": jw[2]},
           "rel_err": errs, "e0_of": e0_of, "e0_rel_vs_csr": route,
           "build_s": t_build, "forward_s": t_fwd, "backward_s": t_bwd,
           "forward_backward_peak_mib": peak_mib, "forward_mode_s": t_jvp,
           "energy_curvature_s": t_curv, "fidelity_susceptibility_s": t_chi,
           "matvec": matvec, "csr_matvec_bitwise_repeats": bitwise,
           "csr_matvec_bit_reproducible": bitwise == len(repeats)}
    bars = {**TFIM_RTOL, "de0_dg_forward_mode": TFIM_RTOL["de0_dg"],
            "d2e0_dg2": SO_TFIM_RTOL["d2e0_dg2"],
            "energy_curvature_e0": TFIM_RTOL["e0"],
            "energy_curvature_de0_dg": TFIM_RTOL["de0_dg"]}
    checks = {f"TFIM N={n} CSR {name} vs Jordan-Wigner, rel {bar}":
              errs[name] <= bar for name, bar in bars.items()}
    checks.update({
        f"TFIM N={n} CSR E0 vs the {name} run, rel {FMT_ROUTE_RTOL}":
            route[name] <= FMT_ROUTE_RTOL for name in route})
    checks.update({
        f"TFIM N={n} {name} matvec vs CSR, rel {FMT_ROUTE_RTOL}":
            matvec[name]["rel_err_vs_csr"] <= FMT_ROUTE_RTOL
        for name in ("coo", "bcoo", "matrix_free", "cusparse_csr")})
    checks["TFIM CSR values finite"] = all(
        math.isfinite(t) for t in (e0, d1, d1_fwd, chi, *curv))
    del parts, h, y, repeats, lib, rows, cols
    return out, checks


def formats_config5(pkg, spmv, lam_eigh):
    """Part (b): config #5 through the composites, and part (d), config
    #5 as one CSR (module docstring, phase 15)."""
    n, bs, bpr = CONFIG5
    counts = spmv.launch_counts
    torch.cuda.empty_cache()
    a0, v0 = config5_operator(pkg)
    a1 = pkg.random_bell_operator(
        n, bs, bpr, generator=torch.Generator(device=DEVICE).manual_seed(8),
        device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    X = torch.randn(n, MULTI_R, generator=gen, device=DEVICE)
    u = torch.nn.functional.normalize(torch.randn(n, generator=gen,
                                                  device=DEVICE), dim=0)
    shifted = pkg.ShiftedOperator(a0, FMT_SHIFT)
    g64 = torch.tensor(SO_G, dtype=torch.float64, device=DEVICE)
    composites = {"shifted": (shifted, 1),
                  "scaled": (pkg.ScaledOperator(a0, FMT_SCALE), 1),
                  "sum_of_scaled": (a0 + g64 * a1, 2),
                  "deflated": (pkg.DeflatedOperator(a0, u), 1),
                  "transposed": (a0.T, 1)}
    out, checks = {"n": n, "bs": bs, "blocks_per_row": bpr, "k": K,
                   "shift": FMT_SHIFT, "scale": FMT_SCALE}, {}
    with torch.no_grad():
        block = {}
        for name, (op, children) in composites.items():
            before = dict(counts)
            Y = op.matmat(X)
            torch.cuda.synchronize()
            block[name] = {k: counts[k] - before[k] for k in before
                           if counts[k] != before[k]}
            checks[f"{name}.matmat: {children} bell_spmm_banded_f32 "
                   f"launch(es), no SpMV"] = block[name] == {
                       "bell_spmm_banded_f32": children} and bool(
                           torch.isfinite(Y).all())
        out["block_product_launches"] = block
        fwd = dict(k=K, extreme="min", v0=v0, device=DEVICE)
        (lam_s, _), t_s = timed(lambda: pkg.dominant_eigh(shifted, **fwd))
        (lam_c, _), t_c = timed(lambda: pkg.dominant_eigh(
            composites["scaled"][0], **fwd))
    lam_s, lam_c = float(lam_s), float(lam_c)
    shift_err = abs(lam_s - (lam_eigh - FMT_SHIFT)) / abs(lam_eigh)
    scale_err = abs(lam_c - FMT_SCALE * lam_eigh) / abs(FMT_SCALE * lam_eigh)
    out.update({"lam_eigh_phase": lam_eigh, "lam_shifted": lam_s,
                "lam_scaled": lam_c, "shifted_rel_err": shift_err,
                "scaled_rel_err": scale_err, "shifted_forward_s": t_s,
                "scaled_forward_s": t_c})
    checks[f"dominant_eigh(A - σ) == λ - σ, rel {FMT_COMPOSITE_RTOL}"] = \
        shift_err <= FMT_COMPOSITE_RTOL
    checks[f"dominant_eigh(c A) == c λ, rel {FMT_COMPOSITE_RTOL}"] = \
        scale_err <= FMT_COMPOSITE_RTOL

    # H(g) = A0 + g A1 by the algebra and by the coupled matrix-free
    # route: the first-order jvp's dE/dg (v^T A1 v, formed before its
    # solve, which is capped short: the tangent of v is not read).
    d1 = {}
    for name, make in (("algebra", lambda gg: pkg.SumOperator(
            a0, pkg.ScaledOperator(a1, gg))),
                       ("matrix_free", coupled(pkg, a0, a1))):
        (_, d), t = timed(lambda make=make: torch.func.jvp(
            lambda gg: pkg.dominant_eigh(make(gg), k=K, tol=CG_TOL,
                                         maxiter=10, device=DEVICE)[0],
            (g64,), (torch.ones_like(g64),)))
        d1[name] = {"de_dg": float(d), "s": t}
    d1_err = abs(d1["algebra"]["de_dg"] - d1["matrix_free"]["de_dg"]) \
        / abs(d1["matrix_free"]["de_dg"])
    out["h_of_g"] = {"g": SO_G, **d1, "rel_err": d1_err}
    checks[f"H(g) by the algebra: dE/dg vs the matrix-free route, rel "
           f"{FMT_ROUTE_RTOL}"] = d1_err <= FMT_ROUTE_RTOL
    del a1, composites
    torch.cuda.empty_cache()

    # The block solver on A - σ: one SpMM per block product.
    before = dict(counts)
    with torch.no_grad():
        (lams, V, info), t_lob = timed(lambda: pkg.dominant_eigh_multi(
            shifted, r=MULTI_R, k=LOBPCG_ITERS, method="lobpcg", x0=X,
            with_info=True, device=DEVICE))
        lob = {k: counts[k] - before[k] for k in before}
        its = int(info.effective_k)
        rq = torch.stack([torch.dot(V[:, i], shifted.matvec(
            V[:, i].contiguous())) for i in range(MULTI_R)])
    rq_err = float((rq - lams).abs().max() / lams.abs().max())
    out["lobpcg"] = {"r": MULTI_R, "iterations": its, "lams": lams.tolist(),
                     "residual": float(info.residual), "s": t_lob,
                     "launches": {k: c for k, c in lob.items() if c},
                     "rayleigh_quotient_rel_err": rq_err}
    checks["LOBPCG on A - σ: banded SpMM launches == 1 + 2 x iterations, "
           "no SpMV"] = lob["bell_spmm_banded_f32"] == 1 + 2 * its and all(
               c == 0 for k, c in lob.items() if k != "bell_spmm_banded_f32")
    checks["LOBPCG on A - σ: λ vs Rayleigh quotients, rel 1e-5"] = \
        rq_err <= 1e-5

    # The preconditioner of the shifted operator.
    with torch.no_grad():
        (d, jac), t_pc = timed(lambda: (pkg.operator_diagonal(shifted),
                                        pkg.jacobi_precond(shifted,
                                                           shift=lam_s)))
        d0 = pkg.operator_diagonal(a0)
        ref = pkg.jacobi_precond(diag=d0 - FMT_SHIFT, shift=lam_s)
        same = bool(torch.equal(d, d0 - FMT_SHIFT)) and bool(
            torch.equal(jac(X), ref(X)))
    out["precond_build_s"] = t_pc
    checks["operator_diagonal(A - σ) == diag(A) - σ, Jacobi equal"] = same
    del V, X, shifted, d, d0, jac, ref

    # Part (d): config #5 as one CSR, row-major (block-row i, row a in the
    # block, slot j, column b): 2176 entries a row.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nb, max_blk = a0.cols.shape
    row_nnz = max_blk * bs

    def build():
        b = torch.arange(bs, dtype=torch.int32, device=DEVICE)
        return pkg.CSROperator(
            torch.arange(n + 1, dtype=torch.int32, device=DEVICE) * row_nnz,
            (a0.cols[:, None, :, None] * bs + b).expand(
                nb, bs, max_blk, bs).reshape(-1),
            a0.vals.permute(0, 2, 1, 3).reshape(-1), n,
            torch.arange(n, dtype=torch.int32, device=DEVICE)[:, None]
            .expand(n, row_nnz).reshape(-1))

    torch.cuda.reset_peak_memory_stats()
    csr, t_build = timed(build)
    x = torch.randn(n, generator=gen, device=DEVICE)
    counted = dict(counts)                  # comparison launches: uncounted
    with torch.no_grad():
        y_csr = csr.matvec(x)
        y_k4b = a0.matvec(x)
        lib = csr_library_call(csr.indptr, csr.indices, csr.data, n)
        lib_err = rel_err(lib(x), y_k4b)
        ms = {}
        for name in ("k4b", "csr", "cusparse_csr", "cusparse_csr", "csr",
                     "k4b"):
            fn = {"k4b": lambda: a0.matvec(x), "csr": lambda: csr.matvec(x),
                  "cusparse_csr": lambda: lib(x)}[name]
            ms.setdefault(name, []).append(event_ms(fn, samples=5))
    counts.update(counted)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    nnz = csr.nnz
    err = rel_err(y_csr, y_k4b)
    least = {"csr": nnz * 12 + 2 * n * 4,
             "cusparse_csr": nnz * 8 + (n + 1) * 4 + 2 * n * 4,
             "k4b": nnz * 4 + nb * max_blk * 4 + 2 * n * 4}
    out["config5_csr"] = {
        "nnz": nnz, "build_s": t_build, "peak_gib": peak_gib,
        "rel_err_vs_k4b": err, "cusparse_rel_err_vs_k4b": lib_err,
        "ms": ms, "ms_median": {k: statistics.median(t)
                                for k, t in ms.items()},
        "least_bytes": least,
        "bound_ms": {k: least_ms(b) for k, b in least.items()},
        "code_bytes_ms": least_ms(nnz * TRIPLET_CODE_BYTES_PER_NNZ)}
    checks[f"config #5 CSR matvec vs K4b, rel {FMT_CSR_RTOL}"] = \
        err <= FMT_CSR_RTOL
    checks[f"config #5 cuSPARSE CSR vs K4b, rel {FMT_CSR_RTOL}"] = \
        lib_err <= FMT_CSR_RTOL
    del csr, lib, a0, y_csr, y_k4b
    torch.cuda.empty_cache()
    return out, checks


def formats_transpose(pkg, sparse):
    """Part (c): ``dominant_eig`` of the eig phase's non-symmetric Bell
    and of its transpose (module docstring, phase 15)."""
    op = positive_ring_bell(pkg, sparse)
    kw = dict(method="arnoldi", arnoldi_k=EIG_BELL_ARNOLDI_K, with_info=True,
              device=DEVICE)
    with torch.no_grad():
        (lam, l, r, info), t = timed(lambda: pkg.dominant_eig(op, **kw))
        (lam_t, l_t, r_t, info_t), t_t = timed(lambda: pkg.dominant_eig(
            op.T, **kw))
        # A^T's right vector is A's left one, and its left A's right.
        res_left = float(torch.linalg.vector_norm(
            op.rmatvec(r_t) - lam_t * r_t) / lam_t.abs())
        res_right = float(torch.linalg.vector_norm(
            op.matvec(l_t) - lam_t * l_t)
            / (lam_t.abs() * torch.linalg.vector_norm(l_t)))

        def cos(a, b):
            return float(torch.dot(a, b) / (torch.linalg.vector_norm(a)
                                            * torch.linalg.vector_norm(b)))

    twin = abs(float(lam_t) - float(lam)) / abs(float(lam))
    out = {"n": EIG_BELL[0], "lam": float(lam), "lam_transposed":
           float(lam_t), "rel": twin, "residual_left_of_a": res_left,
           "residual_right_of_a": res_right,
           "cos_r_transposed_l": cos(r_t, l), "cos_l_transposed_r":
           cos(l_t, r), "converged": [float(info.converged),
                                      float(info_t.converged)],
           "forward_s": t, "transposed_forward_s": t_t}
    checks = {
        f"dominant_eig(A.T) λ vs dominant_eig(A), rel {EIG_BELL_TWIN_RTOL}":
            twin <= EIG_BELL_TWIN_RTOL,
        f"A.T's r is A's left vector and its l A's right, residuals "
        f"{EIG_BELL_RESIDUAL}": max(res_left, res_right) <= EIG_BELL_RESIDUAL,
        "both power loops converged": out["converged"] == [1.0, 1.0]}
    return out, checks


def phase_formats(pkg, spmv, lam_eigh):
    """The COO, CSR and BCOO formats and the operator algebra (module
    docstring, phase 15).  Returns the phase's kernel launch counts."""
    from dominantsparseeigenad_tpu_torch import models
    sparse = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                     "sparse")
    t_phase = time.perf_counter()
    spmv.reset_launch_counts()
    out, checks = {}, {}
    for name, part in (("tfim", lambda: formats_tfim(pkg, models)),
                       ("config5", lambda: formats_config5(pkg, spmv,
                                                           lam_eigh)),
                       ("transpose", lambda: formats_transpose(pkg,
                                                               sparse))):
        out[name], more = part()
        checks.update(more)
    counts = dict(spmv.launch_counts)
    for name in ("bell_spmv_banded_f32", "bell_spmm_banded_f32"):
        checks[f"{name} launched on the formats path"] = counts[name] > 0
    out["launches"] = {k: c for k, c in counts.items() if c}
    out["card"] = nvidia_smi_name_power()
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "formats", **out})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"formats phase failed: {failed}")
    return counts


def config5_operator(pkg):
    """The eigh phase's operator and start vector (the same seed and
    draws)."""
    n, bs, bpr = CONFIG5
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    op = pkg.random_bell_operator(n, bs, bpr, generator=gen, device=DEVICE)
    return op, torch.randn(n, generator=gen, device=DEVICE)


def peak_since(fn):
    """``(fn(), seconds, MiB)``: the MiB the call's peak adds to what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, seconds = timed(fn)
    return out, seconds, (torch.cuda.max_memory_allocated() - base) / 2**20


def restart_resume(pkg, op, v0):
    """The cycle-stepped driver at config #5: RESTART_RESUME_AT cycles, a
    checkpoint written and read back into a fresh state, the remaining
    cycles; against the uninterrupted run, field by field."""
    from dominantsparseeigenad_tpu_torch.utils import load_pytree, save_pytree
    k = RESTART_K
    init = pkg.restart_init(op, k, v0=v0, device=DEVICE)
    full = init
    for _ in range(RESTART_CYCLES):
        full, _ = pkg.restart_cycle(op, full, k)
    state = init
    for _ in range(RESTART_RESUME_AT):
        state, _ = pkg.restart_cycle(op, state, k)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "restart_state")
        save_pytree(path, state)
        fresh = pkg.RestartState(*(torch.empty_like(t) for t in state))
        del state
        state = load_pytree(path, fresh)
    for _ in range(RESTART_CYCLES - RESTART_RESUME_AT):
        state, _ = pkg.restart_cycle(op, state, k)
    return {"bitwise": {f: torch.equal(getattr(state, f), getattr(full, f))
                        for f in state._fields},
            "max_abs_diff": {f: float((getattr(state, f)
                                       - getattr(full, f)).abs().max())
                             for f in state._fields},
            "lam": float(pkg.restart_extract(state)[0])}


def restart_config5(pkg, spmv, lam_eigh):
    """Part (a) of the restart phase (module docstring, phase 16)."""
    n, bs, bpr = CONFIG5
    k, cycles = RESTART_K, RESTART_CYCLES
    kernel = "bell_spmv_banded_f32"
    counts = spmv.launch_counts
    op, v0 = config5_operator(pkg)
    op.vals.requires_grad_(True)
    before = counts[kernel]
    (lam, v), t_fwd, peak_r = peak_since(lambda: pkg.dominant_eigh(
        op, k=k, restart_cycles=cycles, v0=v0, device=DEVICE))
    fwd_launches = counts[kernel] - before
    before = counts[kernel]
    (g,), t_bwd = timed(lambda: torch.autograd.grad(lam, op.vals))
    bwd_launches = counts[kernel] - before
    lam, v = lam.detach(), v.detach()
    with torch.no_grad():
        resid = float(torch.linalg.vector_norm(op.matvec(v) - lam * v))
        (lam_p, v_p), t_plain, peak_p = peak_since(lambda: pkg.dominant_eigh(
            op, k=K, v0=v0, device=DEVICE))
        resid_p = float(torch.linalg.vector_norm(op.matvec(v_p)
                                                 - lam_p * v_p))
        vb = v.reshape(-1, bs)
        expect = vb[:, None, :, None] * vb[op.cols.long()][:, :, None, :]
        dlam_err = rel_err(g, expect)
        del expect, g
        (resume, t_resume) = timed(lambda: restart_resume(pkg, op, v0))
    lam_f, lam_pf = float(lam), float(lam_p)
    expected = k + 1 + cycles * (k - max(1, k // 4))
    vec_mib = n * 4 / 2**20
    out = {"n": n, "k": k, "cycles": cycles, "lam": lam_f,
           "ritz_residual": resid, "forward_s": t_fwd, "backward_s": t_bwd,
           "forward_launches": fwd_launches, "expected_launches": expected,
           "backward_launches": bwd_launches, "peak_mib": peak_r,
           "window_mib": (k + 1) * vec_mib, "dlam_dvals_rel_err": dlam_err,
           "plain_k": K, "plain_lam": lam_pf, "plain_ritz_residual": resid_p,
           "plain_forward_s": t_plain, "plain_peak_mib": peak_p,
           "plain_basis_mib": (K + 1) * vec_mib,
           "plain_lam_equals_eigh_phase": lam_pf.hex() == lam_eigh.hex(),
           "lam_gap": abs(lam_f - lam_pf), "resume": resume,
           "resume_cycles": [RESTART_RESUME_AT,
                             cycles - RESTART_RESUME_AT],
           "resume_run_s": t_resume,
           "resumed_lam_equals_dominant_eigh": resume["lam"] == lam_f}
    checks = {
        # restart_init: k SpMVs and one for q_{k+1}; each cycle k - l.
        "restart forward launches == k + 1 + cycles (k - k/4)":
            fwd_launches == expected,
        # ∂λ alone: one matvec differentiated, no solve.
        "∂λ backward launches == 1": bwd_launches == 1,
        "|λ_restart - λ_plain| <= sum of their Ritz residual norms":
            abs(lam_f - lam_pf) <= resid + resid_p,
        "∂λ/∂vals vs v⊗v, rel 1e-5": dlam_err <= 1e-5,
        "restart window below the plain basis: peak_mib < plain_peak_mib":
            peak_r < peak_p,
        "resumed state == uninterrupted state, bit for bit":
            all(resume["bitwise"].values()),
        "finite": math.isfinite(lam_f) and math.isfinite(resid),
    }
    return out, checks


def restart_tfim(pkg, models):
    """Part (b): restart_bench.py's cell through dominant_eigh."""
    n, p = RESTART_TFIM_N, RESTART_TFIM

    def value_and_grad():
        g = torch.tensor(p["g"], dtype=torch.float32, device=DEVICE,
                         requires_grad=True)
        lam, _ = pkg.dominant_eigh(
            models.tfim_operator(n, g, dtype=torch.float32, device=DEVICE),
            k=p["k"], restart_cycles=p["cycles"],
            reorth_passes=p["reorth_passes"], device=DEVICE)
        (d,) = torch.autograd.grad(lam, g)
        return float(lam.detach()), float(d)

    runs = [peak_since(value_and_grad) for _ in range(2)]
    (e0, de0), _, peak = runs[-1]
    jw = (float(models.tfim_exact_e0(n, p["g"], device=DEVICE)),
          models.tfim_exact_de0_dg(n, p["g"]))
    errs = dict(zip(RESTART_RTOL, (abs(a - b) / abs(b) for a, b in
                                   zip((e0, de0), jw))))
    out = {"n": n, "dim": 1 << n, **p, "e0": e0, "de0_dg": de0,
           "jw": jw, "rel_err": errs,
           "value_and_grad_s": [t for _, t, _ in runs], "peak_mib": peak,
           "window_mib": (p["k"] + 1) * (1 << n) * 4 / 2**20}
    checks = {f"TFIM N={n} {key} vs Jordan-Wigner, rel {bar}":
              errs[key] <= bar for key, bar in RESTART_RTOL.items()}
    return out, checks


def restart_stepped(pkg, models):
    """Part (c): the cycle-stepped driver at RESTART_STEPPED_N."""
    from dominantsparseeigenad_tpu_torch.models.tfim import flip_sum
    n, p = RESTART_STEPPED_N, RESTART_TFIM
    k, passes = p["k"], p["reorth_passes"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    op = models.tfim_operator(n, p["g"], dtype=torch.float32, device=DEVICE)
    matvec_ms = event_ms(lambda: op.matvec(op.params[1]), samples=3)
    state, t_init = timed(lambda: pkg.restart_init(
        op, k, reorth_passes=passes, device=DEVICE))
    cycle_s, resids = [], []
    for _ in range(p["cycles"]):
        (state, resid), t = timed(lambda: pkg.restart_cycle(
            op, state, k, reorth_passes=passes))
        cycle_s.append(t)
        resids.append(float(resid))
    lam, v, _ = pkg.restart_extract(state)
    del state
    # Hellmann-Feynman: dE0/dg = <v| dH/dg |v> = -<v| Σ_i X_i |v>.
    de0 = -float(torch.dot(v, flip_sum(v, n)))
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    e0 = float(lam)
    jw = (float(models.tfim_exact_e0(n, p["g"], device=DEVICE)),
          models.tfim_exact_de0_dg(n, p["g"]))
    errs = dict(zip(RESTART_RTOL, (abs(a - b) / abs(b) for a, b in
                                   zip((e0, de0), jw))))
    out = {"n": n, "dim": 1 << n, **p, "e0": e0, "de0_dg": de0, "jw": jw,
           "rel_err": errs, "init_s": t_init, "cycle_s": cycle_s,
           "cycle_residuals": resids, "matvec_ms": matvec_ms,
           "peak_gib": peak,
           "window_gib": (k + 1) * (1 << n) * 4 / 2**30}
    checks = {f"TFIM N={n} stepped {key} vs Jordan-Wigner, rel {bar}":
              errs[key] <= bar for key, bar in RESTART_RTOL.items()}
    del op, v
    return out, checks


def phase_restart(pkg, spmv, lam_eigh):
    """Thick-restart Lanczos (module docstring, phase 16).  Returns the
    phase's kernel launch counts."""
    from dominantsparseeigenad_tpu_torch import models
    t_phase = time.perf_counter()
    spmv.reset_launch_counts()
    out, checks = {}, {}
    for name, part in (("config5", lambda: restart_config5(pkg, spmv,
                                                           lam_eigh)),
                       ("tfim", lambda: restart_tfim(pkg, models)),
                       ("stepped", lambda: restart_stepped(pkg, models))):
        out[name], more = part()
        checks.update(more)
        torch.cuda.empty_cache()
    counts = dict(spmv.launch_counts)
    checks["bell_spmv_banded_f32 launched on the restart path"] = \
        counts["bell_spmv_banded_f32"] > 0
    out["launches"] = {k: c for k, c in counts.items() if c}
    out["card"] = nvidia_smi_name_power()
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "restart", **out})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"restart phase failed: {failed}")
    return counts


def diagonal_operator(pkg, w, n, dtype=torch.float32):
    """diag(w) as a MatrixFreeOperator whose parameter is ``w``."""
    return pkg.MatrixFreeOperator(lambda d, x: d * x, w, n, dtype=dtype)


def gen_config5(pkg, spmv):
    """Part (a) of the gen phase, and (c) (module docstring, phase 17)."""
    from dominantsparseeigenad_tpu_torch.ops import gen as gen_module
    from dominantsparseeigenad_tpu_torch.ops.cg import CHECK_EVERY
    n, bs, bpr = CONFIG5
    r = MULTI_R
    kernel = "bell_spmm_banded_f32"
    counts = spmv.launch_counts
    a, v0 = config5_operator(pkg)
    a.vals.requires_grad_(True)
    gen = torch.Generator(device=DEVICE).manual_seed(GEN_SEED)
    m = (1.0 + torch.rand(n, generator=gen, device=DEVICE)).requires_grad_()
    x0 = torch.randn(n, r, generator=gen, device=DEVICE)
    c = torch.randn(r, generator=gen, device=DEVICE)
    C = torch.randn(n, r, generator=gen, device=DEVICE) / math.sqrt(n)
    m_d = m.detach()
    b = diagonal_operator(pkg, m, n)
    before = dict(counts)
    (lams, X, info), t_fwd, peak = peak_since(lambda: pkg.dominant_eigh_gen(
        a, b, r=r, maxiter=LOBPCG_ITERS, tol=CG_TOL,
        solve_maxiter=MULTI_CG_MAXITER, precond=lambda z: z / m_d, x0=x0,
        with_info=True, device=DEVICE))
    fwd = {key: counts[key] - before[key] for key in counts
           if counts[key] != before[key]}
    its = int(info.effective_k)
    before = counts[kernel]
    (g_m_lam,), t_lam = timed(lambda: torch.autograd.grad(
        lams.sum(), m, retain_graph=True))
    lam_bwd = counts[kernel] - before
    # The full loss' gradient; its one pencil CG is recorded as it runs.
    loop, cg_its = gen_module._cg_columns_loop, []

    def recorded(*args, **kw):
        out = loop(*args, **kw)
        cg_its.append(int(out[1].max()))
        return out

    gen_module._cg_columns_loop = recorded
    try:
        before = counts[kernel]
        loss = (c * lams).sum() + (C * X).sum()
        (g_vals, g_m), t_bwd = timed(lambda: torch.autograd.grad(
            loss, (a.vals, m)))
        bwd = counts[kernel] - before
    finally:
        gen_module._cg_columns_loop = loop
    lams_d, X_d = lams.detach(), X.detach().double()
    with torch.no_grad():
        gram = X_d.T @ (m_d.double()[:, None] * X_d)
        bortho = float((gram - torch.eye(r, dtype=gram.dtype,
                                         device=DEVICE)).abs().max())
        finite = all(bool(torch.isfinite(t).all())
                     for t in (lams_d, X_d, g_vals, g_m))
        # The two routes' ∂λ_i/∂m are -λ_i x_i² (the pencil rule) and
        # -x_i ⊙ (A x_i) / m (the standard rule through D): they differ by
        # -x_i ⊙ r_i / m, r_i = A x_i - λ_i M x_i, which an unconverged
        # block leaves.
        Xf = X.detach()
        resid_blk = a.matmat(Xf) - m_d[:, None] * Xf * lams_d[None, :]
        corr = -(Xf * resid_blk).sum(dim=1) / m_d
        del g_vals, g_m, gram, resid_blk
    # The standard problem D A D, D = M^{-1/2}, by the operator algebra;
    # unpreconditioned LOBPCG from M^{1/2} x0.
    m2 = m_d.clone().requires_grad_(True)
    d = diagonal_operator(pkg, m2.rsqrt(), n)
    dad = d @ (a.with_vals(a.vals.detach()) @ d)
    before = counts[kernel]
    (lams_s, _, info_s), t_std = timed(lambda: pkg.dominant_eigh_multi(
        dad, r=r, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL,
        x0=x0 * m_d.sqrt()[:, None], with_info=True, device=DEVICE))
    std_launches = counts[kernel] - before
    (g_m_std,) = torch.autograd.grad(lams_s.sum(), m2)
    its_std = int(info_s.effective_k)
    route_lam = rel_err(lams_s.detach(), lams_d)
    route_grad = rel_err(g_m_std, g_m_lam + corr)
    route_grad_raw = rel_err(g_m_std, g_m_lam)
    del g_m_std, g_m_lam, corr
    # (c) reorth_chunks in the block solver's Lanczos sweep.
    with torch.no_grad():
        (lams_c, _), t_chunks = timed(lambda: pkg.dominant_eigh_multi(
            a, r=r, k=K, reorth_chunks=4, v0=v0, device=DEVICE))
        lams_u, _ = pkg.dominant_eigh_multi(a, r=r, k=K, v0=v0,
                                            device=DEVICE)
    out = {"n": n, "r": r, "lams": lams_d.tolist(),
           "lobpcg_iterations": its, "residual": float(info.residual),
           "forward_s": t_fwd, "forward_launches": fwd, "peak_mib": peak,
           "lam_backward_s": t_lam, "lam_backward_launches": lam_bwd,
           "backward_s": t_bwd, "backward_launches": bwd,
           "backward_cg_iterations": cg_its,
           "b_orthonormality_defect": bortho,
           "dad_lams": lams_s.detach().tolist(),
           "dad_lobpcg_iterations": its_std,
           "dad_residual": float(info_s.residual), "dad_forward_s": t_std,
           "dad_launches": std_launches, "route_lam_rel": route_lam,
           "route_dsumlam_dm_rel": route_grad,
           "route_dsumlam_dm_rel_uncorrected": route_grad_raw,
           "chunked_lams": lams_c.tolist(), "chunked_forward_s": t_chunks,
           "chunked_vs_unchunked_rel": rel_err(lams_c, lams_u)}
    checks = {
        # One A product of the start block, then A W and A P an iteration;
        # B is matrix-free, and no SpMV.
        "pencil forward: SpMMs == 1 + 2 iterations, no SpMV":
            fwd == {kernel: 1 + 2 * its},
        "∂Σλ backward: one SpMM (A V), no solve": lam_bwd == 1,
        # The pencil CG's matmats (a column frozen once it meets the
        # tolerance, the host checking every CHECK_EVERY) and one A V.
        "backward SpMMs - 1 in [CG iterations, + CHECK_EVERY)":
            len(cg_its) == 1
            and cg_its[0] <= bwd - 1 < cg_its[0] + CHECK_EVERY,
        f"X^T B X = I within {GEN_BORTHO_BAR}": bortho <= GEN_BORTHO_BAR,
        "D A D forward: SpMMs == 1 + 2 iterations": std_launches
            == 1 + 2 * its_std,
        f"pencil λ vs D A D λ, rel {GEN_ROUTE_RTOL['lam']}":
            route_lam <= GEN_ROUTE_RTOL["lam"],
        f"∂Σλ/∂m pencil + residual term vs D A D, rel "
        f"{GEN_ROUTE_RTOL['dsumlam_dm']}":
            route_grad <= GEN_ROUTE_RTOL["dsumlam_dm"],
        "reorth_chunks=4 λ == unchunked λ": torch.equal(lams_c, lams_u),
        "finite": finite,
    }
    return out, checks


def gen_vibrational(pkg):
    """Part (b): examples/vibrational_modes.py's chain, float64."""
    import scipy.linalg
    n, r = VIB["n"], VIB["r"]
    rng = np.random.default_rng(0)
    ks = 1.0 + rng.random(n + 1)
    kmat = (np.diag(ks[:-1] + ks[1:]) - np.diag(ks[1:-1], 1)
            - np.diag(ks[1:-1], -1))
    masses = 0.5 + rng.random(n)
    kt = torch.tensor(kmat, device=DEVICE)
    kinv = torch.tensor(np.linalg.inv(kmat), device=DEVICE)
    m = torch.tensor(masses, device=DEVICE, requires_grad=True)
    (lams, _, info), t_fwd = timed(lambda: pkg.dominant_eigh_gen(
        kt, diagonal_operator(pkg, m, n, torch.float64), r=r,
        maxiter=VIB["maxiter"], tol=1e-12, precond=lambda v: kinv @ v,
        with_info=True, device=DEVICE))
    (grad,), t_bwd = timed(lambda: torch.autograd.grad(lams[0], m))
    ew = scipy.linalg.eigh(kmat, np.diag(masses), eigvals_only=True)
    j = int(torch.argmin(grad))
    eps = VIB["fd_eps"]
    mp, mm = masses.copy(), masses.copy()
    mp[j] += eps
    mm[j] -= eps
    fd = (scipy.linalg.eigh(kmat, np.diag(mp), eigvals_only=True)[0]
          - scipy.linalg.eigh(kmat, np.diag(mm), eigvals_only=True)[0]) \
        / (2 * eps)
    lam_err = float(np.abs(lams.detach().cpu().numpy() / ew[:r] - 1).max())
    grad_err = abs(float(grad[j]) - fd) / abs(fd)
    out = {"n": n, "r": r, "omega2": lams.detach().tolist(),
           "lobpcg_iterations": float(info.effective_k),
           "omega2_rel_err": lam_err, "site": j, "grad": float(grad[j]),
           "fd": fd, "grad_vs_fd_rel": grad_err, "forward_s": t_fwd,
           "backward_s": t_bwd}
    checks = {"chain LOBPCG converged": float(info.converged) == 1.0,
              f"ω² vs scipy.linalg.eigh(K, M), rel {VIB_RTOL['omega2']}":
                  lam_err <= VIB_RTOL["omega2"],
              f"d(ω0²)/dm vs central difference, rel "
              f"{VIB_RTOL['grad_vs_fd']}": grad_err <= VIB_RTOL["grad_vs_fd"]}
    return out, checks


def phase_gen(pkg, spmv):
    """The generalized pencil (module docstring, phase 17).  Returns the
    phase's kernel launch counts."""
    t_phase = time.perf_counter()
    spmv.reset_launch_counts()
    out, checks = {}, {}
    for name, part in (("config5", lambda: gen_config5(pkg, spmv)),
                       ("vibrational", lambda: gen_vibrational(pkg))):
        out[name], more = part()
        checks.update(more)
        torch.cuda.empty_cache()
    counts = dict(spmv.launch_counts)
    for name in ("bell_spmv_banded_f32", "bell_spmm_banded_f32"):
        checks[f"{name} launched on the gen path"] = counts[name] > 0
    out["launches"] = {k: c for k, c in counts.items() if c}
    out["card"] = nvidia_smi_name_power()
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "gen", **out})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"gen phase failed: {failed}")
    return counts

def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dominantsparseeigenad_tpu_torch as pkg
    # The module, not the function of the same name that ops exports.
    spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                   "bell_spmv")
    sparse = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                     "sparse")

    copy_gbps = phase_build(spmv)
    big = spmv_case(spmv, sparse, *CONFIG5, copy_gbps, seed=1)
    spmv_case(spmv, sparse, *SMALL_SHAPES[0], copy_gbps, seed=2)
    spmv_case(spmv, sparse, *SMALL_SHAPES[1], copy_gbps, seed=3,
              unaligned=True)
    counts, lam_eigh = phase_eigh(pkg, spmv)
    spmm = [spmm_case(spmv, sparse, *shape, r, seed=4 + i,
                      unaligned=unaligned)
            for i, (shape, r, unaligned) in enumerate(SPMM_SHAPES)]
    counts.update({k: v for k, v in phase_eigh_multi(pkg, spmv).items()
                   if k.startswith("bell_spmm")})
    big.update(spmm[0])
    panel = phase_panel(spmv, sparse)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    panel_counts = phase_sharded()
    phase_tfim(pkg)
    phase_sweep(pkg)
    so_counts, reverse_c5 = phase_second_order(pkg, spmv)
    for name in ("bell_spmv_banded_f32", "bell_spmm_banded_f32"):
        if so_counts[name] < 1:
            raise AssertionError(f"{name} never launched on the "
                                 f"second_order path")
    counts = {k: counts[k] + so_counts[k] for k in counts}
    fn_counts = phase_forward_n(pkg, spmv, reverse_c5)
    for name in ("bell_spmv_banded_f32", "bell_spmm_banded_f32"):
        if fn_counts[name] < 1:
            raise AssertionError(f"{name} never launched on the "
                                 f"forward_n path")
    counts = {k: counts[k] + fn_counts[k] for k in counts}
    phase_ising2d(pkg, spmv)
    eig_counts = phase_eig(pkg, spmv)
    counts = {k: counts[k] + eig_counts[k] for k in counts}
    phase_complex(pkg, spmv)
    fmt_counts = phase_formats(pkg, spmv, lam_eigh)
    counts = {k: counts[k] + fmt_counts[k] for k in counts}
    torch.cuda.empty_cache()
    rs_counts = phase_restart(pkg, spmv, lam_eigh)
    counts = {k: counts[k] + rs_counts[k] for k in counts}
    gen_counts = phase_gen(pkg, spmv)
    counts = {k: counts[k] + gen_counts[k] for k in counts}

    csrc = "dominantsparseeigenad_tpu_torch/csrc/"
    # The Pallas kernel body, and the SpMM entry that runs it on (N, r).
    tpu = "dominantsparseeigenad_tpu/ops/pallas_spmv.py:161"
    tpu_spmm = "dominantsparseeigenad_tpu/ops/pallas_spmv.py:424"
    kernels = []
    # K1-K3 (launched by the twins) and K4b (by the main path).
    for name in ("bell_spmv_f32", "bell_spmv_bf16vals", "bell_spmm_f32",
                 "bell_spmm_bf16vals", "bell_spmv_banded_f32",
                 "bell_spmv_banded_bf16vals", "bell_spmm_banded_f32",
                 "bell_spmm_banded_bf16vals"):
        row = big[name]
        if counts[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")
        spmm_kernel = "spmm" in name
        replaces = tpu
        if spmm_kernel and "banded" not in name:
            replaces = tpu_spmm
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + ("bell_spmm.cu" if spmm_kernel
                                          else "bell_spmv.cu"),
                        "replaces": replaces,
                        "launches": counts[name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    # K4a: the same kernels on the row panels of the sharded run (p = 2).
    for kind, suffix in (("spmv", "f32"), ("spmv", "bf16vals"),
                         ("spmm", "f32"), ("spmm", "bf16vals")):
        name = f"bell_{kind}_{suffix}"
        row = panel[(name, SHARDED_RANKS)]
        if panel_counts[name] < 1:
            raise AssertionError(f"{name} never launched on a panel in the "
                                 f"sharded run")
        kernels.append({"name": f"bell_{kind}_panel_{suffix}",
                        "route": "cuda",
                        "source": csrc + f"bell_{kind}.cu",
                        "replaces": tpu_spmm if kind == "spmm" else tpu,
                        "launches": panel_counts[name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    print(nvidia_smi_name_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
