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
   config #5 with r = 8 (the block solvers' width), 4 (the narrow
   body), 16 (the KPM probe block) and 32 (one full pass of the wide
   body), and at small odd shapes (r = 8 and 13; r = 3 and 40, two
   passes of the wide body, with an X that is not 16-byte aligned); then
   its banded mode as in ``spmv``; kernel, plain, chained-SpMV, bound,
   bytes with every X gather over the measured copy rate, and library
   (cuSPARSE BSR, float32 only) times.  The ``build`` phase fails if
   ptxas reports a spill store in any SpMM kernel.  ``python3
   chip_smoke.py --spmm-turns LABEL=CSRC_DIR ...`` runs only the build
   and ``spmm_turns``: this checkout's SpMM against the kernel libraries
   built from other ``csrc`` directories (e.g. the parent commit's),
   timed in turns.
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
   SpMM (r = 8; r = 16 at p = 2), float32 and bfloat16 values: against
   the plain version and against the matching rows of the square
   product (expected equal bit for bit); kernel, plain, bound and
   library (cuSPARSE BSR on the panel, float32 only) times.
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
   solvers made, bf16 against f32).  Then, in the same ranks: the sharded
   matrix-free TFIM at N = 20 (``tfim_sharded_operator``: the low spin
   flips on the rank's segment, the top one an XOR exchange of whole
   segments), E0, dE0/dg in reverse and forward mode and d²E0/dg² against
   Jordan-Wigner and against the unsharded operator from the same v0, the
   ranks bitwise equal with the same collectives, one matvec split into
   its local flips, the exchange and the row gather, the peak memory;
   second order and forward mode through the Bell panels (d²λ/dt² and
   dλ/dt of A0 + t A1 at the small spiked shape, against the float64 sum
   over states and the unsharded operator; K4a on the tangent); λ and
   dλ/dt of a complex Hermitian ``RowShardedOperator`` (n = 256) against
   ``torch.linalg.eigh``.  Last, a spawn of four ranks as a 2 x 2
   (batch, shards) mesh, the TFIM at N = 16, one coupling a row.  Its
   times are those of ranks sharing one card over gloo, not a multi-GPU
   number.
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

15. ``complex_bell``: complex blocked-ELL values on the hand-written
   complex64 kernels K5 (SpMV) and K6 (SpMM), at config #5's full width
   in a complex gauge: vals_c[i, j] = diag(d_i) vals[i, j] diag(conj
   d_{cols[i, j]}) with unit phases d from a seeded generator, 9.13 GB of
   complex64 values, complex Hermitian (built with ``symmetric=False``)
   and unitarily similar to the real config #5.  (a) The real operator's
   Lanczos coefficients (k = 100, from v0), λ and LOBPCG λ (r = 8, 100
   iterations, from x0); its products with complex64 vectors (one real
   SpMM on the (re, im) columns, K4b) against the real and imaginary
   parts done apart, exactly; then the real values go.  (b) K5 and K6
   against their plain versions (1e-5): SpMV, SpMM at r = 4, 8, 16, 32,
   gather and banded (banded equal to gather bit for bit, timed in
   turns), the panels of a p = 2 sharding (the square product's rows bit
   for bit); kernel, plain, bound (bytes, or 8 r flops a complex value)
   and library (cuSPARSE BSR in complex64) times; at three small shapes
   (bs = 25 among them) every r of 1-5, 8, 13, 16, 32 and 40 with X
   aligned and offset by one complex value, against the plain versions,
   banded = gather and panel = square rows bit for bit; lazily conjugated
   x, X and vals (``.conj()``), also real values with a conjugated
   complex x, equal bit for bit to their resolved copies.  (c) The main
   path, counted: Lanczos from D v0 (α, β against the real run's, 1e-5
   of their largest), λ against
   the real λ (1e-5), the λ-only gradient (v v^H on the pattern) against
   a forward-mode dλ along random complex dvals by the dot-product
   identity (1e-5), LOBPCG from D x0 against the real λ (1e-4), twin
   forwards on the gather kernels (equal bit for bit).  (d) A complex
   Hermitian Bell at n = 4096, bs = 32 (three spiked eigenvalues) against
   a float64 ``eigh`` of its dense matrix: the eigenvector loss
   λ + |<w, v>|² along a second Hermitian Bell by reverse and forward
   mode, and E, dE/dg, d²E/dg² of A0 + g A1 by ``energy_curvature``.
   (e) Two ranks sharing the card over gloo (not multi-GPU) on the
   complex panels (K5, K6 on a row panel): λ against the unsharded λ
   (1e-5), a 20-iteration LOBPCG against the unsharded one (1e-4).  The
   phase's peak memory and time on its line.

16. ``formats``: the COO, CSR and BCOO formats and the operator algebra.
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

17. ``restart``: thick-restart Lanczos.  (a) Config #5, the ``eigh``
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

18. ``gen``: the generalized pencil.  (a) Config #5's A with B = diag(m),
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

19. ``spectral``: the spectral tiers.  (a) Config #5 (the ``eigh``
   phase's operator, K4b, f32 values): ``spectral_bounds`` (30 SpMVs);
   ``spectral_density`` and ``trace_function(exp)`` at the JAX defaults
   (degree 120, 16 probes: one r = 16 SpMM a degree, with their own
   enclosures), the moments μ0 = 1, μ1 and μ2 against Tr(Ã)/N and
   2 ||Ã||_F²/N − 1 exact from the values within 5 standard errors;
   ``logdet`` of A − lo with its auto-bounds (two ``dominant_eigh``
   runs) under Jensen's bound; ``spectral_slice`` (r = 8) on a window at
   the top edge, degree 40 and 30 LOBPCG iterations (cuts of the
   defaults 80 and 150), the gradient of Σ c_i λ_i + <C, V> through one
   batched MINRES capped at 1000, against the forward-mode tangent of
   the same rule by the dot-product identity (each solve's residual term
   included), λ_i = v_i^T A v_i, ∂Σλ/∂vals against Σ v_i⊗v_i;
   ``spectral_function`` at 8 frequencies as one batched CG, against the
   per-frequency loop at two; every call's SpMV and SpMM launches against
   the iterations it reports.  (b) The TFIM: ``examples/spectrum_slice.py``'s
   case (N = 10, g = 0.3, r = 14, degree 200, f64) against dense
   ``eigvalsh`` and a central difference of d(centroid)/dg;
   ``interior_eigh`` in that window (against the slice's λ) and at
   N = 12 against dense ``eigvalsh``; ``spectral_function`` at N = 20
   (``examples/spectral.py``'s probe, g = 1.2, η = 0.2, 8 frequencies,
   f32) through the block TFIM product: S >= 0, batched against the loop
   at two frequencies, the block product against the column loop (bit
   for bit and timed).  Its K4b launches join the ``kernels`` line.

20. ``models``: the XXZ chain at N = 20, f32, isotropic, through
   ``dominant_eigh`` (k = 200): E0, ∂E0/∂j and ∂E0/∂jz, Euler's identity
   E0 = j ∂E0/∂j + jz ∂E0/∂jz, the SU(2) identity ∂E0/∂j = 2 ∂E0/∂jz and
   E0/N against the Bethe value 1/4 − ln 2 (0.02); the 2D TFIM on the
   4 × 5 torus (2^20 states) at g = 3.04, f32: E0 and dE0/dg against
   −<ψ|Σσˣ|ψ> by ``flip_sum``.  No hand-written kernel is on this path.

21. ``utils``: the port's ``utils/``.  (a) ``timeit`` (host clock
   around a synchronized call, 12 repeats) of one config-#5 K4b SpMV
   through the operator's ``matvec``, against the kernel's CUDA-event
   median from the ``spmv`` phase: at least it, at most 1.15 x it + 0.05
   ms.  (b) ``trace`` (``torch.profiler``, CPU and CUDA activity) around
   config #5's ``dominant_eigh`` forward and backward (k = 100, CG capped
   at 3000) and (c) around the TFIM N = 20 forward-mode pass (the
   ``tfim`` phase's settings): each trace file read back, the named
   ranges ``lanczos_matvec``, ``lanczos_reorth`` (k each) and
   ``cg_matvec`` (the CG's products) counted, a ``bell_spmv_banded``
   kernel found in the config-#5 trace, and the idle share of each traced
   window (one minus the union of the kernel and copy intervals over the
   window from the first to the last device activity); the phase fails
   if the profiler recorded no device activity.  The TFIM pass also
   timed untraced before and after its trace.  (d) ``lanczos_health`` of
   config #5's k = 100 Lanczos run (orthogonality loss, both Ritz
   residuals, breakdowns), logged through ``JsonlLogger`` on the card's
   tensors (a bfloat16 one among them) and read back;
   ``cg_relative_residual`` of the traced backward's capped CG (its solve
   recorded as it ran).  (e) ``assert_converged`` raises on a k = 10
   Lanczos at config #5 and passes on the TFIM N = 20 solve.  (f) The
   host cost of one named range with no profiler running.

22. ``examples``: the twelve drivers of
   ``dominantsparseeigenad_tpu_torch/examples`` in this process at their
   JAX twins' defaults (``EXAMPLES`` lists any cut of sweep points; none
   so far), ``sharded_sparse`` and ``distributed_lanczos`` each spawning
   its two gloo ranks on the card;
   each driver's wall time and key numbers against the closed form it
   prints (Jordan-Wigner, the XXZ ferromagnet and Bethe's value, Onsager
   at the first β, Onsager's ξ), its own check (``SystemExit`` on a
   miss), a ``--log`` record a point where it logs, the panel kernels on
   the sharded ranks and the banded ones on the local operator.

24. ``sharded_vectors`` (right after ``sharded``): the sharded-vector
   layout and ring mode, two gloo ranks sharing the card.  Config #5
   (the ``sharded`` phase's operator and start vectors) as one panel
   behind three operators: the replicated-vector one, and ``all_gather``
   and ``ring`` over sharded vectors.  (a) ``matvec`` and ``matmat``
   (r = 8) against the replicated operator's rows: all_gather bit for
   bit, ring at 1e-5.  (b) ``ring_offsets`` against the bucketing of
   ``cols`` computed apart, ``ring_hops``, and a ring matvec's
   ``ppermute`` count.  (c) ``dominant_eigh`` (k = 100) in both modes: λ
   against the replicated run (1e-5), ∂λ/∂panel against v⊗v on the
   rank's rows (1e-5), the ranks' λ bitwise equal with the same
   collectives.  (d) LOBPCG (r = 8, ring) against the replicated run.
   (e) The bucket launches, counted apart: one gather kernel per active
   offset per product.  The sharded TFIM at N = 20 over sharded vectors
   (E0, dE0/dg in both modes, d²E0/dg² against Jordan-Wigner), its
   matvec beside the replicated layout's; an (N/p, 8) Lanczos basis saved
   by both ranks and read back bit for bit; each mode's matvec and
   matmat times, the bucket gathers' share of a ring matvec, the peak
   memory; the ``sharded_sparse`` driver in ``--mode ring``; then, in
   this process, each config-#5 bucket of rank 0 on the SpMV and SpMM
   kernels against the plain version, with kernel, plain, bound,
   library and gather times (the ring rows of the ``kernels`` line).
   Every time is that of ranks sharing one card over gloo, not a
   multi-GPU number.
25. ``sharded_solvers`` (right after ``sharded_vectors``): the Hermitian
   solvers over sharded vectors, two gloo ranks sharing the card, after
   the unsharded references in this process.  (a) The TFIM N = 20
   headline (the ``tfim`` phase's settings, ``bench.py:78-99``: bf16
   basis, ``reorth_chunks=4``, k = 60, one pass, CG tol 1e-5 and at most
   150 iterations) over sharded vectors, and its float32-basis twin: one
   forward-mode pass each, E0 and dE0/dg against Jordan-Wigner and χ_F
   against the unsharded bf16 pass at the ``tfim`` bars; the pass's wall
   time and rank 0's idle share beside the unsharded pass's.  (b) Thick
   restart (the ``restart`` phase's k = 32, 8 cycles) on the sharded
   TFIM N = 20: E0 and dE0/dg against Jordan-Wigner, a rank's peak
   memory beside the unsharded restart's.  (c) Config #5's KPM density
   and ``trace_function(exp)`` (degree 120, 16 probes: one r = 16 SpMM a
   degree) through ``RowShardedBellOperator`` over sharded vectors, in
   all_gather (K4a panel SpMMs) and ring (bucket SpMMs) mode, against the
   unsharded operator with the same generator seed.  (d) The ``gen``
   phase's pencil with A row-sharded and B = diag(m) a sharded
   matrix-free operator: λ (LOBPCG, r = 8, 100 iterations) and ∂Σλ/∂m
   against the unsharded run from the same x0.  (e) F11's diagnostics on
   the sharded TFIM against the replicated layout.  The KPM and pencil
   launches are counted from 0 and added to the K4a and ring rows of the
   ``kernels`` line; the ranks ran the same collectives and agree bit for
   bit.  Ranks sharing one card over gloo: not multi-GPU numbers.
26. ``sharded_general`` (right after ``sharded_solvers``): the general
   (non-symmetric) tier over sharded vectors, two gloo ranks sharing the
   card, after the unsharded references in this process.  (a) Config
   #5's non-symmetric twin (its pattern, positive float32 values drawn as
   the ``eig`` phase draws them): ``dominant_eig`` (Arnoldi, 64 steps a
   side) unsharded on K4b, and on the ranks as
   ``RowShardedBellOperator(..., symmetric=False, vectors="sharded")`` in
   all_gather (K4a panel SpMVs) and ring (bucket SpMVs) mode: λ against
   the unsharded run, both one-sided residuals, ∂λ/∂panel against l⊗r on
   the rank's pattern, and the gradient of <c, r> (the transposed
   bordered BiCGStab over sharded vectors, its border on rank 0) against
   the unsharded run's on sampled block-rows and in Frobenius norm; the
   forward and both backwards timed, the products and collectives of the
   forward counted.  (b) The small twin (``EIG_BELL``):
   ``dominant_eig_multi`` (m = 2), ``solve_general`` by BiCGStab, GMRES
   and CGNR on A + 2 λ1 I with the gradient in b, ``dominant_svd``
   (r = 2); a dense float64 ``RowShardedOperator`` (n = 256) with a
   dominant conjugate pair: ``dominant_eig_pair`` and the
   ``spectrum_structure`` replay of ``dominant_eig_spectrum`` (m = 2),
   each with a gradient; all against the unsharded runs.  The launches
   are counted from 0 and added to the K4a and ring rows of the
   ``kernels`` line.  Ranks sharing one card over gloo: not multi-GPU
   numbers.

Then a ``kernels`` line (each SpMM entry with its config-#5 times, bound
and library time at every r of ``spmm``, the panel entries at r = 8 and
16, the complex64 entries at every r of ``complex_bell``, under
``by_r``), the ``nvidia-smi`` name and power-limit line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the exit code is not 0.  Without a CUDA device it exits with
code 1 before printing any result.
"""

import contextlib
import importlib
import io
import json
import math
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

from pathlib import Path

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
SPMM_SHAPES = ((CONFIG5, 8, False), (CONFIG5, 4, False), (CONFIG5, 16, False),
               (CONFIG5, 32, False), (SMALL_SHAPES[0], 8, False),
               (SMALL_SHAPES[1], 3, True), (SMALL_SHAPES[0], 13, False),
               (SMALL_SHAPES[1], 40, True))
SPMM_WIDE_PASS = 32                    # columns a pass of the r > 4 body
PANEL_R16_SHARDS = (2,)                # the r = 16 panel's shardings
MULTI_R = 8
LOBPCG_ITERS = 100
MULTI_CG_MAXITER = 1000
LANCZOS_K = 50
PANEL_SHARDS = (2, 4)                  # the panels of these shardings
PANEL_R = 8
SHARDED_RANKS = 2                      # ranks sharing the one card
SHARDED_CG_MAXITER = 1000
SHARDED_TIMEOUT_S = 600                # a rank's whole run
# The sharded phase's matrix-free, second-order and complex parts.
# (a) The sharded TFIM at the flagship width of the tfim phase (N = 20,
# g = 1.2, f32, k = 60, CG tol 1e-5 and at most 150 iterations), split
# over the ranks by tfim_sharded_operator: E0, dE0/dg in reverse and
# forward mode and d²E0/dg² against Jordan-Wigner at the forward_n
# phase's TFIM bars, and against the unsharded tfim_operator run from
# the same v0.  (b) d²λ/dt² and forward dλ/dt through the Bell panels at
# the small spiked shape of forward_n (d): H(t) = A0 + t A1 at t = SO_G,
# against its float64 sum over states at FWDN_SMALL_RTOL and against the
# unsharded BellOperator.  (c) The complex Hermitian h0 + t h1 of
# tests/test_parallel.py:237 (n = 256, k = 60, complex128) through
# RowShardedOperator, against torch.linalg.eigh at that test's bars.
# (d) The batch axis: 4 ranks as a 2 x 2 mesh, the TFIM at N = 16, one
# coupling a batch row, against Jordan-Wigner.
SHARDED_TFIM_RTOL = {"e0": 2e-5, "de0_dg": 1e-3, "de0_dg_fwd": 1e-3,
                     "d2e0_dg2": 5e-4}
SHARDED_VS_UNSHARDED = 1e-5
SHARDED_BELL_VS_UNSHARDED = 1e-4
SHARDED_CX = (256, 60, 12)             # n, k, numpy seed
SHARDED_CX_RTOL = {"lam": 1e-10, "dlam_dt": 1e-8}
BATCH_RANKS, BATCH_SHARDS, BATCH_TFIM_N = 4, 2, 16
BATCH_G = (1.0, 1.2)                   # one coupling a batch row
# The sharded_vectors phase (2 ranks sharing the card over gloo): config #5
# over vectors sharded across the ranks, all_gather and ring mode, held
# against the replicated-vector operator at the same p (all_gather bit for
# bit, ring at SV_RTOL: f32 sums of the ring's buckets in another order),
# dominant_eigh (k = K) and LOBPCG (r = MULTI_R) against the replicated
# run at SV_RTOL; the sharded TFIM at N = 20 over sharded vectors at the
# sharded phase's bars; a checkpoint of an (N/p, SV_CKPT_K) basis.
SV_RTOL = 1e-5
SV_CKPT_K = 8
# The sharded_solvers phase (2 ranks sharing the card over gloo): the
# Hermitian solvers over sharded vectors.  The KPM estimators of config #5
# (the spectral phase's seeds: the same enclosure start and the same
# probes, drawn whole and narrowed) against the unsharded operator's,
# float32 sums in another order over degree KPM_DEGREE; the pencil's
# ∂Σλ/∂m (-λ_i x_i², first order in the Ritz vectors' error) against the
# unsharded run from the same x0; F11's diagnostics on the sharded TFIM
# against the replicated layout (the Lanczos runs under lanczos_health
# are two float32 runs).
SS_KPM_RTOL = 1e-4
SS_PENCIL_GRAD_RTOL = 1e-3
SS_F11_RTOL = 1e-4
# The sharded_general phase (2 ranks sharing the card over gloo): the
# general (non-symmetric) tier over sharded vectors.  Config #5's
# non-symmetric twin (its pattern, positive float32 values: the mean part,
# 0.51 (C ⊗ J) for the ring's circulant C of 8 offsets in 4096 block-rows,
# puts |λ2|/λ1 near 0.78), held against the unsharded run at the
# sharded phase's SHARDED_BELL_VS_UNSHARDED and the eig phase's bars.  The
# gradient of <c, r> runs the transposed bordered BiCGStab, which stops
# at float32's floor (50 eps, a relative residual of 6e-6) in both runs
# with products summed in another order; its error is that floor times
# the bordered system's conditioning (|λ1| / |λ1 - λ2| ~ 5), so the bar
# SG_RLOSS_RTOL leaves a factor ~30 above it, on the gradient's sampled
# block-rows and on its whole Frobenius norm.  The small cases (the
# EIG_BELL twin, float32) at SG_SMALL_RTOL, the solves on A + 2 λ1 I
# (SG_SOLVE_SHIFT: eigenvalues with real parts in about [1.4, 3] λ1); the
# dense float64 pair (SG_PAIR: n, numpy seed) at SG_PAIR_RTOL.
SG_RLOSS_RTOL = 1e-3
SG_SMALL_RTOL = 1e-4
SG_SOLVE_SHIFT = 2.0
SG_PAIR = (256, 83)
SG_PAIR_RTOL = 1e-8
SG_SAMPLE_ROWS = 8                     # block-rows a rank, compared
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
# The spectral phase.  (a) Config #5 (the eigh phase's operator, K4b, f32
# values): spectral_bounds with SPEC_BOUNDS_K Lanczos steps (its SpMVs);
# spectral_density and trace_function(exp) at the JAX defaults (degree
# KPM_DEGREE, KPM_PROBES Rademacher probes: one r = 16 SpMM a degree),
# their auto-enclosure SPEC_BOUNDS_K SpMVs; the moments μ0 = 1, μ1 and
# μ2 against Tr(Ã)/N and 2 ||Ã||_F^2/N - 1, exact from the values, within
# KPM_SE_BAR standard errors of the probes; logdet of A - lo (lo the
# enclosure's bottom, so SPD) with its auto-bounds (two dominant_eigh
# runs of k = 2 SPEC_BOUNDS_K) and degree LOGDET_DEGREE, below ln of the
# mean eigenvalue (Jensen); spectral_slice with r = MULTI_R on the
# window [θ_max - SLICE_WINDOW, hi] (θ_max the top Ritz value of a
# SPEC_BOUNDS_K-step Lanczos), degree SLICE_DEGREE and maxiter
# SLICE_MAXITER (cut from the defaults 80 and 150), the gradient of
# Σ c_i λ_i + <C, V> through its batched MINRES capped at
# SLICE_SOLVE_MAXITER, held against the forward-mode tangent of the same
# rule by the dot-product identity with each solve's residual term;
# spectral_function at SPECFN_POINTS frequencies over the enclosure, η =
# SPECFN_ETA_REL of its width, one batched CG capped at SPECFN_MAXITER,
# against the per-frequency loop at two of them.  (b) The TFIM:
# examples/spectrum_slice.py's case (SLICE_TFIM, f64) against dense
# eigvalsh and a central difference, the example's own bars;
# interior_eigh in that window (N = 10, against the slice's λ) and at N =
# INTERIOR_TFIM_N, σ in its own window, against dense eigvalsh (f64);
# spectral_function at N = SPECFN_TFIM["n"] (examples/spectral.py: g =
# 1.2, η = 0.2, the probe flip_sum(ψ0), frequencies E0 + [0, wmax]) at
# SPECFN_POINTS frequencies, f32, through the block TFIM product: S >= 0,
# the batched result against the loop at two frequencies; the block
# product at m = SPECFN_POINTS timed against the column loop.
SPEC_SEED = 31
SPEC_BOUNDS_K = 30
KPM_DEGREE, KPM_PROBES, LOGDET_DEGREE = 120, 16, 160
KPM_SE_BAR = 5.0
SLICE_DEGREE, SLICE_MAXITER, SLICE_SOLVE_MAXITER = 40, 30, 1000
SLICE_WINDOW = 0.05
SLICE_RTOL = {"pair": 1e-5, "dsumlam_dvals": 1e-5, "dot": 1e-4}
SPECFN_POINTS, SPECFN_ETA_REL, SPECFN_MAXITER, SPECFN_TOL = 8, 0.05, 500, 1e-5
SPECFN_LOOP_RTOL = 1e-5
SLICE_TFIM = dict(n=10, g=0.3, r=14, degree=200, maxiter=300, tol=1e-9,
                  window=(1.5, 3.37))
SLICE_TFIM_RTOL = {"lam": 1e-8, "dcentroid_vs_fd": 1e-5, "fd_eps": 1e-5}
INTERIOR_TFIM_N, INTERIOR_RTOL = 12, 1e-10
SPECFN_TFIM = dict(n=20, g=1.2, eta=0.2, wmax=12.0, k=150, maxiter=2000)
# The models phase, f32.  (a) The isotropic XXZ chain at N = XXZ_N through
# dominant_eigh (k = XXZ_K): E0 and its gradient in (j, jz); Euler's
# identity E0 = j ∂E0/∂j + jz ∂E0/∂jz (E0 is homogeneous of degree 1),
# the SU(2) identity ∂E0/∂j = 2 ∂E0/∂jz of the singlet, E0/N against the
# Bethe value 1/4 - ln 2 within the JAX test's 0.02.  (b) The 2D TFIM on
# the TFIM2D torus (2^20 states) at g = TFIM2D_G (k = TFIM2D_K): E0 and
# dE0/dg against -<ψ|Σ σˣ|ψ> by flip_sum.  tools/jax_models_errors.py
# measures the JAX package's own f32 errors at N = 16 and on the 4 x 4
# torus (the sizes a CPU run takes): Euler 2.3e-7 and SU(2) 1.0e-7 (bars
# ~8x: 2e-6, and the SU(2) bar the looser 1e-4, since at N = 20 the
# ground state's gap is smaller than at N = 16); the 2D gradient against
# flip_sum 6.2e-5 in JAX, two Lanczos runs apart, one run here (bar 1e-5).
XXZ_N, XXZ_K = 20, 200
XXZ_RTOL = {"euler": 2e-6, "su2": 1e-4, "bethe_abs": 0.02}
TFIM2D, TFIM2D_G, TFIM2D_K = (4, 5), 3.04, 150
TFIM2D_RTOL = 1e-5
# The utils phase.  timeit of one config-#5 K4b SpMV (median of 12 synced
# calls) against the CUDA-event median of the same call: at least it, at
# most 1.15 x it + 0.05 ms.  The ranges the solvers open (the JAX
# package's named scopes), the device activity a trace holds, and the
# deliberately short Lanczos that assert_converged must flag.
UTILS_TIMEIT_REPEATS = 12
UTILS_TIMEIT_BAR = (1.15, 0.05)
RANGES = ("lanczos_matvec", "lanczos_reorth", "cg_matvec", "bicgstab_matvec")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UTILS_SHORT_K = 10
# The examples phase: each driver at its JAX defaults plus these arguments
# (a cut of sweep points only, never of chi, steps, N or k), in-process;
# sharded_sparse spawns its own 2 ranks.  Drivers with --log write it.
EXAMPLES = (("tfim_ed", []), ("tfim_sparse", []), ("heisenberg", []),
            ("spectral", []), ("ising2d", []), ("transfer_spectrum", []),
            ("lobpcg_precond", []), ("spectrum_slice", []),
            ("vibrational_modes", []), ("complex_spectrum", []),
            ("sharded_sparse", []), ("distributed_lanczos", []))
EXAMPLES_LOGGED = ("tfim_ed", "tfim_sparse", "heisenberg", "spectral",
                   "ising2d", "transfer_spectrum")
# Bars on the closed forms the drivers print: Jordan-Wigner for tfim_ed
# (float64: E0, dE0/dg, d2E0/dg2 absolute) and tfim_sparse (E0 relative);
# the XXZ chain's ferromagnetic E0/N = Jz/4 for Jz <= -1 and the Bethe
# value 1/4 - ln 2 at Jz = 1 (N = 12, the models phase's 0.02); Onsager at
# the ising2d sweep's first beta (0.3, away from beta_c; CTMRG chi = 30),
# and Onsager's row-to-row xi there for transfer_spectrum (the eig
# phase's 0.1); the spectral driver's E0 against Jordan-Wigner.
EX_TFIM_ED_ABS = (1e-9, 1e-7, 1e-5)
EX_TFIM_SPARSE_REL = 1e-9
EX_XXZ = {"ferro_abs": 1e-10, "bethe_abs": 0.02}
EX_ISING_FIRST_ABS = (1e-10, 1e-8, 1e-6)
EX_XI_REL = 0.1
EX_SPECTRAL_E0_REL = 1e-10
# distributed_lanczos (float64, N = 12, k = 80): E0 against Jordan-Wigner.
EX_DISTRIBUTED_E0_REL = 1e-10


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


def ptxas_functions(log):
    """{function: (registers, spill store bytes)} from nvcc's
    ``-Xptxas -v`` output."""
    funcs, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"([\w$]+)", ln)
        if m:
            name = m.group(1)
            funcs.setdefault(name, [None, None])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            funcs[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            funcs[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in funcs.items()}


def phase_build(spmv):
    spmv.build_library()
    log = spmv.build_info["log"]
    ptxas = [ln.strip() for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln]
    # Every SpMM kernel (both bodies, every instantiation) without spills.
    spmm_funcs = {k: v for k, v in ptxas_functions(log).items()
                  if "bell_spmm" in k}
    spills = {k: v[1] for k, v in spmm_funcs.items() if v[1] != 0}
    if (not spmm_funcs and spmv.build_info["seconds"]) or spills:
        raise AssertionError(f"SpMM kernels: {len(spmm_funcs)} in the ptxas "
                             f"log, spill stores {spills}")
    n_copy = 1 << 30                                   # 4 GiB of float32
    src = torch.empty(n_copy, dtype=torch.float32, device=DEVICE)
    src.fill_(1.0)
    dst = torch.empty_like(src)
    copy_ms = event_ms(lambda: dst.copy_(src), samples=10)
    del src, dst
    copy_gbps = 2 * n_copy * 4 / (copy_ms * 1e-3) / 1e9
    emit({"phase": "build", "nvcc_s": spmv.build_info["seconds"],
          "library": spmv.build_info["path"], "ptxas": ptxas,
          "spmm_kernels_spill_free": len(spmm_funcs),
          "spmm_max_registers": max((v[0] or 0 for v in
                                     spmm_funcs.values()), default=None),
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


def bound(nnz, val_bytes, other_bytes, r=1, flops_per_value=2):
    """Least time (ms) for the product and what bounds it: each input read
    once and each output written once at the published memory rate, or
    ``flops_per_value`` r operations per value (2 real, 8 complex) at the
    float32 rate."""
    bytes_min = nnz * val_bytes + other_bytes
    t_bytes = bytes_min / PEAK_BYTES_PER_S
    t_ops = flops_per_value * nnz * r / PEAK_F32_FLOP_PER_S
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


def spmm_passes(r):
    """Passes over the values the SpMM kernel makes for r columns."""
    return -(-r // SPMM_WIDE_PASS)


def spmm_case(spmv, sparse, n, bs, bpr, r, seed, copy_gbps,
              unaligned=False):
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
        # The same stream as the kernel moves it: the values and cols once
        # a pass, every X segment a block-row stages, Y once; over the
        # measured copy rate.
        nb, max_blk = cols.shape
        bytes_gather = spmm_passes(r) * (vals.numel() * vals.element_size()
                                         + cols.numel() * 4) \
            + nb * max_blk * bs * r * 4 + n * r * 4
        row = {"phase": "spmm", "kernel": name, "n": n, "bs": bs,
               "blocks_per_row": bpr, "r": r, "x_aligned": not unaligned,
               "rel_err": err, "max_abs_err": max_abs,
               "chained_spmv_rel_err": chained_err,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_rel_err": lib_err,
               "chained_spmv_ms": chained_ms, "bytes_min": bytes_min,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes_with_gathers": bytes_gather,
               "copy_bound_ms": bytes_gather / (copy_gbps * 1e9) * 1e3,
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


def kernel_library(spmv, csrc):
    """Build and load the kernel library from the sources in ``csrc`` (a
    ``csrc`` directory of another checkout) beside this one's; return it
    and the ptxas summary of its SpMM kernels."""
    saved = spmv._CSRC, spmv._lib
    try:
        spmv._CSRC, spmv._lib = Path(csrc).resolve(), None
        lib = spmv._library()
        funcs = {k: v for k, v in
                 ptxas_functions(spmv.build_info["log"]).items()
                 if "bell_spmm" in k}
    finally:
        spmv._CSRC, spmv._lib = saved
    return lib, funcs


def spmm_turns(spmv, sparse, libs):
    """The SpMM entries of several builds of the kernel library, timed in
    turns on the same config-#5 inputs (first to last, then last to first;
    each turn the median of 12 CUDA-event samples of 5 launches): square
    gather and banded at r = 4, 8, 16, 32 and the p = 2 row panel at r =
    8, 16, float32 and bfloat16 values.  Each build's Y against the first
    build's and against the plain version.  ``libs``: {label: library}."""
    n, bs, bpr = CONFIG5
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    op = sparse.random_bell_operator(n, bs, bpr, generator=gen,
                                     device=DEVICE)
    nb = n // bs
    half = slice(nb // 2, nb)                 # the last rank's panel, p = 2
    saved = spmv._lib
    cases = [(mode, r) for r in (4, 8, 16, 32) for mode in ("gather",
                                                           "banded")]
    cases += [("panel", 8), ("panel", 16)]
    try:
        for suffix, vals in (("f32", op.vals),
                             ("bf16vals", op.vals.to(torch.bfloat16))):
            for mode, r in cases:
                X = torch.randn(n, r, generator=gen, device=DEVICE)
                v, c = (vals[half], op.cols[half]) if mode == "panel" \
                    else (vals, op.cols)
                if mode == "banded":
                    def call():
                        return spmv._bell_spmm_banded_cuda(v, c, X,
                                                           op.slot_plan)
                    plain = spmv._bell_spmm_banded_torch(v, c, X,
                                                         op.slot_plan)
                else:
                    def call():
                        return spmv._bell_spmm_cuda(v, c, X)
                    plain = spmv._bell_spmm_torch(v, c, X)
                ys, errs = {}, {}
                for label, lib in libs.items():
                    spmv._lib = lib
                    ys[label] = call()
                    torch.cuda.synchronize()
                    errs[label] = rel_err(ys[label], plain)
                first = next(iter(ys.values()))
                diffs = {k: float((y - first).abs().max())
                         for k, y in ys.items()}
                if not all(math.isfinite(e) and e <= 1e-5
                           for e in errs.values()):
                    raise AssertionError(f"spmm turns {suffix} {mode} r={r}"
                                         f": rel errs {errs}")
                turns = {k: [] for k in libs}
                for label in [*libs, *reversed(libs)]:
                    spmv._lib = libs[label]
                    turns[label].append(event_ms(call, samples=12, batch=5))
                _, bound_ms, bound_by = bound(
                    v.numel(), v.element_size(),
                    c.numel() * 4 + X.numel() * 4
                    + v.shape[0] * bs * r * 4, r)
                emit({"phase": "spmm_turns", "values": suffix, "mode": mode,
                      "r": r, "rel_err": errs, "max_abs_diff_vs_first": diffs,
                      "ms_turns": turns,
                      "ms": {k: statistics.mean(t) for k, t in turns.items()},
                      "bound_ms": bound_ms, "bound_by": bound_by})
                del X, ys, plain, first
    finally:
        spmv._lib = saved
    del op
    torch.cuda.empty_cache()


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
           "spmm": torch.randn(n, PANEL_R, generator=gen, device=DEVICE),
           "spmm16": torch.randn(n, 16, generator=gen, device=DEVICE)}
    kernels = {"spmv": (spmv._bell_spmv_cuda, spmv._bell_spmv_torch),
               "spmm": (spmv._bell_spmm_cuda, spmv._bell_spmm_torch)}
    results = {}
    for suffix, vals in (("f32", op.vals),
                         ("bf16vals", op.vals.to(torch.bfloat16))):
        for key, x in rhs.items():
            # r = 16 runs the wide body (one panel, p = 2).
            kind = key[:4]
            kernel, plain = kernels[kind]
            r = 1 if x.ndim == 1 else x.shape[1]
            square = kernel(vals, op.cols, x)
            for p in PANEL_R16_SHARDS if r == 16 else PANEL_SHARDS:
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
                results[(name, p) if r != 16 else (name, p, r)] = row
                del y_k, y_p
            del square
        del vals
    del op, rhs
    torch.cuda.empty_cache()
    return results


def _sharded_rank(rank, world, init_method, out_queue, body):
    """One rank of the ``sharded`` phase (a spawned process) running
    ``body(shard group)``: sends (rank, results, None), or (rank, None,
    traceback) if it failed."""
    try:
        out_queue.put((rank, _sharded_run(rank, world, init_method, body),
                       None))
    except Exception:  # the parent raises it; this rank exits non-zero
        out_queue.put((rank, None, traceback.format_exc()))
        sys.exit(1)


def _sharded_run(rank, world, init_method, body):
    from dominantsparseeigenad_tpu_torch import init_distributed, make_mesh
    init_distributed("gloo", init_method, rank, world)
    try:
        return body(make_mesh())
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
    out = {
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
    del sop, panel, cols_l, v, V, lams, g_lam, g_sum, x, b, y_l, c, x0, v0, dav
    torch.cuda.empty_cache()
    out["tfim"] = _sharded_tfim(pkg, sg)
    out["bell_second_order"] = _sharded_bell_second_order(pkg, spmv, sg)
    out["complex"] = _sharded_complex(pkg, sg)
    return out


def _tfim_derivatives(make, g0, dtype, v0):
    """E0, dE0/dg (reverse, by a create_graph backward), d²E0/dg² (its
    second backward) and dE0/dg (forward mode) of the operator
    ``make(g)`` at the tfim phase's settings from ``v0``, and the time of
    each part."""
    from dominantsparseeigenad_tpu_torch import dominant_eigh
    kw = dict(k=TFIM_K, extreme="min", tol=TFIM_CG_TOL,
              maxiter=TFIM_CG_MAXITER, v0=v0, device=DEVICE)
    times = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    g = torch.tensor(g0, dtype=dtype, device=DEVICE, requires_grad=True)
    lam, _ = dominant_eigh(make(g), **kw)
    lap("forward_s", t0)
    t0 = time.perf_counter()
    (d1,) = torch.autograd.grad(lam, g, create_graph=True)
    lap("backward1_s", t0)
    t0 = time.perf_counter()
    (d2,) = torch.autograd.grad(d1, g)
    lap("backward2_s", t0)
    t0 = time.perf_counter()
    with torch.no_grad(), fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(g0, dtype=dtype, device=DEVICE),
                              torch.ones((), dtype=dtype, device=DEVICE))
        lam_f, _ = dominant_eigh(make(dual), **kw)
        d1_fwd = fwAD.unpack_dual(lam_f).tangent
    lap("forward_mode_s", t0)
    values = {"e0": float(lam), "de0_dg": float(d1),
              "de0_dg_fwd": float(d1_fwd), "d2e0_dg2": float(d2)}
    return values, times


def _sharded_tfim(pkg, sg):
    """Part (a) of the sharded phase's additions, on each rank: the
    sharded TFIM at N = 20 and its derivatives in every mode, the
    collectives each ran, the split of one sharded matvec, the peak
    memory; rank 0 also runs the unsharded operator from the same v0."""
    from dominantsparseeigenad_tpu_torch import models
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    f32, n = torch.float32, TFIM_N

    def sharded(nn):
        return lambda g: models.tfim_sharded_operator(nn, g, sg, dtype=f32,
                                                      device=DEVICE)

    def local(nn):
        return lambda g: models.tfim_operator(nn, g, dtype=f32,
                                              device=DEVICE)

    def start(nn):
        return torch.randn(1 << nn, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(11))

    # Warm-up at N = 10 through the same calls.
    _tfim_derivatives(sharded(TFIM_N_ED), TFIM_G, f32, start(TFIM_N_ED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    collectives.reset_collective_counts()
    v0 = start(n)
    values, times = _tfim_derivatives(sharded(n), TFIM_G, f32, v0)
    counts = dict(collectives.collective_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    unsharded = None
    if sg.rank == 0:
        _tfim_derivatives(local(TFIM_N_ED), TFIM_G, f32, start(TFIM_N_ED))
        values_u, times_u = _tfim_derivatives(local(n), TFIM_G, f32, v0)
        unsharded = {"values": values_u, "times": times_u}

    # The split of one sharded matvec: the rank's own work (diagonal and
    # the m low-bit flips of its segment), one XOR exchange (host-staged
    # over gloo), the gather of the row blocks; and the whole matvec.
    op = models.tfim_sharded_operator(n, TFIM_G, sg, dtype=f32,
                                      device=DEVICE)
    g_t, diag_l = op.parameters()
    m = n - (sg.size.bit_length() - 1)
    rows = (1 << n) // sg.size
    with torch.no_grad():
        x = v0 / torch.linalg.vector_norm(v0)
        x_l = x[sg.rank * rows:(sg.rank + 1) * rows]
        perm = tuple((s_, s_ ^ 1) for s_ in range(sg.size))
        y_l = diag_l * x_l - g_t * models.flip_sum(x_l, m)
        split = {
            "local_flips_ms": event_ms(
                lambda: diag_l * x_l - g_t * models.flip_sum(x_l, m),
                samples=12, batch=5),
            "xor_exchange_ms": event_ms(
                lambda: collectives.permute_exchange(x_l, sg, perm),
                samples=12, batch=5),
            "row_gather_ms": event_ms(
                lambda: collectives.all_gather_rows(y_l, sg),
                samples=12, batch=5),
            "matvec_ms": event_ms(lambda: op.matvec(x), samples=12,
                                  batch=5)}
    return {"n": n, "g": TFIM_G, "dtype": "float32", "k": TFIM_K,
            "cg_tol": TFIM_CG_TOL, "cg_maxiter": TFIM_CG_MAXITER,
            "values": values, "hex": {k: float(v).hex()
                                      for k, v in values.items()},
            "times": times, "collectives": counts,
            "unsharded": unsharded, "matvec_split": split,
            "segment_len": rows, "local_bits": m,
            "peak_mem_gib": peak_gib, "base_mem_gib": base_gib}


def _bell_dense_f64(vals, cols):
    """The dense float64 matrix of blocked-ELL ``(vals, cols)`` (numpy)."""
    nb, bpr, bs, _ = vals.shape
    a = np.zeros((nb, bs, nb, bs))
    for i in range(nb):
        for j in range(bpr):
            a[i, :, cols[i, j], :] += vals[i, j]
    return a.reshape(nb * bs, nb * bs)


def _sharded_bell_second_order(pkg, spmv, sg):
    """Part (b): d²λ/dt² (reverse over reverse, the ranks' shares summed)
    and dλ/dt (forward mode: the panel kernel on the tangent, K4a) of
    H(t) = A0 + t A1 through the Bell panels at t = SO_G; rank 0 also runs
    the unsharded BellOperator and the float64 sum over states."""
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    n, bs, bpr = FWDN_SMALL
    (a0, cols), (a1, _) = (spiked_bell(n, bs, bpr, seed,
                                       SO_SPIKES if i == 0 else ())
                           for i, seed in enumerate(FWDN_SEEDS))
    kw = dict(k=K, extreme="min", tol=CG_TOL, maxiter=CG_MAXITER,
              device=DEVICE)
    sop = pkg.RowShardedBellOperator(torch.from_numpy(a0).to(DEVICE),
                                     torch.from_numpy(cols).to(DEVICE), n,
                                     sg, symmetric=True)
    nb_l = sop.vals.shape[0]
    pert = torch.from_numpy(a1[sg.rank * nb_l:(sg.rank + 1) * nb_l]) \
        .to(DEVICE)
    counts = spmv.panel_launch_counts
    before = dict(counts)
    t0 = time.perf_counter()
    t = torch.tensor(SO_G, device=DEVICE, requires_grad=True)
    lam, _ = pkg.dominant_eigh(sop.with_vals(sop.vals + t * pert), **kw)
    (d1,) = torch.autograd.grad(lam, t, create_graph=True)
    (d2,) = torch.autograd.grad(d1, t)
    d2_total = float(collectives.all_reduce_sum(d2.detach().reshape(1),
                                                sg))
    torch.cuda.synchronize()
    t_rev = time.perf_counter() - t0
    reverse_launches = {k: counts[k] - before[k] for k in counts}
    before = dict(counts)
    t0 = time.perf_counter()
    with torch.no_grad(), fwAD.dual_level():
        lam_f, _ = pkg.dominant_eigh(sop.with_vals(fwAD.make_dual(
            sop.vals + SO_G * pert, pert)), **kw)
        e_fwd, d1_fwd = (float(z) for z in fwAD.unpack_dual(lam_f))
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    forward_launches = {k: counts[k] - before[k] for k in counts}
    out = {"n": n, "bs": bs, "blocks_per_row": bpr, "seeds": FWDN_SEEDS,
           "spikes": SO_SPIKES, "t": SO_G, "k": K, "e": float(lam),
           "e_hex": float(lam).hex(), "de_dt_fwd": d1_fwd,
           "de_dt_fwd_hex": d1_fwd.hex(), "e_fwd": e_fwd,
           "d2e_dt2_share": float(d2), "d2e_dt2": d2_total,
           "reverse_s": t_rev, "forward_mode_s": t_fwd,
           "reverse_panel_launches": reverse_launches,
           "forward_panel_launches": forward_launches}
    if sg.rank == 0:
        op = pkg.bell_operator_from_numpy(a0, cols, n, symmetric=True,
                                          device=DEVICE)
        a1_d = torch.from_numpy(a1).to(DEVICE)
        t = torch.tensor(SO_G, device=DEVICE, requires_grad=True)
        lam_u, _ = pkg.dominant_eigh(op.with_vals(op.vals + t * a1_d), **kw)
        (d1_u,) = torch.autograd.grad(lam_u, t, create_graph=True)
        (d2_u,) = torch.autograd.grad(d1_u, t)
        with torch.no_grad():
            h0 = torch.from_numpy(_bell_dense_f64(a0, cols)).to(DEVICE)
            h1 = torch.from_numpy(_bell_dense_f64(a1, cols)).to(DEVICE)
            w, vec = torch.linalg.eigh(h0 + SO_G * h1)
            mm = vec.T @ (h1 @ vec[:, 0])
            want = (float(w[0]), float(mm[0]),
                    float(2.0 * torch.sum(mm[1:] ** 2 / (w[0] - w[1:]))))
            del h0, h1, w, vec, mm
        out["unsharded"] = {"e": float(lam_u), "de_dt": float(d1_u),
                            "d2e_dt2": float(d2_u)}
        out["float64_sum_over_states"] = dict(zip(FWDN_SMALL_RTOL, want))
    return out


def _sharded_complex(pkg, sg):
    """Part (c): λ and dλ/dt of h0 + t h1 (complex Hermitian, n = 256,
    complex128) through RowShardedOperator, in reverse mode (the ranks'
    shares summed) and forward mode, against torch.linalg.eigh."""
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    n, k, seed = SHARDED_CX
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h1 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h0, h1 = (torch.from_numpy((h + h.conj().T) / 2).to(DEVICE)
              for h in (h0, h1))
    f64 = torch.float64
    t0 = time.perf_counter()
    t = torch.zeros((), dtype=f64, device=DEVICE, requires_grad=True)
    lam, _ = pkg.dominant_eigh(pkg.RowShardedOperator(h0 + t * h1, sg),
                               k=k, device=DEVICE)
    (share,) = torch.autograd.grad(lam, t)
    dlam = float(collectives.all_reduce_sum(share.reshape(1), sg))
    with torch.no_grad(), fwAD.dual_level():
        dual = fwAD.make_dual(torch.zeros((), dtype=f64, device=DEVICE),
                              torch.ones((), dtype=f64, device=DEVICE))
        lam_f, _ = pkg.dominant_eigh(
            pkg.RowShardedOperator(h0 + dual * h1, sg), k=k, device=DEVICE)
        dlam_fwd = float(fwAD.unpack_dual(lam_f).tangent)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        w, vec = torch.linalg.eigh(h0)
        exact = (float(w[0]), float(torch.real(
            vec[:, 0].conj() @ (h1 @ vec[:, 0]))))
    return {"n": n, "k": k, "dtype": "complex128", "lam": float(lam),
            "lam_hex": float(lam).hex(), "dlam_dt": dlam,
            "dlam_dt_fwd": dlam_fwd, "dlam_dt_share": float(share),
            "eigh": dict(zip(SHARDED_CX_RTOL, exact)), "wall_s": wall}


def _batch_solves(sg):
    """One rank of the batch-axis spawn: the 2 x 2 mesh, the TFIM at
    N = 16 sharded over the rank's row, the row's coupling."""
    import dominantsparseeigenad_tpu_torch as pkg
    from dominantsparseeigenad_tpu_torch import models
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    row = pkg.make_mesh(n_shards=BATCH_SHARDS,
                        n_batch=sg.size // BATCH_SHARDS)
    g0 = BATCH_G[row.batch_index]
    collectives.reset_collective_counts()
    t0 = time.perf_counter()
    g = torch.tensor(g0, device=DEVICE, requires_grad=True)
    lam, _ = pkg.dominant_eigh(models.tfim_sharded_operator(
        BATCH_TFIM_N, g, row, dtype=torch.float32, device=DEVICE),
        k=TFIM_K, extreme="min", tol=TFIM_CG_TOL, maxiter=TFIM_CG_MAXITER,
        device=DEVICE)
    (d1,) = torch.autograd.grad(lam, g)
    torch.cuda.synchronize()
    return {"rank": sg.rank, "batch_index": row.batch_index,
            "shard": row.rank, "shards": row.size, "n_batch": row.n_batch,
            "g": g0, "e0": float(lam), "de0_dg": float(d1),
            "e0_hex": float(lam).hex(), "wall_s": time.perf_counter() - t0,
            "collectives": dict(collectives.collective_counts),
            "exact": {"e0": float(models.tfim_exact_e0(BATCH_TFIM_N, g0,
                                                        device=DEVICE)),
                      "de0_dg": models.tfim_exact_de0_dg(BATCH_TFIM_N,
                                                         g0)}}


def spawn_ranks(world, body):
    """Spawn ``world`` gloo ranks on this card, each running
    ``body(shard group)``; their results in rank order, and the wall
    time."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    store = tempfile.mkdtemp(prefix="sharded_store_", dir=build)
    # The ranks reach each other over the loopback interface.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = torch.multiprocessing.get_context("spawn")
    out_queue = ctx.Queue()
    procs = [ctx.Process(target=_sharded_rank,
                         args=(rank, world, f"file://{store}/store",
                               out_queue, body))
             for rank in range(world)]
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
    return [got[rank] for rank in range(world)], time.perf_counter() - t0


def phase_sharded():
    """Spawn the ranks, collect what each sends, check them together;
    then the batch axis's four ranks."""
    ranks, wall_s = spawn_ranks(SHARDED_RANKS, _sharded_solves)
    added = [{key: res.pop(key) for key in ("tfim", "bell_second_order",
                                            "complex")} for res in ranks]
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
    for name, count in sharded_added_checks(added, checks).items():
        total[name] += count
    batch, batch_wall = spawn_ranks(BATCH_RANKS, _batch_solves)
    emit({"phase": "sharded_batch", "note": f"{BATCH_RANKS} ranks sharing "
          "one card over gloo as a (batch, shards) grid; not a multi-GPU "
          "number", "n": BATCH_TFIM_N, "grid": [BATCH_RANKS // BATCH_SHARDS,
                                                BATCH_SHARDS],
          "wall_s": batch_wall, "ranks": batch})
    for res in batch:
        rk = res["rank"]
        errs = {key: abs(res[key] - res["exact"][key]) / abs(res["exact"][key])
                for key in ("e0", "de0_dg")}
        res["rel_err"] = errs
        mate = batch[rk ^ 1]
        checks.update({
            f"batch rank {rk}: row {rk // BATCH_SHARDS}, shard "
            f"{rk % BATCH_SHARDS}": (res["batch_index"], res["shard"],
                                     res["n_batch"])
            == (rk // BATCH_SHARDS, rk % BATCH_SHARDS,
                BATCH_RANKS // BATCH_SHARDS),
            f"batch rank {rk}: E0 vs Jordan-Wigner, rel "
            f"{SHARDED_TFIM_RTOL['e0']}": errs["e0"] <= SHARDED_TFIM_RTOL["e0"],
            f"batch rank {rk}: dE0/dg vs Jordan-Wigner, rel "
            f"{SHARDED_TFIM_RTOL['de0_dg']}":
                errs["de0_dg"] <= SHARDED_TFIM_RTOL["de0_dg"],
            f"batch rank {rk}: its row's partner bitwise equal":
                mate["e0_hex"] == res["e0_hex"]
                and mate["collectives"] == res["collectives"],
        })
    checks["batch rows solve different couplings"] = \
        batch[0]["e0"] != batch[BATCH_SHARDS]["e0"]
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sharded phase failed: {failed}")
    return total


def sharded_added_checks(added, checks):
    """Emit the sharded phase's TFIM, Bell second-order and complex parts
    (one dict a rank each), add their checks to ``checks``, and return
    the panel launches of the Bell part, summed over the ranks."""
    from dominantsparseeigenad_tpu_torch import models
    note = ("2 ranks sharing one card over gloo; not a multi-GPU or "
            "scaling number")
    tf = [a["tfim"] for a in added]
    de0 = models.tfim_exact_de0_dg(TFIM_N, TFIM_G)
    exact = {"e0": float(models.tfim_exact_e0(TFIM_N, TFIM_G, device="cpu")),
             "de0_dg": de0, "de0_dg_fwd": de0,
             "d2e0_dg2": models.tfim_exact_d2e0_dg2(TFIM_N, TFIM_G)}
    errs = {key: abs(tf[0]["values"][key] - exact[key]) / abs(exact[key])
            for key in SHARDED_TFIM_RTOL}
    unsharded = tf[0]["unsharded"]["values"]
    vs_unsharded = {key: abs(tf[0]["values"][key] - unsharded[key])
                    / abs(unsharded[key]) for key in SHARDED_TFIM_RTOL}
    emit({"phase": "sharded_tfim", "note": note,
          "jordan_wigner": exact, "rel_err": errs, "rtol": SHARDED_TFIM_RTOL,
          "vs_unsharded_rel": vs_unsharded, "ranks": tf,
          "card": nvidia_smi_name_power()})
    for key, bar in SHARDED_TFIM_RTOL.items():
        checks[f"sharded TFIM N={TFIM_N} {key} vs Jordan-Wigner, rel "
               f"{bar}"] = errs[key] <= bar
        checks[f"sharded TFIM {key} vs unsharded, rel "
               f"{SHARDED_VS_UNSHARDED}"] = \
            vs_unsharded[key] <= SHARDED_VS_UNSHARDED
    checks["sharded TFIM: ranks bitwise equal, same collectives"] = all(
        t["hex"] == tf[0]["hex"] and t["collectives"] == tf[0]["collectives"]
        for t in tf)
    checks["sharded TFIM: the XOR exchange ran"] = \
        tf[0]["collectives"]["ppermute"] > 0

    bl = [a["bell_second_order"] for a in added]
    want = bl[0]["float64_sum_over_states"]
    got = {"e": bl[0]["e"], "de_dg": bl[0]["de_dt_fwd"],
           "d2e_dg2": bl[0]["d2e_dt2"]}
    b_errs = {key: abs(got[key] - want[key]) / abs(want[key])
              for key in FWDN_SMALL_RTOL}
    un = bl[0]["unsharded"]
    b_vs = {key: abs(got[key] - un[ukey]) / abs(un[ukey]) for key, ukey in
            (("e", "e"), ("de_dg", "de_dt"), ("d2e_dg2", "d2e_dt2"))}
    emit({"phase": "sharded_bell_second_order", "note": note,
          "rel_err": b_errs, "rtol": FWDN_SMALL_RTOL,
          "vs_unsharded_rel": b_vs, "ranks": bl})
    for key, bar in FWDN_SMALL_RTOL.items():
        checks[f"sharded Bell {key} vs float64 sum over states, rel "
               f"{bar}"] = b_errs[key] <= bar
        checks[f"sharded Bell {key} vs unsharded, rel "
               f"{SHARDED_BELL_VS_UNSHARDED}"] = \
            b_vs[key] <= SHARDED_BELL_VS_UNSHARDED
    checks["sharded Bell: ranks bitwise equal"] = all(
        b["e_hex"] == bl[0]["e_hex"] and b["de_dt_fwd_hex"]
        == bl[0]["de_dt_fwd_hex"] and b["d2e_dt2"] == bl[0]["d2e_dt2"]
        for b in bl)
    launches = {}
    for rk, b in enumerate(bl):
        for part in ("reverse_panel_launches", "forward_panel_launches"):
            for name, count in b[part].items():
                launches[name] = launches.get(name, 0) + count
        # Forward mode: k panel SpMVs, the tangent's, its CG's.
        checks[f"sharded Bell rank {rk}: forward-mode panel SpMVs > k"] = \
            b["forward_panel_launches"]["bell_spmv_f32"] > K
        checks[f"sharded Bell rank {rk}: reverse panel SpMVs > k"] = \
            b["reverse_panel_launches"]["bell_spmv_f32"] > K

    cx = [a["complex"] for a in added]
    ex = cx[0]["eigh"]
    c_errs = {"lam": abs(cx[0]["lam"] - ex["lam"]) / abs(ex["lam"]),
              "dlam_dt": abs(cx[0]["dlam_dt"] - ex["dlam_dt"])
              / abs(ex["dlam_dt"]),
              "dlam_dt_fwd": abs(cx[0]["dlam_dt_fwd"] - ex["dlam_dt"])
              / abs(ex["dlam_dt"])}
    emit({"phase": "sharded_complex", "note": note, "rel_err": c_errs,
          "rtol": SHARDED_CX_RTOL, "ranks": cx})
    checks.update({
        f"sharded complex λ vs eigh, rel {SHARDED_CX_RTOL['lam']}":
            c_errs["lam"] <= SHARDED_CX_RTOL["lam"],
        f"sharded complex dλ/dt vs eigh, rel {SHARDED_CX_RTOL['dlam_dt']}":
            c_errs["dlam_dt"] <= SHARDED_CX_RTOL["dlam_dt"],
        f"sharded complex forward dλ/dt vs eigh, rel "
        f"{SHARDED_CX_RTOL['dlam_dt']}":
            c_errs["dlam_dt_fwd"] <= SHARDED_CX_RTOL["dlam_dt"],
        "sharded complex: ranks bitwise equal": all(
            c["lam_hex"] == cx[0]["lam_hex"]
            and c["dlam_dt_fwd"] == cx[0]["dlam_dt_fwd"] for c in cx),
    })
    return launches



def ring_offsets_of(cols, p):
    """The active ring offsets of a blocked-ELL ``cols`` (numpy, global)
    split over p ranks, ascending: o such that some slot of a row owned by
    rank d reads a block-column owned by rank (d + o) % p (the definition
    of the JAX package's ``_bucket_by_offset``, computed here apart)."""
    nb = cols.shape[0]
    nb_l = nb // p
    owner = np.arange(nb)[:, None] // nb_l
    return tuple(int(o) for o in np.unique((cols // nb_l - owner) % p))


def _sv_counts(spmv):
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    return (dict(spmv.ring_launch_counts), dict(spmv.panel_launch_counts),
            dict(spmv.launch_counts), dict(collectives.collective_counts))


def _sv_diff(after, before):
    return [{k: a[k] - b[k] for k in a if a[k] != b[k]}
            for a, b in zip(after, before)]


def _sharded_vector_solves(sg):
    """One rank of the sharded_vectors phase (module docstring)."""
    import importlib
    import dominantsparseeigenad_tpu_torch as pkg
    from dominantsparseeigenad_tpu_torch import models, utils
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                   "bell_spmv")
    t_rank = time.perf_counter()
    n, bs, bpr = CONFIG5
    r = MULTI_R
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    op = pkg.random_bell_operator(n, bs, bpr, generator=gen, device=DEVICE)
    v0 = torch.randn(n, generator=gen, device=DEVICE)
    torch.randn(n, generator=gen, device=DEVICE)        # the sharded c
    x0 = torch.randn(n, r, generator=gen, device=DEVICE)
    offsets_indep = ring_offsets_of(op.cols.cpu().numpy(), sg.size)
    # One panel for the three operators: the replicated-vector one (the
    # default layout), all_gather and ring over sharded vectors.
    rep = pkg.RowShardedBellOperator.from_bell(op, sg)
    ag = pkg.RowShardedBellOperator.from_bell(
        op, sg, vectors="sharded").with_vals(rep.vals)
    t0 = time.perf_counter()
    ring = pkg.RowShardedBellOperator.from_bell(
        op, sg, mode="ring", vectors="sharded").with_vals(rep.vals)
    t_bucket_build = time.perf_counter() - t0
    del op
    torch.cuda.empty_cache()
    lay = ag.vector_layout
    n_off = len(ring.ring_offsets)
    m_o = [int(b[1].shape[1]) for b in ring._buckets]
    v0_s, x0_s = lay.rows(v0).clone(), lay.rows(x0).clone()
    out = {"rank": sg.rank, "world": sg.size, "offsets": ring.ring_offsets,
           "hops": ring.ring_hops, "offsets_indep": offsets_indep,
           "bucket_slots": m_o, "bucket_build_s": t_bucket_build}

    # Warm-up through the same calls on a small sharded operator.
    small = pkg.random_bell_operator(1 << 14, bs, bpr, generator=gen,
                                     device=DEVICE)
    for mode in ("all_gather", "ring"):
        w = pkg.RowShardedBellOperator.from_bell(small, sg, mode=mode,
                                                 vectors="sharded")
        w = w.with_vals(w.vals.clone().requires_grad_(True))
        lam_w, _ = pkg.dominant_eigh(w, k=20, device=DEVICE)
        lam_w.backward()
        pkg.dominant_eigh_multi(w, r=r, k=r, method="lobpcg", device=DEVICE)
    del small, w, lam_w
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- (a), (b), (e): the products, counted --------------------------
    spmv.reset_launch_counts()
    collectives.reset_collective_counts()
    with torch.no_grad():
        y_rep = lay.rows(rep.matvec(v0))
        Y_rep = lay.rows(rep.matmat(x0))
        before = _sv_counts(spmv)
        y_ag = ag.matvec(v0_s)
        mid = _sv_counts(spmv)
        y_ring = ring.matvec(v0_s)
        after = _sv_counts(spmv)
        Y_ag = ag.matmat(x0_s)
        mid2 = _sv_counts(spmv)
        Y_ring = ring.matmat(x0_s)
        after2 = _sv_counts(spmv)
    out.update({
        "ag_matvec_bitwise": bool(torch.equal(y_ag, y_rep)),
        "ag_matmat_bitwise": bool(torch.equal(Y_ag, Y_rep)),
        "ring_matvec_rel": rel_err(y_ring, y_rep),
        "ring_matmat_rel": rel_err(Y_ring, Y_rep),
        "ag_matvec_counts": _sv_diff(mid, before),
        "ring_matvec_counts": _sv_diff(after, mid),
        "ring_matmat_counts": _sv_diff(after2, mid2)})
    del y_rep, Y_rep, y_ag, Y_ag, y_ring, Y_ring

    # ---- (c): dominant_eigh, both modes, against the replicated run -----
    solve = dict(k=K, extreme="min", tol=CG_TOL, device=DEVICE)
    with torch.no_grad():
        lam_rep = float(pkg.dominant_eigh(rep, v0=v0, **solve)[0])
    out["lam_replicated"] = lam_rep
    collectives.reset_collective_counts()
    eigh = {}
    for mode, sop in (("all_gather", ag), ("ring", ring)):
        panel = sop.vals.clone().requires_grad_(True)
        before = _sv_counts(spmv)
        t0 = time.perf_counter()
        lam, v = pkg.dominant_eigh(sop.with_vals(panel), v0=v0_s, **solve)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        mid = _sv_counts(spmv)
        t0 = time.perf_counter()
        (g_lam,) = torch.autograd.grad(lam, panel)
        torch.cuda.synchronize()
        t_bwd = time.perf_counter() - t0
        after = _sv_counts(spmv)
        with torch.no_grad():
            # ∂λ/∂panel = v[rows] ⊗ v[cols] on the panel's pattern.
            vb = pkg.row_sharding(sg).gather(v.detach()).reshape(-1, bs)
            nb_l = panel.shape[0]
            expect = vb[sg.rank * nb_l:(sg.rank + 1) * nb_l][:, None, :,
                                                              None] \
                * vb[sop.cols.long()][:, :, None, :]
            dlam_err = rel_err(g_lam, expect)
            del expect
        eigh[mode] = {"lam": float(lam), "lam_hex": float(lam).hex(),
                      "lam_vs_replicated": abs(float(lam) - lam_rep)
                      / abs(lam_rep),
                      "dlam_dpanel_rel_err": dlam_err,
                      "forward_s": t_fwd, "backward_lam_s": t_bwd,
                      "forward_counts": _sv_diff(mid, before),
                      "backward_counts": _sv_diff(after, mid),
                      "finite": bool(torch.isfinite(v).all()
                                     and torch.isfinite(g_lam).all())}
        del panel, lam, v, g_lam
    out["eigh"] = eigh
    out["eigh_collectives"] = dict(collectives.collective_counts)

    # ---- (d): LOBPCG in ring mode against the replicated run -------------
    with torch.no_grad():
        t0 = time.perf_counter()
        lams_rep, _, info_rep = pkg.dominant_eigh_multi(
            rep, r=r, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL, x0=x0,
            with_info=True, device=DEVICE)
        torch.cuda.synchronize()
        t_rep = time.perf_counter() - t0
        before = _sv_counts(spmv)
        t0 = time.perf_counter()
        lams, _, info = pkg.dominant_eigh_multi(
            ring, r=r, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL, x0=x0_s,
            with_info=True, device=DEVICE)
        torch.cuda.synchronize()
        t_ring = time.perf_counter() - t0
        after = _sv_counts(spmv)
    out["lobpcg"] = {
        "lams": lams.tolist(), "lams_hex": [float(t).hex() for t in lams],
        "lams_replicated": lams_rep.tolist(),
        "rel_vs_replicated": float((lams - lams_rep).abs().max()
                                   / lams_rep.abs().max()),
        "iterations": int(info.effective_k),
        "iterations_replicated": int(info_rep.effective_k),
        "residual": float(info.residual), "ring_s": t_ring,
        "replicated_s": t_rep, "counts": _sv_diff(after, before)}
    # The main path's launches: the products above, both modes' solves
    # and the ring LOBPCG (the replicated runs' panels among them).
    ring_total = dict(spmv.ring_launch_counts)
    panel_total = dict(spmv.panel_launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # ---- times (both ranks in step, sharing the card) --------------------
    with torch.no_grad():
        times = {
            "replicated_matvec_ms": event_ms(lambda: rep.matvec(v0),
                                             samples=12, batch=3),
            "all_gather_matvec_ms": event_ms(lambda: ag.matvec(v0_s),
                                             samples=12, batch=3),
            "ring_matvec_ms": event_ms(lambda: ring.matvec(v0_s),
                                       samples=12, batch=3),
            "replicated_matmat_ms": event_ms(lambda: rep.matmat(x0),
                                             samples=8, batch=2),
            "all_gather_matmat_ms": event_ms(lambda: ag.matmat(x0_s),
                                             samples=8, batch=2),
            "ring_matmat_ms": event_ms(lambda: ring.matmat(x0_s),
                                       samples=8, batch=2)}
        rows = torch.arange(ring.vals.shape[0], device=DEVICE)[:, None]

        def gathers():
            for _, slot_idx, _, mask in ring._buckets:
                ring.vals[rows, slot_idx.long()] \
                    * mask.to(ring.vals.dtype)[:, :, None, None]

        times["ring_bucket_gathers_ms"] = event_ms(gathers, samples=12,
                                                   batch=3)
        times["ring_gather_share"] = times["ring_bucket_gathers_ms"] \
            / times["ring_matvec_ms"]
    out["times"] = times

    # ---- the checkpoint of an (N/p, k) Lanczos basis ---------------------
    with torch.no_grad():
        res = pkg.lanczos(ag, SV_CKPT_K, v0=v0_s, device=DEVICE)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    path = os.path.join(build, "sharded_vectors_ckpt")
    specs = type(res)(pkg.replicated(sg), pkg.replicated(sg),
                      pkg.row_sharding(sg, 2))
    utils.save_orbax(path, res, specs)
    back = utils.load_orbax(path, res, specs)
    out["checkpoint_bitwise"] = all(torch.equal(a, b)
                                    for a, b in zip(back, res))
    out["checkpoint_mb"] = os.path.getsize(path + ".npz") / 2**20
    torch.distributed.barrier()
    if sg.rank == 0:
        for ext in (".npz", ".tree.json"):
            os.remove(path + ext)
    del rep, ag, ring, res, back
    torch.cuda.empty_cache()

    # ---- the sharded TFIM at N = 20 over sharded vectors -----------------
    f32 = torch.float32

    def tfim(vectors, nn=TFIM_N):
        return lambda g: models.tfim_sharded_operator(
            nn, g, sg, dtype=f32, device=DEVICE, vectors=vectors)

    def start(nn):
        return torch.randn(1 << nn, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(11))

    small = start(TFIM_N_ED)
    _tfim_derivatives(tfim("sharded", TFIM_N_ED), TFIM_G, f32,
                      shard_rows(small, sg))
    torch.cuda.synchronize()
    collectives.reset_collective_counts()
    t0v = start(TFIM_N)
    values, tfim_times = _tfim_derivatives(tfim("sharded"), TFIM_G, f32,
                                           shard_rows(t0v, sg))
    tfim_counts = dict(collectives.collective_counts)
    sharded_op = tfim("sharded")(TFIM_G)
    replicated_op = tfim("replicated")(TFIM_G)
    with torch.no_grad():
        x = t0v / torch.linalg.vector_norm(t0v)
        x_l = shard_rows(x, sg)
        mv = {"sharded_ms": event_ms(lambda: sharded_op.matvec(x_l),
                                     samples=12, batch=5),
              "replicated_ms": event_ms(lambda: replicated_op.matvec(x),
                                        samples=12, batch=5)}
    out["tfim"] = {"values": values, "hex": {k: float(v).hex()
                                             for k, v in values.items()},
                   "times": tfim_times, "collectives": tfim_counts,
                   "matvec": mv}
    out.update({"ring_launches": ring_total, "panel_launches": panel_total,
                "peak_mem_gib": peak_gib,
                "rank_s": time.perf_counter() - t_rank})
    return out


def shard_rows(x, sg):
    """The rank's rows of a global tensor (no gradient)."""
    rows = x.shape[0] // sg.size
    return x[sg.rank * rows:(sg.rank + 1) * rows].clone()


def bucket_library_call(bucket, local_col, mask, n):
    """One PyTorch call for a ring bucket's product: a cuSPARSE BSR matrix
    of its stored slots (the padding left out, each row's slots sorted by
    column).  A yardstick only."""
    nb, m_o, bs, _ = bucket.shape
    keep = mask > 0
    counts = keep.sum(dim=1)
    key = torch.where(keep, local_col.long(), torch.full_like(
        local_col.long(), n // bs))
    order = key.argsort(dim=1)
    rows = torch.arange(nb, device=bucket.device)[:, None]
    keep_s = keep[rows, order]
    crow = torch.zeros(nb + 1, dtype=torch.int32, device=bucket.device)
    crow[1:] = counts.cumsum(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = torch.sparse_bsr_tensor(
            crow, local_col.long()[rows, order][keep_s].to(torch.int32),
            bucket[rows, order][keep_s], size=(nb * bs, n),
            check_invariants=False)
    return lambda x: a @ x


def bucket_kernel_rows(spmv, pkg):
    """The ring buckets of rank 0 of config #5 split over SHARDED_RANKS, on
    their own in this process: each bucket's SpMV and SpMM (r = MULTI_R)
    kernel against the plain version, kernel, plain, bound and library
    (cuSPARSE BSR on the bucket) times, and the bucket gather's own time.
    The first (widest) offset's rows name the ring kernels in the
    ``kernels`` line."""
    from dominantsparseeigenad_tpu_torch.parallel.mesh import ShardGroup
    n, bs, bpr = CONFIG5
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    op = pkg.random_bell_operator(n, bs, bpr, generator=gen, device=DEVICE)
    sg = ShardGroup(group=None, rank=0, size=SHARDED_RANKS, backend="gloo")
    ring = pkg.RowShardedBellOperator.from_bell(op, sg, mode="ring",
                                                vectors="sharded")
    del op
    torch.cuda.empty_cache()
    nb_l = ring.vals.shape[0]
    seg = torch.randn(nb_l * bs, generator=gen, device=DEVICE)
    segs = torch.randn(nb_l * bs, MULTI_R, generator=gen, device=DEVICE)
    rows_idx = torch.arange(nb_l, device=DEVICE)[:, None]
    rows = {}
    for o, slot_idx, local_col, mask in ring._buckets:
        mask = mask.to(DEVICE)

        def gather(s=slot_idx, m=mask):
            return ring.vals[rows_idx, s.long()] \
                * m.to(ring.vals.dtype)[:, :, None, None]

        bucket = gather()
        gather_ms = event_ms(gather, samples=8, batch=2)
        for kind, x, kernel, plain in (
                ("spmv", seg, spmv._bell_spmv_cuda, spmv._bell_spmv_torch),
                ("spmm", segs, spmv._bell_spmm_cuda, spmv._bell_spmm_torch)):
            r = 1 if x.ndim == 1 else x.shape[1]
            with spmv.ring_launches():
                y_k = kernel(bucket, local_col, x)
            y_p = plain(bucket, local_col, x)
            torch.cuda.synchronize()
            err = rel_err(y_k, y_p)
            if not (math.isfinite(err) and err <= 1e-5):
                raise AssertionError(f"ring bucket {kind} offset {o}: rel "
                                     f"err {err} against the plain version")
            with spmv.ring_launches():
                kernel_ms = event_ms(lambda: kernel(bucket, local_col, x),
                                     samples=12, batch=3)
            plain_ms = event_ms(lambda: plain(bucket, local_col, x),
                                samples=8)
            lib = bucket_library_call(bucket, local_col, mask, nb_l * bs)
            lib_err = rel_err(lib(x), y_p)
            library_ms = event_ms(lambda: lib(x), samples=12)
            del lib
            # Least bytes: the bucket's values and local columns, the
            # segment once, y once; the padding slots are part of the work.
            bytes_min, bound_ms, bound_by = bound(
                bucket.numel(), bucket.element_size(),
                local_col.numel() * 4 + x.numel() * 4 + y_k.numel() * 4, r)
            row = {"phase": "sharded_vectors", "kernel":
                   f"bell_{kind}_ring_f32", "offset": o,
                   "bucket_slots": int(local_col.shape[1]),
                   "block_rows": nb_l, "bs": bs, "r": r, "rel_err": err,
                   "max_abs_err": float((y_k - y_p).abs().max()),
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_rel_err": lib_err,
                   "gather_ms": gather_ms, "bytes_min": bytes_min,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "achieved_gbps": bytes_min / (kernel_ms * 1e-3) / 1e9}
            emit(row)
            rows.setdefault(f"bell_{kind}_f32", []).append(row)
            del y_k, y_p
        del bucket
    del ring, seg, segs
    torch.cuda.empty_cache()
    return {k: max(v, key=lambda row: row["bucket_slots"])
            for k, v in rows.items()}


def phase_sharded_vectors(pkg, spmv):
    """The sharded-vector layout and ring mode on the card (module
    docstring); returns the ring bucket and the panel launches of its
    main path, and the bucket kernels' rows."""
    from dominantsparseeigenad_tpu_torch import models
    t_phase = time.perf_counter()
    ranks, wall_s = spawn_ranks(SHARDED_RANKS, _sharded_vector_solves)
    note = ("2 ranks sharing one card over gloo; not a multi-GPU or "
            "scaling number")
    first = ranks[0]
    de0 = models.tfim_exact_de0_dg(TFIM_N, TFIM_G)
    exact = {"e0": float(models.tfim_exact_e0(TFIM_N, TFIM_G, device="cpu")),
             "de0_dg": de0, "de0_dg_fwd": de0,
             "d2e0_dg2": models.tfim_exact_d2e0_dg2(TFIM_N, TFIM_G)}
    tf_err = {key: abs(first["tfim"]["values"][key] - exact[key])
              / abs(exact[key]) for key in SHARDED_TFIM_RTOL}
    # The ring example driver: its parity gate against the unsharded
    # operator, its buckets counted apart.
    driver = importlib.import_module(
        "dominantsparseeigenad_tpu_torch.examples.sharded_sparse")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ex = driver.main(["--mode", "ring", "--device", DEVICE])
    ex_s = time.perf_counter() - t0
    rows = bucket_kernel_rows(spmv, pkg)
    card = nvidia_smi_name_power()
    emit({"phase": "sharded_vectors", "note": note, "card": card,
          "n": CONFIG5[0], "bs": CONFIG5[1], "blocks_per_row": CONFIG5[2],
          "k": K, "r": MULTI_R, "lobpcg_cap": LOBPCG_ITERS, "wall_s": wall_s,
          "tfim_jordan_wigner": exact, "tfim_rel_err": tf_err,
          "example_ring": {k: ex[k] for k in (
              "lam_sharded", "lam_local", "grad_max_abs_diff",
              "ring_launches", "ring_offsets")}, "example_ring_s": ex_s,
          "ranks": ranks, "phase_s": time.perf_counter() - t_phase})
    n_off = len(first["offsets"])
    checks = {
        "ring offsets: ranks agree": all(res["offsets"] == first["offsets"]
                                         for res in ranks),
        "ring offsets == the bucketing of cols, computed apart":
            tuple(first["offsets"]) == tuple(first["offsets_indep"]),
        "ring hops == active offsets other than 0":
            first["hops"] == sum(1 for o in first["offsets"] if o != 0),
        "ranks' λ bitwise equal, both modes": all(
            res["eigh"][m]["lam_hex"] == first["eigh"][m]["lam_hex"]
            for res in ranks for m in ("all_gather", "ring")),
        "ranks' LOBPCG λ bitwise equal": all(
            res["lobpcg"]["lams_hex"] == first["lobpcg"]["lams_hex"]
            for res in ranks),
        "ranks ran the same collectives": all(
            res["eigh_collectives"] == first["eigh_collectives"]
            and res["tfim"]["collectives"] == first["tfim"]["collectives"]
            for res in ranks),
        "sharded TFIM: ranks bitwise equal": all(
            res["tfim"]["hex"] == first["tfim"]["hex"] for res in ranks),
        "example --mode ring: ring bucket SpMVs launched":
            ex["ring_launches"].get("bell_spmv_f32", 0) > 0,
    }
    for key, bar in SHARDED_TFIM_RTOL.items():
        checks[f"sharded-vector TFIM N={TFIM_N} {key} vs Jordan-Wigner, "
               f"rel {bar}"] = tf_err[key] <= bar
    for res in ranks:
        rk = res["rank"]
        ring_mv, ring_mm = res["ring_matvec_counts"], res["ring_matmat_counts"]
        checks.update({
            f"rank {rk}: all_gather matvec == replicated rows, bitwise":
                res["ag_matvec_bitwise"],
            f"rank {rk}: all_gather matmat == replicated rows, bitwise":
                res["ag_matmat_bitwise"],
            f"rank {rk}: ring matvec vs replicated, rel {SV_RTOL}":
                res["ring_matvec_rel"] <= SV_RTOL,
            f"rank {rk}: ring matmat vs replicated, rel {SV_RTOL}":
                res["ring_matmat_rel"] <= SV_RTOL,
            f"rank {rk}: a ring matvec launches one SpMV per offset":
                ring_mv[0] == {"bell_spmv_f32": n_off}
                and not ring_mv[1] and not ring_mv[2],
            f"rank {rk}: a ring matmat launches one SpMM per offset":
                ring_mm[0] == {"bell_spmm_f32": n_off}
                and not ring_mm[1] and not ring_mm[2],
            f"rank {rk}: a ring matvec runs ring_hops ppermutes":
                ring_mv[3].get("ppermute", 0) == res["hops"],
            f"rank {rk}: all_gather matvec: one panel SpMV, no ring":
                res["ag_matvec_counts"][1] == {"bell_spmv_f32": 1}
                and not res["ag_matvec_counts"][0],
            f"rank {rk}: ring forward: k x offsets bucket SpMVs":
                res["eigh"]["ring"]["forward_counts"][0]
                == {"bell_spmv_f32": K * n_off},
            f"rank {rk}: ring LOBPCG: offsets x (1 + 2 x iterations) "
            f"bucket SpMMs":
                res["lobpcg"]["counts"][0].get("bell_spmm_f32")
                == n_off * (1 + 2 * res["lobpcg"]["iterations"]),
            f"rank {rk}: checkpoint read back bitwise":
                res["checkpoint_bitwise"],
        })
        for mode in ("all_gather", "ring"):
            e = res["eigh"][mode]
            checks.update({
                f"rank {rk}: {mode} λ vs replicated, rel {SV_RTOL}":
                    e["lam_vs_replicated"] <= SV_RTOL,
                f"rank {rk}: {mode} ∂λ/∂panel vs v⊗v, rel {SV_RTOL}":
                    e["dlam_dpanel_rel_err"] <= SV_RTOL,
                f"rank {rk}: {mode} finite": e["finite"]})
        checks[f"rank {rk}: ring LOBPCG λ vs replicated, rel {SV_RTOL}"] = \
            res["lobpcg"]["rel_vs_replicated"] <= SV_RTOL
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sharded_vectors phase failed: {failed}")
    ring_total, panel_total = {}, {}
    for res in ranks:
        add_counts(ring_total, res["ring_launches"])
        add_counts(panel_total, res["panel_launches"])
    return ring_total, panel_total, rows


def sharded_tfim_pass(pkg, models, sg, n, **extra):
    """:func:`tfim_pass` on the sharded TFIM over sharded vectors: (E0,
    dE0/dg, χ_F), ψ and its tangent the rank's rows, the two inner
    products of χ_F summed over the ranks."""
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    f32 = torch.float32
    with torch.no_grad(), fwAD.dual_level():
        g = fwAD.make_dual(torch.tensor(TFIM_G, dtype=f32, device=DEVICE),
                           torch.ones((), dtype=f32, device=DEVICE))
        op = models.tfim_sharded_operator(n, g, sg, dtype=f32, device=DEVICE,
                                          vectors="sharded")
        lam, v = pkg.dominant_eigh(
            op, k=min(TFIM_K, 1 << n), extreme="min", tol=TFIM_CG_TOL,
            maxiter=TFIM_CG_MAXITER, reorth_passes=TFIM_REORTH_PASSES,
            device=DEVICE, **extra)
        e0, de0 = fwAD.unpack_dual(lam)
        psi, dpsi = fwAD.unpack_dual(v)
        dots = collectives.sum_over_ranks(
            torch.stack([torch.dot(dpsi, dpsi), torch.dot(psi, dpsi)]), sg)
    chi = dots[0] - dots[1] ** 2
    return float(e0), float(de0), float(chi)


def restart_value_and_grad(pkg, make):
    """(E0, dE0/dg) of the operator ``make(g)`` by thick restart at the
    restart phase's TFIM settings (``RESTART_TFIM``), float32."""
    p = RESTART_TFIM
    g = torch.tensor(p["g"], dtype=torch.float32, device=DEVICE,
                     requires_grad=True)
    lam, _ = pkg.dominant_eigh(make(g), k=p["k"], restart_cycles=p["cycles"],
                               reorth_passes=p["reorth_passes"],
                               device=DEVICE)
    (d,) = torch.autograd.grad(lam, g)
    return float(lam.detach()), float(d)


def kpm_pair(pkg, op, energies):
    """The spectral phase's KPM density at ``energies`` and Tr exp(A)
    (degree ``KPM_DEGREE``, ``KPM_PROBES`` probes, the enclosure and the
    probes drawn from ``SPEC_SEED``)."""
    def seeded():
        return torch.Generator(device=DEVICE).manual_seed(SPEC_SEED)

    with torch.no_grad():
        rho = pkg.spectral_density(op, energies, degree=KPM_DEGREE,
                                   n_probe=KPM_PROBES, generator=seeded(),
                                   bounds_k=SPEC_BOUNDS_K, device=DEVICE)
        tr = pkg.trace_function(op, torch.exp, degree=KPM_DEGREE,
                                n_probe=KPM_PROBES, generator=seeded(),
                                bounds_k=SPEC_BOUNDS_K, device=DEVICE)
    return rho.tolist(), float(tr)


def _sharded_solver_solves(energies, sg):
    """One rank of the sharded_solvers phase (module docstring):
    ``energies`` are the unsharded KPM density's."""
    import dominantsparseeigenad_tpu_torch as pkg
    from dominantsparseeigenad_tpu_torch import SHARD_AXIS, models, utils
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                   "bell_spmv")
    t_rank = time.perf_counter()
    f32 = torch.float32
    out = {"rank": sg.rank}

    # ---- (a) the TFIM headline over sharded vectors ---------------------
    for extra in (TFIM_HEADLINE, {}):          # warm-up at N = 10
        sharded_tfim_pass(pkg, models, sg, TFIM_N_ED, **extra)
    torch.cuda.synchronize()
    collectives.reset_collective_counts()
    tf = {}
    for name, extra in (("bf16_basis", TFIM_HEADLINE), ("f32_basis", {})):
        t0 = time.perf_counter()
        values = sharded_tfim_pass(pkg, models, sg, TFIM_N, **extra)
        torch.cuda.synchronize()
        tf[name] = {"values": values, "hex": [v.hex() for v in values],
                    "pass_s": time.perf_counter() - t0}
    tf["collectives"] = dict(collectives.collective_counts)
    # The bf16 pass again, rank 0 under the profiler (its idle share).
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    trace_dir = os.path.join(build, f"sharded_solvers_trace_{os.getpid()}")
    t0 = time.perf_counter()
    if sg.rank == 0:
        with utils.trace(trace_dir) as log_dir:
            sharded_tfim_pass(pkg, models, sg, TFIM_N, **TFIM_HEADLINE)
        tf["trace"] = {k: v for k, v in read_trace(log_dir).items()
                       if k in ("idle_share", "window_ms", "busy_ms",
                                "device_intervals")}
        shutil.rmtree(trace_dir, ignore_errors=True)
    else:
        sharded_tfim_pass(pkg, models, sg, TFIM_N, **TFIM_HEADLINE)
    torch.cuda.synchronize()
    tf["traced_pass_s"] = time.perf_counter() - t0
    out["tfim"] = tf

    # ---- (b) thick restart on the sharded TFIM N = 20 --------------------
    runs = [peak_since(lambda: restart_value_and_grad(
        pkg, lambda g: models.tfim_sharded_operator(
            TFIM_N, g, sg, dtype=f32, device=DEVICE, vectors="sharded")))
        for _ in range(2)]
    (e0, de0), _, peak = runs[-1]
    out["restart"] = {"e0": e0, "de0_dg": de0, "peak_mib": peak,
                      "value_and_grad_s": [t for _, t, _ in runs],
                      "hex": [e0.hex(), de0.hex()]}

    # ---- (e) F11: the diagnostics, sharded against replicated -------------
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    v0 = torch.randn(1 << TFIM_N, generator=gen, device=DEVICE)
    ops = {vectors: models.tfim_sharded_operator(
        TFIM_N, TFIM_G, sg, dtype=f32, device=DEVICE, vectors=vectors)
        for vectors in ("sharded", "replicated")}
    lay = ops["sharded"].vector_layout
    with torch.no_grad():
        lam, v = pkg.dominant_eigh(ops["sharded"], k=TFIM_K,
                                   v0=lay.rows(v0), device=DEVICE)
        v_whole = pkg.row_sharding(sg).gather(v)
        b = lay.rows(v0) / 16.0
        x = pkg.cg(ops["sharded"].matvec, b, maxiter=5, device=DEVICE)
        diag = {}
        for vectors, op in ops.items():
            whole = vectors == "replicated"
            health = utils.lanczos_health(op, pkg.lanczos(
                op, 10, v0=v0 if whole else lay.rows(v0), device=DEVICE))
            xb = (pkg.row_sharding(sg).gather(x), v0 / 16.0) if whole \
                else (x, b)
            diag[vectors] = [
                float(utils.ritz_residual(op, lam + 0.1,
                                          v_whole if whole else v)),
                float(health["ortho_loss"]),
                float(health["ritz_residual_min"]),
                float(health["ritz_residual_max"]),
                float(utils.cg_relative_residual(op.matvec, xb[1], xb[0]))]
    out["diagnostics"] = diag
    del ops, v0, v, v_whole, b, x
    torch.cuda.empty_cache()

    # ---- (c) KPM through the row panel, (d) the pencil: counted ----------
    op, _ = config5_operator(pkg)
    n, r = CONFIG5[0], MULTI_R
    panels = {mode: pkg.RowShardedBellOperator.from_bell(
        op, sg, mode=mode, vectors="sharded") for mode in ("all_gather",
                                                          "ring")}
    del op
    torch.cuda.empty_cache()
    lay = panels["all_gather"].vector_layout
    energies = torch.tensor(energies, device=DEVICE)
    # Warm-up of the sharded KPM calls at a small shape.
    small = pkg.random_bell_operator(1 << 14, CONFIG5[1], CONFIG5[2],
                                     generator=torch.Generator(
                                         device=DEVICE).manual_seed(1),
                                     device=DEVICE)
    for mode in ("all_gather", "ring"):
        w = pkg.RowShardedBellOperator.from_bell(small, sg, mode=mode,
                                                 vectors="sharded")
        with torch.no_grad():
            pkg.spectral_density(w, energies, degree=8, n_probe=KPM_PROBES,
                                 bounds_k=8, device=DEVICE)
    del small, w
    torch.cuda.synchronize()
    spmv.reset_launch_counts()
    collectives.reset_collective_counts()
    kpm = {}
    for mode, sop in panels.items():
        before = _sv_counts(spmv)
        t0 = time.perf_counter()
        rho, tr = kpm_pair(pkg, sop, energies)
        torch.cuda.synchronize()
        kpm[mode] = {"density": rho, "trace_exp": tr,
                     "s": time.perf_counter() - t0,
                     "launches": _sv_diff(_sv_counts(spmv), before)}
    del panels["ring"]
    torch.cuda.empty_cache()
    out["kpm"] = kpm
    # The gen phase's pencil with A row-sharded: B = diag(m) a sharded
    # matrix-free operator (its rows of m), on A's layout.
    a = panels.pop("all_gather")
    gen = torch.Generator(device=DEVICE).manual_seed(GEN_SEED)
    m = (1.0 + torch.rand(n, generator=gen, device=DEVICE)).requires_grad_()
    x0 = torch.randn(n, r, generator=gen, device=DEVICE)
    bop = pkg.ShardedMatrixFreeOperator(lambda d, x: d * x, m, n, sg,
                                        dtype=f32, param_specs=SHARD_AXIS,
                                        vectors="sharded")
    m_rows = lay.rows(m.detach())
    before = _sv_counts(spmv)
    t0 = time.perf_counter()
    lams, _, info = pkg.dominant_eigh_gen(
        a, bop, r=r, maxiter=LOBPCG_ITERS, tol=CG_TOL,
        precond=lambda z: z / m_rows, x0=lay.rows(x0), with_info=True,
        device=DEVICE)
    (g_m,) = torch.autograd.grad(lams.sum(), m)
    torch.cuda.synchronize()
    out["pencil"] = {"lams": lams.tolist(), "hex": [float(t).hex()
                                                     for t in lams],
                     "iterations": int(info.effective_k),
                     "residual": float(info.residual),
                     "s": time.perf_counter() - t0,
                     "launches": _sv_diff(_sv_counts(spmv), before),
                     "dsumlam_dm_rows": lay.rows(g_m).cpu().numpy(),
                     "collectives": dict(collectives.collective_counts)}
    ring, panel, square, _ = _sv_counts(spmv)
    out.update({"ring_launches": ring, "panel_launches": panel,
                "square_launches": square,
                "rank_s": time.perf_counter() - t_rank})
    del a, bop, m, x0, lams, g_m
    torch.cuda.empty_cache()
    return out


def phase_sharded_solvers(pkg, spmv):
    """The Hermitian solvers over sharded vectors (module docstring):
    the unsharded references in this process first, then two ranks;
    returns the panel and ring launches of the ranks' counted path."""
    import functools
    from dominantsparseeigenad_tpu_torch import models, utils
    t_phase = time.perf_counter()
    f32 = torch.float32
    ref = {}
    # The unsharded TFIM headline pass (warm, then timed and traced).
    tfim_pass(pkg, models, TFIM_N_ED, f32, **TFIM_HEADLINE)
    tfim_pass(pkg, models, TFIM_N, f32, **TFIM_HEADLINE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0, de0, chi, _ = tfim_pass(pkg, models, TFIM_N, f32, **TFIM_HEADLINE)
    torch.cuda.synchronize()
    ref["tfim"] = {"values": (e0, de0, chi),
                   "pass_s": time.perf_counter() - t0}
    work = tempfile.mkdtemp(prefix="sharded_solvers_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    with utils.trace(work) as log_dir:
        tfim_pass(pkg, models, TFIM_N, f32, **TFIM_HEADLINE)
    ref["tfim"]["trace"] = {k: v for k, v in read_trace(log_dir).items()
                            if k in ("idle_share", "window_ms", "busy_ms",
                                     "device_intervals")}
    shutil.rmtree(work, ignore_errors=True)
    # The unsharded restart at N = 20 (the restart phase's k and cycles).
    p = RESTART_TFIM
    runs = [peak_since(lambda: restart_value_and_grad(
        pkg, lambda g: models.tfim_operator(TFIM_N, g, dtype=f32,
                                            device=DEVICE)))
        for _ in range(2)]
    ref["restart"] = {"e0": runs[-1][0][0], "de0_dg": runs[-1][0][1],
                      "peak_mib": runs[-1][2]}
    # The unsharded config #5 KPM (the spectral phase's seeds) and pencil.
    op, _ = config5_operator(pkg)
    seeded = torch.Generator(device=DEVICE).manual_seed(SPEC_SEED)
    with torch.no_grad():
        lo, hi = pkg.spectral_bounds(op, SPEC_BOUNDS_K, generator=seeded,
                                     device=DEVICE)
    width = float(hi - lo)
    energies = torch.linspace(float(lo) + 0.01 * width,
                              float(hi) - 0.01 * width, 64, device=DEVICE)
    rho, tr = kpm_pair(pkg, op, energies)
    ref["kpm"] = {"density": rho, "trace_exp": tr}
    n, r = CONFIG5[0], MULTI_R
    gen = torch.Generator(device=DEVICE).manual_seed(GEN_SEED)
    m = (1.0 + torch.rand(n, generator=gen, device=DEVICE)).requires_grad_()
    x0 = torch.randn(n, r, generator=gen, device=DEVICE)
    m_d = m.detach()
    lams, _, info = pkg.dominant_eigh_gen(
        op, diagonal_operator(pkg, m, n), r=r, maxiter=LOBPCG_ITERS,
        tol=CG_TOL, precond=lambda z: z / m_d, x0=x0, with_info=True,
        device=DEVICE)
    (g_m,) = torch.autograd.grad(lams.sum(), m)
    ref["pencil"] = {"lams": lams.tolist(),
                     "iterations": int(info.effective_k),
                     "dsumlam_dm": g_m.cpu().numpy()}
    del op, m, x0, lams, g_m
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    ranks, wall_s = spawn_ranks(
        SHARDED_RANKS, functools.partial(_sharded_solver_solves,
                                         energies.tolist()))
    first = ranks[0]
    jw = {"e0": float(models.tfim_exact_e0(TFIM_N, TFIM_G, device=DEVICE)),
          "de0_dg": models.tfim_exact_de0_dg(TFIM_N, TFIM_G)}
    jw_restart = {"e0": float(models.tfim_exact_e0(TFIM_N, p["g"],
                                                  device=DEVICE)),
                  "de0_dg": models.tfim_exact_de0_dg(TFIM_N, p["g"])}
    tf_err = {basis: {"e0": abs(first["tfim"][basis]["values"][0]
                                - jw["e0"]) / abs(jw["e0"]),
                      "de0_dg": abs(first["tfim"][basis]["values"][1]
                                    - jw["de0_dg"]) / abs(jw["de0_dg"]),
                      "chi_f_vs_unsharded_bf16": abs(
                          first["tfim"][basis]["values"][2]
                          - ref["tfim"]["values"][2])
                      / abs(ref["tfim"]["values"][2])}
              for basis in ("bf16_basis", "f32_basis")}
    rs_err = {key: abs(first["restart"][key] - jw_restart[key])
              / abs(jw_restart[key]) for key in RESTART_RTOL}
    kpm_err = {mode: {
        "density": float(np.abs(np.subtract(first["kpm"][mode]["density"],
                                            ref["kpm"]["density"])).max()
                         / np.abs(ref["kpm"]["density"]).max()),
        "trace_exp": abs(first["kpm"][mode]["trace_exp"]
                         - ref["kpm"]["trace_exp"])
        / abs(ref["kpm"]["trace_exp"])} for mode in ("all_gather", "ring")}
    g_m_sharded = np.concatenate([res["pencil"].pop("dsumlam_dm_rows")
                                  for res in ranks])
    pencil_err = {
        "lams": rel_err(torch.tensor(first["pencil"]["lams"]),
                        torch.tensor(ref["pencil"]["lams"])),
        "dsumlam_dm": float(np.abs(g_m_sharded - ref["pencil"].pop(
            "dsumlam_dm")).max() / np.abs(g_m_sharded).max())}
    f11_err = max(abs(a - b) / max(abs(b), 1e-30) for res in ranks
                  for a, b in zip(res["diagnostics"]["sharded"],
                                  res["diagnostics"]["replicated"])
                  if b > 1e-6)
    f11_abs = max(abs(a - b) for res in ranks
                  for a, b in zip(res["diagnostics"]["sharded"],
                                  res["diagnostics"]["replicated"]))
    ring_gain, panel_gain = {}, {}
    for res in ranks:
        add_counts(ring_gain, res["ring_launches"])
        add_counts(panel_gain, res["panel_launches"])
    note = ("2 ranks sharing one card over gloo; not a multi-GPU or "
            "scaling number")
    emit({"phase": "sharded_solvers", "note": note,
          "card": nvidia_smi_name_power(), "wall_s": wall_s,
          "tfim": {"n": TFIM_N, "g": TFIM_G, "k": TFIM_K,
                   "headline_options": {k: str(v) for k, v in
                                        TFIM_HEADLINE.items()},
                   "jordan_wigner": jw, "rel_err": tf_err,
                   "unsharded_bf16": ref["tfim"]},
          "restart": {**p, "n": TFIM_N, "jordan_wigner": jw_restart,
                      "rel_err": rs_err, "unsharded": ref["restart"]},
          "kpm": {"degree": KPM_DEGREE, "probes": KPM_PROBES,
                  "rel_vs_unsharded": kpm_err,
                  "unsharded_trace_exp": ref["kpm"]["trace_exp"]},
          "pencil": {"r": r, "lobpcg_cap": LOBPCG_ITERS,
                     "rel_vs_unsharded": pencil_err,
                     "unsharded": ref["pencil"]},
          "diagnostics_rel": f11_err, "diagnostics_abs": f11_abs,
          "launches_gained": {"ring": ring_gain, "panel": panel_gain},
          "ranks": ranks, "phase_s": time.perf_counter() - t_phase})
    checks = {}
    for basis in ("bf16_basis", "f32_basis"):
        for key in ("e0", "de0_dg"):
            checks[f"sharded TFIM N={TFIM_N} {basis} {key} vs "
                   f"Jordan-Wigner, rel {TFIM_RTOL[key]}"] = \
                tf_err[basis][key] <= TFIM_RTOL[key]
        checks[f"sharded TFIM N={TFIM_N} {basis} χ_F vs the unsharded bf16 "
               f"pass, rel {TFIM_RTOL['chi_f']}"] = \
            tf_err[basis]["chi_f_vs_unsharded_bf16"] <= TFIM_RTOL["chi_f"]
    for key, bar in RESTART_RTOL.items():
        checks[f"sharded restart N={TFIM_N} {key} vs Jordan-Wigner, rel "
               f"{bar}"] = rs_err[key] <= bar
    for mode in ("all_gather", "ring"):
        for key in ("density", "trace_exp"):
            checks[f"KPM {key} {mode} vs unsharded, rel {SS_KPM_RTOL}"] = \
                kpm_err[mode][key] <= SS_KPM_RTOL
        checks[f"KPM {mode}: SpMMs launched"] = any(
            first["kpm"][mode]["launches"][i].get("bell_spmm_f32", 0) > 0
            for i in (0, 1))
    checks.update({
        f"pencil λ vs unsharded, rel {SV_RTOL}": pencil_err["lams"]
            <= SV_RTOL,
        f"pencil ∂Σλ/∂m vs unsharded, rel {SS_PENCIL_GRAD_RTOL}":
            pencil_err["dsumlam_dm"] <= SS_PENCIL_GRAD_RTOL,
        f"F11 diagnostics sharded vs replicated, rel {SS_F11_RTOL}":
            f11_err <= SS_F11_RTOL,
        "KPM all_gather: panel SpMMs at r = 16, no ring launch":
            first["kpm"]["all_gather"]["launches"][1].get(
                "bell_spmm_f32", 0) > 0
            and not first["kpm"]["all_gather"]["launches"][0],
        "KPM ring: ring bucket SpMMs": first["kpm"]["ring"]["launches"][0]
            .get("bell_spmm_f32", 0) > 0,
        "pencil: panel SpMMs": first["pencil"]["launches"][1].get(
            "bell_spmm_f32", 0) > 0,
        "ranks ran the same collectives": all(
            res["tfim"]["collectives"] == first["tfim"]["collectives"]
            and res["pencil"]["collectives"]
            == first["pencil"]["collectives"] for res in ranks),
        "ranks bitwise equal (TFIM, restart, pencil λ)": all(
            res["tfim"][b]["hex"] == first["tfim"][b]["hex"]
            for res in ranks for b in ("bf16_basis", "f32_basis"))
            and all(res["restart"]["hex"] == first["restart"]["hex"]
                    and res["pencil"]["hex"] == first["pencil"]["hex"]
                    for res in ranks),
        "finite": all(math.isfinite(x) for res in ranks
                      for x in _floats(res)),
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sharded_solvers phase failed: {failed}")
    return ring_gain, panel_gain


def sampled_block_rows(world, nb):
    """The block-rows whose gradient the sharded_general phase compares:
    the first and last ``SG_SAMPLE_ROWS // 2`` of each rank's range."""
    nb_l, half = nb // world, SG_SAMPLE_ROWS // 2
    return [rank * nb_l + j for rank in range(world)
            for j in (*range(half), *range(nb_l - half, nb_l))]


def dense_pair_input():
    """The float64 (n, n) matrix of the sharded_general phase's pair cases:
    a dominant conjugate pair 3 e^{±0.7i}, then 2, the rest in [0, 1.5),
    in a random orthonormal basis (numpy seed)."""
    n, seed = SG_PAIR
    rng = np.random.default_rng(seed)
    blk = np.zeros((n, n))
    blk[:2, :2] = 3.0 * np.array([[np.cos(0.7), -np.sin(0.7)],
                                  [np.sin(0.7), np.cos(0.7)]])
    blk[2, 2] = 2.0
    blk[3:, 3:] = np.diag(1.5 * rng.random(n - 3))
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return torch.tensor(q @ blk @ q.T, dtype=torch.float64, device=DEVICE)


def general_small_cases(pkg, op, a_pair, pair_operator, lam1,
                        rows=lambda t: t, total=lambda t: t):
    """The sharded_general phase's small cases on the EIG_BELL twin ``op``
    and on ``pair_operator(a)`` of the dense pair ``a_pair`` (whole, or
    sharded with ``rows`` the rank's rows of a whole vector and ``total``
    a sum over the ranks): each result as lists and arrays, the vectors
    the rank's rows, the gradients in ``a_pair`` the rank's shares."""
    n = op.dim
    gen = torch.Generator(device=DEVICE).manual_seed(47)
    b = rows(torch.randn(n, generator=gen, device=DEVICE))
    c = rows(torch.randn(n, generator=gen, device=DEVICE))
    out = {}
    t0 = time.perf_counter()
    lams, ls, rs = pkg.dominant_eig_multi(op, m=2,
                                          arnoldi_k=EIG_BELL_ARNOLDI_K,
                                          device=DEVICE)
    out["multi"] = {"lams": lams.tolist(), "r": rs.cpu().numpy()}
    shifted = pkg.ShiftedOperator(op, -SG_SOLVE_SHIFT * lam1)
    for method in ("bicgstab", "gmres", "cgnr"):
        bl = b.clone().requires_grad_(True)
        x = pkg.solve_general(shifted, bl, method=method, device=DEVICE)
        (gb,) = torch.autograd.grad(total((c * x).sum()), bl)
        out[f"solve_{method}"] = {"x": x.detach().cpu().numpy(),
                                  "db": gb.cpu().numpy()}
    u, sv, v = pkg.dominant_svd(op, r=2, device=DEVICE)
    out["svd"] = {"s": sv.tolist(), "u": u.cpu().numpy(),
                  "v": v.cpu().numpy()}
    torch.cuda.synchronize()
    out["bell_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    leaf = a_pair.clone().requires_grad_(True)
    lam, l, r = pkg.dominant_eig_pair(pair_operator(leaf), device=DEVICE)
    loss = lam.real + 0.5 * lam.imag + total((r.real ** 3).sum())
    (g,) = torch.autograd.grad(loss, leaf)
    out["pair"] = {"lam": [lam.real.item(), lam.imag.item()],
                   "r": r.detach().cpu().numpy(), "grad": g.cpu().numpy()}
    structure = pkg.spectrum_structure(pair_operator(a_pair), m=2,
                                       device=DEVICE)
    leaf = a_pair.clone().requires_grad_(True)
    lams, _, _, _ = pkg.dominant_eig_spectrum(
        pair_operator(leaf), m=2, structure=structure, device=DEVICE)
    (g,) = torch.autograd.grad(lams.real.sum() + lams.imag.abs().sum(),
                               leaf)
    out["spectrum"] = {"structure": list(structure),
                       "lams": [[z.real, z.imag] for z in lams.tolist()],
                       "grad": g.cpu().numpy()}
    torch.cuda.synchronize()
    out["pair_s"] = time.perf_counter() - t0
    return out


def _sharded_general_solves(ref, sg):
    """One rank of the sharded_general phase (module docstring): ``ref``
    holds the unsharded run's λ and the small cases' shifts."""
    import dominantsparseeigenad_tpu_torch as pkg
    from dominantsparseeigenad_tpu_torch.parallel import collectives
    spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                   "bell_spmv")
    sparse = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                     "sparse")
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    t_rank = time.perf_counter()
    out = {"rank": sg.rank}
    spmv.reset_launch_counts()
    collectives.reset_collective_counts()

    def rows(t):
        return lay.rows(t).clone()

    def total(t):
        return collectives.sum_over_ranks(t, sg)

    # ---- (b) the small cases first (their warm-up is the small twin) ---
    small = positive_ring_bell(pkg, sparse)
    sop = pkg.RowShardedBellOperator.from_bell(small, sg, symmetric=False,
                                               vectors="sharded")
    del small
    lay = sop.vector_layout
    a_pair = dense_pair_input()
    out["small"] = general_small_cases(
        pkg, sop, a_pair, lambda a: pkg.RowShardedOperator(
            a, sg, vectors="sharded"), ref["small_lam1"], rows, total)
    del sop, a_pair
    torch.cuda.empty_cache()

    # ---- (a) config #5's non-symmetric twin, both modes -----------------
    op = positive_ring_bell(pkg, sparse, CONFIG5)
    n, bs, _ = CONFIG5
    nb = n // bs
    panels = {"all_gather": pkg.RowShardedBellOperator.from_bell(
        op, sg, symmetric=False, vectors="sharded")}
    panels["ring"] = pkg.RowShardedBellOperator.from_bell(
        op, sg, symmetric=False, mode="ring", vectors="sharded").with_vals(
        panels["all_gather"].vals)
    del op
    torch.cuda.empty_cache()
    lay = panels["all_gather"].vector_layout
    nb_l = nb // sg.size
    c = rows(torch.randn(n, generator=torch.Generator(
        device=DEVICE).manual_seed(43), device=DEVICE))
    mine = [i - sg.rank * nb_l for i in sampled_block_rows(sg.size, nb)
            if sg.rank * nb_l <= i < (sg.rank + 1) * nb_l]
    kw = dict(method="arnoldi", arnoldi_k=EIG_BELL_ARNOLDI_K, device=DEVICE)
    torch.cuda.synchronize()
    big = {}
    for mode, sop in panels.items():
        before = _sv_counts(spmv)
        x = sop.vals.detach().requires_grad_(True)
        with counted_products(pkg, cg) as products:
            (lam, l, r, info), fwd_s = timed(lambda: pkg.dominant_eig(
                sop.with_vals(x), with_info=True, **kw))
            fwd_counts = _sv_diff(_sv_counts(spmv), before)
            fwd_products = {k: products[k] for k in ("matvec", "rmatvec")}
            (g_lam,), bwd_s = timed(lambda: torch.autograd.grad(
                lam, x, retain_graph=True))
            (g_r,), rloss_s = timed(lambda: torch.autograd.grad(
                total((c * r).sum()), x))
        lam, l, r = lam.detach(), l.detach(), r.detach()
        with torch.no_grad():
            res_r = float(lay.norm(sop.matvec(r) - lam * r) / lam.abs())
            res_l = float(lay.norm(sop.rmatvec(l) - lam * l)
                          / (lam.abs() * lay.norm(l)))
            r_whole = pkg.row_sharding(sg).gather(r)
            cols = sop.cols.long()
            lr = l.reshape(nb_l, 1, bs, 1) * r_whole.reshape(nb, bs)[cols][
                :, :, None, :]
            grad_vs_lr = rel_err(g_lam, lr)
            del lr
            # Summed over the ranks: the whole gradient's.
            g_r_sq = float(total((g_r.double() ** 2).sum()))
        fwd_coll = fwd_counts[3]
        n_products = fwd_products["matvec"] + fwd_products["rmatvec"]
        big[mode] = {
            "lam": float(lam), "hex": float(lam).hex(),
            "residual_right": res_r, "residual_left": res_l,
            "power_iterations": float(info.iterations),
            "converged": float(info.converged),
            "rank1_defect": float(info.rank1_defect),
            "dlam_dpanel_vs_l_r": grad_vs_lr,
            "drloss_sampled": g_r[mine].cpu().numpy(),
            "drloss_fro_sq": g_r_sq,
            "forward_s": fwd_s, "backward_lam_s": bwd_s,
            "backward_rloss_s": rloss_s,
            "forward_products": fwd_products,
            "forward_collectives": fwd_coll,
            "collectives_per_product": {
                k: v / max(n_products, 1) for k, v in fwd_coll.items()},
            "products": _read_counts(products),
            "launches": _sv_diff(_sv_counts(spmv), before)}
        del x, g_lam, g_r, r_whole
        torch.cuda.empty_cache()
    out["big"] = big
    out["collectives"] = dict(collectives.collective_counts)
    ring, panel, _, _ = _sv_counts(spmv)
    out.update({"ring_launches": ring, "panel_launches": panel,
                "rank_s": time.perf_counter() - t_rank})
    del panels
    torch.cuda.empty_cache()
    return out


def phase_sharded_general(pkg, spmv):
    """The general (non-symmetric) tier over sharded vectors (module
    docstring): the unsharded references in this process first, then two
    ranks; returns the panel and ring launches of the ranks' counted
    path."""
    import functools
    sparse = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                     "sparse")
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    t_phase = time.perf_counter()
    n, bs, _ = CONFIG5
    nb = n // bs
    ref = {}
    # (b) unsharded: the small twin (its λ1 sets the solves' shift) and
    # the dense pair.
    small = positive_ring_bell(pkg, sparse)
    lam1 = float(pkg.dominant_eig(small, method="arnoldi",
                                  arnoldi_k=EIG_BELL_ARNOLDI_K,
                                  device=DEVICE)[0])
    a_pair = dense_pair_input()
    ref_small = general_small_cases(pkg, small, a_pair, pkg.DenseOperator,
                                    lam1)
    del small, a_pair
    # (a) unsharded: config #5's twin on K4b, the same calls.
    op = positive_ring_bell(pkg, sparse, CONFIG5)
    c = torch.randn(n, generator=torch.Generator(device=DEVICE).manual_seed(
        43), device=DEVICE)
    x = op.vals.detach().requires_grad_(True)
    kw = dict(method="arnoldi", arnoldi_k=EIG_BELL_ARNOLDI_K, device=DEVICE)
    before = dict(spmv.launch_counts)
    with counted_products(pkg, cg) as products:
        (lam, l, r, info), fwd_s = timed(lambda: pkg.dominant_eig(
            op.with_vals(x), with_info=True, **kw))
        (g_lam,), bwd_s = timed(lambda: torch.autograd.grad(
            lam, x, retain_graph=True))
        (g_r,), rloss_s = timed(lambda: torch.autograd.grad((c * r).sum(),
                                                             x))
    sample = sampled_block_rows(SHARDED_RANKS, nb)
    # The mean part's circulant over the block-rows (row 0's block-columns
    # are its offsets): its two largest |eigenvalues|.
    ring = np.zeros(nb)
    ring[op.cols[0].cpu().numpy()] = 1.0
    mu = np.sort(np.abs(np.fft.fft(ring)))[::-1]
    ref_big = {"lam": float(lam.detach()),
               "mean_part_mu2_over_mu1": float(mu[1] / mu[0]),
               "power_iterations": float(info.iterations),
               "converged": float(info.converged),
               "rank1_defect": float(info.rank1_defect),
               "forward_s": fwd_s, "backward_lam_s": bwd_s,
               "backward_rloss_s": rloss_s,
               "products": _read_counts(products),
               "launches": {k: v - before[k] for k, v in
                            spmv.launch_counts.items() if v != before[k]}}
    drloss_sampled = g_r[sample].cpu().numpy()
    drloss_fro_sq = float((g_r.double() ** 2).sum())
    del op, x, g_lam, g_r, lam, l, r, c
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    ranks, wall_s = spawn_ranks(
        SHARDED_RANKS, functools.partial(_sharded_general_solves,
                                         {"small_lam1": lam1}))
    first = ranks[0]
    big_err = {}
    for mode in ("all_gather", "ring"):
        got = np.concatenate([res["big"][mode].pop("drloss_sampled")
                              for res in ranks])
        big_err[mode] = {
            "lam": abs(first["big"][mode]["lam"] - ref_big["lam"])
            / abs(ref_big["lam"]),
            "drloss_sampled": float(np.abs(got - drloss_sampled).max()
                                    / np.abs(drloss_sampled).max()),
            "drloss_fro": abs(math.sqrt(first["big"][mode]["drloss_fro_sq"])
                              - math.sqrt(drloss_fro_sq))
            / math.sqrt(drloss_fro_sq)}

    def whole(key, sub):
        return np.concatenate([res["small"][key][sub] for res in ranks])

    small_err = {
        "multi_lams": rel_err(torch.tensor(first["small"]["multi"]["lams"]),
                              torch.tensor(ref_small["multi"]["lams"])),
        "svd_s": rel_err(torch.tensor(first["small"]["svd"]["s"]),
                         torch.tensor(ref_small["svd"]["s"])),
        "svd_uv_alignment": max(
            1.0 - abs(float((whole("svd", k)[:, i] * ref_small["svd"][k][
                :, i]).sum())) for k in ("u", "v") for i in range(2)),
        "pair_lam": float(abs(complex(*first["small"]["pair"]["lam"])
                              - complex(*ref_small["pair"]["lam"]))
                          / abs(complex(*ref_small["pair"]["lam"]))),
        "pair_r": float(np.abs(whole("pair", "r") - ref_small["pair"]["r"])
                        .max() / np.abs(ref_small["pair"]["r"]).max()),
        "pair_grad": float(np.abs(sum(res["small"]["pair"]["grad"]
                                      for res in ranks)
                                  - ref_small["pair"]["grad"]).max()
                           / np.abs(ref_small["pair"]["grad"]).max()),
        "spectrum_lams": float(np.abs(
            np.subtract(first["small"]["spectrum"]["lams"],
                        ref_small["spectrum"]["lams"])).max()
            / np.abs(ref_small["spectrum"]["lams"]).max()),
        "spectrum_grad": float(np.abs(sum(res["small"]["spectrum"]["grad"]
                                          for res in ranks)
                                      - ref_small["spectrum"]["grad"]).max()
                               / np.abs(ref_small["spectrum"]["grad"])
                               .max())}
    for method in ("bicgstab", "gmres", "cgnr"):
        key = f"solve_{method}"
        for sub in ("x", "db"):
            small_err[f"{key}_{sub}"] = float(
                np.abs(whole(key, sub) - ref_small[key][sub]).max()
                / np.abs(ref_small[key][sub]).max())
    ring_gain, panel_gain = {}, {}
    for res in ranks:
        add_counts(ring_gain, res["ring_launches"])
        add_counts(panel_gain, res["panel_launches"])
    for res in ranks:
        for part in ("multi", "svd", "pair", "solve_bicgstab",
                     "solve_gmres", "solve_cgnr", "spectrum"):
            for k in ("r", "u", "v", "x", "db", "grad"):
                res["small"][part].pop(k, None)
    note = ("2 ranks sharing one card over gloo; not a multi-GPU or "
            "scaling number")
    emit({"phase": "sharded_general", "note": note,
          "card": nvidia_smi_name_power(), "wall_s": wall_s,
          "config5_twin": {"shape": CONFIG5, "arnoldi_k": EIG_BELL_ARNOLDI_K,
                           "unsharded": ref_big, "rel_vs_unsharded": big_err,
                           "sampled_block_rows": sample},
          "small": {"shape": EIG_BELL, "pair": SG_PAIR,
                    "solve_shift": SG_SOLVE_SHIFT * lam1,
                    "rel_vs_unsharded": small_err,
                    "structure": ref_small["spectrum"]["structure"],
                    "unsharded_s": {k: ref_small[k]
                                    for k in ("bell_s", "pair_s")}},
          "launches_gained": {"ring": ring_gain, "panel": panel_gain},
          "ranks": ranks, "phase_s": time.perf_counter() - t_phase})
    checks = {}
    for mode in ("all_gather", "ring"):
        row = first["big"][mode]
        checks.update({
            f"twin {mode}: λ vs unsharded, rel {SHARDED_BELL_VS_UNSHARDED}":
                big_err[mode]["lam"] <= SHARDED_BELL_VS_UNSHARDED,
            f"twin {mode}: residuals, rel {EIG_BELL_RESIDUAL}":
                all(max(res["big"][mode]["residual_right"],
                        res["big"][mode]["residual_left"])
                    <= EIG_BELL_RESIDUAL for res in ranks),
            f"twin {mode}: ∂λ/∂panel vs l⊗r, rel 1e-4":
                all(res["big"][mode]["dlam_dpanel_vs_l_r"] <= 1e-4
                    for res in ranks),
            f"twin {mode}: ∂<c, r>/∂vals vs unsharded, rel {SG_RLOSS_RTOL}":
                big_err[mode]["drloss_sampled"] <= SG_RLOSS_RTOL
                and big_err[mode]["drloss_fro"] <= SG_RLOSS_RTOL,
            f"twin {mode}: power loop converged": row["converged"] == 1.0,
            f"twin {mode}: ranks bitwise equal λ": all(
                res["big"][mode]["hex"] == row["hex"] for res in ranks)})
    checks.update({
        "twin all_gather: panel SpMVs (K4a), no ring launch":
            first["big"]["all_gather"]["launches"][1].get(
                "bell_spmv_f32", 0) > 0
            and not first["big"]["all_gather"]["launches"][0],
        "twin ring: ring bucket SpMVs": first["big"]["ring"]["launches"][0]
            .get("bell_spmv_f32", 0) > 0,
        "unsharded twin: banded SpMVs (K4b)":
            ref_big["launches"].get("bell_spmv_banded_f32", 0) > 0,
        "ranks ran the same collectives": all(
            res["collectives"] == first["collectives"] for res in ranks),
        f"spectrum structure {ref_small['spectrum']['structure']}":
            all(res["small"]["spectrum"]["structure"]
                == ref_small["spectrum"]["structure"] for res in ranks),
        "finite": all(math.isfinite(x) for res in ranks
                      for x in _floats(res)),
    })
    for key, err in small_err.items():
        bar = SG_PAIR_RTOL if key.startswith(("pair", "spectrum")) \
            else SG_SMALL_RTOL
        checks[f"small {key} vs unsharded, rel {bar}"] = err <= bar
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sharded_general phase failed: {failed}")
    return ring_gain, panel_gain


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
    rmatvec of a ``DenseOperator``, a ``BellOperator`` or a
    ``RowShardedBellOperator``, and the iterations of every BiCGStab
    (``ops/cg.py::_bicgstab_loop``, wrapped for the duration; its count
    stays on the device until read)."""
    counts = {"matvec": 0, "rmatvec": 0, "bicgstab_iterations": []}
    saved = []
    for cls in (pkg.DenseOperator, pkg.BellOperator,
                pkg.RowShardedBellOperator):
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


def positive_ring_bell(pkg, sparse, shape=EIG_BELL):
    """A non-symmetric BellOperator with positive values on config #5's
    ring-band pattern at ``shape`` (the small ``EIG_BELL`` by default;
    banded: K4b)."""
    n, bs, bpr = shape
    base = sparse.random_bell_operator(n, bs, bpr, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    vals = torch.rand(base.vals.shape, device=DEVICE, generator=gen) + 0.01
    cols = base.cols
    del base
    return pkg.BellOperator(vals, cols, n, symmetric=False)


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


# The complex_bell phase: complex blocked-ELL values (the kernels K5 and
# K6) at config #5's full width in a complex gauge, vals_c[i, j] =
# diag(d_i) vals[i, j] diag(conj d_{cols[i, j]}), unit phases d from a
# seeded generator: complex Hermitian (built with symmetric=False) and
# unitarily similar to the real config #5, so its spectrum, its Lanczos
# coefficients from D v0 and its LOBPCG values from D x0 are the real
# ones'.  9.13 GB of complex64 values.
CXB_GAUGE_SEED = 71
CXB_SPMM_R = (4, 8, 16, 32)
CXB_RTOL = {
    "kernel": 1e-5,          # kernel vs plain, as the real kernels
    "lam": 1e-5,             # complex vs real λ (float32 Lanczos)
    "lanczos": 1e-5,         # α, β vs the real run's, of max |α|, |β|
    "dot": 1e-5,             # reverse vs forward dλ, of ||G|| ||D||
    "lobpcg": 1e-4,          # complex vs real LOBPCG λ (r = 8)
}
CXB_PANEL_LOBPCG_ITERS = 20             # the ranks' LOBPCG (2 on one card)
# (d) the derivative set: a complex Hermitian Bell A0 (n, bs, blocks per
# row, seed), spiked below its bulk as spiked_bell, and A1 on its pattern
# (seed + 1), against a float64 eigh of the dense A0: the eigenvector
# loss λ + |<w, v>|^2 along A1 by reverse and forward mode, and E, dE/dg,
# d²E/dg² of A0 + g A1 at g = 0 by energy_curvature.  Bars: float32
# arithmetic, the eigenvector term through a deflated CG at CG_TOL.
CXB_SMALL = (4096, 32, 5, 73)
# (b) the instantiations config #5 does not reach, on complex symmetric
# random_bell_operator values (n, bs, blocks per row): every r below, X
# 16-byte aligned and offset by one complex value (X staged by 4-byte
# copies, as at odd r), bs = 25 (values by plain loads); each entry
# against its plain version (kernel bar), banded = gather and panel = the
# square product's rows bit for bit, and a lazily conjugated x, X or
# vals (``.conj()``) equal bit for bit to its resolved copy.
CXB_KERNEL_SHAPES = ((4096, 32, 5), (4000, 20, 5), (4000, 25, 3))
CXB_KERNEL_R = (1, 2, 3, 4, 5, 8, 13, 16, 32, 40)
CXB_SMALL_RTOL = {"lam": 1e-5, "dloss_rev": 1e-4, "dloss_fwd": 1e-4,
                  "e": 1e-5, "de_dg": 1e-5, "d2e_dg2": 1e-4}


def complex_gauge(nb, bs):
    """``(d, x0)``: the gauge's unit phases (nb, bs), complex64, and the
    real LOBPCG start block, both drawn from one seeded generator."""
    gen = torch.Generator(device=DEVICE).manual_seed(CXB_GAUGE_SEED)
    phi = 2 * math.pi * torch.rand((nb, bs), generator=gen, device=DEVICE)
    d = torch.polar(torch.ones_like(phi), phi)
    x0 = torch.randn(nb * bs, MULTI_R, generator=gen, device=DEVICE)
    return d, x0, gen


def gauge_values(vals, cols, d):
    """vals_c[i, j] = diag(d_i) vals[i, j] diag(conj d_{cols[i, j]}), built
    one band (slot) at a time."""
    out = torch.empty(vals.shape, dtype=torch.complex64, device=DEVICE)
    for j in range(vals.shape[1]):
        out[:, j] = (vals[:, j] * d[:, :, None]) \
            * d[cols[:, j].long()].conj()[:, None, :]
    return out


def cgrad_dot(g, d) -> float:
    """Re<g, d> = Re sum(conj(g) d) in complex128, in chunks."""
    return sum(float(torch.vdot(a.reshape(-1).to(torch.complex128),
                                b.reshape(-1).to(torch.complex128)).real)
               for a, b in zip(g.split(256), d.split(256)))


def cnorm(t) -> float:
    return math.sqrt(sum(float(torch.linalg.vector_norm(a).double()) ** 2
                         for a in t.split(256)))


def library_row(vals, cols, n_cols, x, y_ref, batch):
    """The cuSPARSE BSR yardstick for the same product: (ms, rel err).
    Timed here and used nowhere in the port."""
    lib = bsr_library_call(vals, cols, n_cols)
    err = rel_err(lib(x), y_ref)
    return event_ms(lambda: lib(x), samples=12, batch=batch), err


def cx_kernel_row(spmv, name, vals, cols, x, plan, gather_y=None):
    """One K5/K6 entry at config #5 on complex64 (vals, cols, x): against
    its plain version (1e-5), banded against gather bit for bit (timed in
    turns with it), a panel against the square product's rows bit for
    bit; kernel, plain, library, bound."""
    r = 1 if x.ndim == 1 else x.shape[1]
    kind = "spmv" if x.ndim == 1 else "spmm"
    gather = getattr(spmv, f"_bell_{kind}_cuda")
    plain = getattr(spmv, f"_bell_{kind}_torch")
    y = gather(vals, cols, x)
    y_p = plain(vals, cols, x)
    torch.cuda.synchronize()
    row = {"phase": "complex_bell", "kernel": name, "r": r,
           "block_rows": vals.shape[0], "n_cols": x.shape[0],
           "rel_err": rel_err(y, y_p),
           "max_abs_err": float((y - y_p).abs().max())}
    batch = 3

    def timed_ms(fn):
        return event_ms(fn, samples=12, batch=batch)

    if plan is not None:
        banded = getattr(spmv, f"_bell_{kind}_banded_cuda")
        plain_b = getattr(spmv, f"_bell_{kind}_banded_torch")
        y_b = banded(vals, cols, x, plan)
        y_pb = plain_b(vals, cols, x, plan)
        torch.cuda.synchronize()
        row["banded_rel_err"] = rel_err(y_b, y_pb)
        row["banded_max_abs_err"] = float((y_b - y_pb).abs().max())
        row["banded_vs_gather_max_abs_diff"] = float((y_b - y).abs().max())
        g1 = timed_ms(lambda: gather(vals, cols, x))
        b1 = timed_ms(lambda: banded(vals, cols, x, plan))
        b2 = timed_ms(lambda: banded(vals, cols, x, plan))
        g2 = timed_ms(lambda: gather(vals, cols, x))
        row.update({"kernel_ms": (g1 + g2) / 2, "kernel_ms_turns": [g1, g2],
                    "banded_ms": (b1 + b2) / 2, "banded_ms_turns": [b1, b2],
                    "banded_plain_ms": event_ms(
                        lambda: plain_b(vals, cols, x, plan), samples=6)})
        del y_b, y_pb
    else:
        row["kernel_ms"] = timed_ms(lambda: gather(vals, cols, x))
    if gather_y is not None:
        rows = gather_y[-y.shape[0]:]
        row["square_rows_max_abs_diff"] = float((y - rows).abs().max())
    row["plain_ms"] = event_ms(lambda: plain(vals, cols, x), samples=6)
    row["library_ms"], row["library_rel_err"] = library_row(
        vals, cols, x.shape[0], x, y_p, batch)
    # Least bytes: values, cols, x once, y once; or 8 r flops a value.
    row["bytes_min"], row["bound_ms"], row["bound_by"] = bound(
        vals.numel(), vals.element_size(),
        cols.numel() * 4 + (x.numel() + y.numel()) * x.element_size(), r,
        flops_per_value=8)
    row["achieved_gbps"] = row["bytes_min"] / (row["kernel_ms"] * 1e-3) / 1e9
    emit(row)
    return row, y


def offset_copy(t):
    """A copy of ``t`` whose data starts one element past a 16-byte
    boundary (8 bytes for complex64)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def cx_kernel_shapes(spmv, sparse):
    """Part (b): K5 and K6 at the small shapes of ``CXB_KERNEL_SHAPES``
    (see there); returns the checks.  Launches counted nowhere."""
    checks = {}
    bar = CXB_RTOL["kernel"]
    for i, (n, bs, bpr) in enumerate(CXB_KERNEL_SHAPES):
        gen = torch.Generator(device=DEVICE).manual_seed(90 + i)
        op = sparse.random_bell_operator(n, bs, bpr, generator=gen,
                                         dtype=torch.complex64,
                                         device=DEVICE)
        vals, cols, plan = op.vals, op.cols, op.slot_plan
        nb = n // bs
        half, rows = slice(nb // 2, nb), slice(nb // 2 * bs, n)
        panel = (vals[half].contiguous(), cols[half].contiguous())
        row = {"phase": "complex_bell", "part": "kernel_shapes", "n": n,
               "bs": bs, "blocks_per_row": bpr, "rel_err": {},
               "banded_vs_gather_max_abs_diff": {},
               "panel_vs_square_max_abs_diff": {}}
        cases = [(None, False), (None, True)] + [
            (r, un) for r in CXB_KERNEL_R for un in (False, True)]
        for r, unaligned in cases:
            shape = (n,) if r is None else (n, r)
            x = torch.randn(shape, generator=gen, device=DEVICE,
                            dtype=torch.complex64)
            if unaligned:
                x = offset_copy(x)
            kind = "spmv" if r is None else "spmm"
            tag = f"{kind} r={r or 1}{' unaligned' if unaligned else ''}"
            y = getattr(spmv, f"_bell_{kind}_cuda")(vals, cols, x)
            y_p = getattr(spmv, f"_bell_{kind}_torch")(vals, cols, x)
            y_b = getattr(spmv, f"_bell_{kind}_banded_cuda")(vals, cols, x,
                                                            plan)
            y_pan = getattr(spmv, f"_bell_{kind}_cuda")(*panel, x)
            torch.cuda.synchronize()
            row["rel_err"][tag] = rel_err(y, y_p)
            row["banded_vs_gather_max_abs_diff"][tag] = \
                float((y_b - y).abs().max())
            row["panel_vs_square_max_abs_diff"][tag] = \
                float((y_pan - y[rows]).abs().max())
            checks[f"n={n} bs={bs} {tag} vs plain, rel {bar}"] = \
                row["rel_err"][tag] <= bar
            checks[f"n={n} bs={bs} {tag} banded = gather bit for bit"] = \
                row["banded_vs_gather_max_abs_diff"][tag] == 0.0
            checks[f"n={n} bs={bs} {tag} panel = square rows bit for bit"] \
                = row["panel_vs_square_max_abs_diff"][tag] == 0.0
        # Conjugate views through the operators (complex values; real
        # values with complex vectors on the real kernels).
        x = torch.randn(n, generator=gen, device=DEVICE,
                        dtype=torch.complex64)
        X = torch.randn(n, MULTI_R, generator=gen, device=DEVICE,
                        dtype=torch.complex64)
        real_op = sparse.BellOperator(vals.real.contiguous(), cols, n,
                                      compute_dtype=torch.complex64)
        conj_pairs = {
            "complex matvec(x.conj())": (op.matvec(x.conj()),
                                         op.matvec(x.conj().resolve_conj())),
            "complex matmat(X.conj())": (op.matmat(X.conj()),
                                         op.matmat(X.conj().resolve_conj())),
            "complex with_vals(vals.conj()).matvec": (
                op.with_vals(vals.conj()).matvec(x),
                op.with_vals(vals.conj().resolve_conj()).matvec(x)),
            "real values matvec(x.conj())": (
                real_op.matvec(x.conj()),
                real_op.matvec(x.conj().resolve_conj())),
            "real values matmat(X.conj())": (
                real_op.matmat(X.conj()),
                real_op.matmat(X.conj().resolve_conj()))}
        torch.cuda.synchronize()
        row["conj_view_max_abs_diff"] = {
            name: float((a - b).abs().max())
            for name, (a, b) in conj_pairs.items()}
        for name, diff in row["conj_view_max_abs_diff"].items():
            checks[f"n={n} bs={bs} {name} = resolved bit for bit"] = \
                diff == 0.0
        emit(row)
        del op, vals, cols, panel, real_op, conj_pairs
    torch.cuda.empty_cache()
    return checks


def hermitian_bell(n, bs, bpr, seed, spikes=()):
    """``(vals, cols)`` of a complex Hermitian ring-banded blocked-ELL
    operator on ``spiked_bell``'s pattern: complex Gaussian values from
    ``numpy.random.default_rng(seed)`` of variance 1 / (bpr bs), the
    diagonal block (B + B^H) / 2 with its first entries lowered by
    ``spikes``, the -o band the +o band's conjugate transposes; complex64
    values, int32 columns."""
    nb, n_off = n // bs, (bpr - 1) // 2
    offs = np.random.default_rng(7).permutation(np.arange(1, nb))[:n_off]
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(2.0 * bpr * bs)
    i = np.arange(nb)

    def gauss():
        return (rng.standard_normal((nb, bs, bs))
                + 1j * rng.standard_normal((nb, bs, bs))) * scale

    d = gauss()
    vals, cols = [(d + d.conj().transpose(0, 2, 1)) / 2], [i]
    for o in offs:
        b = gauss()
        vals += [b, b[(i - o) % nb].conj().transpose(0, 2, 1)]
        cols += [(i + o) % nb, (i - o) % nb]
    vals = np.stack(vals, axis=1)
    for j, sp in enumerate(spikes):
        vals[0, 0, j, j] -= sp
    return vals.astype(np.complex64), np.stack(cols, axis=1).astype(np.int32)


def _bell_dense_c128(vals, cols):
    """The dense complex128 matrix of blocked-ELL ``(vals, cols)``."""
    nb, bpr, bs, _ = vals.shape
    a = np.zeros((nb, bs, nb, bs), np.complex128)
    for i in range(nb):
        for j in range(bpr):
            a[i, :, cols[i, j], :] += vals[i, j]
    return a.reshape(nb * bs, nb * bs)


def cx_bell_small(pkg):
    """Part (d): the derivative set of a complex Hermitian Bell at
    n = 4096 against a float64 ``eigh`` of its dense matrix."""
    n, bs, bpr, seed = CXB_SMALL
    v0_np, cols_np = hermitian_bell(n, bs, bpr, seed, spikes=SO_SPIKES)
    v1_np, cols1 = hermitian_bell(n, bs, bpr, seed + 1)
    assert np.array_equal(cols_np, cols1)
    a0 = pkg.BellOperator(torch.from_numpy(v0_np).to(DEVICE),
                          torch.from_numpy(cols_np).to(DEVICE), n,
                          symmetric=False)
    a1 = a0.with_vals(torch.from_numpy(v1_np).to(DEVICE))
    rng = np.random.default_rng(seed + 2)
    w_np = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    w = torch.from_numpy(w_np / np.linalg.norm(w_np)).to(
        torch.complex64).to(DEVICE)
    kw = dict(k=K, tol=CG_TOL, maxiter=CG_MAXITER, device=DEVICE)
    t0 = time.perf_counter()
    h0 = torch.from_numpy(_bell_dense_c128(v0_np, cols_np)).to(DEVICE)
    h1 = torch.from_numpy(_bell_dense_c128(v1_np, cols_np)).to(DEVICE)
    lam_all, vec = torch.linalg.eigh(h0)
    v = vec[:, 0]
    me = vec[:, 1:].conj().T @ (h1 @ v)             # <v_k, H1 v>, k >= 1
    gaps = lam_all[0] - lam_all[1:]
    dv = vec[:, 1:] @ (me / gaps)
    wv = torch.vdot(w.to(torch.complex128), v)
    truth = {"lam": float(lam_all[0]),
             "dloss": float(torch.vdot(v, h1 @ v).real
                            + 2 * (wv.conj() * torch.vdot(
                                w.to(torch.complex128), dv)).real),
             "e": float(lam_all[0]),
             "de_dg": float(torch.vdot(v, h1 @ v).real),
             "d2e_dg2": float(2 * ((me.abs() ** 2) / gaps).sum())}
    truth_s = time.perf_counter() - t0
    del h0, h1, vec, lam_all, v, me, dv

    def loss(op):
        lam, vv = pkg.dominant_eigh(op, **kw)
        return lam + torch.vdot(w, vv).abs() ** 2, lam

    leaf = a0.vals.detach().clone().requires_grad_(True)
    (f, lam), fwd_s = timed(lambda: loss(a0.with_vals(leaf)))
    (g,), bwd_s = timed(lambda: torch.autograd.grad(f, leaf))
    with torch.no_grad(), fwAD.dual_level():
        (f_d, _), jvp_s = timed(lambda: loss(a0.with_vals(
            fwAD.make_dual(a0.vals, a1.vals))))
        dloss_fwd = float(fwAD.unpack_dual(f_d).tangent)

    def make(gg):
        return pkg.MatrixFreeOperator(
            lambda p, x: a0.matvec(x) + p * a1.matvec(x), gg, n,
            dtype=torch.complex64)

    curv, curv_s = timed(lambda: [float(t) for t in pkg.energy_curvature(
        make, 0.0, **kw)])
    got = {"lam": float(lam.detach()), "dloss_rev": cgrad_dot(g, a1.vals),
           "dloss_fwd": dloss_fwd, "e": curv[0], "de_dg": curv[1],
           "d2e_dg2": curv[2]}
    errs = {key: abs(val - truth["dloss" if key.startswith("dloss")
                                 else key]) / abs(
        truth["dloss" if key.startswith("dloss") else key])
        for key, val in got.items()}
    part = {"n": n, "bs": bs, "blocks_per_row": bpr, "dtype": "complex64",
            "spikes": list(SO_SPIKES), "k": K, "got": got, "truth": truth,
            "rel_err": errs, "forward_s": fwd_s, "backward_s": bwd_s,
            "forward_mode_s": jvp_s, "energy_curvature_s": curv_s,
            "float64_eigh_truth_s": truth_s}
    checks = {f"small {key} vs float64 eigh, rel {bar}": errs[key] <= bar
              for key, bar in CXB_SMALL_RTOL.items()}
    return part, checks


def _complex_panel_solves(sg):
    """One rank of the complex panels' spawn: config #5 in the complex
    gauge, the rank's panel of it, ``dominant_eigh`` (k = 100, from D v0)
    and a short LOBPCG (r = 8, from D x0), counted."""
    import importlib
    import dominantsparseeigenad_tpu_torch as pkg
    spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                   "bell_spmv")
    n, bs, bpr = CONFIG5
    op, v0 = config5_operator(pkg)
    d, x0, _ = complex_gauge(n // bs, bs)
    vals_c = gauge_values(op.vals, op.cols, d)
    cols = op.cols
    del op
    sop = pkg.RowShardedBellOperator(vals_c, cols, n, sg, symmetric=False)
    del vals_c
    torch.cuda.empty_cache()
    dflat = d.reshape(-1)
    vc0, x0c = dflat * v0, dflat[:, None] * x0
    with torch.no_grad():
        # Warm-up through the same calls on a small operator in the gauge.
        small = pkg.random_bell_operator(min(1 << 14, n), bs, bpr,
                                         device=DEVICE)
        small = pkg.RowShardedBellOperator(
            gauge_values(small.vals, small.cols, d[:small.vals.shape[0]]),
            small.cols, small.n, sg, symmetric=False)
        pkg.dominant_eigh(small, k=20, device=DEVICE)
        pkg.dominant_eigh_multi(small, r=MULTI_R, k=MULTI_R, method="lobpcg",
                                device=DEVICE)
        del small
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        spmv.reset_launch_counts()
        (lam, _), fwd_s = timed(lambda: pkg.dominant_eigh(
            sop, k=K, v0=vc0, device=DEVICE))
        (lams, _), lobpcg_s = timed(lambda: pkg.dominant_eigh_multi(
            sop, r=MULTI_R, k=CXB_PANEL_LOBPCG_ITERS, method="lobpcg",
            tol=CG_TOL, x0=x0c, device=DEVICE))
    return {"rank": sg.rank, "lam": float(lam), "lam_hex": float(lam).hex(),
            "lams": lams.tolist(), "forward_s": fwd_s,
            "lobpcg_s": lobpcg_s,
            "panel_launches": dict(spmv.panel_launch_counts),
            "square_launches": dict(spmv.launch_counts),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_complex_bell(pkg, spmv):
    """Complex blocked-ELL values on K5 and K6 (see the module docstring,
    phase 15).  Returns the kernel rows and the launches of the counted
    runs (square, and the ranks' panels)."""
    sparse = importlib.import_module("dominantsparseeigenad_tpu_torch.ops."
                                     "sparse")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, bs, bpr = CONFIG5
    nb = n // bs
    out, checks, rows = {}, {}, {}
    op, v0 = config5_operator(pkg)
    cols, plan = op.cols, op.slot_plan
    d, x0, gen = complex_gauge(nb, bs)
    dflat = d.reshape(-1)
    vc0, x0c = dflat * v0, dflat[:, None] * x0

    # (a) The real config #5: its Lanczos coefficients, λ and LOBPCG λ;
    # real values times complex vectors against the parts done apart.
    with torch.no_grad():
        res_r = pkg.lanczos(op, K, v0=v0, device=DEVICE)
        lam_r = float(pkg.dominant_eigh(op, k=K, v0=v0, device=DEVICE)[0])
        lams_r = pkg.dominant_eigh_multi(
            op, r=MULTI_R, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL,
            x0=x0, device=DEVICE)[0]
        xc = torch.randn(n, generator=gen, device=DEVICE,
                         dtype=torch.complex64)
        Xc = torch.randn(n, MULTI_R, generator=gen, device=DEVICE,
                         dtype=torch.complex64)
        spmv.reset_launch_counts()
        y = op.matvec(xc)
        Y = op.matmat(Xc)
        route_launches = dict(spmv.launch_counts)
        apart = torch.complex(op.matmat(xc.real[:, None].contiguous())[:, 0],
                              op.matmat(xc.imag[:, None].contiguous())[:, 0])
        apart_X = torch.complex(op.matmat(Xc.real.contiguous()),
                                op.matmat(Xc.imag.contiguous()))
        torch.cuda.synchronize()
    out["real_values_complex_vectors"] = {
        "matvec_vs_parts_max_abs_diff": float((y - apart).abs().max()),
        "matmat_vs_parts_max_abs_diff": float((Y - apart_X).abs().max()),
        "matvec_rel_err_vs_plain": rel_err(y, spmv._bell_spmv_banded_torch(
            op.vals, cols, xc, plan)),
        "launches": {k: v for k, v in route_launches.items() if v}}
    checks["real values x complex vectors: the parts apart, exactly"] = (
        out["real_values_complex_vectors"]["matvec_vs_parts_max_abs_diff"]
        == 0.0 and out["real_values_complex_vectors"][
            "matmat_vs_parts_max_abs_diff"] == 0.0)
    checks["real values x complex vectors ran K4b SpMM, twice"] = \
        route_launches["bell_spmm_banded_f32"] == 2 and sum(
            route_launches.values()) == 2
    del y, Y, apart, apart_X, xc, Xc

    # The complex operator; the real one goes.
    t0 = time.perf_counter()
    vals_c = gauge_values(op.vals, cols, d)
    torch.cuda.synchronize()
    out["gauge_build_s"] = time.perf_counter() - t0
    del op
    torch.cuda.empty_cache()
    op_c = sparse.BellOperator(vals_c, cols, n, symmetric=False)
    op_g = sparse.BellOperator(vals_c, cols, n, symmetric=False,
                               slot_plan=None)
    checks["the complex operator binds the all-band plan"] = \
        op_c.slot_plan == plan and op_g.slot_plan is None
    out["values_gb"] = vals_c.numel() * vals_c.element_size() / 1e9

    # (b) K5 and K6 against their plain versions, banded = gather; the
    # panels of a p = 2 sharding (the last rank's rows); the small
    # shapes; a conjugate view of x at full width.
    t0 = time.perf_counter()
    checks.update(cx_kernel_shapes(spmv, sparse))
    out["kernel_shapes_s"] = time.perf_counter() - t0
    x = torch.randn(n, generator=gen, device=DEVICE, dtype=torch.complex64)
    rows["bell_spmv_c64"], y_sq = cx_kernel_row(spmv, "bell_spmv_c64",
                                                vals_c, cols, x, plan)
    out["conj_view_max_abs_diff"] = float((
        op_c.matvec(x.conj()) - op_c.matvec(x.conj().resolve_conj())
    ).abs().max())
    checks["config #5 matvec(x.conj()) = resolved bit for bit"] = \
        out["conj_view_max_abs_diff"] == 0.0
    half = slice(nb // 2, nb)
    rows["bell_spmv_panel_c64"], _ = cx_kernel_row(
        spmv, "bell_spmv_panel_c64", vals_c[half], cols[half], x, None,
        gather_y=y_sq)
    del x, y_sq
    by_r = {}
    for r in CXB_SPMM_R:
        X = torch.randn(n, r, generator=gen, device=DEVICE,
                        dtype=torch.complex64)
        by_r[r], Y_sq = cx_kernel_row(spmv, "bell_spmm_c64", vals_c, cols,
                                      X, plan)
        if r == MULTI_R:
            rows["bell_spmm_panel_c64"], _ = cx_kernel_row(
                spmv, "bell_spmm_panel_c64", vals_c[half], cols[half], X,
                None, gather_y=Y_sq)
        del X, Y_sq
    rows["bell_spmm_c64"] = dict(by_r[MULTI_R], by_r=by_r)
    for name, row in [*rows.items(), *((f"spmm r={r}", row)
                                       for r, row in by_r.items())]:
        checks[f"{name} vs plain, rel {CXB_RTOL['kernel']}"] = \
            row["rel_err"] <= CXB_RTOL["kernel"]
        if "banded_rel_err" in row:
            checks[f"{name} banded vs plain banded, rel "
                   f"{CXB_RTOL['kernel']}"] = \
                row["banded_rel_err"] <= CXB_RTOL["kernel"]
            checks[f"{name} banded = gather bit for bit"] = \
                row["banded_vs_gather_max_abs_diff"] == 0.0
        if "square_rows_max_abs_diff" in row:
            checks[f"{name} = the square product's rows bit for bit"] = \
                row["square_rows_max_abs_diff"] == 0.0
    torch.cuda.empty_cache()

    # Warm-up: the same calls on a small operator in the gauge, so that
    # first-use costs (library handles, lazy loading) stay out of the
    # times.
    small = pkg.random_bell_operator(min(1 << 14, n), bs, bpr, device=DEVICE)
    small = sparse.BellOperator(gauge_values(small.vals, small.cols,
                                             d[:small.vals.shape[0]]),
                                small.cols, small.n, symmetric=False)
    w_leaf = small.vals.detach().clone().requires_grad_(True)
    w_lam, _ = pkg.dominant_eigh(small.with_vals(w_leaf), k=20,
                                 device=DEVICE)
    torch.autograd.grad(w_lam, w_leaf)
    with torch.no_grad(), fwAD.dual_level():
        pkg.dominant_eigh(small.with_vals(fwAD.make_dual(
            small.vals, torch.ones_like(small.vals))), k=20, maxiter=5,
            device=DEVICE)
        pkg.dominant_eigh_multi(small, r=MULTI_R, k=MULTI_R,
                                method="lobpcg", device=DEVICE)
    del small, w_leaf, w_lam
    torch.cuda.synchronize()

    # (c) The main path, counted: Lanczos, λ and its λ-only gradient,
    # forward mode, LOBPCG; the twins on the gather kernels.
    peak_ab = torch.cuda.max_memory_allocated() / 2**30
    spmv.reset_launch_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        res_c, lanczos_s = timed(lambda: pkg.lanczos(op_c, K, v0=vc0,
                                                     device=DEVICE))
    leaf = vals_c.detach().requires_grad_(True)
    (lam_c, _), fwd_s = timed(lambda: pkg.dominant_eigh(
        op_c.with_vals(leaf), k=K, v0=vc0, tol=CG_TOL, maxiter=CG_MAXITER,
        device=DEVICE))
    (g,), bwd_s = timed(lambda: torch.autograd.grad(lam_c, leaf))
    del leaf
    dvals = torch.randn(vals_c.shape, generator=gen, device=DEVICE,
                        dtype=torch.complex64)
    with torch.no_grad(), fwAD.dual_level():
        (lam_f, _), jvp_s = timed(lambda: pkg.dominant_eigh(
            op_c.with_vals(fwAD.make_dual(vals_c, dvals)), k=K, v0=vc0,
            tol=CG_TOL, maxiter=FWD_CG_MAXITER, device=DEVICE))
        dlam_fwd = float(fwAD.unpack_dual(lam_f).tangent)
    lhs = cgrad_dot(g, dvals)
    dot_scale = cnorm(g) * cnorm(dvals)
    del g, dvals
    torch.cuda.empty_cache()
    with torch.no_grad():
        (lams_c, _, info), lobpcg_s = timed(lambda: pkg.dominant_eigh_multi(
            op_c, r=MULTI_R, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL,
            x0=x0c, with_info=True, device=DEVICE))
        lams_short = pkg.dominant_eigh_multi(
            op_c, r=MULTI_R, k=CXB_PANEL_LOBPCG_ITERS, method="lobpcg",
            tol=CG_TOL, x0=x0c, device=DEVICE)[0]
        lam_g = float(pkg.dominant_eigh(op_g, k=K, v0=vc0,
                                        device=DEVICE)[0])
        lams_g = pkg.dominant_eigh_multi(
            op_g, r=MULTI_R, k=LOBPCG_ITERS, method="lobpcg", tol=CG_TOL,
            x0=x0c, device=DEVICE)[0]
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    counts = dict(spmv.launch_counts)
    lam_c = float(lam_c.detach())
    scale = float(torch.cat([res_r.alphas.abs(), res_r.betas.abs()]).max())
    main = {
        "k": K, "lam": lam_c, "lam_real": lam_r,
        "lam_rel": abs(lam_c - lam_r) / abs(lam_r),
        "alpha_max_diff": float((res_c.alphas - res_r.alphas).abs().max()),
        "beta_max_diff": float((res_c.betas - res_r.betas).abs().max()),
        "alpha_beta_scale": scale,
        "alpha_beta_first20_max_diff": float(max(
            (res_c.alphas[:20] - res_r.alphas[:20]).abs().max(),
            (res_c.betas[:20] - res_r.betas[:20]).abs().max())),
        "dlam_reverse": lhs, "dlam_forward": dlam_fwd,
        "dot_rel": abs(lhs - dlam_fwd) / dot_scale,
        "lobpcg_lams": lams_c.tolist(), "lobpcg_lams_real": lams_r.tolist(),
        "lobpcg_rel": float(((lams_c - lams_r).abs() / lams_r.abs()).max()),
        "lobpcg_iterations": float(info.effective_k),
        "lobpcg_residual": float(info.residual),
        "twin_lam_equal": lam_g == lam_c,
        "twin_lobpcg_equal": bool(torch.equal(lams_g, lams_c)),
        "lanczos_s": lanczos_s, "forward_s": fwd_s,
        "lambda_backward_s": bwd_s, "forward_mode_s": jvp_s,
        "lobpcg_s": lobpcg_s, "peak_added_gib": peak_gib}
    out["config5_gauge"] = main
    checks.update({
        f"complex vs real lambda, rel {CXB_RTOL['lam']}":
            main["lam_rel"] <= CXB_RTOL["lam"],
        f"complex vs real alpha/beta, of their max, {CXB_RTOL['lanczos']}":
            max(main["alpha_max_diff"], main["beta_max_diff"])
            <= CXB_RTOL["lanczos"] * scale,
        f"reverse vs forward d lambda, rel {CXB_RTOL['dot']}":
            main["dot_rel"] <= CXB_RTOL["dot"],
        f"complex vs real LOBPCG lambdas, rel {CXB_RTOL['lobpcg']}":
            main["lobpcg_rel"] <= CXB_RTOL["lobpcg"],
        "gather twin lambda = banded lambda bit for bit":
            main["twin_lam_equal"],
        "gather twin LOBPCG = banded bit for bit":
            main["twin_lobpcg_equal"]})
    del res_c, res_r

    # (d) The derivative set at n = 4096 (counted with the main path).
    out["small_derivatives"], more = cx_bell_small(pkg)
    checks.update(more)
    counts = dict(spmv.launch_counts)
    main_launches = {k: v for k, v in counts.items() if v}
    out["main_path_launches"] = main_launches
    for name in ("bell_spmv_banded_c64", "bell_spmm_banded_c64",
                 "bell_spmv_c64", "bell_spmm_c64"):
        checks[f"{name} launched on the main path"] = counts[name] > 0
    checks["no real kernel on the complex main path"] = all(
        not v for k, v in counts.items() if not k.endswith("_c64"))

    # (e) Complex panels: two ranks sharing this card over gloo.
    del op_c, op_g, vals_c
    torch.cuda.empty_cache()
    ranks, spawn_s = spawn_ranks(2, _complex_panel_solves)
    panel_counts = {k: sum(rk["panel_launches"][k] for rk in ranks)
                    for k in ranks[0]["panel_launches"]}
    lam_sh = ranks[0]["lam"]
    short = torch.tensor(ranks[0]["lams"], dtype=torch.float64)
    sh_rel = float(((short - lams_short.double().cpu()).abs()
                    / lams_short.double().cpu().abs()).max())
    out["panels"] = {
        "ranks": 2, "note": "two ranks sharing one card over gloo, not "
        "multi-GPU", "spawn_s": spawn_s,
        "lam": lam_sh, "lam_unsharded": lam_c,
        "lam_rel": abs(lam_sh - lam_c) / abs(lam_c),
        "lobpcg_short_rel": sh_rel,
        "per_rank": [{k: rk[k] for k in ("forward_s", "lobpcg_s",
                                         "peak_gib", "lam_hex")}
                     for rk in ranks],
        "panel_launches": {k: v for k, v in panel_counts.items() if v}}
    checks.update({
        "panel ranks' lambda equal bit for bit":
            len({rk["lam_hex"] for rk in ranks}) == 1,
        f"panel lambda vs unsharded, rel {SHARDED_VS_UNSHARDED}":
            out["panels"]["lam_rel"] <= SHARDED_VS_UNSHARDED,
        f"panel LOBPCG ({CXB_PANEL_LOBPCG_ITERS} its) vs unsharded, rel "
        f"{SHARDED_BELL_VS_UNSHARDED}": sh_rel <= SHARDED_BELL_VS_UNSHARDED,
        "bell_spmv_c64 launched on the panels":
            panel_counts["bell_spmv_c64"] > 0,
        "bell_spmm_c64 launched on the panels":
            panel_counts["bell_spmm_c64"] > 0,
        "no square kernel in the ranks' counted run": all(
            not any(rk["square_launches"].values()) for rk in ranks)})
    out["peak_gib"] = max(peak_ab,
                          torch.cuda.max_memory_allocated() / 2**30)
    out["card"] = nvidia_smi_name_power()
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "complex_bell", **out})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"complex_bell phase failed: {failed}")
    return rows, counts, panel_counts


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
    16)."""
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
    #5 as one CSR (module docstring, phase 16)."""
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
    and of its transpose (module docstring, phase 16)."""
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
    docstring, phase 16).  Returns the phase's kernel launch counts."""
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
    """Part (a) of the restart phase (module docstring, phase 17)."""
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
    """Thick-restart Lanczos (module docstring, phase 17).  Returns the
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
    """Part (a) of the gen phase, and (c) (module docstring, phase 18)."""
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
    """The generalized pencil (module docstring, phase 18).  Returns the
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
def launched(spmv, fn):
    """``(fn(), seconds, K4b f32 launches)``: the call timed, and the
    banded SpMV and SpMM launches it made."""
    names = ("bell_spmv_banded_f32", "bell_spmm_banded_f32")
    before = [spmv.launch_counts[k] for k in names]
    out, seconds = timed(fn)
    return out, seconds, {k: spmv.launch_counts[k] - b
                          for k, b in zip(names, before)}


def add_counts(total, more):
    for k, c in more.items():
        total[k] = total.get(k, 0) + c


@contextlib.contextmanager
def recorded_loop(module, name):
    """Record the iterations (of a batched loop, the per-column max) of
    every run of the solver loop ``module.name`` inside the block."""
    loop = getattr(module, name)
    its = []

    def record(*args, **kw):
        x, n_its = loop(*args, **kw)
        its.append(int(torch.as_tensor(n_its).max()))
        return x, n_its

    setattr(module, name, record)
    try:
        yield its
    finally:
        setattr(module, name, loop)


def loop_products(its, maxiter):
    """The block products a batched loop made: its longest column's
    iterations, rounded up to the host's check (``CHECK_EVERY``), at
    most ``maxiter``."""
    from dominantsparseeigenad_tpu_torch.ops.cg import CHECK_EVERY
    return min(maxiter, -(-its // CHECK_EVERY) * CHECK_EVERY)


def kpm_exact(op, center, half, s):
    """μ1 = Tr(Ã)/N and μ2 = 2 ||Ã||_F^2 / N - 1 of Ã = (A - c)/h, exact
    in float64 from the values, and the standard errors of their
    s-probe Rademacher estimates (μ2's an upper bound: ||Ã²||_F <=
    ||Ã||_F inside the enclosure)."""
    vals, cols = op.vals.detach(), op.cols
    nb = vals.shape[0]
    n = op.dim
    c, h = float(center), float(half)
    diag_slot = (cols.long() == torch.arange(nb, device=cols.device)[:, None])
    dvals = torch.diagonal(vals, dim1=-2, dim2=-1).double()
    tr = float((dvals.sum(-1) * diag_slot).sum())
    diag2 = float(((dvals ** 2).sum(-1) * diag_slot).sum())
    frob2 = sum(float((b.double() ** 2).sum()) for b in vals.split(256))
    at_frob2 = (frob2 - 2 * c * tr + n * c * c) / (h * h)
    mu1 = (tr - n * c) / (n * h)
    mu2 = 2 * at_frob2 / n - 1
    se1 = math.sqrt(2 * (frob2 - diag2)) / (h * n * math.sqrt(s))
    se2 = 2 * math.sqrt(2 * at_frob2) / (n * math.sqrt(s))
    return {"mu1": mu1, "mu2": mu2, "se1": se1, "se2": se2,
            "trace": tr}


def spectral_config5(pkg, spmv):
    """Part (a) of the spectral phase (module docstring, phase 19)."""
    from dominantsparseeigenad_tpu_torch.ops.eigh import _block_tangents
    slicing = importlib.import_module(
        "dominantsparseeigenad_tpu_torch.ops.slicing")
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    sv, sm = "bell_spmv_banded_f32", "bell_spmm_banded_f32"
    n, bs, bpr = CONFIG5
    r = MULTI_R
    main = {}
    op, v0 = config5_operator(pkg)
    gen = torch.Generator(device=DEVICE).manual_seed(SPEC_SEED)

    def seeded():
        return torch.Generator(device=DEVICE).manual_seed(SPEC_SEED)

    def run(fn):
        out, seconds, got = launched(spmv, fn)
        add_counts(main, got)
        return out, seconds, got

    # (1) The enclosure.
    with torch.no_grad():
        (lo, hi), t_bounds, l_bounds = run(lambda: pkg.spectral_bounds(
            op, SPEC_BOUNDS_K, v0=v0, device=DEVICE))
    lo_f, hi_f = float(lo), float(hi)
    width = hi_f - lo_f
    # (2) KPM: density and Tr exp(A) at the JAX defaults, their
    # moments recorded as they run.
    energies = torch.linspace(lo_f + 0.01 * width, hi_f - 0.01 * width, 64,
                              device=DEVICE)
    moments = []
    cheb = slicing._chebyshev_moments

    def record(*args):
        out = cheb(*args)
        moments.append(out)
        return out

    slicing._chebyshev_moments = record
    try:
        with torch.no_grad():
            rho, t_dos, l_dos = run(lambda: pkg.spectral_density(
                op, energies, degree=KPM_DEGREE, n_probe=KPM_PROBES,
                generator=seeded(), bounds_k=SPEC_BOUNDS_K, device=DEVICE))
            tr_exp, t_tr, l_tr = run(lambda: pkg.trace_function(
                op, torch.exp, degree=KPM_DEGREE, n_probe=KPM_PROBES,
                generator=seeded(), bounds_k=SPEC_BOUNDS_K, device=DEVICE))
    finally:
        slicing._chebyshev_moments = cheb
    mus, center, half = moments[0]
    exact = kpm_exact(op, center, half, KPM_PROBES)
    mu = [float(t) for t in mus[:3]]
    rho_int = float(torch.trapezoid(rho, energies))
    # (3) log det of the SPD shift A - lo.
    spd = pkg.ShiftedOperator(op, lo_f)
    with torch.no_grad():
        ld, t_ld, l_ld = run(lambda: pkg.logdet(
            spd, degree=LOGDET_DEGREE, n_probe=KPM_PROBES,
            generator=seeded(), bounds_k=SPEC_BOUNDS_K, device=DEVICE))
    jensen = math.log(exact["trace"] / n - lo_f)
    # (4) The slice at the top edge, its backward and forward mode.
    with torch.no_grad():
        theta, _ = pkg.lanczos_eigh(op, SPEC_BOUNDS_K, extreme="max", v0=v0,
                                    device=DEVICE)
    a_win, b_win = float(theta) - SLICE_WINDOW, hi_f
    op.vals.requires_grad_(True)
    c = torch.randn(r, generator=gen, device=DEVICE)
    C = torch.randn(n, r, generator=gen, device=DEVICE) / math.sqrt(n)
    applies = []
    fm = slicing._filtered_matvec

    def counted_filter(params, x):
        applies.append(tuple(x.shape))
        return fm(params, x)

    slicing._filtered_matvec = counted_filter
    try:
        (lams, V, info), t_fwd, l_fwd = run(lambda: pkg.spectral_slice(
            op, a_win, b_win, r=r, degree=SLICE_DEGREE, maxiter=SLICE_MAXITER,
            tol=CG_TOL, solve_maxiter=SLICE_SOLVE_MAXITER,
            bounds_k=SPEC_BOUNDS_K, generator=seeded(), device=DEVICE))
    finally:
        slicing._filtered_matvec = fm
    (g_sum,), t_bwd_lam, l_bwd_lam = run(lambda: torch.autograd.grad(
        lams.sum(), op.vals, retain_graph=True))
    with recorded_solves() as bwd_solves, \
            recorded_loop(cg, "_minres_columns_loop") as bwd_its:
        (g_full,), t_bwd, l_bwd = run(lambda: torch.autograd.grad(
            (c * lams).sum() + (C * V).sum(), op.vals))
    lams_d, V_d = lams.detach(), V.detach()
    op_d = op.with_vals(op.vals.detach())
    opts = slicing.SliceOptions(r=r, solve_tol=CG_TOL,
                                solve_maxiter=SLICE_SOLVE_MAXITER)
    dvals = torch.randn(op.vals.shape, generator=gen, device=DEVICE)

    def solve(rhs):
        return pkg.solve_deflated(op_d, lams_d, V_d, rhs, method="minres",
                                  tol=CG_TOL, maxiter=SLICE_SOLVE_MAXITER,
                                  device=DEVICE)

    with torch.no_grad(), recorded_solves() as fwd_solves, \
            recorded_loop(cg, "_minres_columns_loop") as fwd_its:
        (dlams, dV), t_tan, l_tan = run(lambda: _block_tangents(
            op_d, lams_d, V_d, [dvals], opts, solve))
    # (5) The resolvent at SPECFN_POINTS frequencies: one batched CG.
    b_probe = torch.randn(n, generator=gen, device=DEVICE)
    eta = SPECFN_ETA_REL * width
    omegas = torch.linspace(lo_f + 0.1 * width, hi_f - 0.1 * width,
                            SPECFN_POINTS, device=DEVICE)
    with torch.no_grad(), recorded_loop(cg, "_cg_columns_loop") as sf_its:
        s_w, t_sf, l_sf = run(lambda: pkg.spectral_function(
            op_d, b_probe, omegas, eta, tol=SPECFN_TOL,
            maxiter=SPECFN_MAXITER, device=DEVICE))
    # ---- end of the main path; the checks' own products follow --------
    with torch.no_grad():
        loop_two = torch.cat([pkg.spectral_function(
            op_d, b_probe, omegas[i:i + 1], eta, tol=SPECFN_TOL,
            maxiter=SPECFN_MAXITER, device=DEVICE) for i in (1, 5)])
        sf_loop_err = rel_err(loop_two, s_w[[1, 5]])
        av = op_d.matmat(V_d)
        rq = (V_d * av).sum(dim=0)
        pair_err = float((rq - lams_d).abs().max() / lams_d.abs().max())
        vb = V_d.reshape(-1, bs, r)
        expect = torch.matmul(vb[:, None],
                              vb[op.cols.long()].transpose(-1, -2))
        dsum_err = rel_err(g_sum, expect)
        del expect, vb

        def deflated(Z):
            """P (A P Z - P Z diag(λ)) P, P = I - V V^T."""
            pz = Z - V_d @ (V_d.T @ Z)
            az = op_d.matmat(pz) - pz * lams_d[None, :]
            return az - V_d @ (V_d.T @ az)

        # reverse <∇, D> - forward dL = <r_w, X> - <W, r_x> exactly, W
        # and X the two batched solves, r_w and r_x their residuals.
        rhs_w, W = bwd_solves[0][:2]
        rhs_x, X = fwd_solves[0][:2]
        r_w, r_x = rhs_w - deflated(W), rhs_x - deflated(X)
        lhs = grad_dot(g_full, dvals)
        tangent = [float((c * dlams).sum()), float((C * dV).sum())]
        resid = [float((r_w * X).sum()), -float((W * r_x).sum())]
        dot_err = abs(lhs - sum(tangent) - sum(resid)) / (
            abs(lhs) + sum(abs(t) for t in tangent + resid))
        finite = all(bool(torch.isfinite(t).all()) for t in (
            rho, tr_exp, ld, lams_d, V_d, g_sum, g_full, dlams, dV, s_w))
    del g_full, g_sum, dvals, W, X, r_w, r_x
    out = {
        "n": n, "bounds": [lo_f, hi_f], "bounds_s": t_bounds,
        "bounds_launches": l_bounds,
        "density_s": t_dos, "density_launches": l_dos,
        "density_integral": rho_int, "moments_0_2": mu,
        "moments_exact_1_2": [exact["mu1"], exact["mu2"]],
        "moments_se_1_2": [exact["se1"], exact["se2"]],
        "trace_exp": float(tr_exp), "trace_exp_s": t_tr,
        "trace_exp_launches": l_tr, "logdet": float(ld),
        "logdet_per_site": float(ld) / n, "logdet_jensen_bound": jensen,
        "logdet_s": t_ld, "logdet_launches": l_ld,
        "slice_window": [a_win, b_win], "slice_lams": lams_d.tolist(),
        "slice_n_inside": float(info.n_inside),
        "slice_residual": float(info.residual),
        "slice_residuals": info.residuals.tolist(),
        "slice_converged": float(info.converged),
        "slice_filter_applies": len(applies),
        "slice_lobpcg_iterations": (len(applies) - 1) // 2,
        "slice_capped": (len(applies) - 1) // 2 >= SLICE_MAXITER,
        "slice_forward_s": t_fwd, "slice_forward_launches": l_fwd,
        "slice_dsumlam_s": t_bwd_lam, "slice_dsumlam_launches": l_bwd_lam,
        "slice_backward_s": t_bwd, "slice_backward_launches": l_bwd,
        "slice_backward_minres_iterations": bwd_its,
        "slice_backward_capped": bwd_its[0] >= SLICE_SOLVE_MAXITER,
        "slice_tangent_s": t_tan, "slice_tangent_launches": l_tan,
        "slice_tangent_minres_iterations": fwd_its,
        "slice_pair_rel_err": pair_err, "slice_dsumlam_rel_err": dsum_err,
        "slice_dot_lhs": lhs, "slice_dot_tangent": tangent,
        "slice_dot_residual_terms": resid, "slice_dot_rel_err": dot_err,
        "specfn_eta": eta, "specfn_omegas": omegas.tolist(),
        "specfn": s_w.tolist(), "specfn_s": t_sf,
        "specfn_launches": l_sf, "specfn_cg_iterations": sf_its,
        "specfn_capped": sf_its[0] >= SPECFN_MAXITER,
        "specfn_loop_rel_err": sf_loop_err}
    width_ok = all(shape == (n, r) for shape in applies)
    checks = {
        "bounds: SPEC_BOUNDS_K SpMVs, no SpMM":
            l_bounds == {sv: SPEC_BOUNDS_K, sm: 0},
        "density: enclosure SpMVs + one r = 16 SpMM a degree":
            l_dos == {sv: SPEC_BOUNDS_K, sm: KPM_DEGREE},
        "trace: enclosure SpMVs + one SpMM a degree":
            l_tr == {sv: SPEC_BOUNDS_K, sm: KPM_DEGREE},
        "logdet: 2 (k + 1) SpMVs + one SpMM a degree":
            l_ld == {sv: 2 * (2 * SPEC_BOUNDS_K + 1), sm: LOGDET_DEGREE},
        "μ0 == 1 (within 1e-6)": abs(mu[0] - 1.0) <= 1e-6,
        f"μ1 within {KPM_SE_BAR} standard errors of Tr(Ã)/N":
            abs(mu[1] - exact["mu1"]) <= KPM_SE_BAR * exact["se1"],
        f"μ2 within {KPM_SE_BAR} standard errors of 2||Ã||²/N - 1":
            abs(mu[2] - exact["mu2"]) <= KPM_SE_BAR * exact["se2"],
        "density integrates to 1 within 0.05": abs(rho_int - 1) < 0.05,
        "Tr exp(A) > 0": float(tr_exp) > 0,
        "logdet / N below ln(mean eigenvalue) (Jensen)":
            float(ld) / n < jensen,
        "slice forward: degree x filtered applies + 1 SpMMs, "
        "SPEC_BOUNDS_K SpMVs":
            l_fwd == {sv: SPEC_BOUNDS_K,
                      sm: SLICE_DEGREE * len(applies) + 1}
            and width_ok and len(applies) % 2 == 1,
        "∂Σλ backward: one SpMM": l_bwd_lam == {sv: 0, sm: 1},
        "backward: one batched MINRES (its loop's SpMMs) + 1 SpMM":
            len(bwd_its) == 1 and l_bwd == {
                sv: 0, sm: loop_products(bwd_its[0], SLICE_SOLVE_MAXITER)
                + 1},
        "tangent: one SpMM + one batched MINRES":
            len(fwd_its) == 1 and l_tan == {
                sv: 0, sm: 1 + loop_products(fwd_its[0],
                                             SLICE_SOLVE_MAXITER)},
        "spectral_function: one batched CG, 2 SpMMs an iteration":
            len(sf_its) == 1 and l_sf == {
                sv: 0, sm: 2 * loop_products(sf_its[0], SPECFN_MAXITER)},
        f"slice λ_i == v_i^T A v_i, rel {SLICE_RTOL['pair']}":
            pair_err <= SLICE_RTOL["pair"],
        f"∂Σλ/∂vals vs Σ v_i⊗v_i, rel {SLICE_RTOL['dsumlam_dvals']}":
            dsum_err <= SLICE_RTOL["dsumlam_dvals"],
        f"dot-product identity, reverse vs forward, rel {SLICE_RTOL['dot']}":
            dot_err <= SLICE_RTOL["dot"],
        "S(ω) >= 0": bool((s_w >= 0).all()),
        f"batched resolvent vs the loop at 2 frequencies, rel "
        f"{SPECFN_LOOP_RTOL}": sf_loop_err <= SPECFN_LOOP_RTOL,
        "finite": finite,
    }
    op.vals.requires_grad_(False)
    return out, checks, main


def spectral_tfim(pkg):
    """Part (b) of the spectral phase: the TFIM (module docstring, phase
    19)."""
    from dominantsparseeigenad_tpu_torch import models
    f64 = torch.float64
    cfg = SLICE_TFIM
    n, g = cfg["n"], cfg["g"]

    def window(nn):
        e0, _ = pkg.dominant_eigh(models.tfim_operator(nn, g, dtype=f64,
                                                       device=DEVICE),
                                  k=80, extreme="min", tol=1e-10,
                                  device=DEVICE)
        return float(e0) + cfg["window"][0], float(e0) + cfg["window"][1]

    def dense_evals(nn, gv):
        return torch.linalg.eigvalsh(models.tfim_dense_hamiltonian(
            nn, gv, dtype=f64, device=DEVICE)).cpu().numpy()

    lo_e, hi_e = window(n)

    def centroid(gv):
        ls, _, inf = pkg.spectral_slice(
            models.tfim_operator(n, gv, dtype=f64, device=DEVICE), lo_e,
            hi_e, r=cfg["r"], degree=cfg["degree"], maxiter=cfg["maxiter"],
            tol=cfg["tol"], device=DEVICE)
        msk = (ls >= lo_e) & (ls <= hi_e)
        cen = torch.where(msk, ls, torch.zeros_like(ls)).sum() \
            / torch.clamp(msk.sum(), min=1)
        return cen, ls, inf

    gt = torch.tensor(g, dtype=f64, device=DEVICE, requires_grad=True)
    (cen, ls, info), t_fwd = timed(lambda: centroid(gt))
    (dc,), t_bwd = timed(lambda: torch.autograd.grad(cen, gt))
    ew = dense_evals(n, g)
    truth = ew[(ew >= lo_e) & (ew <= hi_e)]
    ls_np = ls.detach().cpu().numpy()
    got = np.sort(ls_np[(ls_np >= lo_e) & (ls_np <= hi_e)])
    lam_err = (float(np.abs(got - truth).max() / np.abs(truth).max())
               if len(got) == len(truth) else float("inf"))
    eps = SLICE_TFIM_RTOL["fd_eps"]

    def band_mean(gv):
        e = dense_evals(n, gv)
        return e[(e >= lo_e) & (e <= hi_e)].mean()

    fd = (band_mean(g + eps) - band_mean(g - eps)) / (2 * eps)
    dc_err = abs(float(dc) - fd) / abs(fd)
    # interior_eigh: σ at the window's middle (N = 10, against the slice),
    # and at N = INTERIOR_TFIM_N in its own window.
    interior = {}
    for nn in (n, INTERIOR_TFIM_N):
        a_w, b_w = (lo_e, hi_e) if nn == n else window(nn)
        sigma = 0.5 * (a_w + b_w)
        (lam, _), t_int = timed(lambda: pkg.interior_eigh(
            models.tfim_operator(nn, g, dtype=f64, device=DEVICE), sigma,
            device=DEVICE))
        e = ew if nn == n else dense_evals(nn, g)
        nearest = float(e[np.argmin(np.abs(e - sigma))])
        interior[nn] = {"sigma": sigma, "lam": float(lam),
                        "nearest_dense": nearest,
                        "rel_err": abs(float(lam) - nearest) / abs(nearest),
                        "s": t_int}
        if nn == n:
            near = float(ls_np[np.argmin(np.abs(ls_np - sigma))])
            interior[nn]["slice_lam"] = near
            interior[nn]["vs_slice_rel"] = abs(float(lam) - near) / abs(near)
    # spectral_function at N = SPECFN_TFIM["n"], f32, block products.
    sf = SPECFN_TFIM
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    op20 = models.tfim_operator(sf["n"], sf["g"], dtype=torch.float32,
                                device=DEVICE)
    with torch.no_grad():
        e0, psi0 = pkg.dominant_eigh(op20, k=sf["k"], extreme="min",
                                     tol=1e-10, device=DEVICE)
        probe = models.flip_sum(psi0, sf["n"])
        omegas = float(e0) + torch.linspace(0.0, sf["wmax"], SPECFN_POINTS,
                                            device=DEVICE)
        with recorded_loop(cg, "_cg_columns_loop") as its:
            s_w, t_sf = timed(lambda: pkg.spectral_function(
                op20, probe, omegas, sf["eta"], tol=SPECFN_TOL,
                maxiter=sf["maxiter"], device=DEVICE))
        loop_two = torch.cat([pkg.spectral_function(
            op20, probe, omegas[i:i + 1], sf["eta"], tol=SPECFN_TOL,
            maxiter=sf["maxiter"], device=DEVICE) for i in (2, 5)])
        loop_err = rel_err(loop_two, s_w[[2, 5]])
        X = torch.randn(op20.dim, SPECFN_POINTS, device=DEVICE)
        block_ms = event_ms(lambda: op20.matmat(X), samples=5)
        loop_ms = event_ms(lambda: [op20.matvec(X[:, j])
                                    for j in range(SPECFN_POINTS)],
                           samples=5)
        same = torch.equal(op20.matmat(X), torch.stack(
            [op20.matvec(X[:, j]) for j in range(SPECFN_POINTS)], dim=1))
    out = {"slice": {"n": n, "g": g, "window": [lo_e, hi_e],
                     "n_inside": float(info.n_inside),
                     "dense_inside": len(truth),
                     "residual": float(info.residual),
                     "converged": float(info.converged),
                     "lam_rel_err": lam_err, "centroid": float(cen),
                     "dcentroid_dg": float(dc), "fd": fd,
                     "dcentroid_vs_fd_rel": dc_err, "forward_s": t_fwd,
                     "backward_s": t_bwd},
           "interior": interior,
           "specfn": {"n": sf["n"], "e0": float(e0), "omegas": omegas.tolist(),
                      "s": s_w.tolist(), "cg_iterations": its,
                      "capped": its[0] >= sf["maxiter"], "seconds": t_sf,
                      "loop_rel_err": loop_err,
                      "block_matmat_ms": block_ms,
                      "column_loop_ms": loop_ms,
                      "block_equals_loop": same}}
    checks = {
        "TFIM slice n_inside == dense count":
            float(info.n_inside) == len(truth),
        f"TFIM slice λ vs dense, rel {SLICE_TFIM_RTOL['lam']}":
            lam_err <= SLICE_TFIM_RTOL["lam"],
        f"d(centroid)/dg vs central difference, rel "
        f"{SLICE_TFIM_RTOL['dcentroid_vs_fd']}":
            dc_err <= SLICE_TFIM_RTOL["dcentroid_vs_fd"],
        f"interior λ vs nearest dense, rel {INTERIOR_RTOL}":
            all(v["rel_err"] <= INTERIOR_RTOL for v in interior.values()),
        f"interior λ vs the slice's, rel {SLICE_TFIM_RTOL['lam']}":
            interior[n]["vs_slice_rel"] <= SLICE_TFIM_RTOL["lam"],
        "TFIM S(ω) >= 0 and finite": bool((s_w >= 0).all())
            and bool(torch.isfinite(s_w).all()),
        f"TFIM resolvent batched vs loop, rel {SPECFN_LOOP_RTOL}":
            loop_err <= SPECFN_LOOP_RTOL,
        "TFIM block product == column loop bit for bit": same,
    }
    return out, checks


def phase_spectral(pkg, spmv):
    """The spectral tiers (module docstring, phase 19).  Returns the
    kernel launch counts of its main path."""
    t_phase = time.perf_counter()
    spmv.reset_launch_counts()
    out, checks = {}, {}
    out["config5"], more, counts = spectral_config5(pkg, spmv)
    checks.update(more)
    torch.cuda.empty_cache()
    out["tfim"], more = spectral_tfim(pkg)
    checks.update(more)
    torch.cuda.empty_cache()
    for name in ("bell_spmv_banded_f32", "bell_spmm_banded_f32"):
        checks[f"{name} launched on the spectral path"] = counts[name] > 0
    out["launches"] = counts
    out["card"] = nvidia_smi_name_power()
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "spectral", **out})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"spectral phase failed: {failed}")
    return counts


def phase_models(pkg):
    """The XXZ chain and the 2D TFIM (module docstring, phase 20)."""
    from dominantsparseeigenad_tpu_torch import models
    t_phase = time.perf_counter()
    f32 = torch.float32
    j = torch.tensor(1.0, dtype=f32, device=DEVICE, requires_grad=True)
    jz = torch.tensor(1.0, dtype=f32, device=DEVICE, requires_grad=True)
    op = models.heisenberg_operator(XXZ_N, j, jz, dtype=f32, device=DEVICE)
    (e0, _), t_fwd, peak = peak_since(lambda: pkg.dominant_eigh(
        op, k=XXZ_K, extreme="min", tol=CG_TOL, device=DEVICE))
    (dj, djz), t_bwd = timed(lambda: torch.autograd.grad(e0, (j, jz)))
    e, dj, djz = float(e0), float(dj), float(djz)
    x = torch.randn(op.dim, device=DEVICE)
    with torch.no_grad():
        xxz_ms = event_ms(lambda: op.matvec(x), samples=10)
    xxz = {"n": XXZ_N, "k": XXZ_K, "e0": e, "e0_per_site": e / XXZ_N,
           "de0_dj": dj, "de0_djz": djz,
           "euler_rel": abs(e - (dj + djz)) / abs(e),
           "su2_rel": abs(dj - 2.0 * djz) / abs(dj),
           "bethe_abs": abs(e / XXZ_N - (0.25 - math.log(2.0))),
           "forward_s": t_fwd, "backward_s": t_bwd, "peak_mib": peak,
           "matvec_ms": xxz_ms}
    lx, ly = TFIM2D
    g = torch.tensor(TFIM2D_G, dtype=f32, device=DEVICE, requires_grad=True)
    op2 = models.tfim2d_operator(lx, ly, g, dtype=f32, device=DEVICE)
    (e2, psi), t2_fwd = timed(lambda: pkg.dominant_eigh(
        op2, k=TFIM2D_K, extreme="min", tol=CG_TOL, device=DEVICE))
    (de,), t2_bwd = timed(lambda: torch.autograd.grad(e2, g))
    with torch.no_grad():
        psi = psi.detach()
        hf = -float(torch.dot(psi, models.flip_sum(psi, lx * ly)))
    tfim2d = {"lattice": [lx, ly], "g": TFIM2D_G, "k": TFIM2D_K,
              "e0": float(e2), "e0_per_site": float(e2) / (lx * ly),
              "de0_dg": float(de), "hellmann_feynman": hf,
              "de0_dg_vs_hf_rel": abs(float(de) - hf) / abs(hf),
              "forward_s": t2_fwd, "backward_s": t2_bwd}
    checks = {
        f"XXZ Euler identity, rel {XXZ_RTOL['euler']}":
            xxz["euler_rel"] <= XXZ_RTOL["euler"],
        f"XXZ SU(2) identity, rel {XXZ_RTOL['su2']}":
            xxz["su2_rel"] <= XXZ_RTOL["su2"],
        f"XXZ E0/N vs Bethe within {XXZ_RTOL['bethe_abs']}":
            xxz["bethe_abs"] < XXZ_RTOL["bethe_abs"],
        f"2D TFIM dE0/dg vs -<ψ|Σσˣ|ψ>, rel {TFIM2D_RTOL}":
            tfim2d["de0_dg_vs_hf_rel"] <= TFIM2D_RTOL,
        "finite": all(math.isfinite(t) for t in (e, dj, djz, float(e2),
                                                 float(de), hf)),
    }
    emit({"phase": "models", "xxz": xxz, "tfim2d": tfim2d,
          "card": nvidia_smi_name_power(),
          "phase_s": time.perf_counter() - t_phase})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"models phase failed: {failed}")


def idle_share(intervals):
    """``(idle share, window ms, busy ms)`` of device intervals (µs): one
    minus the union of the intervals over the window from the first
    start to the last end."""
    intervals = sorted(intervals)
    busy, (lo, hi) = 0.0, intervals[0]
    end = max(e for _, e in intervals)
    for s, e in intervals[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    window = end - intervals[0][0]
    return 1.0 - busy / window, window * 1e-3, busy * 1e-3


def read_trace(log_dir):
    """The one trace file ``utils.trace`` wrote into ``log_dir``: the
    named ranges (host side) by count, the device kernels and copies, the
    idle share of the device window, the kernels with the most device
    time.  Fails if the profiler recorded no device activity."""
    files = sorted(Path(log_dir).glob("trace_*.json"))
    if len(files) != 1:
        raise AssertionError(f"expected one trace file in {log_dir}, found "
                             f"{[f.name for f in files]}")
    events = json.loads(files[0].read_text())["traceEvents"]
    ranges = {name: 0 for name in RANGES}
    kernel_us = {}
    intervals = []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name") in ranges:
            ranges[e["name"]] += 1
        elif cat in DEVICE_CATS and e.get("ph") == "X":
            intervals.append((e["ts"], e["ts"] + e["dur"]))
            if cat == "kernel":
                kernel_us[e["name"]] = kernel_us.get(e["name"], 0.0) \
                    + e["dur"]
    if not kernel_us:
        raise AssertionError("the trace holds no CUDA kernel: the profiler "
                             "recorded no device activity")
    idle, window_ms, busy_ms = idle_share(intervals)
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:6]
    return {"file_mib": files[0].stat().st_size / 2**20,
            "events": len(events), "ranges": ranges,
            "device_intervals": len(intervals),
            "distinct_kernels": len(kernel_us),
            "bell_spmv_banded_kernels": sorted(
                n for n in kernel_us if "bell_spmv_banded" in n),
            "idle_share": idle,
            "window_ms": window_ms, "busy_ms": busy_ms,
            "top_kernels_ms": {name[:80]: us * 1e-3 for name, us in top}}


def phase_utils(pkg, spmv, spmv_row):
    """utils/ on the card (module docstring, phase 21): synced timing, the
    profiler trace with the solvers' named ranges and the idle share, the
    logger on CUDA tensors, diagnostics and the convergence guards.
    ``spmv_row`` is the spmv phase's config-#5 K4b f32 row."""
    from dominantsparseeigenad_tpu_torch import models, utils
    cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
    t_phase = time.perf_counter()
    f32 = torch.float32
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="utils_", dir=build)
    out, checks = {"phase": "utils"}, {}

    # (a) timeit of one K4b SpMV (the operator's matvec, synced each call)
    # against the kernel's CUDA-event median from the spmv phase; and the
    # event median of the same synced-free call, one a sample.
    op, v0 = config5_operator(pkg)
    x = torch.randn(op.dim, generator=torch.Generator(device=DEVICE)
                    .manual_seed(8), device=DEVICE)
    with torch.no_grad():
        before = spmv.launch_counts["bell_spmv_banded_f32"]
        res = utils.timeit(op.matvec, x, repeats=UTILS_TIMEIT_REPEATS)
        call_event = event_ms(lambda: op.matvec(x),
                              samples=UTILS_TIMEIT_REPEATS)
        launched = spmv.launch_counts["bell_spmv_banded_f32"] - before
        # The same product through the autograd Function, which op.matvec
        # skips where nothing is differentiated: timeit and the call's
        # event median of each route, in turns.
        routes = {"direct": lambda: op.matvec(x),
                  "function": lambda: spmv._BellProduct.apply(
                      op.vals, op.cols, x, op.slot_plan)}
        turns = {"direct": [], "function": []}
        for route in ("direct", "function", "function", "direct"):
            turns[route].append({
                "timeit_ms": utils.timeit(
                    routes[route], repeats=UTILS_TIMEIT_REPEATS).median * 1e3,
                "call_event_ms": event_ms(routes[route],
                                          samples=UTILS_TIMEIT_REPEATS)})
    timeit_ms, event = res.median * 1e3, spmv_row["kernel_ms"]
    a, b = UTILS_TIMEIT_BAR
    out["timeit"] = {"what": "one config-#5 K4b SpMV (op.matvec)",
                     "repeats": UTILS_TIMEIT_REPEATS, "repr": repr(res),
                     "median_ms": timeit_ms, "best_ms": res.best * 1e3,
                     "event_median_ms": event, "ratio": timeit_ms / event,
                     "call_event_median_ms": call_event,
                     "k4b_launches": launched, "route_turns": turns}
    checks[f"timeit median within [event, {a} x event + {b} ms]"] = \
        event <= timeit_ms <= a * event + b
    checks["timeit and events launched K4b"] = launched > 0

    # (b) config #5, dominant_eigh forward and backward, traced.
    c = torch.randn(op.dim, generator=torch.Generator(device=DEVICE)
                    .manual_seed(9), device=DEVICE) / math.sqrt(op.dim)
    vals = op.vals.detach().clone().requires_grad_(True)
    opg = op.with_vals(vals)
    # Warm (the first λ-only backward of a process pays one-time costs).
    lam_w, v_w = pkg.dominant_eigh(opg, k=20, maxiter=20, device=DEVICE)
    (lam_w + (c * v_w).sum()).backward()
    vals.grad = None
    torch.cuda.synchronize()
    c5_dir = os.path.join(work, "config5")
    before = spmv.launch_counts["bell_spmv_banded_f32"]
    t0 = time.perf_counter()
    with recorded_loop(cg, "_cg_loop") as cg_its, \
            recorded_solves() as solves:
        with utils.trace(c5_dir) as log_dir:
            lam, v = pkg.dominant_eigh(opg, k=K, extreme="min", tol=CG_TOL,
                                       maxiter=CG_MAXITER, v0=v0,
                                       device=DEVICE)
            (lam + (c * v).sum()).backward()
            torch.cuda.synchronize()
    t_traced = time.perf_counter() - t0
    c5_launches = spmv.launch_counts["bell_spmv_banded_f32"] - before
    c5 = read_trace(log_dir)
    cg_products = int(sum(cg_its))
    rhs, xs, sop, sign, slam, sv = solves[0]
    with torch.no_grad():
        cg_rel = float(utils.cg_relative_residual(
            cg._deflated_mv(sop, slam, sv, sign, False),
            cg._project_out(sv, rhs), xs))
    out["config5_trace"] = {**c5, "k": K, "cg_maxiter": CG_MAXITER,
                            "cg_products": cg_products,
                            "backward_solves": len(solves),
                            "cg_relative_residual": cg_rel,
                            "k4b_spmv_launches": c5_launches,
                            "traced_s": t_traced}
    checks.update({
        "config #5: lanczos_matvec == k": c5["ranges"]["lanczos_matvec"] == K,
        "config #5: lanczos_reorth == k": c5["ranges"]["lanczos_reorth"] == K,
        "config #5: cg_matvec == the CG's products":
            c5["ranges"]["cg_matvec"] == cg_products > 0,
        "config #5: a bell_spmv_banded kernel in the trace":
            bool(c5["bell_spmv_banded_kernels"]),
        "config #5: one backward solve": len(solves) == 1,
        "config #5: the capped CG's residual finite":
            math.isfinite(cg_rel),
    })
    lam_f = float(lam.detach())
    del lam, v, lam_w, v_w, vals, opg, solves, rhs, xs, sop, sv
    torch.cuda.empty_cache()

    # (c) the TFIM N = 20 forward-mode pass (the tfim phase's settings),
    # timed untraced before and after its trace.
    tfim_dir = os.path.join(work, "tfim")
    t_before = utils.timeit(lambda: tfim_pass(pkg, models, TFIM_N, f32),
                            repeats=3)
    t0 = time.perf_counter()
    with recorded_loop(cg, "_cg_loop") as tcg_its:
        with utils.trace(tfim_dir) as log_dir:
            e0, de0, chi, _ = tfim_pass(pkg, models, TFIM_N, f32)
    t_tfim = time.perf_counter() - t0
    tf = read_trace(log_dir)
    t_after = utils.timeit(lambda: tfim_pass(pkg, models, TFIM_N, f32),
                           repeats=3, warmup=0)
    tcg = int(sum(tcg_its))
    out["tfim_trace"] = {**tf, "n": TFIM_N, "k": TFIM_K,
                         "reorth_passes": TFIM_REORTH_PASSES,
                         "cg_products": tcg, "traced_s": t_tfim,
                         "pass_ms_before": [t * 1e3 for t in
                                            t_before.times_s],
                         "pass_ms_after": [t * 1e3 for t in
                                           t_after.times_s],
                         "e0": e0, "de0_dg": de0, "chi_f": chi}
    errs, _ = jw_errors(models, TFIM_N, TFIM_G, e0, de0, chi)
    checks.update({
        "TFIM: lanczos_matvec == k": tf["ranges"]["lanczos_matvec"] == TFIM_K,
        "TFIM: lanczos_reorth == k": tf["ranges"]["lanczos_reorth"] == TFIM_K,
        "TFIM: cg_matvec == the tangent CG's products":
            tf["ranges"]["cg_matvec"] == tcg > 0,
        "TFIM: no bicgstab range": tf["ranges"]["bicgstab_matvec"] == 0,
        "TFIM traced pass vs Jordan-Wigner at the tfim bars":
            all(errs[k] <= TFIM_RTOL[k] for k in TFIM_RTOL),
    })

    # (d) lanczos_health of config #5's k = 100 run (same start), and the
    # logger on the card's tensors.
    with torch.no_grad():
        res = pkg.lanczos(op, K, v0=v0, device=DEVICE)
        health = utils.lanczos_health(op, res)
    ritz_min, ritz_max = (float(t) for t in health["ritz_extremes"])
    out["lanczos_health"] = {
        "k": K, "ortho_loss": float(health["ortho_loss"]),
        "ritz_residual_min": float(health["ritz_residual_min"]),
        "ritz_residual_max": float(health["ritz_residual_max"]),
        "breakdowns": int(health["breakdowns"]),
        "ritz_extremes": [ritz_min, ritz_max]}
    log_path = os.path.join(work, "health.jsonl")
    with utils.JsonlLogger(log_path) as log:
        log.log("lanczos_health", ortho_loss=health["ortho_loss"],
                ritz_residual_min=health["ritz_residual_min"],
                ritz_residual_max=health["ritz_residual_max"],
                breakdowns=health["breakdowns"],
                ritz_extremes=torch.stack(health["ritz_extremes"]),
                alphas_bf16=res.alphas[:4].to(torch.bfloat16))
    with open(log_path) as f:
        rec = json.loads(f.read())
    checks.update({
        "health: finite": all(math.isfinite(v) for v in (
            out["lanczos_health"]["ortho_loss"], ritz_min, ritz_max,
            out["lanczos_health"]["ritz_residual_min"],
            out["lanczos_health"]["ritz_residual_max"])),
        "health: no breakdown": out["lanczos_health"]["breakdowns"] == 0,
        "health: its λ_min is the traced solve's, rel 1e-6":
            abs(ritz_min - lam_f) <= 1e-6 * abs(lam_f),
        "logger: CUDA and bf16 tensors logged as numbers":
            rec["event"] == "lanczos_health"
            and rec["ritz_extremes"] == [ritz_min, ritz_max]
            and len(rec["alphas_bf16"]) == 4,
    })
    del res, health

    # (e) the guards: a deliberately short Lanczos is flagged, the TFIM
    # headline solve passes.
    with torch.no_grad():
        _, _, info = pkg.dominant_eigh(op, k=UTILS_SHORT_K, v0=v0,
                                       tol=CG_TOL, with_info=True,
                                       device=DEVICE)
    try:
        utils.assert_converged(info)
        short_msg = None
    except RuntimeError as err:
        short_msg = str(err)
    with torch.no_grad():
        _, _, tinfo = pkg.dominant_eigh(
            models.tfim_operator(TFIM_N, TFIM_G, dtype=f32, device=DEVICE),
            k=TFIM_K, extreme="min", tol=TFIM_CG_TOL,
            maxiter=TFIM_CG_MAXITER, reorth_passes=TFIM_REORTH_PASSES,
            with_info=True, device=DEVICE)
    utils.assert_converged(tinfo, name="TFIM N = 20")
    out["guards"] = {"short_k": UTILS_SHORT_K, "short_message": short_msg,
                     "tfim_residual": float(tinfo.residual),
                     "tfim_converged": float(tinfo.converged)}
    checks[f"assert_converged flags k = {UTILS_SHORT_K} on config #5"] = (
        short_msg is not None and "did not converge" in short_msg)
    # (f) what one named range costs the host with no profiler running,
    # against the ranges a TFIM pass opens.
    def open_ranges(count=10000):
        for _ in range(count):
            with torch.profiler.record_function("lanczos_matvec"):
                pass

    range_us = utils.timeit(open_ranges, repeats=3).median / 10000 * 1e6
    per_pass = sum(tf["ranges"].values())
    out["range_cost"] = {"us_per_range": range_us,
                         "ranges_per_tfim_pass": per_pass,
                         "ms_per_tfim_pass": range_us * per_pass * 1e-3}
    del op, x, c
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    out.update(card=nvidia_smi_name_power(),
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"utils phase failed: {failed}")


def example_summary(name, res):
    """The driver's key numbers against the closed forms it prints, and
    the checks on them: ``(summary, {check: ok})``."""
    from dominantsparseeigenad_tpu_torch import models
    rows = res.get("rows")
    if name == "tfim_ed":
        worst = [max(r["abs_err"][i] for r in rows) for i in range(3)]
        return ({"points": len(rows), "max_abs_err_e0_d1_d2": worst},
                {f"tfim_ed vs Jordan-Wigner within {EX_TFIM_ED_ABS}":
                    all(w <= b for w, b in zip(worst, EX_TFIM_ED_ABS))})
    if name == "tfim_sparse":
        worst = max(r["rel_err_e0"] for r in rows)
        mid = min(rows, key=lambda r: abs(r["g"] - 1.0))
        return ({"points": len(rows), "max_rel_err_e0": worst,
                 "chi_f_near_g1": [mid["g"], mid["chi"]],
                 "per_point_ms": res["per_point_ms"]},
                {f"tfim_sparse E0 vs Jordan-Wigner, rel "
                 f"{EX_TFIM_SPARSE_REL}": worst <= EX_TFIM_SPARSE_REL})
    if name == "heisenberg":
        ferro = [abs(r["e0_per_site"] - r["jz"] / 4) for r in rows
                 if r["jz"] <= -1.0]
        iso = min(rows, key=lambda r: abs(r["jz"] - 1.0))
        bethe = abs(iso["e0_per_site"] - (0.25 - math.log(2.0)))
        return ({"points": len(rows), "ferro_max_abs_err": max(ferro),
                 "e0_per_site_jz1": iso["e0_per_site"], "bethe_abs": bethe},
                {"XXZ E0/N = Jz/4 for Jz <= -1":
                    bool(ferro) and max(ferro) <= EX_XXZ["ferro_abs"],
                 "XXZ E0/N at Jz = 1 vs Bethe":
                    bethe <= EX_XXZ["bethe_abs"]})
    if name == "spectral":
        exact = float(models.tfim_exact_e0(res["n"], res["g"],
                                           device="cpu"))
        err = abs(res["e0"] - exact) / abs(exact)
        return ({"points": len(rows), "e0_rel_err": err,
                 "s_max": max(r["s"] for r in rows),
                 "s_min": min(r["s"] for r in rows)},
                {"spectral E0 vs Jordan-Wigner": err <= EX_SPECTRAL_E0_REL,
                 "spectral S(ω) >= 0": min(r["s"] for r in rows) >= -1e-8})
    if name == "ising2d":
        first = rows[0]
        worst = [max(r["abs_err"][i] for r in rows) for i in range(3)]
        return ({"points": len(rows), "first_beta": first["beta"],
                 "first_abs_err": first["abs_err"],
                 "max_abs_err_lnz_u_cv": worst},
                {f"ising2d at β = {first['beta']} vs Onsager within "
                 f"{EX_ISING_FIRST_ABS}": all(
                     e <= b for e, b in zip(first["abs_err"],
                                            EX_ISING_FIRST_ABS))})
    if name == "transfer_spectrum":
        first = rows[0]
        b = first["beta"]
        onsager = 1.0 / (-math.log(math.tanh(b)) - 2.0 * b)
        err = abs(first["xi"] - onsager) / onsager
        return ({"points": len(rows), "first_beta": b, "xi": first["xi"],
                 "onsager_xi": onsager, "xi_rel_err": err,
                 "dxi": first["dxi"], "lams": first["lams"]},
                {f"transfer ξ vs Onsager, rel {EX_XI_REL}": err <= EX_XI_REL})
    if name == "lobpcg_precond":
        return ({k: res[k] for k in ("iters_precond", "iters_plain", "e0",
                                     "de0_dg", "fd")},
                {"preconditioner cuts LOBPCG's iterations":
                    res["iters_precond"] < res["iters_plain"],
                 "lobpcg dense check ran": "fd" in res})
    if name == "spectrum_slice":
        return ({k: res[k] for k in ("n_inside", "residual", "centroid",
                                     "dcentroid_dg", "fd")},
                {"slice dense check ran": "fd" in res})
    if name == "vibrational_modes":
        return ({k: res[k] for k in ("omega2", "scipy", "iterations", "grad",
                                     "fd")},
                {"chain converged": res["converged"],
                 "chain scipy check ran": "fd" in res})
    if name == "complex_spectrum":
        return ({k: res[k] for k in ("structure", "xi", "wavelength",
                                     "dtheta_dbias")},
                {"dθ/db = 1 within 1e-6": abs(res["dtheta_dbias"] - 1.0)
                 <= 1e-6})
    if name == "sharded_sparse":
        panel = res["panel_launches"]
        local = res["local_square_launches"]
        return ({k: res[k] for k in ("ranks", "lam_sharded", "lam_local",
                                     "grad_max_abs_diff", "grad_norm",
                                     "panel_launches",
                                     "local_square_launches")},
                {"sharded: the ranks' λ equal":
                    len(set(res["lam_sharded_by_rank"])) == 1,
                 "sharded: panel SpMV kernels launched":
                    panel.get("bell_spmv_f32", 0) > 0,
                 "sharded: no square launch on a rank's panel":
                    not res["sharded_square_launches"],
                 "sharded: the local operator launched banded kernels":
                    local.get("bell_spmv_banded_f32", 0) > 0})
    if name == "distributed_lanczos":
        err = abs(res["e0"] - res["exact"]) / abs(res["exact"])
        counts = res["collectives_by_rank"]
        return ({"ranks": res["ranks"], "n": res["n"], "e0": res["e0"],
                 "exact": res["exact"], "e0_rel_err": err,
                 "de0_dg": res["de0_dg"], "steady_ms": res["steady_ms"],
                 "collectives_rank0": counts[0]},
                {f"distributed_lanczos E0 vs Jordan-Wigner, rel "
                 f"{EX_DISTRIBUTED_E0_REL}": err <= EX_DISTRIBUTED_E0_REL,
                 "distributed_lanczos: the ranks' E0 and dE0/dg equal":
                    len(set(res["e0_by_rank"])) == 1
                    and len(set(res["de0_dg_by_rank"])) == 1,
                 "distributed_lanczos: the XOR exchange ran, the same "
                 "collectives on every rank":
                    counts[0]["ppermute"] > 0
                    and all(c == counts[0] for c in counts)})
    raise ValueError(name)


def phase_examples(pkg):
    """The twelve drivers on the card (module docstring, phase 22)."""
    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="examples_", dir=build)
    drivers, checks = {}, {}
    try:
        for name, extra in EXAMPLES:
            mod = importlib.import_module(
                f"dominantsparseeigenad_tpu_torch.examples.{name}")
            args = [*extra, "--device", DEVICE]
            log_path = None
            if name in EXAMPLES_LOGGED:
                log_path = os.path.join(work, f"{name}.jsonl")
                args += ["--log", log_path]
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    res = mod.main(args)
            except SystemExit as err:
                raise AssertionError(
                    f"examples phase: {name} failed its own check: {err}\n"
                    f"{buf.getvalue()[-3000:]}") from err
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            summary, more = example_summary(name, res)
            lines = buf.getvalue().splitlines()
            entry = {"wall_s": wall, "args": args[:-2] if log_path else args,
                     **summary, "printed_lines": len(lines),
                     "last_line": lines[-1] if lines else None}
            if log_path is not None:
                with open(log_path) as f:
                    recs = [json.loads(line) for line in f]
                entry["log_records"] = len(recs)
                more[f"{name}: one log record a point"] = \
                    len(recs) == len(res["rows"])
            more[f"{name}: finite"] = all(
                math.isfinite(v) for v in _floats(res))
            drivers[name] = entry
            checks.update(more)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "examples", "cuts": {n: e for n, e in EXAMPLES if e},
          "drivers": drivers, "card": nvidia_smi_name_power(),
          "phase_s": time.perf_counter() - t_phase})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"examples phase failed: {failed}")


def _floats(obj):
    """Every float in a nest of dicts and lists."""
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _floats(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _floats(v)
    elif isinstance(obj, float):
        yield obj


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
    if sys.argv[1:2] == ["--spmm-turns"]:
        # python3 chip_smoke.py --spmm-turns LABEL=CSRC_DIR ...: this
        # checkout's SpMM against other builds, in turns; no other phase.
        libs = {"this": spmv._library()}
        for arg in sys.argv[2:]:
            label, csrc = arg.split("=", 1)
            libs[label], funcs = kernel_library(spmv, csrc)
            emit({"phase": "build", "library": label, "spmm_ptxas": funcs})
        spmm_turns(spmv, sparse, libs)
        print(nvidia_smi_name_power(), flush=True)
        return
    big = spmv_case(spmv, sparse, *CONFIG5, copy_gbps, seed=1)
    spmv_case(spmv, sparse, *SMALL_SHAPES[0], copy_gbps, seed=2)
    spmv_case(spmv, sparse, *SMALL_SHAPES[1], copy_gbps, seed=3,
              unaligned=True)
    counts, lam_eigh = phase_eigh(pkg, spmv)
    spmm = [spmm_case(spmv, sparse, *shape, r, seed=4 + i,
                      copy_gbps=copy_gbps, unaligned=unaligned)
            for i, (shape, r, unaligned) in enumerate(SPMM_SHAPES)]
    counts.update({k: v for k, v in phase_eigh_multi(pkg, spmv).items()
                   if k.startswith("bell_spmm")})
    big.update(spmm[0])
    # Each SpMM entry's config-#5 rows by r.
    spmm_by_r = {}
    for (shape, r, _), rows in zip(SPMM_SHAPES, spmm):
        if shape == CONFIG5:
            for name, row in rows.items():
                spmm_by_r.setdefault(name, {})[str(r)] = {
                    "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "library_ms": row["library_ms"],
                    "max_abs_err": row["max_abs_err"]}
    panel = phase_panel(spmv, sparse)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    panel_counts = phase_sharded()
    ring_counts, sv_panel_counts, ring_rows = phase_sharded_vectors(pkg,
                                                                    spmv)
    add_counts(panel_counts, sv_panel_counts)
    ss_ring_counts, ss_panel_counts = phase_sharded_solvers(pkg, spmv)
    add_counts(ring_counts, ss_ring_counts)
    add_counts(panel_counts, ss_panel_counts)
    sg_ring_counts, sg_panel_counts = phase_sharded_general(pkg, spmv)
    add_counts(ring_counts, sg_ring_counts)
    add_counts(panel_counts, sg_panel_counts)
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
    cx_rows, cx_counts, cx_panel_counts = phase_complex_bell(pkg, spmv)
    fmt_counts = phase_formats(pkg, spmv, lam_eigh)
    counts = {k: counts[k] + fmt_counts[k] for k in counts}
    torch.cuda.empty_cache()
    rs_counts = phase_restart(pkg, spmv, lam_eigh)
    counts = {k: counts[k] + rs_counts[k] for k in counts}
    gen_counts = phase_gen(pkg, spmv)
    counts = {k: counts[k] + gen_counts[k] for k in counts}
    torch.cuda.empty_cache()
    add_counts(counts, phase_spectral(pkg, spmv))
    phase_models(pkg)
    phase_utils(pkg, spmv, big["bell_spmv_banded_f32"])
    phase_examples(pkg)

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
        if spmm_kernel:
            kernels[-1]["by_r"] = spmm_by_r[name]
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
        if kind == "spmm":
            kernels[-1]["by_r"] = {
                str(r): {"ms": rr["kernel_ms"], "plain_ms": rr["plain_ms"],
                         "bound_ms": rr["bound_ms"],
                         "library_ms": rr["library_ms"],
                         "max_abs_err": rr["max_abs_err"]}
                for r, rr in ((PANEL_R, row),
                              (16, panel[(name, SHARDED_RANKS, 16)]))}
    # K1 and K3 on the ring buckets (sharded_vectors): each offset's bucket
    # against the segment in hand; the JAX ring multiplies its buckets on
    # its XLA path (parallel/sharded_sparse.py:259-266).
    for kind in ("spmv", "spmm"):
        name = f"bell_{kind}_f32"
        if ring_counts.get(name, 0) < 1:
            raise AssertionError(f"{name} never launched on a ring bucket in "
                                 f"the sharded_vectors run")
        row = ring_rows[name]
        kernels.append({"name": f"bell_{kind}_ring_f32", "route": "cuda",
                        "source": csrc + f"bell_{kind}.cu",
                        "replaces": "dominantsparseeigenad_tpu/parallel/"
                                    "sharded_sparse.py:259",
                        "launches": ring_counts[name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    # K5 and K6: complex64 values, on the complex_bell phase's counted
    # paths (square: its main path and twins; panels: its two ranks).
    # The JAX package multiplies complex blocks on its XLA path only.
    xla = {"spmv": "dominantsparseeigenad_tpu/ops/sparse.py:337",
           "spmm": "dominantsparseeigenad_tpu/ops/sparse.py:364",
           "panel": "dominantsparseeigenad_tpu/parallel/sharded_sparse.py:206"}
    for name, row_name, banded, launches in (
            ("bell_spmv_c64", "bell_spmv_c64", False,
             cx_counts["bell_spmv_c64"]),
            ("bell_spmv_banded_c64", "bell_spmv_c64", True,
             cx_counts["bell_spmv_banded_c64"]),
            ("bell_spmm_c64", "bell_spmm_c64", False,
             cx_counts["bell_spmm_c64"]),
            ("bell_spmm_banded_c64", "bell_spmm_c64", True,
             cx_counts["bell_spmm_banded_c64"]),
            ("bell_spmv_panel_c64", "bell_spmv_panel_c64", False,
             cx_panel_counts["bell_spmv_c64"]),
            ("bell_spmm_panel_c64", "bell_spmm_panel_c64", False,
             cx_panel_counts["bell_spmm_c64"])):
        if launches < 1:
            raise AssertionError(f"{name} never launched on the "
                                 f"complex_bell path")
        kind = "spmm" if "spmm" in name else "spmv"

        def entry(row):
            if banded:
                return {"max_abs_err": row["banded_max_abs_err"],
                        "ms": row["banded_ms"],
                        "plain_ms": row["banded_plain_ms"]}
            return {"max_abs_err": row["max_abs_err"],
                    "ms": row["kernel_ms"], "plain_ms": row["plain_ms"]}

        row = cx_rows[row_name]
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + f"bell_{kind}.cu",
                        "replaces": xla["panel" if "panel" in name
                                        else kind],
                        "launches": launches, **entry(row),
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
        if "by_r" in row:
            kernels[-1]["by_r"] = {
                str(r): {**entry(rr), "bound_ms": rr["bound_ms"],
                         "library_ms": rr["library_ms"]}
                for r, rr in row["by_r"].items()}
    emit({"kernels": kernels})
    print(nvidia_smi_name_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
