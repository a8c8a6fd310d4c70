"""Differentiable dominant eigensolver for symmetric operators.

Counterpart of ``dominant_eigh`` and ``dominant_eigh_multi`` in
``dominantsparseeigenad_tpu/ops/eigh.py``.  The JAX package
registers the implicit-function-theorem rule as a JVP,

    dλ = v^T (dA) v,
    (A - λI) dv = -(I - v v^T) (dA) v,   v^T dv = 0,

and lets JAX transpose it.  Here the transpose is written out as the
backward of a ``torch.autograd.Function``, the design of the reference's
``DominantSymeig``: given the cotangents (λ̄, v̄),

    x = solve_deflated(A, λ, v, -(I - v v^T) v̄),   u = λ̄ v + x,

and the gradient of every operator parameter θ is ``u^T (∂A/∂θ) v``, taken
as ``torch.autograd.grad`` of one matvec ``A(θ) v`` with ``u`` as its
output cotangent, v held constant (``operators.partial_vjp``): one
matvec's cost, with no N×N matrix built.

The rules work to any order.  The backward is built of differentiable
operations on the saved (λ, v), of the differentiable deflated solve of
``cg.py`` (whose own backward is one more solve) and of that one
product; so under ``torch.autograd.grad(..., create_graph=True)`` it
records a graph, and the cotangents of the saved λ and v flow back into
this same rule (the JAX package's "recursive -> higher order OK").  No
derivative is ever taken through the Lanczos, LOBPCG or CG iterations.
An output the loss does not use brings no cotangent: the backward of
``λ`` alone runs no solve.

The block solver :func:`dominant_eigh_multi` (the r extremal pairs, by
one Lanczos sweep or by LOBPCG) has the block counterpart of that rule:
for cotangents (λ̄ (r,), V̄ (N, r)), with ``W = V^T V̄`` and the broadened
gap inverses ``F[j, i] = g / (g² + gap_eps²)``, ``g = λ_i - λ_j``,
``F[i, i] = 0``,

    G = diag(λ̄) + F ∘ W,
    X[:, i] = solve_deflated(A, λ_i, V, -(I - V V^T) V̄[:, i]),
    U = V G + X,

deflated on span(V)⊥ (the whole block, so a cluster inside it stays
well conditioned) and solved by the batched CG of ``cg.py``, one matmat
per iteration; the gradient is ``autograd.grad`` of one ``A(θ) V`` with
output cotangent U.  This is the transpose of the JAX package's
``_multi_pair_tangents``.

Forward mode is that JVP rule itself, the JAX package's ``_pair_jvp``
and ``_multi_pair_tangents``, as the ``jvp`` of the same Functions:
under ``torch.func.jvp`` (or ``torch.autograd.forward_ad``), with
tangents on the operator's parameters,

    dA v = op.tangent_matvec(v, dθ),   dλ = v^T (dA v),
    dv = solve_deflated(A, λ, v, -(dA v - dλ v)),

one tangent product (on a ``BellOperator`` the same kernel as a matvec;
``tangent_matmat`` and one SpMM for a block) and one deflated solve
(batched over the block's columns).  The Lanczos and LOBPCG loops carry
no tangents: forward AD is off inside a custom Function's forward.
The rule is built of this module's Functions, the deflated solve's and
the operator's tangent product, each with its own ``jvp`` and
differentiable backward, so under nested ``torch.func.jvp`` it
differentiates again (``operators.nestable_jvp`` runs it one level down
with forward grad on): forward mode to any order, as the JAX package
nests ``jax.jvp``, and ``hessian``, ``jacfwd∘jacrev`` and
``grad∘jvp`` mix the two modes.  Every rule rebuilds the operator from
the parameters it is handed (``rebind``), never from tensors the
operator object holds.  ``torch.func.vmap`` runs each lane's solve on
its own (``operators.per_lane_vmap``): the Lanczos and LOBPCG loops read
the host.

The forward of :func:`dominant_eigh` runs the options of the JAX
``_forward``: ``restart_cycles`` (thick restart, ``restart.py``, whose
(k+1, N) window bounds the memory), ``early_exit_tol``
(``lanczos_adaptive``), a narrow ``basis_dtype`` with its one-step Newton
polish (:func:`refine_eigenpair`, inside the Function's forward, so it
records no graph), ``reorth_chunks`` and ``restart_mode``.  The rules
need only the converged pair, whichever engine found it.  ``precond``
reaches every deflated solve of the rules, of either solver, and the
LOBPCG forward of the block solver.

Complex Hermitian operators: λ and dλ = Re<v, dA v> are real, every
transpose above is a conjugate transpose, and the forward's pivot gauge
(the largest-magnitude entry of each eigenvector real and positive)
enters the rules.  The raw IFT tangent keeps <v, dv> = 0, which fixes
dv's phase the wrong way; the JAX package's ``_pivot_phase_project``
shifts it along i v so that the pivot entry stays real:

    dv += i α v,   α = -Im(dv[p]) / v[p].

The backward applies the transpose of that shift to the cotangent,

    v̄ += i (Im<v̄, v> / v[p]) e_p,

before the deflated solve (column by column for the block rule).  For a
real dtype both are the identity.  PyTorch's gradient of a complex
tensor is the conjugate of JAX's cotangent; the rules above are written
for PyTorch's.

Sharded vectors (``operators.vector_layout``, the row-sharded operators
with ``vectors="sharded"``): v, V, their cotangents and tangents are the
rank's rows, and every inner product over the vector axis above (V^H X,
<v, v̄>, the pivot) is summed over the ranks; λ and those sums are the
same on every rank.  A replicated value that enters the rank's rows (λ,
λ̄, a sum) is marked there (``layout.bcast``), so that a second
backward sums its gradient over the ranks that used it.  Every forward
and option runs there: the Lanczos and LOBPCG forwards, thick restart,
the early exit, a narrow basis with its polish, restart mode "carry",
``with_info``, and a preconditioner, whose apply is row-local.
"""

from __future__ import annotations

import dataclasses

import torch

from .cg import solve_deflated
from .lanczos import (LanczosInfo, _tridiagonal_eigh, lanczos,
                      lanczos_adaptive, lanczos_eigh)
from .lobpcg import lobpcg_eigh
from .operators import (_reduced, as_operator, check_device, hdot, hmatmul,
                        layout_bcast, layout_norm, layout_sum, nestable_jvp,
                        partial_vjp, per_lane_vmap, pivot_gauge, rebind,
                        tol_floor, vector_layout)
from .precond import _apply_columns
from .restart import lanczos_restarted
from .spans import span


@dataclasses.dataclass(frozen=True)
class EighOptions:
    """Configuration of :func:`dominant_eigh`."""

    k: int = 128
    extreme: str = "min"
    tol: float = 1e-8
    maxiter: int | None = None
    reorthogonalize: bool = True
    reorth_passes: int = 2
    reorth_chunks: int = 0
    restart_cycles: int = 0
    early_exit_tol: float | None = None
    basis_dtype: torch.dtype | None = None
    restart_mode: str = "cond"
    # An SPD approximate inverse z = M^{-1} r for the deflated solves.
    precond: object = None


def _pair_info(op, opts, lam, v):
    """The :class:`LanczosInfo` of one pair (the JAX ``_forward_info``
    of the plain fixed-k forward): the true Ritz residual ``||A v - λ v||
    / |λ|`` from one extra matvec, ``converged`` against ``tol`` clamped
    to what the dtype reaches, ``effective_k`` the steps run (the
    restart tier: k, then k - max(1, k // 4) a cycle)."""
    resid = layout_norm(vector_layout(op), op.matvec(v) - lam * v) \
        / torch.clamp(lam.abs(), min=torch.finfo(v.dtype).tiny)
    k = min(opts.k, op.dim)
    steps = k + max(opts.restart_cycles, 0) * (k - max(1, k // 4))
    return LanczosInfo(
        effective_k=torch.tensor(float(steps), dtype=resid.dtype,
                                 device=v.device),
        residual=resid,
        converged=(resid <= tol_floor(opts.tol, op.dtype)).to(resid.dtype))


def _pivots(v):
    """The pivot index of each column of ``v`` (an (N,) vector or an
    (N, r) block): its largest-magnitude entry, real and positive after
    :func:`~.operators.pivot_gauge`."""
    return torch.argmax(torch.abs(v), dim=0)


def _pivot_phase_project(v, dv, layout=None):
    """The JAX package's ``_pivot_phase_project``: ``dv + i α v`` with
    ``α = -Im(dv[p]) / v[p]`` per column, the tangent that keeps each
    pivot entry real (the forward's gauge); the identity for a real
    dtype."""
    if not v.is_complex():
        return dv
    if layout is not None:
        idx, _ = layout.pivot(v)
        alpha = -layout.take(dv, idx).imag / layout.take(v, idx).real
        alpha = layout.bcast(alpha)
        return dv + 1j * (alpha if v.ndim == 1 else alpha[None, :]) * v
    idx = _pivots(v)
    if v.ndim == 1:
        alpha = -dv[idx].imag / v[idx].real
    else:
        alpha = (-torch.gather(dv, 0, idx[None])[0].imag
                 / torch.gather(v, 0, idx[None])[0].real)
    return dv + 1j * alpha * v


def _pivot_phase_cotangent(v, v_bar, layout=None):
    """The transpose of :func:`_pivot_phase_project` applied to the
    cotangent ``v̄`` (PyTorch's convention): ``v̄ + i (Im<v̄, v> / v[p])
    e_p`` per column, so that ``Re<v̄, P dv> = Re<P^T v̄, dv>``; the
    identity for a real dtype."""
    if not v.is_complex():
        return v_bar
    if layout is not None:
        idx, _ = layout.pivot(v)
        inner = hdot(v_bar, v) if v.ndim == 1 \
            else (v_bar.conj() * v).sum(dim=0)
        c = layout.bcast(layout.sum(inner).imag / layout.take(v, idx).real)
        e = layout.one_hot(idx, v.dtype)
        return v_bar + 1j * (c if v.ndim == 1 else c[None, :]) * e
    idx = _pivots(v)
    if v.ndim == 1:
        c = hdot(v_bar, v).imag / v[idx].real
        return v_bar + 1j * c * torch.nn.functional.one_hot(
            idx, v.shape[0]).to(v.dtype)
    c = ((v_bar.conj() * v).sum(dim=0).imag
         / torch.gather(v, 0, idx[None])[0].real)
    e = torch.nn.functional.one_hot(idx, v.shape[0]).T.to(v.dtype)
    return v_bar + 1j * c[None, :] * e


def _signs(extreme):
    """The definite sign of each pair's deflated solve: +1 for the
    minimum, -1 for the maximum."""
    return {"min": (1.0,), "max": (-1.0,), "both": (1.0, -1.0)}[extreme]


def _forward(op, opts, v0, generator):
    """``(pairs, info)``: the pair(s) of the JAX ``_forward``, and
    ``lanczos_adaptive``'s own report under ``early_exit_tol`` (None
    otherwise: the caller measures the true residual)."""
    k = min(opts.k, op.dim)
    if opts.restart_cycles > 0:
        lam, v, _ = lanczos_restarted(
            op, k, n_restarts=opts.restart_cycles, extreme=opts.extreme,
            v0=v0, generator=generator, reorth_passes=opts.reorth_passes,
            device=op.device)
        return (lam, v), None
    if opts.early_exit_tol is not None:
        lam, v, info = lanczos_adaptive(
            op, k, extreme=opts.extreme, tol=opts.early_exit_tol, v0=v0,
            generator=generator, reorthogonalize=opts.reorthogonalize,
            reorth_passes=opts.reorth_passes, device=op.device)
        return (lam, v), info
    out = lanczos_eigh(op, k, extreme=opts.extreme, v0=v0,
                       generator=generator,
                       reorthogonalize=opts.reorthogonalize,
                       reorth_passes=opts.reorth_passes,
                       reorth_chunks=opts.reorth_chunks,
                       basis_dtype=opts.basis_dtype,
                       restart_mode=opts.restart_mode, device=op.device)
    if opts.basis_dtype in (None, op.dtype):
        return out, None
    # A narrow basis leaves its storage rounding (~eps_bf16 / sqrt(3) in
    # norm) in the Ritz vector: one Newton step against the operator in
    # its own precision (quadratic: ~4e-3 -> ~1e-6 residual) cleans the
    # pair the IFT tangents use; then the pivot gauge again.
    polished = []
    for sign, lam, v in zip(_signs(opts.extreme), out[::2], out[1::2]):
        lam, v = refine_eigenpair(op, lam, v, iters=1, tol=opts.tol,
                                  maxiter=opts.maxiter, definite_sign=sign,
                                  device=op.device)
        polished += [lam, pivot_gauge(v, layout=vector_layout(op))]
    return tuple(polished), None


@per_lane_vmap
class _DominantEigh(torch.autograd.Function):
    """Outputs ``(λ, v)`` per pair (one, or two for "both", the minimum
    first), then the three :class:`LanczosInfo` fields with
    ``with_info``."""

    @staticmethod
    def forward(op, opts, v0, generator, with_info, *params):
        op = rebind(op, params)
        out, info = _forward(op, opts, v0, generator)
        # λ is a view into the tridiagonal's eigenvalues: forward mode
        # needs outputs that are not views of other tensors.
        pairs = [t.clone() if i % 2 == 0 else t for i, t in enumerate(out)]
        if not with_info:
            info = ()
        elif info is None:
            info = _pair_info(op, opts, *pairs)
        return (*pairs, *info)

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, opts, _, _, with_info, *params = inputs
        ctx.op, ctx.opts = op, opts
        ctx.n_info = 3 if with_info else 0
        pairs = output[:len(output) - ctx.n_info]
        ctx.save_for_backward(*pairs, *params)
        ctx.save_for_forward(*pairs, *params)
        ctx.mark_non_differentiable(*output[len(pairs):])
        # An output the loss does not use brings no cotangent (None),
        # and costs no deflated solve.
        ctx.set_materialize_grads(False)

    @staticmethod
    def _saved(ctx):
        """``(op, pairs)``: the operator rebuilt on the saved parameters
        and the saved (λ, v) pairs."""
        saved = ctx.saved_tensors
        n = 4 if ctx.opts.extreme == "both" else 2
        return rebind(ctx.op, saved[n:]), saved[:n]

    @staticmethod
    @nestable_jvp
    def jvp(ctx, _op, _opts, _v0, _generator, _with_info, *dparams):
        """The IFT tangents (dλ, dv) of each pair for the parameters'
        tangents ``dparams`` (the JAX package's ``_pair_jvp``); zero
        tangents for the info fields (None: PyTorch's zero tangent of an
        output marked non-differentiable)."""
        with span("ift_jvp"):
            opts = ctx.opts
            op, pairs = _DominantEigh._saved(ctx)
            layout = vector_layout(op)
            moving = any(t is not None for t in dparams)
            tangents = []
            for sign, lam, v in zip(_signs(opts.extreme), pairs[::2],
                                    pairs[1::2]):
                if not moving:
                    tangents += [torch.zeros_like(lam), torch.zeros_like(v)]
                    continue
                dav = op.tangent_matvec(v, dparams)
                # <v, dA v> is real for a Hermitian dA, as λ is.
                dlam = layout_sum(layout, hdot(v, dav)).real
                dv = solve_deflated(op, lam, v,
                                    -(dav - layout_bcast(layout, dlam) * v),
                                    definite_sign=sign, tol=opts.tol,
                                    maxiter=opts.maxiter,
                                    precond=opts.precond, device=op.device)
                tangents += [dlam, _pivot_phase_project(v, dv, layout)]
            return (*tangents, *(None,) * ctx.n_info)

    @staticmethod
    def backward(ctx, *bars):
        with span("ift_backward"):
            opts = ctx.opts
            op, pairs = _DominantEigh._saved(ctx)
            layout = vector_layout(op)
            grads = [None] * len(op.parameters())
            for sign, lam, v, lam_bar, v_bar in zip(
                    _signs(opts.extreme), pairs[::2], pairs[1::2],
                    bars[0::2], bars[1::2]):
                if lam_bar is None and v_bar is None:
                    continue
                # u = λ̄ v + x, x = solve_deflated(A, λ, v, -(I - v v^H)
                # v̄); a pair whose v̄ never arrived needs no solve.
                u = torch.zeros_like(v) if lam_bar is None \
                    else layout_bcast(layout, lam_bar) * v
                if v_bar is not None:
                    v_bar = _pivot_phase_cotangent(v, v_bar, layout)
                    b = -(v_bar - v * _reduced(layout, hdot(v, v_bar)))
                    u = u + solve_deflated(op, lam, v, b, definite_sign=sign,
                                           tol=opts.tol,
                                           maxiter=opts.maxiter,
                                           precond=opts.precond,
                                           device=op.device)
                # u^H (dA/dθ) v: differentiate one matvec A(θ) v with
                # output cotangent u, v held constant (under create_graph
                # v's own history stays in the graph: "recursive, so
                # higher order").
                got = partial_vjp(op, lambda held: held.matvec(v), [], u,
                                  ctx.needs_input_grad[5:])
                grads = [g if h is None else h if g is None else g + h
                         for g, h in zip(grads, got)]
            return (None, None, None, None, None, *grads)


def dominant_eigh(op, k: int = 128, *, extreme: str = "min",
                  tol: float = 1e-8, maxiter: int | None = None,
                  seed: int = 0, reorthogonalize: bool = True,
                  reorth_passes: int = 2, reorth_chunks: int = 0,
                  restart_cycles: int = 0,
                  early_exit_tol: float | None = None,
                  with_info: bool = False, precond=None, basis_dtype=None,
                  restart_mode: str = "cond",
                  v0: torch.Tensor | None = None,
                  generator: torch.Generator | None = None, device=None):
    """Extremal eigenpair(s) of a symmetric operator, differentiable to
    any order in ``op.parameters()``: reverse mode (``backward``, and
    ``torch.autograd.grad(..., create_graph=True)`` again and again),
    forward mode (``torch.func.jvp``, nested to any order, or
    ``torch.autograd.forward_ad`` dual tensors among the parameters),
    the ``torch.func`` transforms that mix them, and ``vmap`` (see the
    module docstring).

    op      : LinearOperator, or a dense symmetric tensor.
    k       : Lanczos steps (clamped to ``op.dim``).
    extreme : "min", "max", or "both" (one Lanczos run, both pairs).
    tol     : relative residual tolerance of the deflated CG of the
              backward (or of the forward-mode tangent, or of the polish);
              ``maxiter`` bounds its iterations (default 10 N).
    seed    : seeds the Lanczos start/restart generator when ``generator``
              is None; ``v0`` gives the start vector explicitly.
    reorth_chunks, restart_mode : as in :func:`~.lanczos.lanczos`.
    restart_cycles : when > 0 ("min"/"max"), the forward is
              :func:`~.restart.lanczos_restarted` with a window of ``k``
              and this many restart cycles: memory bounded by the
              (k+1, N) window, not by the steps run.
    early_exit_tol : when set ("min"/"max"), the forward is
              :func:`~.lanczos.lanczos_adaptive`, which stops once its
              Ritz residual estimate meets this relative tolerance.
    precond : an SPD approximate inverse ``z = M^{-1} r`` (vector
              convention, e.g. :func:`~.precond.jacobi_precond`) used,
              projected, by every deflated solve of the derivative rules.
    basis_dtype : storage dtype of the Lanczos basis (e.g.
              ``torch.bfloat16`` on a float32 operator): the eigenvalue
              comes from the full-precision tridiagonal, and the
              eigenvector is polished by one Newton step of
              :func:`refine_eigenpair` (CG at ``tol``, ``maxiter``).
              Plain fixed-k forward only.
    with_info : also return a :class:`~.lanczos.LanczosInfo` (effective
              k, the true Ritz residual ``||A v - λ v|| / |λ|`` from one
              extra matvec, a converged flag against ``tol``; under
              ``early_exit_tol`` the adaptive run's own report), with zero
              tangents and no gradient; "min" or "max" only.
    device  : where the solve runs (CUDA when None); the operator must
              live there.

    Returns ``(λ, v)``, ``(λ, v, info)`` with ``with_info``, or
    ``(λmin, vmin, λmax, vmax)`` for "both".  ``v`` is normalized and
    pivot-gauged (largest-magnitude entry real and positive).
    """
    if extreme not in ("min", "max", "both"):
        raise ValueError(f"extreme must be min|max|both, got {extreme!r}")
    # The JAX package's guards, with its messages.
    if restart_cycles and extreme == "both":
        raise ValueError("restart_cycles requires extreme='min' or 'max'")
    if restart_cycles and early_exit_tol is not None:
        raise ValueError("early_exit_tol is not supported with "
                         "restart_cycles (the restart loop has its own "
                         "convergence control)")
    if int(reorth_chunks) > 1 and (restart_cycles
                                   or early_exit_tol is not None):
        raise ValueError("reorth_chunks is only implemented for the "
                         "plain fixed-k forward; it would be silently "
                         "ignored with restart_cycles/early_exit_tol")
    if (with_info or early_exit_tol is not None) and extreme == "both":
        raise ValueError("with_info/early_exit_tol require extreme='min' "
                         "or 'max'")
    if basis_dtype is not None and (restart_cycles
                                    or early_exit_tol is not None):
        raise ValueError("basis_dtype is only implemented for the plain "
                         "fixed-k forward (it would be silently ignored "
                         "with restart_cycles/early_exit_tol)")
    if restart_mode != "cond" and (restart_cycles
                                   or early_exit_tol is not None):
        raise ValueError("restart_mode is only implemented for the plain "
                         "fixed-k forward (it would be silently ignored "
                         "with restart_cycles/early_exit_tol)")
    op = as_operator(op)
    dev = check_device(device, op)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    opts = EighOptions(k=int(k), extreme=extreme, tol=float(tol),
                       maxiter=None if maxiter is None else int(maxiter),
                       reorthogonalize=bool(reorthogonalize),
                       reorth_passes=int(reorth_passes),
                       reorth_chunks=int(reorth_chunks),
                       restart_cycles=int(restart_cycles),
                       early_exit_tol=None if early_exit_tol is None
                       else float(early_exit_tol),
                       basis_dtype=basis_dtype, restart_mode=restart_mode,
                       precond=precond)
    out = _DominantEigh.apply(op, opts, v0, generator, bool(with_info),
                              *op.parameters())
    if with_info:
        return out[0], out[1], LanczosInfo(*out[2:])
    return out


def refine_eigenpair(op, lam, v, *, iters: int = 2, tol: float = 1e-12,
                     maxiter: int | None = None,
                     definite_sign: float | None = None, device=None):
    """Newton refinement of a symmetric eigenpair against ``op`` in its
    own (target) precision: each step is a Rayleigh quotient and one
    deflated solve of ``(A - λ) dv = -(A v - λ v)`` on v⊥, by CG with
    ``definite_sign`` (+1 for the algebraic minimum, -1 for the maximum)
    or by MINRES when it is None (any eigenvalue, interior too).
    Convergence is quadratic: ``iters=2`` takes a float32-accurate pair
    to float64 round-off.  ``lam`` and ``v`` are cast to the operator's
    dtype; built of differentiable operations.

    Returns ``(lam, v)``: ``lam`` real (the operator's real dtype), ``v``
    in the operator's dtype, ``||v|| = 1``.  Over sharded vectors ``v``
    is the rank's rows, and the norms and Rayleigh quotients are the
    whole vector's.
    """
    op = as_operator(op)
    dev = check_device(device, op)
    layout = vector_layout(op)
    v = torch.as_tensor(v).to(device=dev, dtype=op.dtype)
    v = v / layout_bcast(layout, layout_norm(layout, v))
    method = "minres" if definite_sign is None else "cg"
    sign = 1.0 if definite_sign is None else float(definite_sign)
    for _ in range(int(iters)):
        av = op.matvec(v)
        lam = layout_sum(layout, hdot(v, av)).real
        dv = solve_deflated(op, lam, v,
                            -(av - layout_bcast(layout, lam) * v),
                            definite_sign=sign, method=method, tol=tol,
                            maxiter=maxiter, device=dev)
        v = v + dv
        v = v / layout_bcast(layout, layout_norm(layout, v))
    return layout_sum(layout, hdot(v, op.matvec(v))).real, v


@dataclasses.dataclass(frozen=True)
class EighMultiOptions:
    """Configuration of :func:`dominant_eigh_multi`."""

    r: int = 4
    k: int = 128
    extreme: str = "min"
    tol: float = 1e-8
    maxiter: int | None = None
    reorth_passes: int = 2
    reorth_chunks: int = 0
    gap_eps: float = 1e-12
    method: str = "lanczos"
    # An SPD approximate inverse (vector convention) for the LOBPCG
    # forward, column by column, and the deflated solves.
    precond: object = None


def _lobpcg_precond(opts):
    """The preconditioner of :class:`EighMultiOptions`, applied column by
    column to LOBPCG's (N, r) residual block (the JAX ``_columnwise``)."""
    return None if opts.precond is None else _apply_columns(opts.precond)


def _multi_forward(op, opts, v0, generator):
    """``(lams, V)``: the r extremal pairs, V pivot-gauged."""
    if opts.method == "lobpcg":
        # LOBPCG iterations are not bounded by the dimension: k is the
        # iteration cap, unclamped.
        return lobpcg_eigh(op, opts.r, extreme=opts.extreme,
                           maxiter=opts.k, tol=opts.tol, x0=v0,
                           generator=generator,
                           precond=_lobpcg_precond(opts), device=op.device)
    k = min(opts.k, op.dim)
    res = lanczos(op, k, v0=v0, generator=generator,
                  reorth_passes=opts.reorth_passes,
                  reorth_chunks=opts.reorth_chunks, device=op.device)
    evals, evecs = _tridiagonal_eigh(res.alphas, res.betas)
    idx = torch.arange(opts.r, device=evals.device)
    if opts.extreme == "max":
        idx = k - 1 - idx
    y = evecs[:, idx].to(res.basis.dtype)
    return evals[idx], pivot_gauge(hmatmul(res.basis, y),
                                   layout=vector_layout(op))


def _multi_forward_info(op, opts, v0, generator):
    """Forward with its :class:`LanczosInfo`: the max-over-block Ritz
    residual ``||A v - lam v|| / max(|lam|, 1)``, the LOBPCG stopping
    convention.  LOBPCG reports its own (``effective_k`` = iterations
    run, no extra matmat); the Lanczos sweep pays one width-r matmat."""
    if opts.method == "lobpcg":
        lams, v, linfo = lobpcg_eigh(
            op, opts.r, extreme=opts.extreme, maxiter=opts.k, tol=opts.tol,
            x0=v0, generator=generator, precond=_lobpcg_precond(opts),
            with_info=True, device=op.device)
        return lams, v, LanczosInfo(effective_k=linfo.iterations,
                                    residual=linfo.residual,
                                    converged=linfo.converged)
    lams, v = _multi_forward(op, opts, v0, generator)
    resid = layout_norm(vector_layout(op), op.matmat(v) - v * lams[None, :],
                        dim=0)
    resid = torch.max(resid / torch.clamp(lams.abs(), min=1.0))
    ref_tol = tol_floor(opts.tol, op.dtype)
    return lams, v, LanczosInfo(
        effective_k=torch.tensor(float(min(opts.k, op.dim)),
                                 dtype=lams.dtype, device=v.device),
        residual=resid, converged=(resid <= ref_tol).to(lams.dtype))


def _gap_inverses(lams, opts):
    """F[j, i] = g / (g² + gap_eps²), g = λ_i - λ_j, F[i, i] = 0: the
    in-block rotations, finite on multiplets and exact for separated
    pairs (differentiable in the saved λ)."""
    gap = lams[None, :] - lams[:, None]
    f = gap / (gap * gap + opts.gap_eps ** 2)
    return f * (1.0 - torch.eye(opts.r, dtype=f.dtype, device=f.device))


def _block_tangents(op, lams, v, dparams, opts, solve):
    """The block IFT tangents ``(dλ, dV)`` of the pairs ``(lams, v)``
    along the parameters' tangents ``dparams`` (the JAX package's
    ``_multi_pair_tangents``): with ``M = V^H dA V``,

        dλ = Re diag(M),
        dV = V (F ∘ M) + solve(-(dA V - V M)),

    then the pivot-phase projection of each column; ``solve`` is the
    batched deflated solve on span(V)⊥ (CG for an extremal block, MINRES
    for an interior one)."""
    layout = vector_layout(op)
    dav = op.tangent_matmat(v, dparams)
    m = layout_sum(layout, hmatmul(v.mH, dav))
    dlams = torch.diagonal(m).real.clone()
    m_rows = layout_bcast(layout, m)
    dv_out = solve(-(dav - hmatmul(v, m_rows)))
    gaps = _gap_inverses(layout_bcast(layout, lams), opts)
    dv = hmatmul(v, gaps.to(m.dtype) * m_rows) + dv_out
    return dlams, _pivot_phase_project(v, dv, layout)


def _block_cotangent(lams, v, lams_bar, v_bar, opts, solve, layout=None):
    """The transpose of :func:`_block_tangents`: the U whose ``U^H (∂A/∂θ)
    V`` is each parameter's gradient, for cotangents ``(λ̄, V̄)`` (either
    may be None),

        U = V (diag(λ̄) + F ∘ (V^H V̄')) + solve(-(I - V V^H) V̄'),

    ``V̄'`` the cotangent after the pivot-phase transpose."""
    g = (torch.zeros((opts.r, opts.r), dtype=v.dtype, device=v.device)
         if lams_bar is None else torch.diag(lams_bar).to(v.dtype))
    u = hmatmul(v, layout_bcast(layout, g))
    if v_bar is not None:
        v_bar = _pivot_phase_cotangent(v, v_bar, layout)
        gaps = _gap_inverses(layout_bcast(layout, lams), opts)
        u = u + hmatmul(v, gaps.to(v.dtype)
                        * _reduced(layout, hmatmul(v.mH, v_bar)))
        # Out-of-block part: one deflated solve per pair on span(V)⊥,
        # batched over the r columns.
        u = u + solve(-(v_bar - hmatmul(
            v, _reduced(layout, hmatmul(v.mH, v_bar)))))
    return u


@per_lane_vmap
class _DominantEighMulti(torch.autograd.Function):
    """Outputs ``(λ (r,), V (N, r))``, then the three
    :class:`LanczosInfo` fields with ``with_info``."""

    @staticmethod
    def forward(op, opts, v0, generator, with_info, *params):
        op = rebind(op, params)
        if with_info:
            lams, v, info = _multi_forward_info(op, opts, v0, generator)
            return (lams, v, *info)
        return _multi_forward(op, opts, v0, generator)

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, opts, _, _, with_info, *params = inputs
        ctx.op, ctx.opts = op, opts
        ctx.n_info = 3 if with_info else 0
        ctx.save_for_backward(*output[:2], *params)
        ctx.save_for_forward(*output[:2], *params)
        ctx.mark_non_differentiable(*output[2:])
        ctx.set_materialize_grads(False)

    @staticmethod
    def _saved(ctx):
        lams, v, *params = ctx.saved_tensors
        return rebind(ctx.op, params), lams, v

    @staticmethod
    @nestable_jvp
    def jvp(ctx, _op, _opts, _v0, _generator, _with_info, *dparams):
        """The block IFT tangents (the JAX package's
        ``_multi_pair_tangents``): with ``M = V^H dA V``,

            dλ = Re diag(M),
            dV = V (F ∘ M) + X,  X[:, i] = solve_deflated(A, λ_i, V,
                                            -(dA V - V M)[:, i]),

        then the pivot-phase projection of each column (the identity for
        real dtypes): one tangent product ``dA V`` (on a ``BellOperator``
        one SpMM on the tangent values) and one batched deflated solve.
        The info fields get zero tangents (None, as in
        :class:`_DominantEigh`)."""
        with span("ift_jvp"):
            op, lams, v = _DominantEighMulti._saved(ctx)
            info = (None,) * ctx.n_info
            if all(t is None for t in dparams):
                return (torch.zeros_like(lams), torch.zeros_like(v), *info)
            return (*_block_tangents(op, lams, v, dparams, ctx.opts,
                                     _DominantEighMulti._solve(ctx, op,
                                                               lams, v)),
                    *info)

    @staticmethod
    def _solve(ctx, op, lams, v):
        """The batched deflated CG of the rules, with the block's sign."""
        opts = ctx.opts
        sign = 1.0 if opts.extreme == "min" else -1.0
        return lambda b: solve_deflated(
            op, lams, v, b, definite_sign=sign, tol=opts.tol,
            maxiter=opts.maxiter, precond=opts.precond, device=op.device)

    @staticmethod
    def backward(ctx, lams_bar, v_bar, *info_bar):
        with span("ift_backward"):
            op, lams, v = _DominantEighMulti._saved(ctx)
            if lams_bar is None and v_bar is None:
                return (None,) * (5 + len(op.parameters()))
            u = _block_cotangent(lams, v, lams_bar, v_bar, ctx.opts,
                                 _DominantEighMulti._solve(ctx, op, lams, v),
                                 vector_layout(op))
            grads = partial_vjp(op, lambda held: held.matmat(v), [], u,
                                ctx.needs_input_grad[5:])
            return (None, None, None, None, None, *grads)


def dominant_eigh_multi(op, r: int = 4, k: int = 128, *,
                        extreme: str = "min", tol: float = 1e-8,
                        maxiter: int | None = None, seed: int = 0,
                        reorth_passes: int = 2, reorth_chunks: int = 0,
                        gap_eps: float = 1e-12,
                        method: str = "lanczos", precond=None,
                        with_info: bool = False,
                        v0: torch.Tensor | None = None,
                        x0: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        device=None):
    """Top-r extremal eigenpairs of a symmetric operator, differentiable
    to any order in ``op.parameters()``: reverse mode (again under
    ``create_graph``), forward mode to any order (``torch.func.jvp``, or
    ``torch.autograd.forward_ad``), and ``torch.func.vmap``.

    method  : "lanczos" (one k-step sweep; ``k`` clamped to ``op.dim``,
              start vector ``v0`` (N,)) or "lobpcg" (up to ``k``
              iterations of :func:`~.lobpcg.lobpcg_eigh`, start block
              ``x0`` (N, r)); both drawn from ``generator`` (seeded
              ``seed`` on the device when None) if not given.
    extreme : "min" (ascending) or "max" (descending).
    reorth_chunks : as in :func:`~.lanczos.lanczos` (the Lanczos sweep).
    tol     : the LOBPCG residual target and the tolerance of the
              backward's (or the forward-mode tangent's) CG; ``maxiter``
              bounds the CG's iterations (default 10 N).
    gap_eps : broadening of the in-block gap inverses.
    precond : an SPD approximate inverse ``z = M^{-1} r`` (vector
              convention) used by the LOBPCG forward on its residual
              block, column by column, and by the batched deflated CG of
              the derivative rules.
    device  : where the solve runs (CUDA when None).

    Returns ``(lams, V)``, lams (r,) and V (N, r) orthonormal and
    pivot-gauged; with ``with_info``, ``(lams, V, info)`` where ``info`` is
    a :class:`~.lanczos.LanczosInfo` (zero tangents, no gradient) whose
    residual is the max-over-block ``||A v - lam v|| / max(|lam|, 1)``.
    """
    if extreme not in ("min", "max"):
        raise ValueError(f"extreme must be min|max, got {extreme!r}")
    if method not in ("lanczos", "lobpcg"):
        raise ValueError(f"method must be lanczos|lobpcg, got {method!r}")
    start = x0 if method == "lobpcg" else v0
    if (v0 if method == "lobpcg" else x0) is not None:
        raise ValueError("pass v0 (N,) for method='lanczos' and x0 (N, r) "
                         "for method='lobpcg'")
    op = as_operator(op)
    dev = check_device(device, op)
    r = int(r)
    k = int(min(k, op.dim)) if method == "lanczos" else int(k)
    if r > k:
        raise ValueError(f"need k >= r, got k={k} < r={r}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    opts = EighMultiOptions(
        r=r, k=k, extreme=extreme, tol=float(tol),
        maxiter=None if maxiter is None else int(maxiter),
        reorth_passes=int(reorth_passes), reorth_chunks=int(reorth_chunks),
        gap_eps=float(gap_eps), method=method, precond=precond)
    out = _DominantEighMulti.apply(op, opts, start, generator,
                                   bool(with_info), *op.parameters())
    if with_info:
        return out[0], out[1], LanczosInfo(*out[2:])
    return out
