"""Linear operators on PyTorch tensors.

Counterpart of ``dominantsparseeigenad_tpu/ops/operators.py``.  The JAX
package carries an operator's differentiable inputs as pytree leaves;
here every operator exposes them through :meth:`LinearOperator.parameters`,
the tensors that ``torch.autograd.grad`` differentiates the IFT rule of
``eigh.py`` into.

Every operator implements ``matvec``, ``rmatvec``, ``dim``, ``dtype`` and
``device``; ``matmat``/``rmatmat`` default to a loop over columns.
``tangent_matvec``, ``tangent_matmat``, ``tangent_rmatvec`` and
``tangent_rmatmat`` are the operator's tangent products ``(dA) x``,
``(dA) X``, ``(dA)^T x`` and ``(dA)^T X`` that forward mode of the
eigensolvers needs, and ``with_parameters`` rebuilds the operator on
other tensors, which :func:`partial_vjp` (the derivative rules'
``u^T (∂A/∂θ) w``) differentiates into.  A ``MatrixFreeOperator`` may
hold another operator among its params (the Wielandt deflation of
``eig.py`` wraps the stage before it): its parameters are then the inner
operator's too.

The operator algebra is the JAX module's: ``A @ B`` (or ``A @ x``), ``A.T``,
``A + B``, ``c * A``, ``A - B`` and ``-A`` build the lazy composites
:class:`TransposedOperator`, :class:`ShiftedOperator` (``A - shift I``),
:class:`DeflatedOperator` (``P A P``, ``P = I - V V^H``),
:class:`SumOperator`, :class:`ScaledOperator` and
:class:`ComposedOperator`.  A composite's parameters are its children's,
in order, then its own ``shift``, ``c`` or ``V`` where that is a tensor
(a Python number is a constant); its block products call its children's
block products, so a blocked-ELL child still runs one SpMM for a block.

Complex dtypes are supported as in the JAX package: ``hdot`` conjugates
its first argument, :func:`pivot_gauge` fixes the phase (not only the
sign) of an eigenvector, and ``rmatvec`` is the bilinear transpose
``A^T x`` (not the adjoint ``A^H x = conj(A^T conj(x))``, which the
solvers that need it build themselves).  :func:`refuse_complex` remains
for the model whose physics has no complex form (the 2D Ising model).

Transforms.  Every ``torch.autograd.Function`` of the port takes the
operator's structure as a Python object and its tensors as explicit
inputs (``*op.parameters()``), and its rules rebuild the operator from
the tensors they are handed (:func:`rebind`), never from tensors the
Python object holds: under ``torch.func`` a rule runs one transform level
below the caller, and a held tensor would leak the caller's level into
it.  Two helpers make the Functions compose with ``torch.func``:
:func:`nestable_jvp` runs a ``jvp`` rule one level down with forward
grad on, so that an outer ``torch.func.jvp`` sees the rule's own
operations (forward mode to any order), and :func:`per_lane_vmap` gives
a Function the ``vmap`` rule that slices each batched input and applies
the Function once per lane (no Function uses ``generate_vmap_rule``: the
solvers read the host).

Precision policy: the JAX package pins HIGHEST precision on its internal
dots and GEMMs (``hdot``/``hmatmul``) because a TPU otherwise rounds f32
operands to bf16.  The hazard on an NVIDIA card is TF32, which keeps about
three decimal digits.  This module turns TF32 off for matrix products and
:func:`hmatmul` refuses to run if something turned it back on.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from typing import Any, Callable

import torch
import torch.autograd.forward_ad as fwAD
from torch._C import _functorch
from torch._functorch.pyfunctorch import (
    retrieve_current_functorch_interpreter)

torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    There is no quiet fallback: with no card present, a caller that did
    not ask for ``"cpu"`` gets an error.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def check_device(device, *items) -> torch.device:
    """Resolve ``device`` and require every item (a tensor or an
    operator) to live on it."""
    dev = resolve_device(device)
    for t in items:
        if t.device.type != dev.type:
            raise ValueError(
                f"input on {t.device} but the call runs on {dev}; pass "
                f"device={t.device.type!r} or move the inputs")
    return dev


def refuse_complex(dtype, what: str, why: str):
    """Raise TypeError for a complex ``dtype`` where the port has no
    complex form; ``why`` names the reason (and its ROADMAP.md item)."""
    if dtype is not None and dtype.is_complex:
        raise TypeError(f"{what} is {dtype}: {why}")


def real_dtype(dtype) -> torch.dtype:
    """The real dtype of ``dtype`` (float64 for complex128, float32 for
    complex64, ``dtype`` itself when real): the dtype of norms, of the
    Lanczos coefficients and of a Hermitian operator's eigenvalues."""
    return dtype.to_real() if dtype.is_complex else dtype


def _check_no_tf32():
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the solvers' "
            "reductions need true fp32 (set it back to False)")


def _promoted(a, b):
    """``a`` and ``b`` in their common dtype (a real operand meets a
    complex one as complex, as JAX promotes)."""
    if a.dtype == b.dtype:
        return a, b
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def promote_to(x, dtype):
    """``x`` as complex when it is real and ``dtype`` (an operator's
    compute dtype) is complex: a real vector meeting a complex operator,
    as JAX promotes; otherwise ``x`` itself."""
    if dtype.is_complex and not x.is_complex():
        return x.to(torch.promote_types(x.dtype, dtype))
    return x


def hmatmul(a, b):
    """``torch.matmul`` in true fp32/fp64 (never TF32), the operands
    promoted to their common dtype."""
    _check_no_tf32()
    return torch.matmul(*_promoted(a, b))


def hdot(a, b):
    """Inner product ``<a, b> = sum(conj(a) * b)`` of two vectors (the JAX
    ``jnp.vdot``), accumulated in the vectors' own dtype (cuBLAS ``dot``
    has no TF32 mode).  For real vectors it is ``torch.dot``."""
    return torch.vdot(*_promoted(a, b))


def pivot_gauge(v, *companions, layout=None):
    """Scale ``v`` (an (N,) vector, or the columns of an (N, r) block) by
    the phase ``conj(sgn(pivot))`` that makes its largest-magnitude entry
    real and positive: the gauge every forward of the JAX package applies
    and its derivative rules assume (for a real dtype, a sign).
    ``companions`` (e.g. a tracked ``A v``) get the same phase; with
    companions the return is a tuple ``(v', *companions')``.  With a
    sharded ``layout`` (see :func:`vector_layout`) ``v`` is the rank's
    rows and the pivot is the whole vector's, the same on every rank."""
    if layout is not None:
        _, entry = layout.pivot(v)
        phase = torch.sgn(entry).conj()
        phase = phase if v.ndim == 1 else phase[None, :]
    elif v.ndim == 1:
        phase = torch.sgn(v[torch.argmax(torch.abs(v))]).conj()
    else:
        idx = torch.argmax(torch.abs(v), dim=0)
        phase = torch.sgn(torch.gather(v, 0, idx[None])[0]).conj()[None, :]
    out = (v * phase,) + tuple(c * phase for c in companions)
    return out if companions else out[0]


def vector_layout(op):
    """The layout of ``op``'s vectors: None when every process holds them
    whole (one process, or the replicated vectors of the row-sharded
    operators), else the object a row-sharded operator with
    ``vectors="sharded"`` carries (``parallel/collectives.py``,
    ``ShardedVectors``).  Its vectors are then the rank's rows, and the
    solvers take every contraction over the vector axis through it:

    * ``sum(t)``: a local contraction summed over the ranks, the same on
      every rank (a replicated result);
    * ``bcast(t)``: a replicated value marked where it enters the rank's
      own rows (identity; its gradient is summed over the ranks, each of
      whose rows used it);
    * ``norm(x, dim=None)``, ``local_dim``, ``offset``, ``dim``;
    * ``draw(shape, generator, dtype, device)``: the global draw, narrowed
      to the rank's rows;
    * ``pivot(v)``: the global index of the first largest |v| (per column
      of a block) and the entry there; ``take(t, idx)`` the entries of
      ``t`` at global indices, and ``one_hot(idx, dtype)`` the rank's rows
      of the unit vectors there, all the same on every rank;
    * ``tall_qr(z)``: the thin QR of a whole (N, r) block from its rows;
    * ``stacked()``: the layout of the (2N,) vectors (u; v) of the
      Hermitian embedding of an operator on this one (``svd.py``);
      ``bordered(k)``: that of a bordered vector (x; ν), whose border of
      k entries the first rank holds (``cg.py``, the bordered solves).

    Duck-typed: ``ops/`` never imports ``parallel/``."""
    return getattr(op, "vector_layout", None)


def layout_sum(layout, t):
    """``t``, a local contraction over the vector axis, summed over the
    ranks of ``layout`` (a replicated result); ``t`` with no layout."""
    return t if layout is None else layout.sum(t)


def layout_bcast(layout, t):
    """A replicated ``t`` marked where it enters the rank's rows (see
    :func:`vector_layout`); ``t`` with no layout."""
    return t if layout is None else layout.bcast(t)


def layout_norm(layout, x, dim=None):
    """``torch.linalg.vector_norm(x, dim=dim)`` over the whole vector (or
    each column, ``dim=0``), the same on every rank."""
    if layout is None:
        return torch.linalg.vector_norm(x, dim=dim)
    return layout.norm(x, dim)


def common_layout(*items):
    """The one vector layout of the operators among ``items`` (None for
    whole vectors); operators whose layouts differ do not conform."""
    layouts = [vector_layout(c) for c in items
               if isinstance(c, LinearOperator)]
    if any(lay != layouts[0] for lay in layouts):
        raise ValueError("the operators' vectors are laid out differently "
                         "(sharded and whole) and do not conform")
    return layouts[0]


def matvec_layout(matvec):
    """The vector layout of a bare ``matvec``: its operator's, where it is
    a bound method (``op.matvec`` names ``op`` through ``__self__``)."""
    return vector_layout(getattr(matvec, "__self__", matvec))


def local_dim(op) -> int:
    """The rows of ``op``'s vectors that this process holds: ``op.dim``,
    or the rank's rows under a sharded layout."""
    layout = vector_layout(op)
    return op.dim if layout is None else layout.local_dim


def tol_floor(tol: float, dtype) -> float:
    """Clamp a relative tolerance to 50 eps of ``dtype``, what a
    residual-stopped loop can reach (~6e-6 in f32, ~1.1e-14 in f64)."""
    return max(float(tol), 50.0 * float(torch.finfo(dtype).eps))


def partial_vjp(op, apply, tensors, cot, needs) -> list:
    """The partial derivatives of ``<cot, apply(op, *tensors)>`` in
    ``tensors`` and then ``op.parameters()``, for those that ``needs``
    marks (None for the others and for an unused one).

    Each differentiated tensor enters ``apply`` as a variable of its own,
    a view of it, on an operator rebuilt by ``op.with_parameters``: a
    path through the history of something ``apply`` closes over (an
    eigenvector, an earlier solve's output, itself a function of the
    same parameters) is held constant, as a partial derivative must.
    The derivative rules call this from a backward; when that backward
    runs under ``create_graph`` (grad mode on), the result is built with
    a graph and differentiates again, through those closed-over tensors'
    histories too."""
    create = torch.is_grad_enabled()
    leaves = [*tensors, *op.parameters()]
    wanted = [i for i, need in enumerate(needs) if need]
    out = [None] * len(leaves)
    if not wanted:
        return out
    if transforms_active() or any(
            _functorch.is_functorch_wrapped_tensor(t) for t in leaves):
        # Under torch.func (a rule run inside grad, jvp or vmap, or the
        # vjp function of a torch.func.vjp called after its level exited)
        # the partials are a torch.func.vjp, which every outer level
        # differentiates: the tensors here may be wrappers of a level
        # that has already exited, which torch.autograd.grad cannot see.
        def held_apply(*ts):
            full = list(leaves)
            for i, t in zip(wanted, ts):
                full[i] = t
            return apply(op.with_parameters(full[len(tensors):]),
                         *full[:len(tensors)])

        _, vjp_fn = torch.func.vjp(held_apply, *[leaves[i] for i in wanted])
        for i, g in zip(wanted, vjp_fn(cot)):
            out[i] = g
        return out
    with torch.enable_grad():
        proxies = list(leaves)
        for i in wanted:
            proxies[i] = leaves[i].view_as(leaves[i])
        held = op.with_parameters(proxies[len(tensors):])
        y = apply(held, *proxies[:len(tensors)])
    got = torch.autograd.grad(y, [proxies[i] for i in wanted],
                              grad_outputs=cot, allow_unused=True,
                              create_graph=create)
    for i, g in zip(wanted, got):
        out[i] = g
    return out


def transforms_active() -> bool:
    """Whether a ``torch.func`` transform (grad, jvp, vmap) is active."""
    return _functorch.peek_interpreter_stack() is not None


def under_vmap() -> bool:
    """Whether a ``torch.func.vmap`` is among the active transforms."""
    stack = _functorch.get_interpreter_stack() or []
    return any(i.key() == _functorch.TransformType.Vmap for i in stack)


@contextlib.contextmanager
def outside_transforms():
    """Run the block with every ``torch.func`` level popped, so that a
    draw from a generator (which depends on no input) is one plain
    tensor shared by every lane, as an unbatched JAX key gives, where
    ``vmap`` would refuse a random operation."""
    stack = []
    try:
        while _functorch.peek_interpreter_stack() is not None:
            stack.append(_functorch.pop_dynamic_layer_stack())
        yield
    finally:
        while stack:
            _functorch.push_dynamic_layer_stack(stack.pop())


class _LevelDown:
    """A Function's ``ctx`` whose saved tensors are those of one
    ``torch.func`` level down; every other attribute is the ctx's."""

    def __init__(self, ctx, saved):
        self._ctx = ctx
        self.saved_tensors = saved

    def __getattr__(self, name):
        return getattr(self._ctx, name)


def nestable_jvp(rule):
    """Decorator for a ``torch.autograd.Function``'s ``jvp``: forward
    mode to any order under ``torch.func.jvp``.

    PyTorch runs a Function's ``jvp`` with forward grad off, which at a
    ``torch.func.jvp`` level also hides the rule's operations from every
    outer jvp level.  Under a jvp level this runs the rule as that
    level's own forward runs: its saved tensors and tangents unwrapped
    one level down, the level popped, forward grad on; the tangents it
    returns are wrapped back.  The rule's operations (this and other
    Functions, and differentiable tensor operations) then carry the
    outer levels' tangents, and a ``grad`` level's too.  Elsewhere (no
    transform, or ``torch.autograd.forward_ad``) the rule runs as is."""

    @functools.wraps(rule)
    def jvp(ctx, *tangents):
        if not transforms_active():
            return rule(ctx, *tangents)
        interp = retrieve_current_functorch_interpreter()
        if interp.key() != _functorch.TransformType.Jvp:
            return rule(ctx, *tangents)
        level = interp.level()

        def down(t):
            return _functorch._unwrap_for_grad(t, level) \
                if isinstance(t, torch.Tensor) else t

        def up(t):
            return _functorch._wrap_for_grad(t, level) \
                if isinstance(t, torch.Tensor) else t

        saved = tuple(down(t) for t in ctx.saved_tensors)
        with interp.lower(), fwAD._set_fwd_grad_enabled(True):
            out = rule(_LevelDown(ctx, saved), *map(down, tangents))
        return tuple(map(up, out)) if isinstance(out, tuple) else up(out)

    return jvp


def per_lane_vmap(cls):
    """Class decorator: give the Function ``cls`` its ``vmap`` rule as a
    loop over lanes.  Each batched input is sliced on its ``in_dim``,
    ``cls.apply`` runs once per lane (one transform level down, where
    the forward's host reads are allowed), and each output is stacked on
    dim 0.  A ``torch.Generator`` among the inputs is reset to its state
    before every lane, so each lane draws what an unbatched call draws.
    It is the correctness baseline; a Function with a batched rule
    (``_BellProduct``, ``_DeflatedSolve``) falls back to it."""

    def vmap(info, in_dims, *args):
        return _per_lane(cls, info, in_dims, args)

    cls.vmap = staticmethod(vmap)
    return cls


def _per_lane(cls, info, in_dims, args):
    gens = [(a, a.get_state()) for a in args
            if isinstance(a, torch.Generator)]
    outs = []
    for i in range(info.batch_size):
        for gen, state in gens:
            gen.set_state(state)
        lane = [a.select(d, i) if isinstance(a, torch.Tensor)
                and d is not None else a for a, d in zip(args, in_dims)]
        outs.append(cls.apply(*lane))
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs)), 0
    return torch.stack(outs), 0


def rebind(op, params):
    """``op`` on the tensors ``params`` (one per :meth:`parameters`), as a
    Function's forward and rules take it: ``op`` itself where they are its
    own tensors (plain autograd), else ``op.with_parameters(params)``
    (under a transform, where they are one level down)."""
    own = op.parameters()
    if len(own) == len(params) and all(a is b for a, b in zip(own, params)):
        return op
    return op.with_parameters(params)


def _tensors_of(params) -> list:
    """Flatten a tensor, or a (nested) list/tuple/dict of them; an
    operator among them contributes its :meth:`LinearOperator.parameters`
    (a deflated stage nests the operator it deflates)."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, LinearOperator):
        return list(params.parameters())
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in _tensors_of(p)]
    return []


def _rebuild(params, tensors):
    """``params`` with its tensors replaced by ``tensors``, taken in the
    order of :func:`_tensors_of`."""
    it = iter(tensors)

    def go(p):
        if isinstance(p, torch.Tensor):
            return next(it)
        if isinstance(p, LinearOperator):
            return p.with_parameters(
                [next(it) for _ in range(len(p.parameters()))])
        if isinstance(p, dict):
            return {k: go(v) for k, v in p.items()}
        if isinstance(p, list):
            return [go(q) for q in p]
        if isinstance(p, tuple):
            items = [go(q) for q in p]
            return type(p)(*items) if hasattr(p, "_fields") else tuple(items)
        return p

    return go(params)


class LinearOperator:
    """Abstract square linear operator."""

    # None: vectors live whole on this process (see vector_layout).
    vector_layout = None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """Transpose matvec ``A.T @ x`` (bilinear: not conjugated)."""
        raise NotImplementedError

    def parameters(self) -> list:
        """The tensors the operator is differentiable in."""
        raise NotImplementedError

    def tangent_matvec(self, x: torch.Tensor, dparams) -> torch.Tensor:
        """``(dA) x``: the derivative of ``A(θ) x`` along the tangents
        ``dparams``, one per tensor of :meth:`parameters` (None for a
        parameter that has none)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no tangent product: forward mode "
            f"through it is not ported")

    def tangent_matmat(self, X: torch.Tensor, dparams) -> torch.Tensor:
        """``(dA) X`` for an (N, m) block, one tangent product per
        column."""
        return torch.stack([self.tangent_matvec(X[:, j], dparams)
                            for j in range(X.shape[1])], dim=1)

    def tangent_rmatvec(self, x: torch.Tensor, dparams) -> torch.Tensor:
        """``(dA)^T x``, the tangent of :meth:`rmatvec` (forward mode of
        the non-symmetric solver)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no transposed tangent product: "
            f"forward mode of the non-symmetric solver through it is not "
            f"ported")

    def tangent_rmatmat(self, X: torch.Tensor, dparams) -> torch.Tensor:
        """``(dA)^T X`` for an (N, m) block, one transposed tangent product
        per column."""
        return torch.stack([self.tangent_rmatvec(X[:, j], dparams)
                            for j in range(X.shape[1])], dim=1)

    @property
    def dim(self) -> int:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dim, self.dim)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """``A @ X`` for an (N, m) block, one matvec per column."""
        return torch.stack([self.matvec(X[:, j]) for j in range(X.shape[1])],
                           dim=1)

    def rmatmat(self, X: torch.Tensor) -> torch.Tensor:
        """``A.T @ X`` for an (N, m) block, one rmatvec per column."""
        return torch.stack([self.rmatvec(X[:, j])
                            for j in range(X.shape[1])], dim=1)

    def to_dense(self) -> torch.Tensor:
        """The dense (N, N) matrix, ``A @ I`` (a test helper)."""
        return self.matmat(torch.eye(self.dim, dtype=self.dtype,
                                     device=self.device))

    def __matmul__(self, x):
        if isinstance(x, LinearOperator):
            return ComposedOperator(self, x)
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)

    @property
    def T(self) -> "TransposedOperator":
        return TransposedOperator(self)

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return SumOperator(self, other)
        return NotImplemented

    def __mul__(self, scalar):
        return ScaledOperator(self, scalar)

    __rmul__ = __mul__

    def __sub__(self, other):
        if isinstance(other, LinearOperator):
            return SumOperator(self, ScaledOperator(other, -1.0))
        return NotImplemented

    def __neg__(self):
        return ScaledOperator(self, -1.0)


class DenseOperator(LinearOperator):
    """Dense square matrix operator; applications run in true fp32/fp64."""

    def __init__(self, a: torch.Tensor):
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected square matrix, got shape "
                             f"{tuple(a.shape)}")
        self.a = a

    def matvec(self, x):
        return hmatmul(self.a, x)

    def rmatvec(self, x):
        return hmatmul(self.a.T, x)

    def matmat(self, X):
        return hmatmul(self.a, X)

    def rmatmat(self, X):
        return hmatmul(self.a.T, X)

    def tangent_matvec(self, x, dparams):
        (da,) = dparams
        return hmatmul(da, x)

    def tangent_matmat(self, X, dparams):
        (da,) = dparams
        return hmatmul(da, X)

    def tangent_rmatvec(self, x, dparams):
        (da,) = dparams
        return hmatmul(da.T, x)

    tangent_rmatmat = tangent_rmatvec

    def to_dense(self):
        return self.a

    def parameters(self):
        return [self.a]

    def with_parameters(self, tensors):
        (a,) = tensors
        return DenseOperator(a)

    @property
    def dim(self):
        return self.a.shape[0]

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device


class MatrixFreeOperator(LinearOperator):
    """Matrix-free operator ``A(params) @ x = matvec_fn(params, x)``.

    ``params`` is a tensor or a list/tuple/dict of tensors and operators
    (an operator stands for its ``parameters()``); gradients with
    respect to them come from ``torch.autograd.grad`` of ``matvec_fn``,
    which is the lazy ``u^T (dA/dθ) w`` contraction of the reference: no
    N×N matrix is built.  ``rmatvec_fn`` defaults to ``matvec_fn``
    (symmetric operator).  ``device`` is where the operator runs when
    ``params`` holds no tensor; otherwise it is the parameters' device.
    """

    def __init__(self, matvec_fn: Callable, params: Any, dim: int,
                 dtype=torch.float32, rmatvec_fn: Callable | None = None,
                 symmetric: bool = True, device=None):
        if rmatvec_fn is None and not symmetric:
            raise ValueError(
                "non-symmetric MatrixFreeOperator requires rmatvec_fn")
        self.matvec_fn = matvec_fn
        self.params = params
        self._dim = int(dim)
        self._dtype = dtype
        self.rmatvec_fn = rmatvec_fn
        self.symmetric = bool(symmetric)
        tensors = _tensors_of(params)
        if tensors:
            self._device = tensors[0].device
            if device is not None and \
                    torch.device(device).type != self._device.type:
                raise ValueError(f"params on {self._device}, device="
                                 f"{device!r} requested")
        else:
            self._device = resolve_device(device)

    def matvec(self, x):
        return self.matvec_fn(self.params, x)

    def rmatvec(self, x):
        if self.rmatvec_fn is not None:
            return self.rmatvec_fn(self.params, x)
        return self.matvec_fn(self.params, x)

    def parameters(self):
        return _tensors_of(self.params)

    def with_parameters(self, tensors):
        op = copy.copy(self)
        op.params = _rebuild(self.params, tensors)
        return op

    def tangent_matvec(self, x, dparams):
        """``(dA) x``, the JVP of ``matvec_fn`` in its parameters along
        ``dparams``.  Under a ``torch.func`` transform it is a
        ``torch.func.jvp`` of the product, itself differentiable at every
        outer level (forward and reverse), so a tangent product can
        carry a tangent.  Otherwise (inside a ``torch.autograd.forward_ad``
        rule, where forward AD is off and dual levels do not nest) it is
        ``torch.autograd.functional.jvp``, a reverse product
        differentiated in its cotangent, first order."""
        return self._tangent(lambda op, z: op.matvec(z), x, dparams)

    def tangent_matmat(self, X, dparams):
        """``(dA) X`` for an (N, m) block: one JVP of the whole
        :meth:`matmat` (see :meth:`tangent_matvec`)."""
        return self._tangent(lambda op, z: op.matmat(z), X, dparams)

    def tangent_rmatvec(self, x, dparams):
        """``(dA)^T x``, the JVP of :meth:`rmatvec` (as
        :meth:`tangent_matvec`)."""
        return self._tangent(lambda op, z: op.rmatvec(z), x, dparams)

    def tangent_rmatmat(self, X, dparams):
        """``(dA)^T X``: one JVP of the whole :meth:`rmatmat`."""
        return self._tangent(lambda op, z: op.rmatmat(z), X, dparams)

    def _tangent(self, product, x, dparams):
        moving = [i for i, t in enumerate(dparams) if t is not None]
        if not moving:
            return torch.zeros_like(x)
        nested = transforms_active()
        prims = [p if nested else p.detach() for p in self.parameters()]
        if not nested:
            x = x.detach()

        def apply(*ts):
            full = list(prims)
            for i, t in zip(moving, ts):
                full[i] = t
            return product(self.with_parameters(full), x)

        args = (apply, tuple(prims[i] for i in moving),
                tuple(dparams[i] for i in moving))
        if nested:
            return torch.func.jvp(*args)[1]
        return torch.autograd.functional.jvp(*args)[1]

    @property
    def dim(self):
        return self._dim

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device


class _BlockMatrixFreeOperator(MatrixFreeOperator):
    """A :class:`MatrixFreeOperator` whose ``matvec_fn`` also takes an
    (N, m) block, column by column in one pass: its ``matmat`` (and
    ``rmatmat``, and the tangent block products) is one call of it on
    the block, where the base class loops over columns.  The JAX
    ``matmat`` of a matrix-free operator is ``jax.vmap`` of its matvec,
    which gives the same one pass."""

    def matmat(self, X):
        return self.matvec(X)

    def rmatmat(self, X):
        return self.rmatvec(X)


def _add(a, b):
    """``a + b`` where either may be None (a zero)."""
    return b if a is None else a if b is None else a + b


def _product(op, x, transpose=False):
    """``A x`` (``A^T x`` with ``transpose``) for ``x`` of shape (N,), and
    for an (N, m) block the operator's block product (one ``matmat`` or
    ``rmatmat``, not a loop over columns)."""
    if x.ndim == 2:
        return op.rmatmat(x) if transpose else op.matmat(x)
    return op.rmatvec(x) if transpose else op.matvec(x)


def _tangent_product(op, x, dparams, transpose=False):
    """``(dA) x`` (``(dA)^T x`` with ``transpose``; ``x`` (N,) or (N, m))
    along the parameters' tangents, or None when none moves."""
    if all(t is None for t in dparams):
        return None
    if transpose:
        if x.ndim == 2:
            return op.tangent_rmatmat(x, dparams)
        return op.tangent_rmatvec(x, dparams)
    if x.ndim == 2:
        return op.tangent_matmat(x, dparams)
    return op.tangent_matvec(x, dparams)


def _reduced(layout, t):
    """A contraction over the vector axis, summed over the ranks and
    marked for the rank's rows (``t`` itself with no layout)."""
    return t if layout is None else layout.bcast(layout.sum(t))


def _project_out(V, x, layout=None):
    """``x - V <V, x>`` for a unit vector V and x of shape (N,), or
    ``x - V V^H x`` for V of shape (N,) or (N, r) with orthonormal
    columns and x of shape (N,) or (N, m); the inner products over the
    ranks of a sharded ``layout``."""
    if V.ndim == 1:
        if x.ndim == 1:
            return x - V * _reduced(layout, hdot(V, x))
        V = V[:, None]
    return x - hmatmul(V, _reduced(layout, hmatmul(V.mH, x)))


def _projector_tangent(V, dV, z, layout=None):
    """``(dP) z`` for ``P = I - V V^H``: ``-(dV V^H z + V dV^H z)``."""
    if V.ndim == 1:
        V, dV = V[:, None], dV[:, None]
    return -(hmatmul(dV, _reduced(layout, hmatmul(V.mH, z)))
             + hmatmul(V, _reduced(layout, hmatmul(dV.mH, z))))


def _scaled_dtype(dtype, c):
    """The dtype of ``c * y`` for ``y`` of ``dtype`` and a scalar ``c`` (a
    number or a 0-dim tensor): a complex ``c`` makes a real operator's
    products complex, a real one keeps ``dtype``."""
    return torch.result_type(torch.empty(1, dtype=dtype), c)


class _Composite(LinearOperator):
    """An operator built from others.  ``_fields`` names its child
    operators and then its own scalars or tensors, in the order of
    :meth:`parameters`.  A subclass gives ``_product(x, transpose)`` and
    ``_tangent(x, parts, transpose)`` (``parts``: the tangents cut into
    one list per field; None where nothing moves), for ``x`` of shape
    (N,) or (N, m); the four products and four tangent products follow
    from them, a block always as a block."""

    _fields: tuple = ()

    def _items(self):
        return [getattr(self, f) for f in self._fields]

    def parameters(self):
        return _tensors_of(self._items())

    def with_parameters(self, tensors):
        op = copy.copy(self)
        for f, item in zip(self._fields, _rebuild(self._items(), tensors)):
            setattr(op, f, item)
        return op

    def _split(self, dparams):
        parts, i = [], 0
        for item in self._items():
            n = len(_tensors_of(item))
            parts.append(list(dparams[i:i + n]))
            i += n
        return parts

    def matvec(self, x):
        return self._product(x, False)

    def rmatvec(self, x):
        return self._product(x, True)

    matmat, rmatmat = matvec, rmatvec

    def tangent_matvec(self, x, dparams):
        return self._tangent_or_zero(x, dparams, False)

    def tangent_rmatvec(self, x, dparams):
        return self._tangent_or_zero(x, dparams, True)

    tangent_matmat, tangent_rmatmat = tangent_matvec, tangent_rmatvec

    def _tangent_or_zero(self, x, dparams, transpose):
        out = self._tangent(x, self._split(dparams), transpose)
        if out is None:
            return torch.zeros(x.shape, device=x.device,
                               dtype=torch.promote_types(x.dtype, self.dtype))
        return out

    @property
    def vector_layout(self):
        """The children's vector layout: their products act row by row
        on the rank's rows, so a sum, scaling, shift, transpose or
        product of sharded operators is one too.  Children whose layouts
        differ do not conform."""
        return common_layout(*self._items())

    @property
    def dim(self):
        return self._items()[0].dim

    @property
    def device(self):
        return self._items()[0].device


def _check_conforming(a, b):
    if a.dim != b.dim:
        raise ValueError(f"operators of dimensions {a.dim} and {b.dim} do "
                         f"not conform")


class TransposedOperator(_Composite):
    """Lazy transpose view ``A^T`` of another operator (bilinear, not
    conjugated)."""

    _fields = ("op",)

    def __init__(self, op: LinearOperator):
        self.op = op

    def _product(self, x, transpose):
        return _product(self.op, x, not transpose)

    def _tangent(self, x, parts, transpose):
        return _tangent_product(self.op, x, parts[0], not transpose)

    @property
    def dtype(self):
        return self.op.dtype


class ShiftedOperator(_Composite):
    """``A - shift * I``, the resolvent convention of the derivative
    solves (``ops/precond.py``'s diagonal subtracts ``shift``).  A tensor
    ``shift`` is a parameter, a number a constant."""

    _fields = ("op", "shift")

    def __init__(self, op: LinearOperator, shift):
        self.op = op
        self.shift = shift

    def _product(self, x, transpose):
        return _product(self.op, x, transpose) - self.shift * x

    def _tangent(self, x, parts, transpose):
        d_op, d_shift = parts
        out = _tangent_product(self.op, x, d_op, transpose)
        if d_shift and d_shift[0] is not None:
            out = _add(out, -d_shift[0] * x)
        return out

    @property
    def dtype(self):
        return _scaled_dtype(self.op.dtype, self.shift)


class DeflatedOperator(_Composite):
    """``P A P`` with ``P = I - V V^H`` (V of shape (N,), or (N, r) with
    orthonormal columns): ``A`` restricted to the complement of
    ``span(V)``.  ``V`` is a parameter.  Its transpose products are the
    bilinear ``P^T A^T P^T``, ``P^T = I - conj(V) V^T`` (for a real V the
    same P).  Over sharded vectors V is the rank's rows and the
    projections' inner products are summed over the ranks."""

    _fields = ("op", "V")

    def __init__(self, op: LinearOperator, V: torch.Tensor):
        if V.shape[0] != local_dim(op):
            raise ValueError(f"V has {V.shape[0]} rows, the operator's "
                             f"vectors {local_dim(op)}")
        self.op = op
        self.V = V

    def _product(self, x, transpose):
        V = self.V.conj() if transpose else self.V
        lay = self.vector_layout
        y = _product(self.op, _project_out(V, x, lay), transpose)
        return _project_out(V, y, lay)

    def _tangent(self, x, parts, transpose):
        """``P dA P x + dP A P x + P A dP x``, ``dP z = -(dV V^H z + V
        dV^H z)``."""
        d_op, (dV,) = parts
        V = self.V.conj() if transpose else self.V
        lay = self.vector_layout
        y = _project_out(V, x, lay)
        out = _tangent_product(self.op, y, d_op, transpose)
        out = None if out is None else _project_out(V, out, lay)
        if dV is not None:
            dV = dV.conj() if transpose else dV
            a_y = _product(self.op, y, transpose)
            a_dpx = _product(self.op, _projector_tangent(V, dV, x, lay),
                             transpose)
            out = _add(out, _projector_tangent(V, dV, a_y, lay)
                       + _project_out(V, a_dpx, lay))
        return out

    @property
    def dtype(self):
        return torch.promote_types(self.op.dtype, self.V.dtype)


class SumOperator(_Composite):
    """``A + B`` of two conforming operators (lazy)."""

    _fields = ("a", "b")

    def __init__(self, a: LinearOperator, b: LinearOperator):
        _check_conforming(a, b)
        self.a, self.b = a, b

    def _product(self, x, transpose):
        return _product(self.a, x, transpose) + _product(self.b, x, transpose)

    def _tangent(self, x, parts, transpose):
        return _add(_tangent_product(self.a, x, parts[0], transpose),
                    _tangent_product(self.b, x, parts[1], transpose))

    @property
    def dtype(self):
        return torch.promote_types(self.a.dtype, self.b.dtype)


class ScaledOperator(_Composite):
    """``c * A`` for a scalar ``c``: a tensor (real or complex) is a
    parameter, a number a constant."""

    _fields = ("op", "c")

    def __init__(self, op: LinearOperator, c):
        self.op = op
        self.c = c

    def _product(self, x, transpose):
        return self.c * _product(self.op, x, transpose)

    def _tangent(self, x, parts, transpose):
        d_op, d_c = parts
        out = _tangent_product(self.op, x, d_op, transpose)
        out = None if out is None else self.c * out
        if d_c and d_c[0] is not None:
            out = _add(out, d_c[0] * _product(self.op, x, transpose))
        return out

    @property
    def dtype(self):
        return _scaled_dtype(self.op.dtype, self.c)


class ComposedOperator(_Composite):
    """``A @ B`` (lazy): ``A (B x)``, and ``B^T (A^T x)`` transposed."""

    _fields = ("a", "b")

    def __init__(self, a: LinearOperator, b: LinearOperator):
        _check_conforming(a, b)
        self.a, self.b = a, b

    def _product(self, x, transpose):
        if transpose:
            return _product(self.b, _product(self.a, x, True), True)
        return _product(self.a, _product(self.b, x))

    def _tangent(self, x, parts, transpose):
        """``dA (B x) + A (dB x)``, transposed ``dB^T (A^T x) + B^T (dA^T
        x)``: the operator applied second, differentiated at what the
        first gives, plus the second applied to the first's tangent."""
        first, second = (0, 1) if transpose else (1, 0)
        ops = (self.a, self.b)
        out = None
        if any(t is not None for t in parts[second]):
            out = _tangent_product(ops[second],
                                   _product(ops[first], x, transpose),
                                   parts[second], transpose)
        d_first = _tangent_product(ops[first], x, parts[first], transpose)
        if d_first is not None:
            out = _add(out, _product(ops[second], d_first, transpose))
        return out

    @property
    def dtype(self):
        return torch.promote_types(self.a.dtype, self.b.dtype)


def as_operator(a: Any) -> LinearOperator:
    """Coerce a dense square tensor or an operator into a LinearOperator."""
    if isinstance(a, LinearOperator):
        return a
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a LinearOperator or a tensor, got "
                        f"{type(a).__name__}")
    return DenseOperator(a)
