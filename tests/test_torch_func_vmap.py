"""``torch.func.vmap`` through the port's Functions, and the autograd
checks every Function passes: the batched Bell product (one SpMM), the
batched deflated solve (one block CG), the per-lane rule of the solvers,
``vmap`` and ``vmap∘grad`` of E0 over couplings, ``lanczos`` in restart
mode "carry" under ``vmap`` with a breakdown lane, and the TFIM sweep;
held against the JAX package's ``jax.vmap`` on the same inputs (CPU,
f64), after ``tests/test_eigh_multi.py:115-131``,
``tests/test_lanczos.py:70, :170`` and ``models/tfim.py:344-398``.  Then
``gradcheck`` (forward AD and batched grad on) and ``gradgradcheck``
(forward over reverse on) of each Function on small inputs.
"""

import importlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.autograd import gradcheck, gradgradcheck

import dominantsparseeigenad_tpu as jx
from dominantsparseeigenad_tpu import models as jm

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import models

# The modules, not the functions of the same names that ops exports.
jcg = importlib.import_module("dominantsparseeigenad_tpu.ops.cg")
jlz = importlib.import_module("dominantsparseeigenad_tpu.ops.lanczos")
spmv = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.bell_spmv")
port_cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")
coll = importlib.import_module(
    "dominantsparseeigenad_tpu_torch.parallel.collectives")

torch.set_num_threads(2)

F64 = torch.float64
TOL = 1e-13


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


@pytest.fixture(scope="module")
def bell():
    """A banded blocked-ELL operator (n = 256, bs = 32) and 5 vectors."""
    op = port.random_bell_operator(256, 32, 5, dtype=F64, device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    x = torch.randn(5, 256, dtype=F64, generator=torch.Generator()
                    .manual_seed(4))
    return op, x


def _counting_products(monkeypatch):
    """Record the shape of every product ``_BellProduct`` runs."""
    calls = []
    product = spmv._product

    def counted(vals, cols, x, plan):
        calls.append(tuple(x.shape))
        return product(vals, cols, x, plan)

    monkeypatch.setattr(spmv, "_product", counted)
    return calls


@pytest.mark.parametrize("block", [False, True], ids=["vectors", "blocks"])
def test_vmap_of_bell_product_is_one_spmm(bell, block, monkeypatch):
    """``vmap`` of a Bell matvec over 5 vectors is one product on an
    (N, 5) block, equal to ``matmat`` bit for bit; over 5 (N, 2) blocks,
    one product on (N, 10); and it matches JAX's ``vmap`` of its
    matvec (1e-13)."""
    op, x = bell
    calls = _counting_products(monkeypatch)
    if block:
        xs = torch.stack([x, 2.0 * x], -1)             # (5, N, 2)
        got = torch.func.vmap(op.matmat)(xs)
        assert calls == [(256, 10)]
        want = torch.stack([op.matmat(b) for b in xs])
    else:
        got = torch.func.vmap(op.matvec)(x)
        assert calls == [(256, 5)]
        want = op.matmat(x.T.contiguous()).T
    assert torch.equal(got, want)
    jop = jx.BellOperator(jnp.asarray(op.vals.numpy()),
                          jnp.asarray(op.cols.numpy()), 256, symmetric=True,
                          use_pallas=False)
    ref = jax.vmap(jop.matvec if not block else jop.matmat)(
        jnp.asarray(xs.numpy() if block else x.numpy()))
    assert _rel(got.numpy(), ref) <= 1e-13


def test_vmap_over_bell_values_goes_lane_by_lane(bell, monkeypatch):
    """Batched values: one product per lane, each equal to the plain
    call."""
    op, x = bell
    vals = torch.stack([op.vals, 0.5 * op.vals])
    calls = _counting_products(monkeypatch)
    got = torch.func.vmap(lambda v: op.with_vals(v).matvec(x[0]))(vals)
    assert calls == [(256,), (256,)]
    assert torch.equal(got[1], op.with_vals(vals[1]).matvec(x[0]))


@pytest.fixture(scope="module")
def deflated():
    """A symmetric matrix, its lowest eigenvector, 4 right-hand sides
    and shifts below λ_min."""
    n = 24
    a = _sym(n, 51)
    w, vec = np.linalg.eigh(a)
    rng = np.random.default_rng(52)
    return (a, vec[:, 0], rng.standard_normal((4, n)),
            w[0] - np.array([0.1, 0.2, 0.3, 0.4]))


def test_vmap_of_solve_deflated_is_the_block_solve(deflated):
    """``vmap`` over right-hand sides and shifts is the batched CG over
    columns: equal to the block solve (1e-13: the same CG, the
    projections of the wrapper by rank-1 and by block products), to the
    per-lane loop (1e-10) and to JAX's ``vmap`` of its solve (1e-10)."""
    a, v, bs, lams = deflated
    at, vt, bt, lt = (torch.from_numpy(x) for x in (a, v, bs, lams))
    got = torch.func.vmap(lambda b, lam: port.solve_deflated(
        at, lam, vt, b, tol=TOL, device="cpu"))(bt, lt)
    block = port.solve_deflated(at, lt, vt[:, None], bt.T.contiguous(),
                                tol=TOL, device="cpu").T
    assert _rel(got.numpy(), block.numpy()) <= 1e-13
    loop = torch.stack([port.solve_deflated(at, lam, vt, b, tol=TOL,
                                            device="cpu")
                        for b, lam in zip(bt, lt)])
    assert _rel(got.numpy(), loop.numpy()) <= 1e-10
    ref = jax.jit(jax.vmap(lambda b, lam: jcg.solve_deflated(
        jx.DenseOperator(jnp.asarray(a)), lam, jnp.asarray(v), b,
        tol=TOL)))(jnp.asarray(bs), jnp.asarray(lams))
    assert _rel(got.numpy(), ref) <= 1e-10


@pytest.mark.parametrize("what", ["minres", "operator"])
def test_vmap_of_solve_deflated_per_lane(deflated, what):
    """MINRES (one batched MINRES over the lanes as columns since the
    spectral slice's rule needs it), or a batched operator (lane by
    lane): equal to the loop (1e-13; the wrapper's projections run
    batched)."""
    a, v, bs, lams = deflated
    at, vt, bt, lt = (torch.from_numpy(x) for x in (a, v, bs, lams))
    if what == "minres":
        def solve(b, lam):
            return port.solve_deflated(at, lam, vt, b, tol=TOL,
                                       method="minres", device="cpu")
        got = torch.func.vmap(solve)(bt, lt)
        loop = torch.stack([solve(b, lam) for b, lam in zip(bt, lt)])
    else:
        mats = torch.stack([at, at + 0.01 * torch.eye(24, dtype=F64)])

        def solve(m):
            return port.solve_deflated(m, lt[0], vt, bt[0], tol=TOL,
                                       device="cpu")
        got = torch.func.vmap(solve)(mats)
        loop = torch.stack([solve(m) for m in mats])
    assert _rel(got.numpy(), loop.numpy()) <= 1e-13


@pytest.fixture(scope="module")
def jax_e0_batch():
    """JAX's ``vmap`` of E0 and of its ``grad`` over 3 couplings (TFIM
    N = 6), as ``tests/test_eigh_multi.py:115``."""
    def e0(g):
        return jx.dominant_eigh(jm.tfim_operator(6, g), k=64,
                                extreme="min", tol=TOL)[0]

    gs = jnp.linspace(0.5, 1.5, 3)
    return (np.asarray(jax.jit(jax.vmap(e0))(gs)),
            np.asarray(jax.jit(jax.vmap(jax.grad(e0)))(gs)))


@pytest.mark.parametrize("transform", ["vmap", "vmap_grad"])
def test_vmap_of_e0_over_couplings(jax_e0_batch, transform):
    """``vmap`` and ``vmap∘grad`` of E0 over 3 couplings against JAX's
    (1e-10, 1e-8) and the pointwise calls (1e-12)."""
    def e0(g):
        return port.dominant_eigh(models.tfim_operator(6, g, device="cpu"),
                                  k=64, extreme="min", tol=TOL,
                                  device="cpu")[0]

    f = e0 if transform == "vmap" else torch.func.grad(e0)
    gs = torch.linspace(0.5, 1.5, 3, dtype=F64)
    got = torch.func.vmap(f)(gs).numpy()
    want = jax_e0_batch[0 if transform == "vmap" else 1]
    assert _rel(got, want) <= (1e-10 if transform == "vmap" else 1e-8)
    assert _rel(got, [float(f(g)) for g in gs]) <= 1e-12


def test_vmap_of_lanczos_carry_with_a_breakdown_lane():
    """Restart mode "carry" runs under ``vmap`` itself: one lane breaks
    down (an invariant subspace after one step), one does not; both
    match their pointwise solves (1e-12), the dense spectrum (1e-8) and
    JAX's ``vmap`` (1e-10).  Mode "cond" reads the host a step and
    raises a clear error under ``vmap``."""
    n, k = 16, 16
    a_break = np.diag([1.0, 2.0] + [0.0] * (n - 2))
    mats = np.stack([a_break, _sym(n, 9)])
    v0 = np.zeros(n)
    v0[0] = 1.0
    mt, v0t = torch.from_numpy(mats), torch.from_numpy(v0)

    def smallest(a, mode="carry"):
        return port.lanczos_eigh(port.DenseOperator(a), k, extreme="min",
                                 v0=v0t, restart_mode=mode, device="cpu")[0]

    got = torch.func.vmap(smallest)(mt).numpy()
    assert _rel(got, [float(smallest(m)) for m in mt]) <= 1e-12
    assert np.abs(got - np.linalg.eigvalsh(mats)[:, 0]).max() <= 1e-8
    ref = jax.jit(jax.vmap(lambda a: jlz.lanczos_eigh(
        jx.DenseOperator(a), k, extreme="min", v0=jnp.asarray(v0),
        restart_mode="carry")[0]))(jnp.asarray(mats))
    assert np.abs(got - np.asarray(ref)).max() <= 1e-10
    with pytest.raises(RuntimeError, match="restart_mode='carry'"):
        torch.func.vmap(lambda a: smallest(a, "cond"))(mt)


def test_sweep_matches_jax():
    """``tfim_observables_sweep`` (``vmap`` of one forward-mode pass) on
    TFIM N = 8 against JAX's sweep (1e-9) and the ED oracle (1e-8)."""
    n, gs = 8, [0.6, 1.0, 1.3]
    got = models.tfim_observables_sweep(n, gs, k=256, tol=TOL,
                                        device="cpu").numpy()
    want = np.asarray(jax.jit(lambda g: jm.tfim_observables_sweep(
        n, g, k=256, tol=TOL))(jnp.asarray(gs)))
    assert _rel(got, want) <= 1e-9
    for row, g in zip(got, gs):
        ed = [float(t) for t in models.tfim_ed_observables(n, g,
                                                          device="cpu")]
        assert _rel(row, [ed[0], ed[1], ed[3]]) <= 1e-8


@pytest.mark.parametrize("name", ["eigh_multi", "eig", "eig_pair", "eigh_safe",
                                  "eigh_safe_truncated", "svd_safe",
                                  "svd_safe_truncated"])
def test_vmap_per_lane_matches_the_loop(name):
    """The per-lane rule of the other Functions: ``vmap`` over 2 matrices
    equals the loop bit for bit."""
    n = 12
    rng = np.random.default_rng(61)
    if name in ("eig", "eig_pair"):
        mats = rng.uniform(size=(2, n, n)) + 0.1
    else:
        mats = np.stack([_sym(n, 62), _sym(n, 63)])
    calls = {
        "eigh_multi": lambda m: port.dominant_eigh_multi(
            m, r=2, k=n, tol=TOL, device="cpu"),
        "eig": lambda m: port.dominant_eig(m, tol=TOL, device="cpu"),
        "eig_pair": lambda m: port.dominant_eig_pair(m, tol=TOL,
                                                     device="cpu"),
        "eigh_safe": lambda m: port.eigh_safe(m, device="cpu"),
        "eigh_safe_truncated": lambda m: port.eigh_safe_truncated(
            m, 3, device="cpu"),
        "svd_safe": lambda m: port.svd_safe(m, device="cpu"),
        "svd_safe_truncated": lambda m: port.svd_safe_truncated(
            m, 3, device="cpu"),
    }
    mt = torch.from_numpy(mats)
    got = torch.func.vmap(calls[name])(mt)
    for i, m in enumerate(mt):
        for g, w in zip(got, calls[name](m)):
            assert torch.equal(g[i], w)


# -- gradcheck and gradgradcheck of every Function ----------------------------

def _sym_param(n, seed):
    return torch.from_numpy(_sym(n, seed)).requires_grad_()


def _checks():
    """``(inputs, function)`` for each Function: tensors to outputs that
    are smooth in the inputs (gauge-free for the decompositions)."""
    n = 8
    rng = np.random.default_rng(71)
    op = port.random_bell_operator(64, 16, 3, dtype=F64, device="cpu",
                                   generator=torch.Generator().manual_seed(5))

    def sym(t):
        return (t + t.T) / 2

    def bell(vals, x):
        return spmv.bell_spmv(vals, op.cols, x, slot_plan=op.slot_plan)

    a0 = _sym(n, 72)
    w0, vec0 = np.linalg.eigh(a0)

    def deflated(m, lam, b):
        # V and the base shift from the unperturbed matrix: the deflated
        # system stays definite for the perturbed ones.
        return port.solve_deflated(sym(m), w0[0] - 0.5 + lam,
                                   torch.from_numpy(vec0[:, 0]), b,
                                   tol=TOL, device="cpu")

    def general(m, lam, u, w, rhs):
        # GMRES: a tangent in w alone gives the right-hand side (0; c),
        # on which BiCGStab's first step breaks down (in JAX too).
        o = port.DenseOperator(m)
        return port_cg._GeneralSolve.apply(o, False, TOL, None, "gmres",
                                           rhs, lam, u[:, None], w[:, None],
                                           *o.parameters())

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float64)) \
            .requires_grad_()

    w_mid = np.linalg.eigvalsh(a0)

    def interior(m):
        lam, v = port.interior_eigh(sym(m), float(w_mid[3] + 0.1), k=n,
                                    inner_tol=1e-13, tol=TOL,
                                    v0=torch.ones(n, dtype=F64),
                                    device="cpu")
        return lam, v * v

    def spectral_slice(m):
        lams, v, _ = port.spectral_slice(
            sym(m), float(w_mid[2] + w_mid[3]) / 2,
            float(w_mid[4] + w_mid[5]) / 2, r=2, degree=30, maxiter=200,
            tol=TOL, device="cpu")
        return lams, v * v

    a_pos = rng.uniform(size=(n, n)) + 0.1
    a_pair = 0.2 * rng.standard_normal((n, n))
    a_pair[:2, :2] += np.array([[1.0, 2.0], [-2.0, 1.0]])
    return {
        "bell_product": ((op.vals.clone().requires_grad_(),
                          t(rng.standard_normal(64))), bell),
        "deflated_solve": ((t(a0), t(0.1),
                            t(rng.standard_normal(n))), deflated),
        "general_solve": ((t(3 * np.eye(n) + rng.standard_normal((n, n))),
                           t(0.3), t(rng.standard_normal(n)),
                           t(rng.standard_normal(n)),
                           t(rng.standard_normal(n + 1))), general),
        "dominant_eigh": ((_sym_param(n, 73),), lambda m: port.dominant_eigh(
            sym(m), k=n, tol=TOL, device="cpu")),
        "interior_eigh": ((t(a0),), interior),
        "spectral_slice": ((t(a0),), spectral_slice),
        "dominant_eigh_multi": ((_sym_param(n, 74),),
                                lambda m: port.dominant_eigh_multi(
                                    sym(m), r=2, k=n, tol=TOL,
                                    device="cpu")),
        "dominant_eig": ((t(a_pos),), lambda m: port.dominant_eig(
            m, tol=TOL, power_tol=1e-14, device="cpu")),
        "dominant_eig_pair": ((t(a_pair),), lambda m: port.dominant_eig_pair(
            m, tol=TOL, power_tol=1e-14, num_iters=2000, device="cpu")),
        "eigh_safe": ((_sym_param(n, 75),), lambda m: (
            lambda w, v: (w, v * v))(*port.eigh_safe(m, device="cpu"))),
        "eigh_safe_truncated": ((_sym_param(n, 76),), lambda m: (
            lambda w, v: (w, v * v))(*port.eigh_safe_truncated(
                m, 3, device="cpu"))),
        "svd_safe": ((t(rng.standard_normal((n, n))),), lambda m: (
            lambda u, s, vt: (u * u, s, vt * vt))(
                *port.svd_safe(m, device="cpu"))),
        "svd_safe_truncated": ((t(rng.standard_normal((n, n))),), lambda m: (
            lambda u, s, vt: (u * u, s, vt * vt))(
                *port.svd_safe_truncated(m, 3, oversample=5, device="cpu"))),
    }


_CHECKS = _checks()
# The Functions whose backward runs a solver: it reads the host, which the
# prototype vmap of gradcheck's batched-gradient check (torch._vmap_internals,
# which runs no Function's vmap rule) cannot batch.  Their batched
# gradients are checked through torch.func.vmap instead.
_SOLVERS = ("deflated_solve", "general_solve", "dominant_eigh",
            "dominant_eigh_multi", "dominant_eig", "dominant_eig_pair",
            "interior_eigh", "spectral_slice")


def _func_batched_grad(fn, inputs, batch=3):
    """``torch.func.vmap`` of the vjp over ``batch`` random cotangents
    against the vjp of each (1e-10)."""
    inputs = tuple(t.detach() for t in inputs)
    outs, vjp_fn = torch.func.vjp(fn, *inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(9)
    cots = tuple(torch.randn((batch, *o.shape), dtype=o.dtype, generator=gen)
                 for o in outs)
    got = torch.func.vmap(lambda *c: vjp_fn(c if len(c) > 1 else c[0]))(
        *cots)
    for i in range(batch):
        lane = vjp_fn(tuple(c[i] for c in cots) if len(cots) > 1
                      else cots[0][i])
        for g, w in zip(got, lane):
            assert _rel(g[i].numpy(), w.numpy()) <= 1e-10


@pytest.mark.parametrize("name", sorted(_CHECKS))
def test_gradcheck_and_gradgradcheck(name):
    """Every Function's first derivatives in both modes and with batched
    cotangents (``vmap`` over its backward), and its second derivatives
    with forward over reverse, against central differences."""
    inputs, fn = _CHECKS[name]
    solver = name in _SOLVERS
    assert gradcheck(fn, inputs, check_forward_ad=True,
                     check_batched_grad=not solver, fast_mode=True)
    if solver:
        _func_batched_grad(fn, inputs)
    assert gradgradcheck(fn, inputs, check_fwd_over_rev=True,
                         fast_mode=True)


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group (in this process) and its shard group."""
    with tempfile.TemporaryDirectory() as d:
        port.init_distributed("gloo", f"file://{d}/store", 0, 1)
        try:
            yield port.make_mesh()
        finally:
            dist.destroy_process_group()


def _collective(name, sg):
    """The collective ``name`` as a function of one tensor (``ppermute``
    on the one rank's identity permutation)."""
    if name == "ppermute":
        return lambda z: coll.ppermute(z, sg, [(0, 0)])
    return lambda z: getattr(coll, name)(z, sg)


@pytest.mark.parametrize("name", ["replicate", "gather_rows",
                                  "sum_over_ranks", "ppermute"])
def test_collectives_gradcheck_jvp_and_vmap(one_rank, name):
    """The collectives are linear: gradcheck in both modes, gradgradcheck
    (their backwards are collectives again, so a double backward runs
    through them), batched cotangents by ``torch.func.vmap`` of the vjp,
    a nested ``torch.func.jvp`` (the same collective on the tangent,
    twice), and ``vmap`` (one collective per lane)."""
    fn = _collective(name, one_rank)
    x = torch.randn(6, dtype=F64, requires_grad=True)
    # gradcheck's prototype vmap runs no Function's vmap rule and cannot
    # batch a collective: the batched gradient goes through torch.func.
    assert gradcheck(fn, (x,), check_forward_ad=True, fast_mode=True)
    assert gradgradcheck(fn, (x,), check_fwd_over_rev=True, fast_mode=True)
    _func_batched_grad(fn, (x,))
    dx = torch.randn(6, dtype=F64)

    def cube(z):
        return (fn(z) ** 3).sum()

    _, d2 = torch.func.jvp(lambda s: torch.func.jvp(cube, (s,), (dx,))[1],
                           (x.detach(),), (dx,))
    assert torch.allclose(d2, (6 * x.detach() * dx * dx).sum(), rtol=1e-14)
    xs = torch.randn(3, 6, dtype=F64)
    assert torch.equal(torch.func.vmap(fn)(xs), xs)
