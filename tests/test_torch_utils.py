"""The port's ``utils/`` (timing, the profiler trace and the solvers'
named ranges, the JSONL logger, diagnostics and convergence guards)
against the JAX package's (CPU, f64), after ``tests/test_utils.py`` and
the guards of ``tests/test_convergence.py``.  The JAX guards are
``checkify`` checks; the port's raise where those report an error."""

import collections
import importlib
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import dominantsparseeigenad_tpu as J
from dominantsparseeigenad_tpu import models as jm
from dominantsparseeigenad_tpu import utils as ju
from dominantsparseeigenad_tpu.ops.cg import solve_deflated_info as j_sdi
from dominantsparseeigenad_tpu.ops.lanczos import LanczosResult as JLR

import dominantsparseeigenad_tpu_torch as port
from dominantsparseeigenad_tpu_torch import utils
from dominantsparseeigenad_tpu_torch.ops.cg import solve_deflated_info

# The module, not the function of the same name that ops exports.
port_cg = importlib.import_module("dominantsparseeigenad_tpu_torch.ops.cg")

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
F64 = torch.float64
RANGES = ("lanczos_matvec", "lanczos_reorth", "cg_matvec", "bicgstab_matvec")


@pytest.fixture(scope="module", autouse=True)
def _release_jax_compilations():
    """Free this module's JAX executables when it is done."""
    yield
    jax.clear_caches()


def _sym(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- timing -------------------------------------------------------------

def test_timeit_and_sync():
    a = torch.from_numpy(_sym(64))
    res = utils.timeit(lambda x: x @ x, a, repeats=3, warmup=1)
    assert len(res.times_s) == 3 and res.best > 0
    out = utils.sync(a @ a)
    np.testing.assert_allclose(out.numpy(), _sym(64) @ _sym(64))
    tree = {"x": a, "pair": (a[:0], 2.0), "none": None}
    assert utils.sync(tree) is tree


def test_timing_result_matches_jax():
    times = [3e-3, 1e-3, 2.5e-3, 4e-3]
    mine, theirs = utils.TimingResult(times), ju.TimingResult(times)
    assert repr(mine) == repr(theirs)
    assert (mine.best, mine.median) == (theirs.best, theirs.median)


# -- the logger ---------------------------------------------------------

def test_jsonl_records_match_jax(tmp_path):
    """The same fields (0-d, float64, bfloat16 and integer tensors, nested
    shapes, Python values) give the JAX logger's records, but for t."""
    rng = np.random.default_rng(1)
    m = rng.standard_normal((2, 3))
    pairs = [
        ({"residual": torch.tensor(1e-3, dtype=F64), "iter": 3},
         {"residual": jnp.float64(1e-3), "iter": 3}),
        ({"m": torch.from_numpy(m), "ok": True, "name": "x"},
         {"m": jnp.asarray(m), "ok": True, "name": "x"}),
        ({"b": torch.tensor([1.5, 2.25, -0.1], dtype=torch.bfloat16),
          "i": torch.arange(4, dtype=torch.int32).reshape(2, 2)},
         {"b": jnp.asarray([1.5, 2.25, -0.1], jnp.bfloat16),
          "i": jnp.arange(4, dtype=jnp.int32).reshape(2, 2)}),
        ({"a": np.arange(3.0), "none": None},
         {"a": np.arange(3.0), "none": None}),
    ]
    for name, logger, side in (("port", utils.JsonlLogger, 0),
                               ("jax", ju.JsonlLogger, 1)):
        with logger(str(tmp_path / f"{name}.jsonl")) as log:
            for i, pair in enumerate(pairs):
                log.log(f"event{i}", **pair[side])
    recs = {name: [json.loads(line) for line in
                   open(tmp_path / f"{name}.jsonl")]
            for name in ("port", "jax")}
    assert len(recs["port"]) == len(pairs)
    for mine, theirs in zip(recs["port"], recs["jax"]):
        assert isinstance(mine.pop("t"), float)
        theirs.pop("t")
        assert mine == theirs


def test_jsonl_appends_and_writes_stderr(tmp_path, capsys):
    path = str(tmp_path / "log.jsonl")
    for step in range(2):
        with utils.JsonlLogger(path) as log:
            log.log("step", k=step)
    assert [json.loads(line)["k"] for line in open(path)] == [0, 1]
    with utils.JsonlLogger() as log:
        log.log("done", ok=True)
    err = capsys.readouterr().err.strip().splitlines()
    assert json.loads(err[-1])["event"] == "done"


# -- diagnostics ---------------------------------------------------------

@pytest.fixture(scope="module")
def lanczos_runs():
    """A partially converged Lanczos run (n = 80, k = 12, one v0) in both
    packages, a complex Hermitian one (n = 40, k = 20), and a Lanczos run
    with a breakdown (rank-4 operator, k = 8)."""
    rng = np.random.default_rng(3)
    a = _sym(80, seed=3)
    v0 = rng.standard_normal(80)
    h = rng.standard_normal((40, 40)) + 1j * rng.standard_normal((40, 40))
    h = (h + h.conj().T) / 2
    hv0 = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    p, _ = np.linalg.qr(rng.standard_normal((32, 4)))
    low = (p * np.array([3.0, 1.0, -1.0, -2.0])) @ p.T
    lv0 = rng.standard_normal(32)
    out = {}
    for name, mat, k, start in (("real", a, 12, v0), ("complex", h, 20, hv0),
                                ("breakdown", low, 8, lv0)):
        res = port.lanczos(torch.from_numpy(mat), k,
                           v0=torch.from_numpy(start), device="cpu")
        jres = jax.jit(lambda m, s, k=k: J.lanczos(J.DenseOperator(m), k,
                                                   v0=s))(
            jnp.asarray(mat), jnp.asarray(start))
        out[name] = (mat, res, jres)
    return out


def _as_jax(res):
    return JLR(*(jnp.asarray(t.numpy()) for t in res))


@pytest.mark.parametrize("name", ["real", "complex", "breakdown"])
def test_lanczos_health_matches_jax(lanczos_runs, name):
    """Every key of ``lanczos_health`` against JAX's on the same run
    (1e-12; the orthogonality loss and the Ritz residuals, themselves
    relative numbers down to ~1e-15, to 1e-12 absolute), and on the two
    packages' runs from the same v0 (the residuals to 1e-10 absolute,
    the Ritz values to 1e-10)."""
    mat, res, jres = lanczos_runs[name]
    op = torch.from_numpy(mat)
    mine = utils.lanczos_health(op, res)
    same = ju.lanczos_health(J.DenseOperator(jnp.asarray(mat)), _as_jax(res))
    own = ju.lanczos_health(J.DenseOperator(jnp.asarray(mat)), jres)
    assert set(mine) == set(same)
    assert abs(float(mine["ortho_loss"]) - float(same["ortho_loss"])) \
        <= 1e-12
    assert float(mine["ortho_loss"]) < 1e-12
    for key in ("ritz_residual_min", "ritz_residual_max"):
        assert abs(float(mine[key]) - float(same[key])) <= 1e-12, key
        assert abs(float(mine[key]) - float(own[key])) <= 1e-10, key
    assert int(mine["breakdowns"]) == int(same["breakdowns"]) \
        == int(own["breakdowns"])
    assert (int(mine["breakdowns"]) > 0) == (name == "breakdown")
    ext = [float(x) for x in mine["ritz_extremes"]]
    assert _rel(ext, [float(x) for x in same["ritz_extremes"]]) <= 1e-12
    assert _rel(ext, [float(x) for x in own["ritz_extremes"]]) <= 1e-10


def test_orthogonality_loss_complex_basis(lanczos_runs):
    """The conjugate transpose: a complex orthonormal basis has loss ~0
    (Q^T Q would report O(1)), as JAX's regression test asserts."""
    _, res, _ = lanczos_runs["complex"]
    assert float(utils.orthogonality_loss(res)) < 1e-12
    plain = (res.basis.T @ res.basis - torch.eye(20)).abs().max()
    assert float(plain) > 0.1


def test_ritz_residual_matches_jax(lanczos_runs):
    mat, res, _ = lanczos_runs["real"]
    lam, v = port.lanczos_eigh(torch.from_numpy(mat), 12, extreme="min",
                               v0=res.basis[:, 0], device="cpu")
    mine = utils.ritz_residual(torch.from_numpy(mat), lam, v)
    theirs = ju.ritz_residual(jnp.asarray(mat), jnp.asarray(float(lam)),
                              jnp.asarray(v.numpy()))
    assert _rel(float(mine), float(theirs)) <= 1e-12
    assert float(mine) > 1e-4                  # k = 12 of 80: not converged


@pytest.mark.parametrize("maxiter", [5, None], ids=["capped", "full"])
def test_cg_relative_residual_matches_jax(maxiter):
    """CG on the same SPD system in both packages; the relative residual
    of the same (b, x) at 1e-12 (of at least 1e-3: a converged run's
    residual, ~1e-13, is round-off), and of each package's own x (a
    capped run: 5 iterations of both) at 1e-8."""
    a = _sym(80, seed=3)
    spd = a @ a.T + 80 * np.eye(80)
    b = np.random.default_rng(0).standard_normal(80)
    st, bt = torch.from_numpy(spd), torch.from_numpy(b)
    x = port.cg(lambda v: st @ v, bt, tol=1e-12, maxiter=maxiter,
                device="cpu")
    xj = J.cg(lambda v: jnp.asarray(spd) @ v, jnp.asarray(b), tol=1e-12,
              maxiter=maxiter)
    mine = float(utils.cg_relative_residual(lambda v: st @ v, bt, x))
    same = float(ju.cg_relative_residual(lambda v: jnp.asarray(spd) @ v,
                                         jnp.asarray(b),
                                         jnp.asarray(x.numpy())))
    own = float(ju.cg_relative_residual(lambda v: jnp.asarray(spd) @ v,
                                        jnp.asarray(b), xj))
    assert abs(mine - same) <= 1e-12 * max(same, 1e-3)
    if maxiter is None:
        assert mine < 1e-10 and own < 1e-10
    else:
        assert mine > 1e-6 and _rel(mine, own) <= 1e-8


# -- the convergence guards ---------------------------------------------

@pytest.fixture(scope="module")
def tfim_h():
    return np.array(jm.tfim_dense_hamiltonian(8, 1.0))  # dim 256


def _jax_guard_fails(fn, *args) -> bool:
    err, _ = checkify.checkify(fn)(*args)
    return err.get() is not None


def _eigh_case(k):
    def port_side(h):
        _, _, info = port.dominant_eigh(torch.from_numpy(h), k=k,
                                        extreme="min", with_info=True,
                                        device="cpu")
        utils.assert_converged(info)

    def jax_side(h):
        _, _, info = J.dominant_eigh(J.DenseOperator(h), k=k, extreme="min",
                                     with_info=True)
        ju.assert_converged(info)
    return port_side, jax_side, "did not converge"


def _adaptive_case(k):
    def port_side(h):
        _, _, info = port.lanczos_adaptive(torch.from_numpy(h), k,
                                           extreme="min", tol=1e-10,
                                           device="cpu")
        utils.assert_converged(info, name="adaptive")

    def jax_side(h):
        _, _, info = J.lanczos_adaptive(J.DenseOperator(h), k,
                                        extreme="min", tol=1e-10)
        ju.assert_converged(info, name="adaptive")
    return port_side, jax_side, "adaptive did not converge"


def _solve_case(maxiter):
    def operands(h):
        e, vecs = np.linalg.eigh(np.asarray(h))
        b = np.random.default_rng(0).standard_normal(h.shape[0])
        return e[0], vecs[:, 0], b

    def port_side(h):
        lam, v, b = operands(h)
        _, _, resid = solve_deflated_info(
            torch.from_numpy(h), torch.tensor(lam), torch.from_numpy(v),
            torch.from_numpy(b), tol=1e-12, maxiter=maxiter, device="cpu")
        utils.assert_converged_residual(resid, 1e-9)

    def jax_side(h):
        lam, v, b = operands(h)
        _, _, resid = j_sdi(J.DenseOperator(h), jnp.asarray(lam),
                            jnp.asarray(v), jnp.asarray(b), tol=1e-12,
                            maxiter=maxiter)
        ju.assert_converged_residual(resid, 1e-9)
    return port_side, jax_side, "above tolerance"


@pytest.mark.parametrize("case", [
    ("adaptive k=6", lambda: _adaptive_case(6)),
    ("adaptive k=120", lambda: _adaptive_case(120)),
    ("dominant_eigh k=5", lambda: _eigh_case(5)),
    ("dominant_eigh k=60", lambda: _eigh_case(60)),
    ("deflated solve maxiter=3", lambda: _solve_case(3)),
    ("deflated solve full", lambda: _solve_case(None)),
], ids=lambda c: c[0])
def test_guards_raise_where_checkify_reports(tfim_h, case):
    """``assert_converged`` / ``assert_converged_residual`` raise exactly
    where the JAX guards under ``checkify`` report an error
    (``tests/test_convergence.py:49-56``, ``:104-124``, ``:126-151``),
    with the JAX message."""
    port_side, jax_side, message = case[1]()
    jax_fails = _jax_guard_fails(jax_side, jnp.asarray(tfim_h))
    if jax_fails:
        with pytest.raises(RuntimeError, match=message):
            port_side(tfim_h)
    else:
        port_side(tfim_h)
    assert jax_fails == (case[0] in ("adaptive k=6", "dominant_eigh k=5",
                                     "deflated solve maxiter=3"))


def test_guard_messages_and_nan():
    info = port.LanczosInfo(torch.tensor(5.0), torch.tensor(0.25),
                            torch.tensor(0.0))
    with pytest.raises(RuntimeError, match=r"^eigensolver did not converge: "
                       r"residual 0\.25 after 5\.0 steps$"):
        utils.assert_converged(info)
    utils.assert_converged(info._replace(converged=torch.tensor(1.0)))
    with pytest.raises(RuntimeError, match=r"^cg residual nan above "
                       r"tolerance 1e-06$"):
        utils.assert_converged_residual(torch.tensor(float("nan")), 1e-6,
                                        name="cg")
    utils.assert_converged_residual(1e-7, 1e-6)


# -- the profiler trace and the named ranges ----------------------------

def _range_counts(log_dir):
    files = sorted(pathlib.Path(log_dir).glob("trace_*.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    return collections.Counter(e["name"] for e in events
                               if e.get("name") in RANGES)


def test_trace_holds_the_named_ranges(tmp_path, monkeypatch):
    """``trace(device="cpu")`` around a ``dominant_eigh`` forward and
    backward (a deflated CG) and a BiCGStab solve writes one file with
    each range once per product: k Lanczos matvecs and reorthogonalization
    blocks, the CG's products, two per BiCGStab iteration."""
    a = torch.from_numpy(_sym(48, seed=5)).requires_grad_(True)
    c = torch.from_numpy(np.random.default_rng(6).standard_normal(48))
    m = torch.from_numpy(_sym(48, seed=7) + 20 * np.eye(48))
    cg_products = []
    loop = port_cg._cg_loop

    def counted_cg(*args, **kw):
        x, it = loop(*args, **kw)
        cg_products.append(it)
        return x, it

    monkeypatch.setattr(port_cg, "_cg_loop", counted_cg)
    bicg_products = []

    def mv(x):
        bicg_products.append(1)
        return m @ x

    k = 20
    with utils.trace(str(tmp_path), device="cpu") as log_dir:
        lam, v = port.dominant_eigh(a, k=k, tol=1e-10, device="cpu")
        (lam + c @ v).backward()
        x = port.bicgstab(mv, c, tol=1e-10, device="cpu")
    assert log_dir == str(tmp_path)
    counts = _range_counts(tmp_path)
    assert sum(cg_products) > 0 and len(bicg_products) > 0
    assert counts == {"lanczos_matvec": k, "lanczos_reorth": k,
                      "cg_matvec": sum(cg_products),
                      "bicgstab_matvec": len(bicg_products)}
    assert float(torch.linalg.vector_norm(m @ x - c)) < 1e-8


def test_traces_into_one_directory_do_not_overwrite(tmp_path):
    for _ in range(2):
        with utils.trace(str(tmp_path), device="cpu"):
            torch.ones(3).sum()
    assert len(list(tmp_path.glob("trace_*.json"))) == 2


def test_trace_needs_a_card_or_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with utils.trace(str(tmp_path)):
            pass
    assert not list(tmp_path.glob("trace_*.json"))


def test_named_ranges_sit_where_jax_names_its_scopes():
    """Each range name occurs in the port's ``ops/`` as often, and in the
    same file, as the JAX package's ``jax.named_scope`` of that name, and
    nowhere else in the port."""
    pat_jax = re.compile(r'named_scope\("(\w+)"\)')
    pat_port = re.compile(r'record_function\("(\w+)"\)')

    def found(pkg, pat):
        out = collections.Counter()
        for path in sorted((ROOT / pkg).rglob("*.py")):
            for name in pat.findall(path.read_text()):
                out[(path.relative_to(ROOT / pkg).as_posix(), name)] += 1
        return out

    jax_sites = found("dominantsparseeigenad_tpu", pat_jax)
    assert sum(jax_sites.values()) == 5
    assert found("dominantsparseeigenad_tpu_torch", pat_port) == jax_sites


def test_utils_exports_the_jax_list():
    assert set(utils.__all__) == set(ju.__all__)
    assert all(callable(getattr(utils, name)) for name in utils.__all__)
