"""The mesh solves of madipm_tpu_torch/parallel on the CPU: gloo ranks of
world size 4 against the port's one-process solve and the JAX package's
one-device solve (the world-size-2 cases are in test_torch_mesh_batch.py,
which takes its helpers from here).

The JAX side is a one-device solve (``jax.jit(driver.solve_device)``, as
tests/test_parallel.py runs it) or a one-device ``madipm_batch``, never a
JAX mesh solve; the ranks of each world size start once
(``tools/gloo_ranks.py``, 120 s deadline) and run every case while this
process computes the references.

Per case: the same status and the same iterations as the port's
one-process solve, iterations within +-1 of JAX's, objectives to 1e-8
relative (fp64) or 1e-7 (fp32 factor), and the solution bit-identical on
every rank.  This module imports no JAX at its top: the ranks import it to
find their functions.
"""

import numpy as np
import pytest
import torch

import madipm_tpu_torch as mtt
from madipm_tpu_torch.tools.gloo_ranks import start_ranks

torch.set_num_threads(2)  # six xdist workers share the host

QUIET = dict(print_level="ERROR")
LP32 = dict(linear_solver="CHOLESKY_INV", factor_dtype="float32", refinement_steps=6)
K1 = dict(kkt_system="CONDENSED")
K1_32 = dict(K1, linear_solver="CHOLESKY_INV", factor_dtype="float32", refinement_steps=8)


def _opts(pkg, kw):
    """Options by enum name for either package."""
    out = {}
    for k, v in dict(QUIET, **kw).items():
        enum = {"print_level": pkg.PrintLevel, "linear_solver": pkg.LinearSolver,
                "kkt_system": pkg.KKTSystem}.get(k)
        out[k] = enum[v] if enum is not None else v
    return out


def _lp_data(n, m, seed):
    """tests/conftest.random_lp's instance (no upper bounds)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    xstar = rng.random(n) + 0.5
    c = rng.random(n) + 0.1
    uvar = np.full(n, np.inf)
    ub = rng.random(n) < 0.3
    uvar[ub] = xstar[ub] + rng.random(ub.sum()) * 3.0
    return dict(c=c, A=A, lcon=A @ xstar, ucon=A @ xstar, lvar=np.zeros(n), uvar=uvar)


def _qp_data(seed, n=24, m=8):
    """tests/test_parallel.py's K1 model."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    xstar = rng.random(n) + 0.5
    B = rng.standard_normal((n // 2, n)) / np.sqrt(n)
    return dict(c=rng.standard_normal(n), A=A, lcon=A @ xstar, ucon=A @ xstar, lvar=np.zeros(n),
                uvar=np.full(n, np.inf), Q=B.T @ B + 0.3 * np.eye(n))


def _batch_data():
    """Five LPs of tests/_multihost_worker.py's shape (16 x 5)."""
    out = []
    for s in range(5):
        rng = np.random.default_rng(900 + s)
        A = rng.standard_normal((5, 16))
        x = rng.random(16) + 0.5
        out.append(dict(c=rng.random(16) + 0.1, A=A, lcon=A @ x, ucon=A @ x, lvar=np.zeros(16),
                        uvar=np.full(16, np.inf)))
    return out


#: name -> (data, options, pad_multiple) of the solve_sharded cases
#: (the fp32 LP is padded to 32 in both packages: JAX's CHOLESKY_INV
#: recursion compiles several times faster there than at 128)
SHARDED = {"lp64": (_lp_data(96, 24, 77), {}, 128), "lp32": (_lp_data(96, 24, 78), LP32, 32)}
#: name -> (data, options) of the MPCSolver(mesh=...) cases
MESHED = {"mpc": (_lp_data(80, 20, 79), {}), "k1_64": (_qp_data(31), K1), "k1_32": (_qp_data(32), K1_32)}


def _model(pkg, data):
    return pkg.from_dense(**data)


def _result(st, **extra):
    return dict(status=int(st.status), iter=st.iter, objective=st.objective,
                solution=np.asarray(st.solution), **extra)


# ---------------------------------------------------------------------------
# The ranks (import torch and the port only)
# ---------------------------------------------------------------------------


def _errors(mesh, lp):
    """What each refused mesh solve raises."""
    return _refusals({
        "sparse": lambda: mtt.MPCSolver(lp, mesh=mesh, device="cpu", sparse=True),
        "augmented": lambda: mtt.MPCSolver(_model(mtt, _qp_data(31)), mesh=mesh, device="cpu",
                                           kkt_system=mtt.KKTSystem.AUGMENTED),
        "device": lambda: mtt.MPCSolver(lp, mesh=mesh, device="cuda"),
    })


def _refusals(calls):
    """name -> (type name, message) of what each call raises (None if it
    returns)."""
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 - recorded for the test to judge
            out[name] = (type(e).__name__, str(e))
    return out


def _solves(rank, world, names):
    """The mesh cases ``names`` on this rank."""
    from madipm_tpu_torch.parallel import make_mesh, solve_sharded
    from madipm_tpu_torch.tools.gloo_ranks import log

    cols = make_mesh(world, ("cols",))
    out = {}
    for name in names:
        log(name)
        if name in SHARDED:
            data, kw, pad = SHARDED[name]
            solver = mtt.MPCSolver(_model(mtt, data), device="cpu", pad_multiple=pad,
                                   **_opts(mtt, kw))
            _, scale, state = solve_sharded(solver.cfg, solver.prob, cols, distribute_factor=True)
            out[name] = _result(solver._build_stats(scale, state, 0.0))
        elif name in MESHED:
            data, kw = MESHED[name]
            solver = mtt.MPCSolver(_model(mtt, data), device="cpu", mesh=cols, **_opts(mtt, kw))
            out[name] = _result(solver.solve(logged=False), m=solver.prob.m, n=solver.prob.n,
                                dist=solver.cfg.kkt.dist_mesh is cols,
                                kind=solver.cfg.kkt.kind.name)
        elif name in ("batch", "batch_sparse", "batch2d"):
            flat = name != "batch2d"
            shape = (world,) if flat else (world // 2, 2)
            mesh = make_mesh(world, ("batch",) if flat else ("batch", "cols"), shape=shape)
            stats = mtt.madipm_batch([_model(mtt, d) for d in _batch_data()], device="cpu",
                                     mesh=mesh, sparse=name == "batch_sparse", **_opts(mtt, {}))
            out[name] = [_result(st) for st in stats]
        elif name == "solve_batched":
            from madipm_tpu_torch.parallel.batch import batched_stats, bucket_pad, solve_batched
            from madipm_tpu_torch.solver import driver
            from madipm_tpu_torch.utils.options import load_options

            models = [_model(mtt, d) for d in _batch_data()]
            probs, _ = bucket_pad(models, device="cpu")
            cfg = driver.make_config(load_options(**_opts(mtt, {})), is_qp=False,
                                     dtype=torch.float64)
            _, scale, state = solve_batched(cfg, probs, mesh=make_mesh(world, ("batch",)))
            out[name] = [_result(st) for st in batched_stats(models, scale, state, 0.0)]
        elif name == "errors":
            out[name] = _errors(cols, _model(mtt, SHARDED["lp64"][0]))
        elif name == "meshes":
            from madipm_tpu_torch.parallel import batch_sharding, make_multihost_mesh, replicated

            grid = make_multihost_mesh(cols=2)
            out[name] = dict(shape=tuple(grid.mesh.shape), names=grid.mesh_dim_names,
                             placements=repr(batch_sharding(grid)), replicated=repr(replicated(grid)),
                             errors=_refusals({
                                 "cols=3": lambda: make_multihost_mesh(cols=3),
                                 "n_devices=3": lambda: make_mesh(3, ("cols",)),
                             }), device_type=grid.device_type)
        elif name == "drivers":
            lp = _model(mtt, MESHED["mpc"][0])
            solver = mtt.MPCSolver(lp, device="cpu", mesh=cols, **_opts(mtt, {}))
            out[name] = dict(logged=_result(solver.solve(logged=True)),
                             timed=_result(solver.solve(timed=True)))
            out["walltime"] = _result(mtt.MPCSolver(lp, device="cpu", mesh=cols, max_wall_time=0.0,
                                                    **_opts(mtt, {})).solve(logged=False))
    return out


def _world4(rank, world):
    return _solves(rank, world,
                   ["lp64", "lp32", "mpc", "k1_64", "k1_32", "batch2d", "errors", "drivers",
                    "meshes"])


# ---------------------------------------------------------------------------
# References and fixtures
# ---------------------------------------------------------------------------


def port_refs(world, names):
    """The port's one-process solves of the same padded problems."""
    from madipm_tpu_torch.solver import driver

    out = {}
    for name in names:
        if name in SHARDED:
            data, kw, pad = SHARDED[name]
            solver = mtt.MPCSolver(_model(mtt, data), device="cpu", pad_multiple=pad,
                                   **_opts(mtt, kw))
            _, scale, state = driver.solve_device(solver.cfg, solver.prob)
            out[name] = _result(solver._build_stats(scale, state, 0.0))
        elif name in MESHED:
            data, kw = MESHED[name]
            solver = mtt.MPCSolver(_model(mtt, data), device="cpu", pad_multiple=128 * world,
                                   **_opts(mtt, kw))
            out[name] = _result(solver.solve(logged=False))
        else:  # a batch, dense or ELL
            models = [_model(mtt, d) for d in _batch_data()]
            stats = mtt.madipm_batch(models, device="cpu", sparse=name == "batch_sparse",
                                     **_opts(mtt, {}))
            out[name] = [_result(st) for st in stats]
    return out


def jax_refs_of(names):
    """The JAX package's one-device solves, padded as the port's
    one-process solves are."""
    import jax

    import madipm_tpu as mt
    from madipm_tpu.parallel.batch import madipm_batch
    from madipm_tpu.solver import driver

    run = jax.jit(driver.solve_device, static_argnums=0)
    out = {}
    cases = {name: (data, kw, pad) for name, (data, kw, pad) in SHARDED.items()}
    cases.update({name: (data, kw, 128) for name, (data, kw) in MESHED.items()})
    for name in names:
        if name == "batch":
            models = [_model(mt, d) for d in _batch_data()]
            out[name] = [_result(st) for st in madipm_batch(models, **_opts(mt, {}))]
            continue
        data, kw, pad = cases[name]
        solver = mt.MPCSolver(_model(mt, data), pad_multiple=pad, **_opts(mt, kw))
        _, scale, state = run(solver.cfg, solver.prob)
        out[name] = _result(solver._build_stats(scale, state, 0.0))
    return out


def run_with_refs(request, fn, world, port_names):
    """The ranks' results and the port's references; the JAX references
    (the module's ``jax_refs`` fixture) are computed while the ranks run."""
    run = start_ranks(fn, world, request.getfixturevalue("tmp_path_factory").mktemp(f"gloo{world}"),
                      deadline=120.0)
    port = port_refs(world, port_names)
    request.getfixturevalue("jax_refs")
    return run.wait(), port


@pytest.fixture(scope="module")
def jax_refs():
    return jax_refs_of(["lp64", "lp32", "mpc", "k1_64", "k1_32", "batch"])


@pytest.fixture(scope="module")
def world4(request):
    return run_with_refs(request, _world4, 4, ["lp64", "lp32", "mpc", "k1_64", "k1_32", "batch"])


def replicated(ranks, name):
    """Rank 0's result of ``name``, after checking that every rank has the
    same status, iterations, objective and solution, bit for bit."""
    first = ranks[0][name]
    for r in ranks[1:]:
        for a, b in zip(np.atleast_1d(first), np.atleast_1d(r[name])):
            assert a["status"] == b["status"] and a["iter"] == b["iter"]
            assert a["objective"] == b["objective"]
            assert np.array_equal(a["solution"], b["solution"]), f"{name}: ranks disagree"
    return first


def agrees(got, port, jax_ref, tol):
    """Same status and iterations as the port's one-process solve, within
    +-1 of JAX's; objectives to ``tol`` relative."""
    rel = lambda a, b: abs(a - b) / max(1.0, abs(b))
    assert got["status"] == port["status"] == jax_ref["status"]
    assert mtt.Status(got["status"]) == mtt.Status.SOLVE_SUCCEEDED
    assert got["iter"] == port["iter"]
    if got["iter"] != jax_ref["iter"]:
        print(f"iterations {got['iter']} (JAX {jax_ref['iter']}): the distributed factor orders "
              f"its sums as the gloo collectives do")
    assert abs(got["iter"] - jax_ref["iter"]) <= 1
    assert rel(got["objective"], port["objective"]) <= tol
    assert rel(got["objective"], jax_ref["objective"]) <= tol
    assert np.all(np.isfinite(got["solution"]))


@pytest.mark.parametrize("name,tol", [("lp64", 1e-8), ("lp32", 1e-7)])
def test_distributed_factor_lp(world4, jax_refs, name, tol):
    ranks, port = world4
    agrees(replicated(ranks, name), port[name], jax_refs[name], tol)


def test_mpcsolver_mesh(world4):
    from scipy.optimize import linprog

    ranks, port = world4
    got = replicated(ranks, "mpc")
    assert got["m"] % (128 * 4) == 0 and got["n"] % (128 * 4) == 0
    assert got["dist"] and got["kind"] == "NORMAL"
    assert mtt.Status(got["status"]) == mtt.Status.SOLVE_SUCCEEDED
    data = MESHED["mpc"][0]
    bounds = list(zip(data["lvar"], [None if not np.isfinite(u) else u for u in data["uvar"]]))
    ref = linprog(data["c"], A_eq=data["A"], b_eq=data["lcon"], bounds=bounds, method="highs")
    assert abs(got["objective"] - ref.fun) <= 1e-5
    assert got["iter"] == port["mpc"]["iter"]


def test_mesh_drivers(world4):
    """The logged and timed drivers on the mesh walk the fused solve's
    iterates; a wall-clock budget of 0 stops every rank at iteration 0."""
    ranks, _ = world4
    fused = replicated(ranks, "mpc")
    for r in ranks:
        for name in ("logged", "timed"):
            got = r["drivers"][name]
            assert got["status"] == fused["status"] and got["iter"] == fused["iter"]
            assert abs(got["objective"] - fused["objective"]) <= 1e-8 * max(1.0, abs(fused["objective"]))
        assert mtt.Status(r["walltime"]["status"]) == mtt.Status.MAXIMUM_WALLTIME_EXCEEDED
        assert r["walltime"]["iter"] == 0


@pytest.mark.parametrize("name,tol", [("k1_64", 1e-8), ("k1_32", 1e-7)])
def test_distributed_k1_qp(world4, jax_refs, name, tol):
    ranks, port = world4
    got = replicated(ranks, name)
    assert got["dist"] and got["kind"] == "CONDENSED"
    agrees(got, port[name], jax_refs[name], tol)


def check_batch(ranks, port, jax_refs, name, ref="batch"):
    got = replicated(ranks, name)
    assert len(got) == 5
    for g, p, j in zip(got, port[ref], jax_refs["batch"]):
        assert g["status"] == p["status"] and g["iter"] == p["iter"]
        assert g["objective"] == p["objective"] and np.array_equal(g["solution"], p["solution"])
        agrees(g, p, j, 1e-8)


def test_mesh_2d(world4, jax_refs):
    """A (batch, cols) = (2, 2) mesh: lanes over batch, replicated over cols."""
    check_batch(*world4, jax_refs, "batch2d")


@pytest.mark.parametrize("name,text", [
    ("sparse", "mesh-distributed solves use the dense path"),
    ("augmented", "the distributed factorization supports the NORMAL (LP) and CONDENSED (QP)"),
    ("device", "the mesh is on 'cpu' devices"),
])
def test_mesh_refusals(world4, name, text):
    ranks, _ = world4
    for r in ranks:
        kind, msg = r["errors"][name]
        assert kind == "ValueError" and text in msg


def test_meshes(world4):
    """make_multihost_mesh's (batch, cols) grid and placements, and the
    meshes make_mesh and make_multihost_mesh refuse."""
    ranks, _ = world4
    for r in ranks:
        got = r["meshes"]
        assert got["shape"] == (2, 2) and got["names"] == ("batch", "cols")
        assert got["placements"] == "(Shard(dim=0), Replicate())"
        assert got["replicated"] == "(Replicate(), Replicate())"
        assert got["errors"]["cols=3"][0] == "ValueError" and "per-host" in got["errors"]["cols=3"][1]
        assert got["errors"]["n_devices=3"][0] == "ValueError"
        assert got["device_type"] == "cpu"
