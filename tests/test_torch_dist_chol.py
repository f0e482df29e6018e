"""The distributed Cholesky units of madipm_tpu_torch/parallel against
madipm_tpu/parallel on the CPU.

The JAX side runs in this process on a sub-mesh of the conftest's fake CPU
devices (``make_mesh(4, ("cols",))``, and ``make_mesh(2, ...)`` for the
world-size-2 variant); the port runs in 4 (and 2) gloo ranks started once
per world size (``tools/gloo_ranks.py``, 120 s deadline), each rank holding
its row strip or column block as the shard_map body held it on its device.
The same inputs are made from seeds with numpy on both sides.

Tolerances, relative to the largest entry: L, W and jac of fp64 factors
1e-12; of fp32 factors 1e-5; solves 1e-10 against JAX and numpy; live and
ok exactly.  Replicated outputs must be bit-identical on every rank.

This module imports no JAX at its top: the ranks import it to find their
function.
"""

import numpy as np
import pytest
import torch

from madipm_tpu_torch.tools.gloo_ranks import start_ranks

torch.set_num_threads(2)  # six xdist workers share the host

M, N = 64, 128  # the Schur units' (m, n) and the Cholesky order M
DEL_C = -1e-8
SHIFT32 = 1e-6  # ops/kkt.PRECOND_SHIFT, as the fp32 factor takes it
K1_M, K1_N, K1_GAMMA = 32, 64, 1e2


def _inputs():
    """Every unit's inputs (numpy, fp64), from fixed seeds."""
    rng = np.random.default_rng(3)
    G = rng.standard_normal((M, M))
    S = G @ G.T + M * np.eye(M)
    b = np.random.default_rng(4).standard_normal(M)
    rng = np.random.default_rng(5)
    A = rng.standard_normal((M, N))
    dinv = rng.random(N) + 0.5
    dinv[N - 16:] = 0.0  # fixed or padded columns
    row_mask = np.ones(M, bool)
    row_mask[M - 8:] = False  # padded rows
    A[~row_mask] = 0.0
    Af = A.copy()
    Af[M - 9] = 0.0  # for the factor: a structurally empty row, not live
    rx = rng.standard_normal(N)
    rp = rng.standard_normal(M)
    rng = np.random.default_rng(6)
    A1 = rng.standard_normal((K1_M, K1_N))
    free = np.ones(K1_N, bool)
    free[K1_N - 8:] = False
    live = np.ones(K1_M, bool)
    live[K1_M - 4:] = False
    Bq = rng.standard_normal((K1_N // 2, K1_N)) / np.sqrt(K1_N)
    Q = (Bq.T @ Bq + 0.3 * np.eye(K1_N)) * free[:, None] * free[None, :]
    sigma = rng.random(K1_N) + 0.5
    return dict(S=S, b=b, A=A, Af=Af, dinv=dinv, row_mask=row_mask, rx=rx, rp=rp,
                A1=A1 * free[None, :], live=live, Q=Q, sigma=sigma)


# ---------------------------------------------------------------------------
# The ranks (import torch and the port only)
# ---------------------------------------------------------------------------


def _units(rank, world):
    """Every unit on this rank; returns its outputs as numpy arrays."""
    from madipm_tpu_torch.parallel import dist_chol, schur
    from madipm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, ("cols",))
    d = {k: torch.as_tensor(v) for k, v in _inputs().items()}
    rows = lambda v, mm: v[rank * (mm // world):(rank + 1) * (mm // world)]  # leading dim
    cols = lambda v: v[..., rank * (N // world):(rank + 1) * (N // world)]  # last dim
    out = {}
    L, W = dist_chol.dist_cholesky(mesh, rows(d["S"], M).contiguous())
    out["chol"] = (L, W)
    out["solve"] = dist_chol.dist_chol_solve(mesh, L, W, d["b"])
    A_k = cols(d["A"])[None].contiguous()
    args = (A_k, cols(d["dinv"])[None], cols(d["rx"])[None], d["rp"][None], d["row_mask"][None])
    out["schur"] = schur.schur_normal_solve(mesh, *args, DEL_C)
    out["schur_dist"] = dist_chol.schur_normal_solve_dist(mesh, *args, DEL_C)
    del_c = torch.full((1, 1), DEL_C, dtype=torch.float64)
    Af_k = cols(d["Af"])[None].contiguous()
    for name, fdt, shift in (("normal64", torch.float64, 0.0), ("normal32", torch.float32, SHIFT32)):
        out[name] = dist_chol.dist_factor_normal(
            mesh, Af_k, cols(d["dinv"])[None], d["row_mask"][None], del_c, shift, fdt)
    gamma = torch.full((1, 1), K1_GAMMA, dtype=torch.float64)
    A_p = rows(d["A1"], K1_M)[None].contiguous()
    live_p = rows(d["live"], K1_M)[None].to(torch.float64)
    Q_p = rows(d["Q"], K1_N)[None].contiguous()
    for name, Q in (("k1_q", Q_p), ("k1_noq", None)):
        out[name] = dist_chol.dist_factor_condensed(
            mesh, A_p, Q, d["sigma"][None], live_p, gamma, 0.0, torch.float64)
    as_np = lambda v: v.numpy() if isinstance(v, torch.Tensor) else tuple(map(as_np, v))
    return {k: as_np(v) for k, v in out.items()}


def _world2(rank, world):
    """The world-size-2 variant: the Cholesky and the fp64 NORMAL factor."""
    out = _units(rank, world)
    return {k: out[k] for k in ("chol", "solve", "normal64")}


# ---------------------------------------------------------------------------
# The JAX side and the fixtures
# ---------------------------------------------------------------------------


def _jax_units(world, names):
    """The JAX package's functions on a ``world``-device mesh, each under
    jax.jit (one XLA program; outside jit shard_map dispatches op by op)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from madipm_tpu.parallel import dist_chol, make_mesh, schur

    mesh = make_mesh(world, axis_names=("cols",))
    d = _inputs()
    j = {k: jnp.asarray(v) for k, v in d.items()}
    call = lambda f, *args: jax.jit(partial(f, mesh))(*args)
    out = {}
    L, W = call(dist_chol.dist_cholesky, j["S"])
    out["chol"] = (L, W)
    out["solve"] = call(dist_chol.dist_chol_solve, L, W, j["b"])
    args = (j["A"], j["dinv"], j["rx"], j["rp"], j["row_mask"])
    if "schur" in names:
        out["schur"] = call(partial(schur.schur_normal_solve, del_c=DEL_C), *args)
        out["schur_dist"] = call(partial(dist_chol.schur_normal_solve_dist, del_c=DEL_C), *args)
    for name, fdt, shift in (("normal64", jnp.float64, 0.0), ("normal32", jnp.float32, SHIFT32)):
        if name in names:
            f = partial(dist_chol.dist_factor_normal, del_c=DEL_C, shift=shift, factor_dtype=fdt)
            out[name] = call(f, j["Af"], j["dinv"], j["row_mask"])
    for name, Q in (("k1_q", j["Q"]), ("k1_noq", None)):
        if name in names:
            f = lambda mesh_, A1, sigma, live, Q=Q: dist_chol.dist_factor_condensed(
                mesh_, A1, Q, sigma, live, K1_GAMMA, 0.0, jnp.float64)
            out[name] = call(f, j["A1"], j["sigma"], j["live"].astype(jnp.float64))
    as_np = lambda v: np.asarray(v) if not isinstance(v, tuple) else tuple(map(as_np, v))
    return {k: as_np(v) for k, v in out.items()}


def _run(tmp_path_factory, fn, world, names):
    run = start_ranks(fn, world, tmp_path_factory.mktemp(f"gloo{world}"), deadline=120.0)
    ref = _jax_units(world, names)  # meanwhile
    return run.wait(), ref


ALL = ("schur", "normal64", "normal32", "k1_q", "k1_noq")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _run(tmp_path_factory, _units, 4, ALL)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _run(tmp_path_factory, _world2, 2, ("normal64",))


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / max(np.max(np.abs(b)), 1e-300))


def _same_on_all(ranks, key, idx=None):
    """The replicated output ``key`` (element ``idx``) is bit-identical on
    every rank; returns rank 0's."""
    get = lambda r: r[key] if idx is None else r[key][idx]
    for r in ranks[1:]:
        assert np.array_equal(get(r), get(ranks[0])), f"{key}[{idx}] differs between ranks"
    return get(ranks[0])


def _strips(ranks, key, idx):
    """A strip-sharded output put back together in rank order."""
    return np.concatenate([r[key][idx] for r in ranks], axis=-2)


def _check_cholesky(ranks, ref, world):
    L = _strips(ranks, "chol", 0)
    W = _strips(ranks, "chol", 1)
    assert _rel(L, ref["chol"][0]) <= 1e-12
    assert _rel(W, ref["chol"][1]) <= 1e-12
    S = _inputs()["S"]
    assert _rel(L, np.linalg.cholesky(S)) <= 1e-12


def test_dist_cholesky(world4):
    _check_cholesky(*world4, 4)


def test_dist_chol_solve(world4):
    ranks, ref = world4
    x = _same_on_all(ranks, "solve")
    d = _inputs()
    assert _rel(x, ref["solve"]) <= 1e-10
    assert _rel(x, np.linalg.solve(d["S"], d["b"])) <= 1e-10


@pytest.mark.parametrize("name", ["schur", "schur_dist"])
def test_schur_normal_solve(world4, name):
    ranks, ref = world4
    dx = np.concatenate([r[name][0] for r in ranks], axis=-1)[0]
    dy = _same_on_all(ranks, name, 1)[0]
    assert _rel(dx, ref[name][0]) <= 1e-10
    assert _rel(dy, ref[name][1]) <= 1e-10
    d = _inputs()
    A, dinv, mask = d["A"], d["dinv"], d["row_mask"]
    S = (A * dinv) @ A.T
    S = S + np.diag(np.where(mask, -DEL_C, 1.0 - np.diag(S)))
    dy_ref = np.linalg.solve(S, np.where(mask, A @ (dinv * d["rx"]) - d["rp"], 0.0))
    assert _rel(dy, dy_ref) <= 1e-10


def _check_normal(ranks, ref, name, tol):
    L = _strips(ranks, name, 0)
    W = _strips(ranks, name, 1)
    jac = _same_on_all(ranks, name, 2)[0]
    live = _same_on_all(ranks, name, 3)[0]
    ok = _same_on_all(ranks, name, 4)
    rL, rW, rjac, rlive, rok = ref[name]
    assert L.dtype == rL.dtype and jac.dtype == rjac.dtype
    assert _rel(L[0], rL) <= tol and _rel(W[0], rW) <= tol and _rel(jac, rjac) <= tol
    assert np.array_equal(live, rlive) and not live[M - 9] and not live[-1]
    assert ok.tolist() == [bool(rok)] == [True]


@pytest.mark.parametrize("name,tol", [("normal64", 1e-12), ("normal32", 1e-5)])
def test_dist_factor_normal(world4, name, tol):
    _check_normal(*world4, name, tol)


@pytest.mark.parametrize("name", ["k1_q", "k1_noq"])
def test_dist_factor_condensed(world4, name):
    ranks, ref = world4
    L = _strips(ranks, name, 0)
    W = _strips(ranks, name, 1)
    jac = _same_on_all(ranks, name, 2)[0]
    ok = _same_on_all(ranks, name, 3)
    rL, rW, rjac, rok = ref[name]
    assert _rel(L[0], rL) <= 1e-12 and _rel(W[0], rW) <= 1e-12 and _rel(jac, rjac) <= 1e-12
    assert ok.tolist() == [bool(rok)] == [True]


def test_world_size_2(world2):
    ranks, ref = world2
    _check_cholesky(ranks, ref, 2)
    _check_normal(ranks, ref, "normal64", 1e-12)
