"""The QP slice as a whole: madipm_tpu_torch.madipm / madipm_batch against
madipm_tpu on the same convex QPs, for every dense KKT system and linear
solver, and with Gondzio corrections.

Instances (all padded to 128 columns): the dense 24 x 8 QP of the JAX
package's K1 tests, ``known_optimum_qp(20, 40)`` plain and degenerate,
``portfolio_qp(30, 6)`` and one conftest.random_lp LP for the LP-side
cases.  Per case: same status, iterations equal or +-1 (a difference is
printed with its cause), objective to 1e-8 relative.  K2 systems are solved
directly in fp64, so the two packages walk the same iterates; K1 solves
carry gamma = 1e8 and a PCG, which amplify rounding differences to ~1e-6
in a direction and can move the iteration count by one.
"""

import numpy as np
import pytest
import torch

from conftest import random_lp

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu.models.generators import known_optimum_qp, portfolio_qp
from madipm_tpu.parallel.batch import madipm_batch as jax_madipm_batch

torch.set_num_threads(2)


def _dense(qp):
    return dict(c=qp.c, A=qp.A.toarray(), lcon=qp.lcon, ucon=qp.ucon, lvar=qp.lvar, uvar=qp.uvar,
                Q=None if qp.Q is None else qp.Q.toarray())


def _instances():
    rng = np.random.default_rng(42)
    n, meq = 24, 8
    A = rng.standard_normal((meq, n))
    xstar = rng.random(n) + 0.5
    P = rng.standard_normal((n, n))
    out = {"dense": dict(c=rng.random(n), A=A, lcon=A @ xstar, ucon=A @ xstar, lvar=np.zeros(n),
                         uvar=np.full(n, np.inf), Q=P.T @ P + np.eye(n))}
    out["known"] = _dense(known_optimum_qp(20, 40, seed=3)[0])
    out["known_deg"] = _dense(known_optimum_qp(20, 40, seed=4, degenerate=True, sparse_q=True)[0])
    out["portfolio"] = _dense(portfolio_qp(30, 6, seed=1))
    c, A, b, lvar, uvar = random_lp(np.random.default_rng(23), 30, 10)
    out["lp"] = dict(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
    return out


INSTANCES = _instances()
KNOWN_OBJ = {"known": known_optimum_qp(20, 40, seed=3)[1]["obj"],
             "known_deg": known_optimum_qp(20, 40, seed=4, degenerate=True, sparse_q=True)[1]["obj"]}

#: name -> (instance, options by enum name)
CASES = {
    "k2-default-dense": ("dense", {}),
    "k2-default-known": ("known", {}),
    "k2-default-known_deg": ("known_deg", {}),
    "k2-default-portfolio": ("portfolio", {}),
    # padded to 32 (these two): the JAX package's LDL_INV and CHOLESKY_INV
    # recursions compile several times faster than at 128
    "k2-ldl_inv-known": ("known", dict(linear_solver="LDL_INV", pad_multiple=32)),
    "k2-lu-known": ("known", dict(linear_solver="LU")),
    "k25-ldl-known": ("known", dict(kkt_system="SCALED_AUGMENTED")),
    "k1-cholesky-dense": ("dense", dict(kkt_system="CONDENSED")),
    "k1-cholesky-known": ("known", dict(kkt_system="CONDENSED")),
    "k1-cholesky-known_deg": ("known_deg", dict(kkt_system="CONDENSED")),
    "k1-cholesky-portfolio": ("portfolio", dict(kkt_system="CONDENSED")),
    "k1-cholesky_inv-dense": ("dense", dict(kkt_system="CONDENSED", linear_solver="CHOLESKY_INV",
                                            pad_multiple=32)),
    "k1-cholesky-lp": ("lp", dict(kkt_system="CONDENSED")),
    "k2-ldl-lp": ("lp", dict(kkt_system="AUGMENTED")),
    "k2-check_residual-known_deg": ("known_deg", dict(check_residual=True)),
    "ncorr2-known": ("known", dict(max_ncorr=2)),
    "ncorr2-lp": ("lp", dict(max_ncorr=2)),
}


def _opts(pkg, kw):
    out = dict(print_level=pkg.PrintLevel.ERROR, tol=1e-8, max_iter=300)
    for k, v in kw.items():
        if k == "kkt_system":
            v = pkg.KKTSystem[v]
        elif k == "linear_solver":
            v = pkg.LinearSolver[v]
        out[k] = v
    return out


def _compare(name, js, ts):
    assert js.status == ts.status and ts.success, (name, js.status, ts.status)
    if ts.iter != js.iter:
        print(f"{name}: iterations {ts.iter} (torch) vs {js.iter} (jax): rounding differences of "
              f"the two packages' factors, amplified by the system's conditioning, moved the "
              f"last step across the tolerance")
    assert abs(ts.iter - js.iter) <= 1, (name, ts.iter, js.iter)
    rel = abs(ts.objective - js.objective) / max(1.0, abs(js.objective))
    assert rel <= 1e-8, (name, rel)
    assert ts.solution.shape == js.solution.shape


@pytest.mark.parametrize("name", list(CASES))
def test_madipm_qp_matches_jax(name):
    inst, kw = CASES[name]
    d = INSTANCES[inst]
    js = mt.madipm(mt.from_dense(**d), **_opts(mt, kw))
    ts = mtt.madipm(mtt.from_dense(**d), device="cpu", rethrow_error=True, **_opts(mtt, kw))
    _compare(name, js, ts)
    if name.startswith("k2") and "lp" not in name:
        assert ts.iter == js.iter  # direct fp64 solves: the same iterates
    if inst in KNOWN_OBJ:
        assert abs(ts.objective - KNOWN_OBJ[inst]) <= 1e-6 * max(1.0, abs(KNOWN_OBJ[inst]))
    lcon = d["lcon"]
    # K1 relaxes the equalities by |del_c| dy
    assert np.max(np.abs(ts.constraints - lcon)) <= 1e-5 * max(1.0, np.max(np.abs(lcon)))


def test_use_pallas_route_solves_the_same_qp():
    """use_pallas=True (the factor-only Cholesky route; its plain version
    on the CPU) reaches the same solution as the default CHOLESKY route."""
    d = INSTANCES["known"]
    kw = dict(kkt_system="CONDENSED")
    ref = mtt.madipm(mtt.from_dense(**d), device="cpu", rethrow_error=True, **_opts(mtt, kw))
    ts = mtt.madipm(mtt.from_dense(**d), device="cpu", rethrow_error=True, use_pallas=True,
                    **_opts(mtt, kw))
    _compare("use_pallas", ref, ts)
    lp = INSTANCES["lp"]
    ref = mtt.madipm(mtt.from_dense(**lp), device="cpu", rethrow_error=True, **_opts(mtt, {}))
    ts = mtt.madipm(mtt.from_dense(**lp), device="cpu", rethrow_error=True, use_pallas=True,
                    **_opts(mtt, {}))
    _compare("use_pallas NORMAL", ref, ts)


def test_maximize_concave_qp():
    d = dict(INSTANCES["known"])
    d_max = dict(d, c=-d["c"], Q=-d["Q"], minimize=False)
    ref = mtt.madipm(mtt.from_dense(**d), device="cpu", rethrow_error=True, **_opts(mtt, {}))
    ts = mtt.madipm(mtt.from_dense(**d_max), device="cpu", rethrow_error=True, **_opts(mtt, {}))
    js = mt.madipm(mt.from_dense(**d_max), **_opts(mt, {}))
    assert ts.success and ts.iter == ref.iter == js.iter
    assert abs(ts.objective + ref.objective) <= 1e-10 * max(1.0, abs(ref.objective))
    assert abs(ts.objective - js.objective) <= 1e-8 * max(1.0, abs(js.objective))


@pytest.mark.parametrize("kind", ["AUGMENTED", "CONDENSED"])
def test_madipm_batch_qp_matches_vmap_and_single_lanes(kind):
    """Three QPs of different sizes in one bucket: each lane matches the JAX
    package's vmapped batch and the port's own single solve."""
    data = [INSTANCES[k] for k in ("dense", "known", "portfolio")]
    kw = dict(kkt_system=kind)
    js = jax_madipm_batch([mt.from_dense(**d) for d in data], **_opts(mt, kw))
    ts = mtt.madipm_batch([mtt.from_dense(**d) for d in data], device="cpu", **_opts(mtt, kw))
    assert len(ts) == 3
    for i, (j, t, d) in enumerate(zip(js, ts, data)):
        _compare(f"{kind} lane {i}", j, t)
        single = mtt.madipm(mtt.from_dense(**d), device="cpu", rethrow_error=True, **_opts(mtt, kw))
        _compare(f"{kind} lane {i} vs single", single, t)
    assert len({t.iter for t in ts}) > 1  # lanes stop at different trips


def test_mixed_lp_qp_batch_raises():
    with pytest.raises(ValueError, match="padded shape"):
        mtt.madipm_batch([mtt.from_dense(**INSTANCES["lp"]), mtt.from_dense(**INSTANCES["dense"])],
                         device="cpu", print_level=mtt.PrintLevel.ERROR)
