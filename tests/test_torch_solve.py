"""madipm_tpu_torch.madipm against madipm_tpu.madipm on the same LPs.

Instances: two conftest.random_lp LPs (one with a third of the variables
upper-bounded), one known-optimum LP and a maximization model, all
padded to 128 x 128.  Per instance:

- fp64 CHOLESKY (the CPU configuration): same status, same iteration
  count, objective to 1e-10 relative;
- fp32 CHOLESKY_INV + fp64 PCG (the accelerator configuration of
  ROADMAP.md, with native fp64 matvecs): same status, iterations within
  +-1 (a difference is printed with its cause: the fp32 factors of the two
  packages differ by ~1e-7), objective to 1e-8 relative.
"""

import numpy as np
import pytest
import torch

from conftest import random_lp

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu.models.generators import known_optimum_lp

torch.set_num_threads(2)

BASE = dict(tol=1e-8, max_iter=300)
ACC = dict(factor_dtype="float32", refinement_steps=12, pcg_adaptive_tol=True,
           predictor_pcg_budget=0, pcg_tol_floor=1e-8, fp64_matvec="emulated")


def _opts(pkg, config):
    kw = dict(BASE, print_level=pkg.PrintLevel.ERROR,
              regularization=pkg.FixedRegularization(1e-8, -1e-8))
    if config == "acc":
        kw.update(ACC, linear_solver=pkg.LinearSolver.CHOLESKY_INV)
    return kw


def _instances():
    out = {}
    for name, seed, upper in (("lp0", 0, 0.3), ("lp1", 1, 0.0)):
        c, A, b, lvar, uvar = random_lp(np.random.default_rng(seed), 96, 48, density=0.5,
                                        upper_frac=upper)
        out[name] = dict(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
    qp, _ = known_optimum_lp(48, 96, seed=4, degenerate=True)
    out["known"] = dict(c=qp.c, A=qp.A.toarray(), lcon=qp.lcon, ucon=qp.ucon, lvar=qp.lvar, uvar=qp.uvar)
    out["max"] = dict(out["lp0"], c=-out["lp0"]["c"], minimize=False)
    return out


INSTANCES = _instances()
CASES = [(c, i) for c in ("fp64", "acc") for i in INSTANCES if not (c == "acc" and i == "max")]


@pytest.mark.parametrize("config, inst", CASES, ids=[f"{c}-{i}" for c, i in CASES])
def test_madipm_matches_jax(config, inst):
    d = INSTANCES[inst]
    js = mt.madipm(mt.from_dense(**d), **_opts(mt, config))
    ts = mtt.madipm(mtt.from_dense(**d), device="cpu", rethrow_error=True, **_opts(mtt, config))
    assert js.status == ts.status and ts.success, (js.status, ts.status)
    rel = abs(ts.objective - js.objective) / max(1.0, abs(js.objective))
    if config == "fp64":
        assert ts.iter == js.iter
        assert rel <= 1e-10
    else:
        if ts.iter != js.iter:
            print(f"{inst}: iterations {ts.iter} (torch) vs {js.iter} (jax): the fp32 factors "
                  f"differ by ~1e-7 and the predictor applies them without a PCG")
        assert abs(ts.iter - js.iter) <= 1
        assert rel <= 1e-8
    assert ts.solution.shape == js.solution.shape
    assert np.max(np.abs(ts.constraints - d["lcon"])) <= 1e-6 * max(1.0, np.max(np.abs(d["lcon"])))


def test_unported_drivers_raise():
    d = INSTANCES["lp0"]
    solver = mtt.MPCSolver(mtt.from_dense(**d), device="cpu", print_level=mtt.PrintLevel.ERROR)
    with pytest.raises(NotImplementedError, match="A10"):
        solver.solve(logged=True)
    with pytest.raises(NotImplementedError, match="A10"):
        mtt.madipm(mtt.from_dense(**d), device="cpu", max_wall_time=10.0)
    with pytest.raises(NotImplementedError, match="A7b"):
        mtt.madipm(mtt.from_dense(**d), device="cpu", pcg_flex=True)


def test_no_device_and_no_gpu_raises(monkeypatch):
    """Without ``device`` the entry points take the first CUDA device and
    raise where there is none; they never carry on on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qp = mtt.from_dense(**INSTANCES["lp0"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mtt.madipm(qp, print_level=mtt.PrintLevel.ERROR)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mtt.madipm_batch([qp], print_level=mtt.PrintLevel.ERROR)
    assert mtt.madipm(qp, device="cpu", print_level=mtt.PrintLevel.ERROR).success
