"""madipm_tpu_torch.madipm_batch against madipm_tpu's madipm_batch
(``vmap(solve_device)``) on a batch of three LPs of different sizes
padded to one bucket, in both configurations (tolerances as in
test_torch_solve.py: fp64 CHOLESKY same iterations and 1e-10 objectives,
fp32 CHOLESKY_INV + fp64 PCG iterations +-1 and 1e-8 objectives).

Each lane of the torch batch must also match the torch single-instance
solve of its LP at the same tolerances: a lane that stops keeps its
state while the others run on.  (Not bit for bit: a batched product on
the CPU sums in another order than a single one.)
"""

import numpy as np
import pytest
import torch

from conftest import random_lp

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu.models.generators import known_optimum_lp
from madipm_tpu.parallel.batch import madipm_batch as jax_madipm_batch

torch.set_num_threads(2)

ACC = dict(factor_dtype="float32", refinement_steps=12, pcg_adaptive_tol=True,
           predictor_pcg_budget=0, pcg_tol_floor=1e-8, fp64_matvec="emulated")


def _opts(pkg, config):
    kw = dict(tol=1e-8, max_iter=300, print_level=pkg.PrintLevel.ERROR,
              regularization=pkg.FixedRegularization(1e-8, -1e-8))
    if config == "acc":
        kw.update(ACC, linear_solver=pkg.LinearSolver.CHOLESKY_INV)
    return kw


def _data():
    out = []
    for seed, (n, m) in enumerate(((96, 48), (120, 64), (80, 30))):
        c, A, b, lvar, uvar = random_lp(np.random.default_rng(10 + seed), n, m, density=0.4)
        out.append(dict(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar))
    qp, _ = known_optimum_lp(40, 100, seed=9)
    out[2] = dict(c=qp.c, A=qp.A.toarray(), lcon=qp.lcon, ucon=qp.ucon, lvar=qp.lvar, uvar=qp.uvar)
    return out


DATA = _data()


@pytest.mark.parametrize("config", ["fp64", "acc"])
def test_madipm_batch_matches_vmap_and_single_lanes(config):
    js = jax_madipm_batch([mt.from_dense(**d) for d in DATA], **_opts(mt, config))
    ts = mtt.madipm_batch([mtt.from_dense(**d) for d in DATA], device="cpu", **_opts(mtt, config))
    assert len(ts) == len(DATA)
    for i, (j, t, d) in enumerate(zip(js, ts, DATA)):
        assert j.status == t.status and t.success, (i, j.status, t.status)
        rel = abs(t.objective - j.objective) / max(1.0, abs(j.objective))
        if config == "fp64":
            assert t.iter == j.iter, i
            assert rel <= 1e-10, (i, rel)
        else:
            if t.iter != j.iter:
                print(f"lane {i}: iterations {t.iter} (torch) vs {j.iter} (jax): "
                      f"the fp32 factors of the two packages differ by ~1e-7")
            assert abs(t.iter - j.iter) <= 1, i
            assert rel <= 1e-8, (i, rel)
        single = mtt.madipm(mtt.from_dense(**d), device="cpu", rethrow_error=True, **_opts(mtt, config))
        assert single.status == t.status, i
        assert abs(single.iter - t.iter) <= (0 if config == "fp64" else 1), i
        tol = 1e-10 if config == "fp64" else 1e-8
        assert abs(single.objective - t.objective) <= tol * max(1.0, abs(t.objective)), i
    assert len({t.iter for t in ts}) > 1  # lanes stop at different trips
