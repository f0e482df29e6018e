"""The QP operator pieces of madipm_tpu_torch against madipm_tpu:
TorchQP.qmatvec / assemble_ata / add_quad / scale_quad, the QP branches of
eval_obj / eval_grad, gondzio_extra_correction, and the QP generators.

Two lanes (two padded QPs with a fixed column, n=40 -> 128 columns); every
value is compared per lane with the unbatched JAX function at 1e-12
relative to the largest entry of the JAX result (fp64 on both sides, the
same products in another summation order).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu.models import generators as jgen
from madipm_tpu.models import qp as jqp
from madipm_tpu.solver import kernels as jK
from madipm_tpu_torch.models import generators as tgen
from madipm_tpu_torch.models.qp import TorchQP
from madipm_tpu_torch.solver import kernels as tK

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("c", "A", "b", "lb", "ub", "Q", "c0", "row_mask", "col_mask", "x0", "y0")
TOL = 1e-12


def _qp(seed, n=40, m=16):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5)
    xs = rng.random(n) + 0.5
    P = rng.standard_normal((n, n // 4))
    uvar = np.where(rng.random(n) < 0.3, xs + 2.0, np.inf)
    lvar = np.zeros(n)
    lvar[3] = uvar[3] = 0.7  # fixed
    return dict(c=rng.standard_normal(n), A=A, lcon=A @ xs, ucon=A @ xs,
                lvar=lvar, uvar=uvar, Q=P @ P.T + 0.1 * np.eye(n), c0=0.25)


def _jax_padded(seed):
    return jqp.pad_to_device(jqp.slack_form(mt.from_dense(**_qp(seed))))


@pytest.fixture(scope="module")
def lanes():
    jps = [_jax_padded(s) for s in (1, 2)]
    tp = TorchQP.from_numpy({k: np.stack([np.asarray(getattr(jp, k)) for jp in jps]) for k in FIELDS})
    return jps, tp


def _close(t, j, what=""):
    t = np.asarray(t, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64).reshape(t.shape)
    err = float(np.max(np.abs(t - j)))
    assert err <= TOL * max(1e-300, float(np.max(np.abs(j)))), (what, err)


def test_pad_to_device_packs_q_like_jax():
    tp = mtt.pad_to_device(mtt.slack_form(mtt.from_dense(**_qp(1))))
    jp = _jax_padded(1)
    assert tp.is_qp and tp.Q.shape == (1, 128, 128)
    np.testing.assert_array_equal(tp.Q[0].numpy(), np.asarray(jp.Q))


def test_qp_operators_match(lanes):
    jps, tp = lanes
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, tp.n))
    w = (rng.random((2, tp.m)) < 0.7).astype(np.float64)
    C = rng.standard_normal((2, tp.n, tp.n))
    osc = np.array([[0.5], [0.25]])
    tx = torch.tensor(x)
    got = dict(
        qmatvec=tp.qmatvec(tx),
        ata=tp.assemble_ata(torch.tensor(w), torch.float64),
        ata32=tp.assemble_ata(torch.tensor(w), torch.float32),
        quad=tp.add_quad(torch.tensor(C), torch.float64),
        scaled=tp.scale_quad(torch.tensor(osc)).Q,
        obj=tK.eval_obj(tp, tx),
        grad=tK.eval_grad(tp, tx),
    )
    assert got["ata32"].dtype == torch.float32
    for i, jp in enumerate(jps):
        jx = jnp.asarray(x[i])
        _close(got["qmatvec"][i], jp.qmatvec(jx), "qmatvec")
        _close(got["ata"][i], jp.assemble_ata(jnp.asarray(w[i]), jnp.float64), "assemble_ata")
        _close(got["quad"][i], jp.add_quad(jnp.asarray(C[i]), jnp.float64), "add_quad")
        _close(got["scaled"][i], jp.scale_quad(osc[i, 0]).Q, "scale_quad")
        _close(got["obj"][i], jK.eval_obj(jp, jx), "eval_obj")
        _close(got["grad"][i], jK.eval_grad(jp, jx), "eval_grad")
        # fp32 assembly: the fp32 products differ by rounding only
        j32 = np.asarray(jp.assemble_ata(jnp.asarray(w[i]), jnp.float32))
        assert np.max(np.abs(got["ata32"][i].numpy() - j32)) <= 1e-5 * np.max(np.abs(j32))
    # the fixed column and the padding stay out of A'A and Q
    free = tp.free_mask[0].numpy()
    assert not free[3] and np.all(got["ata"][0].numpy()[~free] == 0)
    assert np.all((got["quad"][0].numpy() - C[0])[~free] == 0)


def test_lp_has_no_quadratic_term(lanes):
    _, tp = lanes
    lp = dataclasses.replace(tp, Q=None)
    x = torch.ones(2, tp.n, dtype=torch.float64)
    assert torch.equal(lp.qmatvec(x), torch.zeros_like(x))
    C = torch.ones(2, tp.n, tp.n, dtype=torch.float64)
    assert lp.add_quad(C, torch.float64) is C
    assert torch.equal(tK.eval_grad(lp, x), lp.c)


def test_gondzio_extra_correction_matches(lanes):
    jps, tp = lanes
    rng = np.random.default_rng(5)
    n = tp.n
    v = {k: rng.standard_normal((2, n)) for k in ("dx", "dzl", "dzu", "corr_l", "corr_u")}
    lb, ub = tp.lb.numpy(), tp.ub.numpy()
    x = np.where(np.isfinite(ub), lb + 0.5 * (np.where(np.isfinite(ub), ub, 0) - lb), lb + 1.0)
    x = np.where(tp.free_mask.numpy(), x, lb)
    zl, zu = rng.random((2, n)) * tp.has_lb.numpy(), rng.random((2, n)) * tp.has_ub.numpy()
    ap, ad = np.array([[0.7], [0.9]]), np.array([[0.8], [1.0]])
    mu = np.array([[1e-2], [3e-1]])
    t = lambda a: torch.tensor(a)
    cl, cu = tK.gondzio_extra_correction(
        tp, t(x), t(zl), t(zu), t(v["dx"]), t(v["dzl"]), t(v["dzu"]), t(v["corr_l"]), t(v["corr_u"]),
        t(ap), t(ad), 0.1, 10.0, t(mu))
    changed = 0
    for i, jp in enumerate(jps):
        j = lambda a: jnp.asarray(a[i])
        jcl, jcu = jK.gondzio_extra_correction(
            jp, j(x), j(zl), j(zu), j(v["dx"]), j(v["dzl"]), j(v["dzu"]), j(v["corr_l"]),
            j(v["corr_u"]), ap[i, 0], ad[i, 0], 0.1, 10.0, mu[i, 0])
        _close(cl[i], jcl, "corr_l")
        _close(cu[i], jcu, "corr_u")
        changed += int(np.sum(np.asarray(jcl) != v["corr_l"][i] * np.asarray(jp.has_lb)))
    assert changed > 0  # the clip is active somewhere
    assert torch.all(cl[~tp.has_lb] == 0) and torch.all(cu[~tp.has_ub] == 0)


def _same_model(a, b):
    for f in ("c", "lcon", "ucon", "lvar", "uvar", "x0", "y0"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.A.toarray(), b.A.toarray())
    np.testing.assert_array_equal(a.Q.toarray(), b.Q.toarray())
    assert (a.c0, a.minimize, a.name) == (b.c0, b.minimize, b.name)


@pytest.mark.parametrize("deg, sparse_q", [(False, False), (True, True)])
def test_known_optimum_qp_matches(deg, sparse_q):
    jm, jinfo = jgen.known_optimum_qp(20, 40, seed=5, degenerate=deg, sparse_q=sparse_q)
    tm, tinfo = tgen.known_optimum_qp(20, 40, seed=5, degenerate=deg, sparse_q=sparse_q)
    _same_model(jm, tm)
    assert jinfo["obj"] == tinfo["obj"]
    for k in ("x", "y", "zl", "zu"):
        np.testing.assert_array_equal(jinfo[k], tinfo[k])


def test_portfolio_and_qp_suite_match():
    _same_model(jgen.portfolio_qp(30, 6, seed=2), tgen.portfolio_qp(30, 6, seed=2))
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import ablate_predictor_qp

    for a, b in zip(ablate_predictor_qp.make_qp_suite(2, 12, 32, 0.3),
                    tgen.make_qp_suite(2, 12, 32, 0.3)):
        _same_model(a, b)
