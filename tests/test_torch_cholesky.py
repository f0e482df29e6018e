"""The plain version of the factor-only Cholesky kernel
(ops/block_chol.cholesky, reached through ops/chol_inv.cholesky on the CPU)
against the JAX package's Pallas ``pallas_cholesky`` in interpret mode, at
the sizes the JAX package's own tests run it (N=128, 384, and a batch of
three 128s), and the ``use_pallas`` route of ``kkt.factorize``.

Tolerances, relative to max|L|: fp64 1e-10 (both are exact-arithmetic
Cholesky factors, computed by different blockings); fp32 1e-3, the bound
the JAX package's own test holds its kernel to.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from madipm_tpu.ops.pallas_chol import pallas_cholesky
from madipm_tpu_torch.models.qp import TorchQP
from madipm_tpu_torch.ops import block_chol as tb
from madipm_tpu_torch.ops import chol_inv
from madipm_tpu_torch.ops import kkt as tkkt
from madipm_tpu_torch.ops import linalg as tlin
from madipm_tpu_torch.utils import options as topt

torch.set_num_threads(2)

TOL = {np.float32: 1e-3, np.float64: 1e-10}


def _spd(shape_n, batch=None, seed=0):
    rng = np.random.default_rng(seed + shape_n)
    G = rng.standard_normal(((batch,) if batch else ()) + (shape_n, shape_n))
    return G @ np.swapaxes(G, -1, -2) / shape_n + 0.1 * np.eye(shape_n)


def _rel(a, b):
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(np.asarray(a, dtype=np.float64) - b)) / np.max(np.abs(b)))


CASES = [(128, None, np.float32), (128, None, np.float64), (384, None, np.float32),
         (128, 3, np.float32), (128, 3, np.float64)]


@pytest.mark.parametrize("n, batch, dt", CASES,
                         ids=["128-fp32", "128-fp64", "384-fp32", "3x128-fp32", "3x128-fp64"])
def test_plain_matches_pallas_interpret(n, batch, dt):
    S = _spd(n, batch).astype(dt)
    Lp = np.asarray(pallas_cholesky(jnp.asarray(S), interpret=True))
    L = chol_inv.cholesky(torch.tensor(S)).numpy()
    assert L.dtype == dt and L.shape == S.shape
    assert _rel(L, Lp) <= TOL[dt]
    assert np.all(np.triu(L, 1) == 0)  # upper triangle zero, as the TPU kernel leaves it
    L64 = L.astype(np.float64)
    recon = L64 @ np.swapaxes(L64, -1, -2)
    assert np.max(np.abs(recon - S)) <= (1e-4 if dt == np.float32 else 1e-12)


def test_cholesky_is_the_L_of_chol_inv_and_of_linalg():
    S = torch.tensor(_spd(96, 2, seed=3))
    L = tb.cholesky(S)
    L2, _ = tb.chol_inv(S)
    assert torch.equal(L, L2)  # the same products in the same order
    assert _rel(L, torch.linalg.cholesky(S)) <= 1e-12
    # odd and tiny sizes fall to the unblocked base case
    for n in (1, 7, 33):
        Sn = torch.tensor(_spd(n, seed=n))
        assert _rel(tb.cholesky(Sn), torch.linalg.cholesky(Sn)) <= 1e-12


@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["fp32", "fp64"])
def test_nan_on_indefinite(dt):
    L = chol_inv.cholesky(-torch.eye(128, dtype=dt))
    assert torch.isnan(L).any() and not bool(tlin.cholesky_is_ok(L))
    Lj = pallas_cholesky(-jnp.eye(128, dtype=jnp.float32 if dt == torch.float32 else jnp.float64),
                         interpret=True)
    assert bool(jnp.any(jnp.isnan(Lj)))
    # one bad lane of a batch stays its own
    S = torch.stack([torch.eye(64, dtype=dt) * 4.0, -torch.eye(64, dtype=dt)])
    assert tlin.cholesky_is_ok(chol_inv.cholesky(S)).tolist() == [True, False]


def test_wrapper_dispatch_and_counter():
    """A CPU tensor takes the plain version and counts no launch; another
    device than CPU or CUDA raises instead of falling back."""
    before = (chol_inv.cholesky_launches, chol_inv.launches)
    L = chol_inv.cholesky(torch.eye(64, dtype=torch.float64) * 9.0)
    torch.testing.assert_close(L, 3.0 * torch.eye(64, dtype=torch.float64))
    assert (chol_inv.cholesky_launches, chol_inv.launches) == before
    with pytest.raises(ValueError, match="device"):
        chol_inv.cholesky(torch.empty(64, 64, device="meta"))


def _lp_lanes():
    rng = np.random.default_rng(8)
    m, n = 24, 64
    fields = dict(
        A=rng.standard_normal((2, m, n)) * (rng.random((2, m, n)) < 0.5),
        c=rng.random((2, n)), b=rng.standard_normal((2, m)),
        lb=np.zeros((2, n)), ub=np.full((2, n), np.inf), c0=np.zeros(2),
        row_mask=np.ones((2, m), bool), col_mask=np.ones((2, n), bool),
        x0=np.zeros((2, n)), y0=np.zeros((2, m)),
    )
    return TorchQP.from_numpy(fields), rng


@pytest.mark.parametrize("kind", ["NORMAL", "CONDENSED"])
def test_use_pallas_routes_factorize_through_cholesky(kind, monkeypatch):
    """With use_pallas=True and CHOLESKY, factorize calls
    ops/chol_inv.cholesky (and not torch.linalg's factor); the factor and
    the solve agree with the default route to rounding."""
    tp, rng = _lp_lanes()
    x = torch.tensor(rng.random((2, tp.n)) + 0.5)
    zl = torch.tensor(rng.random((2, tp.n)))
    zu = torch.zeros_like(zl)
    dw = torch.full((2, 1), 1e-8, dtype=torch.float64)
    dc = torch.full((2, 1), -1e-8, dtype=torch.float64)
    calls = []
    real = chol_inv.cholesky
    monkeypatch.setattr(chol_inv, "cholesky", lambda S: (calls.append(S.shape), real(S))[1])

    def run(use_pallas):
        cfg = tkkt.KKTConfig(kind=topt.KKTSystem[kind], linear_solver=topt.LinearSolver.CHOLESKY,
                             factor_dtype=torch.float64,
                             refinement_steps=12 if kind == "CONDENSED" else 0, use_pallas=use_pallas)
        fac, _, _, ok = tkkt.factorize(cfg, tp, x, zl, zu, dw, dc)
        assert bool(ok.all())
        rx, rp = torch.tensor(rng.standard_normal((2, tp.n))), torch.tensor(rng.standard_normal((2, tp.m)))
        return cfg, fac, rx, rp

    cfg0, fac0, rx, rp = run(False)
    assert calls == []
    cfg1, fac1, _, _ = run(True)
    size = tp.m if kind == "NORMAL" else tp.n
    assert calls == [(2, size, size)]
    assert _rel(fac1.L, fac0.L) <= 1e-10
    d0 = tkkt.solve_condensed(cfg0, tp, fac0, rx, rp)
    d1 = tkkt.solve_condensed(cfg1, tp, fac1, rx, rp)
    # K1's matrix carries gamma = 1e8: its PCG leaves at a residual of
    # 1e-14 * |rhs| ~ 1e-6, so two routes agree on the direction to ~1e-6.
    tol = 1e-9 if kind == "NORMAL" else 1e-5
    for a, b in zip(d1, d0):
        assert _rel(a, b) <= tol
    # CHOLESKY_INV never takes the factor-only route
    cfg = tkkt.KKTConfig(kind=topt.KKTSystem[kind], linear_solver=topt.LinearSolver.CHOLESKY_INV,
                         factor_dtype=torch.float64, refinement_steps=0, use_pallas=True)
    tkkt.factorize(cfg, tp, x, zl, zu, dw, dc)
    assert len(calls) == 1
