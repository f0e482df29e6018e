"""The roofline arithmetic gives the bounds of the port's kernel table."""

import pytest

from perfbench import spec
from perfbench.roofline import peaks

chol_inv = spec.roofline("chol_inv")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chol_inv_bound_at_8_by_1024(dtype):
    # PERF.md's table: 0.0855 ms at (8, 1024), set by the operations
    assert chol_inv.bound_s(8, 1024, dtype) * 1e3 == pytest.approx(0.0855, abs=5e-5)
    assert chol_inv.ops(8, 1024) / peaks.FLOPS[dtype] > chol_inv.nbytes(8, 1024, dtype) / peaks.BYTES_PER_S


@pytest.mark.parametrize("B, N, ms", [(4, 2048, 0.3419), (32, 1024, 0.3419), (1, 1024, 0.0107)])
def test_chol_inv_bound_other_shapes(B, N, ms):
    assert chol_inv.bound_s(B, N, "float32") * 1e3 == pytest.approx(ms, abs=5e-5)


def test_bytes_bound_where_operations_are_few():
    # a small factor is bound by its bytes: 3 B N^2 words over 3.35 TB/s
    assert chol_inv.bound_s(1, 32, "float64") == pytest.approx(3 * 32 * 32 * 8 / 3.35e12)
