"""One call of ``ops.chol_inv.chol_inv`` (``csrc/chol_inv.cu``,
``chol_kernel``): L and L^-1 of a (B, N, N) stack of SPD matrices.

Operations: N^3/3 for the factor and N^3/3 for the triangular inverse,
2 N^3 / 3 per instance (the arithmetic of ``chip_smoke.py``'s table).
Bytes: S read once, L and L^-1 written once, 3 B N^2 elements."""

from . import peaks

_SIZE = {"float32": 4, "float64": 8}


def ops(B: int, N: int) -> float:
    return B * 2.0 * float(N) ** 3 / 3.0


def nbytes(B: int, N: int, dtype: str) -> float:
    return 3.0 * B * N * N * _SIZE[dtype]


def bound_s(B: int, N: int, dtype: str) -> float:
    return peaks.bound_s(ops(B, N), nbytes(B, N, dtype), dtype)
