"""One call of the ELL assembly's segmented sum
(``madipm_tpu_torch.models.sparse._segment_sum``, ``torch.segment_reduce``):
``elems`` contributions, every lane's, summed into ``segments`` sums.

Operations: one add per contribution.  Bytes: the contributions read in
the factor dtype, the segment lengths read as int64, the sums written in
the factor dtype."""

from . import peaks

_SIZE = {"float32": 4, "float64": 8}
_INDEX = 8


def ops(elems: float) -> float:
    return float(elems)


def nbytes(elems: float, segments: float, dtype: str) -> float:
    return elems * _SIZE[dtype] + segments * (_INDEX + _SIZE[dtype])


def bound_s(elems: float, segments: float, dtype: str) -> float:
    return peaks.bound_s(ops(elems), nbytes(elems, segments, dtype), dtype)
