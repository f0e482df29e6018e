"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W): 67 TFLOP/s in float32 outside the tensor
cores and in float64 on the tensor cores, 3.35 TB/s of HBM3.  A card set
below 700 W runs slower under load: the run prints the card's power
limit beside the shares."""

FLOPS = {"float32": 67e12, "float64": 67e12}
BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate of ``dtype`` and bytes over the memory bandwidth."""
    return max(ops / FLOPS[dtype], nbytes / BYTES_PER_S)
