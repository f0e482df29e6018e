"""The segmented sum's share of its roofline, in percent: the least time
one call could take (``roofline/segment_sum.py``, its bytes at the card's
bandwidth) over the device time of one call in the profiled call, which
is the time of the device kernels whose names hold one of
:data:`KERNELS`, over the assemblies of that call.

One assembly on the NORMAL route is one ``chol_inv`` launch (the factor
of each attempt) and one segmented sum, so the assemblies are
``run.chol_launches_traced``.  The call's size is the program's own
count, read when the run is over: ``segsum_elems`` contributions and
``segsum_segments`` sums (every lane's, padded ones included) over
``segsum_calls`` calls of ``madipm_tpu_torch.models.sparse``; every call
of a run assembles the same patterns.  The dtype is the ``factor_dtype``
option's.  Layer: ``models.sparse`` ELL assembly.

None where the program has no such counters or the trace no such kernels."""

from perfbench import spec

#: the device kernels of a segmented sum, by a part of their name: cub's
#: segmented reduction, which ``torch.segment_reduce`` launches once a call
#: (the scan of the offsets before it takes 0.5% of the sum's device time)
KERNELS = ("DeviceSegmentedReduceKernel",)


def read(run):
    from madipm_tpu_torch.models import sparse

    calls = getattr(sparse, "segsum_calls", 0)
    if run.trace is None or not run.chol_launches_traced or not calls:
        return None
    device_s = sum(t for name, t in run.trace.device_time_by_name.items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    elems, segments = sparse.segsum_elems / calls, sparse.segsum_segments / calls
    dtype = run.cell.config["options"]["factor_dtype"]
    per_call = device_s / run.chol_launches_traced
    return 100.0 * spec.roofline("segment_sum").bound_s(elems, segments, dtype) / per_call
