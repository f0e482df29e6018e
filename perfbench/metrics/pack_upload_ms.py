"""Packing and upload of one call: the call's host wall less the
program's own solve time (``IPMStats.solver_time``, which lies between
two device synchronisations), averaged over the calls the profiler did
not slow.  Layer: ``parallel.batch`` (``bucket_pad``, the upload and the
unpacking of the statistics)."""


def read(run):
    calls = run.timed_calls
    if not calls:
        return None
    return 1e3 * sum(c.end - c.start - c.solver_time for c in calls) / len(calls)
