"""Operations the host puts on the device per batch iteration: the CUDA
runtime and driver calls that enqueue (kernel launches of every kind,
copies, memsets, graph launches; ``trace.ENQUEUE``) in the profiled
calls, over their batch iterations.  A CUDA graph counts as one launch,
so capturing an iteration shows here."""


def read(run):
    if run.trace is None:
        return None
    iters = sum(max(c.iters) for c in run.traced_calls)
    return run.trace.enqueues / iters if iters else None
