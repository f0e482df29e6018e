"""The device's idle share of the profiled calls, in percent: one less
the union of the device's activity intervals (kernels, copies, memsets)
over the profiled range, both read from the same trace."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
