"""IPM iterations per instance: the mean ``IPMStats.iter`` over every
instance of every call in the window."""


def read(run):
    iters = [i for c in run.calls for i in c.iters]
    return sum(iters) / len(iters)
