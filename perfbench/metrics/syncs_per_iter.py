"""Host syncs per batch iteration: the program's count of device-to-host
reads (``madipm_tpu_torch.utils.sync.count``) over the window, over the
batch iterations of its calls (each call's largest ``IPMStats.iter``:
every lane runs until the last one stops)."""


def read(run):
    iters = sum(max(c.iters) for c in run.calls)
    return run.syncs / iters if iters else None
