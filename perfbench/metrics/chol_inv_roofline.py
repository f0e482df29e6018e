"""``chol_inv``'s share of its roofline, in percent: the least time one
call could take at the factor's shape (``roofline/chol_inv.py``) over the
device time of one call in the profiled calls, which is the time of the
device kernels whose names hold one of :data:`KERNELS`, over the calls
``madipm_tpu_torch.ops.chol_inv.launches`` counted meanwhile.

The factor's shape comes from the configuration: B is the batch (every
lane is factored each time), N the order of the system the KKT form
factors (NORMAL: the rows, CONDENSED: the columns, each padded to the
call's ``pad_multiple``), the type the ``factor_dtype`` option's."""

from perfbench import spec

#: the device kernels of a chol_inv call, by a part of their name
KERNELS = ("chol_kernel",)


def factor_shape(run):
    cfg = run.cell.config
    kkt = cfg["options"]["kkt_system"]["member"]
    size = {"NORMAL": cfg["generator"]["m"], "CONDENSED": cfg["generator"]["n"]}[kkt]
    pad = cfg["call"]["pad_multiple"]
    return run.k, -(-size // pad) * pad, cfg["options"]["factor_dtype"]


def read(run):
    if run.trace is None or not run.chol_launches_traced:
        return None
    device_s = sum(t for name, t in run.trace.device_time_by_name.items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    B, N, dtype = factor_shape(run)
    per_call = device_s / run.chol_launches_traced
    return 100.0 * spec.roofline("chol_inv").bound_s(B, N, dtype) / per_call
