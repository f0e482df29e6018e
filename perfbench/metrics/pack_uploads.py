"""Host-to-device copies the dense route makes in one call's packing: the
program's ``madipm_tpu_torch.parallel.batch.uploads`` (counted by
``bucket_pad``, inside ``madipm.batch.pack``) read when the run is over,
over the calls that packed, which are every call of the run and the warm
call.  A packing that uploads the bucket in one piece reads the same at
any number of instances a call.  Layer: ``parallel.batch`` packing and
upload.

None where the program has no such counter, or it reads 0."""


def read(run):
    from madipm_tpu_torch.parallel import batch

    n = getattr(batch, "uploads", None)
    if not n:
        return None
    return n / (len(run.calls) + 1)
