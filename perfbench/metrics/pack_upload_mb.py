"""Bytes the dense route hands to the device in one call's packing, in MB
(1e6 bytes): the program's ``madipm_tpu_torch.parallel.batch.upload_bytes``
(the host buffers ``bucket_pad`` uploads, inside ``madipm.batch.pack``)
read when the run is over, over the calls that packed, which are every
call of the run and the warm call.  Every call packs the same instances
anew.  Layer: ``parallel.batch`` packing and upload.

None where the program has no such counter, or it reads 0."""


def read(run):
    from madipm_tpu_torch.parallel import batch

    n = getattr(batch, "upload_bytes", None)
    if not n:
        return None
    return n / 1e6 / (len(run.calls) + 1)
