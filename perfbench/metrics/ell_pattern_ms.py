"""Host time of the ELL route's packing of one call, in ms: the program's
``madipm_tpu_torch.models.sparse.pattern_ns`` (the ``madipm.sparse.pattern``
span: the ELL fields and the normal pattern of every lane built on the
host, the upload left out) read when the run is over, over the calls
that packed, which are every call of the run and the warm call.  Every
call packs the same instances anew.  Layer: ``models.sparse``.

None where the program has no such counter, or it reads 0."""


def read(run):
    from madipm_tpu_torch.models import sparse

    ns = getattr(sparse, "pattern_ns", None)
    if not ns:
        return None
    return ns / 1e6 / (len(run.calls) + 1)
