"""Set-up: from the start of the process to the first timed call
(imports, CUDA context, generating the instances, the kernel build or its
cached library, and one warm call at the cell's own shapes)."""


def read(run):
    return run.setup_s
