"""The 95th percentile, over every call of the window, of the host wall
of one ``madipm_batch`` call: from the call to its statistics on the
host, packing and upload included (linear between order statistics, as
numpy's ``percentile`` takes it)."""

import numpy as np


def read(run):
    return float(np.percentile([c.end - c.start for c in run.timed_calls], 95))
