"""call_p95_ms (ms, end to end): the 95th percentile of every call in the
window, each timed on the host from its start to numpy answers in hand."""

import numpy as np


def read(run):
    return float(np.percentile(run.call_s, 95)) * 1e3 if run.call_s else None
