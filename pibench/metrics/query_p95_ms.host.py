"""``query_p95_ms`` read in a traced run, where the card idles most of
the window and the tail is the runner's host work (in ms)."""

import numpy as np


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(run.latencies_ms, 95))
