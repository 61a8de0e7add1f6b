"""The 95th percentile of one read request's time, file opening included,
over all the window's requests, in milliseconds."""

import numpy as np


def read(run):
    times = [r["end"] - r["start"] for r in run.records]
    return float(np.percentile(times, 95)) * 1e3 if times else None
