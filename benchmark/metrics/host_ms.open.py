"""Median host span of a request's calls into the program: the pack or
normalize, the pinned copy's enqueue, the replay's launch and the
outputs' copy (the benchmark's host clock)."""

import numpy as np


def read(rec):
    return float(np.median(rec.host_ms)) if len(rec.host_ms) else None
