"""The 95th percentile over all requests of the window, each timed from
its due time on the open-loop schedule to its outputs landing in pinned
host buffers (the benchmark's host clock)."""

import numpy as np


def read(rec):
    if not len(rec.lat_ms):
        return None
    return float(np.percentile(np.asarray(rec.lat_ms, float), 95))
