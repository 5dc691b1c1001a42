"""Mean device time of a replay of the captured program (CUDA events
around every replay of the window)."""

import numpy as np


def read(rec):
    return float(np.mean(rec.replay_ms)) if len(rec.replay_ms) else None
