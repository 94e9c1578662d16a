"""call_p95_ms: the 95th percentile of the synchronised wall of every call
of the window (numpy's linear interpolation), in milliseconds."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.walls), 95.0)) * 1e3
