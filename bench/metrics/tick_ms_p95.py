"""tick_ms_p95: the 95th percentile (linear interpolation) of every
window tick's time, from the tick's input queued to its records on the
host (host clock), ms."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.tick_s) * 1e3, 95))
