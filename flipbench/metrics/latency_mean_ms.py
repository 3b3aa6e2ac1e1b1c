"""latency_mean_ms: the mean over every request of the window of its
latency, from its scheduled arrival to its retirement, on the host's
clock; a request that failed or never retired counts as infinitely
late, so one makes the mean infinite."""
import numpy as np


def read(run):
    if not run.requests:
        return None
    return float(np.mean([r.latency_s * 1e3 for r in run.requests]))
