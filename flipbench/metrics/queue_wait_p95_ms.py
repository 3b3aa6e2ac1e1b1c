"""queue_wait_p95_ms: the 95th percentile over every request of the
window of the server's `ServeRequest.queue_wait_s` (submission to
admission into a lane)."""
from flipbench.devtrace import percentile


def read(run):
    if not run.requests:
        return None
    return percentile([r.queue_wait_s * 1e3 for r in run.requests], 95)
