"""service_p95_ms: the 95th percentile over every request of the window
of the server's `ServeRequest.service_s` (admission to retirement: the
windows of the rotating batch that carried it)."""
from flipbench.devtrace import percentile


def read(run):
    if not run.requests:
        return None
    return percentile([r.service_s * 1e3 for r in run.requests], 95)
