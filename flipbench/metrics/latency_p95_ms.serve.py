"""latency_p95_ms.serve: the 95th percentile over every request of the
window, from its scheduled arrival to its retirement; a request that
failed or never retired counts as infinitely late. A host stall of half
a second at this load moves it by a third, so it is read per layer, in
the traced run, beside the mean that is judged end to end."""
from flipbench.devtrace import percentile


def read(run):
    if not run.requests:
        return None
    return percentile([r.latency_s * 1e3 for r in run.requests], 95)
