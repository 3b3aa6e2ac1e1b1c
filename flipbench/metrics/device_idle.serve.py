"""device_idle.serve: share of the traced stretch of an open-loop window
in which no operation ran on the card (profiler timeline)."""


def read(run):
    if not run.requests or run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
