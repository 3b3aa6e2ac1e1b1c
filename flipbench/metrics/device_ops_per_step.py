"""device_ops_per_step: device operations (kernels, copies, sets) in the
traced calls, over the fixpoint iterations they ran (each call's largest
per-query step count from its `QueryResult`)."""


def read(run):
    calls = run.traced_queries()
    iters = sum(int(q.steps.max()) for q in calls)
    if run.trace is None or not iters or not run.trace.ops:
        return None
    return run.trace.ops / iters
