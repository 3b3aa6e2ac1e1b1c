"""queries_per_s: sources answered per second over the whole window (a
batch of 8 sources is 8 queries), on the host's clock."""


def read(run):
    if not run.queries:
        return None
    return sum(len(q.srcs) for q in run.queries) / run.window_s
