"""k1_roofline: K1's share of its roofline over the traced calls: the
least time the card could take for the bytes and operations those calls
need (`flipbench.work`, from the reference's frontiers), over K1's
device time in them (the profiler's events named after K1's kernel)."""
from flipbench import work

KERNEL = "relax_kernel"      # K1's __global__ function


def read(run):
    if run.trace is None or not run.traced_queries():
        return None
    k1_s = run.trace.seconds_of(KERNEL)
    if not k1_s:
        return None
    nbytes, ops = run.traced_work()
    return 100.0 * work.bound_s(nbytes, ops) / k1_s
