"""overrun_steps.batch: share of the fixpoint steps the port enqueued
that ran past each fixpoint's end (the device loop's no-op steps in its
last chunk): 100 x (steps enqueued - iterations) / steps enqueued, from
the port's counters over every fixpoint of the run: the warm-up call and
the whole window, not only its traced part (the harness snapshots no
counter at the profiler's start and stop; the counts do not depend on
the profiler)."""
from flipbench import spans


def read(run):
    if not run.queries:
        return None
    c = spans.counters()
    if c is None or not c["fixpoint.steps_enqueued"]:
        return None
    enq = c["fixpoint.steps_enqueued"]
    return 100.0 * (enq - c["fixpoint.iterations"]) / enq
