"""chunks_per_step.batch: the fixpoint loop's chunks per fixpoint
iteration, chunks / iterations, from the port's counters over every
fixpoint of the run: the warm-up call and the whole window, not only its
traced part. On the card each chunk is one CUDA-graph replay of up to 8
steps and one device->host read of its summary, so this is the loop's
reads per step; `overrun_steps.batch` is what a longer chunk costs."""
from flipbench import spans


def read(run):
    if not run.queries:
        return None
    c = spans.counters()
    if c is None or not c["fixpoint.iterations"]:
        return None
    return c["fixpoint.chunks"] / c["fixpoint.iterations"]
