"""idle_fixpoint.batch: share of the traced part of a closed-loop window
in which the card is idle while the port's fixpoint loop is the innermost
program span over the gap: `flip.fixpoint` (the loop's own host work,
the copy into and out of the captured state), `flip.chunk` (a replay's
launch), `flip.read` (the chunk's device->host read) or `flip.capture`
(a CUDA graph built)."""
from flipbench import spans


def read(run):
    if not run.queries:
        return None
    return spans.idle_share(run.trace, spans.FIXPOINT)
