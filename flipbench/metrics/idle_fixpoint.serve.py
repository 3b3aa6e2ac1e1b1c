"""idle_fixpoint.serve: share of the traced stretch of an open-loop
window in which the card is idle while the port's fixpoint loop is the
innermost program span over the gap (`flip.fixpoint`, `flip.chunk`,
`flip.read`, `flip.capture`: each window's K-step segment and its
summary read)."""
from flipbench import spans


def read(run):
    if not run.requests:
        return None
    return spans.idle_share(run.trace, spans.FIXPOINT)
