"""idle_scheduler.serve: share of the traced stretch of an open-loop
window in which the card is idle while the server is the innermost
program span over the gap: `flip.pump` (the scheduler's own host work),
`flip.admit` and its `flip.init` (a lane's admission), `flip.window`
(one algebra's segment outside its fixpoint), `flip.retire` and its
`flip.finalize` (a lane's result read back)."""
from flipbench import spans


def read(run):
    if not run.requests:
        return None
    return spans.idle_share(run.trace, spans.SCHEDULER)
