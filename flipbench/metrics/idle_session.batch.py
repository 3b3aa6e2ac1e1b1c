"""idle_session.batch: share of the traced part of a closed-loop window
in which the card is idle while the port's session is the innermost
program span over the gap: `flip.query` (validation, bookkeeping),
`flip.init` (the host-built initial state and its copy in) or
`flip.finalize` (`finalize_state` -> `to_orig` into numpy)."""
from flipbench import spans


def read(run):
    if not run.queries:
        return None
    return spans.idle_share(run.trace, spans.SESSION)
