"""The program's own spans and counters, as the per-layer readers see them.

The port marks its layer boundaries with `flip.*` spans
(`repro_torch.obs.span`), which it records while a `torch.profiler`
runs: a `--trace 1` run's profiler turns them on over exactly its
stretch, and they land in the device trace as host spans on its clock. A
`--trace 0` run runs no profiler, so they stay off. The loop's per-chunk
spans (`flip.chunk`, `flip.read`) are not recorded by a profiler alone,
so a gap inside the loop falls under `flip.fixpoint`. `idle_under` puts
each idle gap of the traced window down to the innermost `flip.*` span
over its middle; `idle_share` gives a layer's share of the window. The
port also keeps always-on counters (`repro_torch.obs.PROGRAM`), read by
`counters`. A program without them (a checkout from before them) gives
None from both readers, and each metric then reads nothing.
"""
from __future__ import annotations

from flipbench.devtrace import DeviceTrace

PREFIX = "flip."
OUTSIDE = "outside"

# the spans of each layer, as the per-layer metrics group them
SESSION = ("flip.query", "flip.init", "flip.finalize")
FIXPOINT = ("flip.fixpoint", "flip.chunk", "flip.read", "flip.capture")
SCHEDULER = ("flip.pump", "flip.admit", "flip.init", "flip.window",
             "flip.retire", "flip.finalize")

COUNTERS = ("fixpoint.chunks", "fixpoint.steps_enqueued",
            "fixpoint.iterations")


def idle_under(trace, prefix: str = PREFIX) -> dict:
    """Idle seconds of the traced window by the innermost host span whose
    name starts with `prefix` over each gap's middle, by
    `DeviceTrace.idle_gaps`'s rule over those spans alone; gaps under
    none go to "outside". Keep the dot in the prefix: "flip." does not
    match the harness's `flipbench.*`."""
    mine = DeviceTrace(trace.window_s, trace.device,
                       [h for h in trace.host if h[2].startswith(prefix)])
    return {OUTSIDE if name == "no host span" else name: t
            for name, t in mine.idle_gaps(k=len(mine.host) + 1)}


def idle_share(trace, names) -> float | None:
    """Percent of the traced window idle under a span in `names`; None
    with no device operation or no program span in the trace."""
    if trace is None or not trace.ops or not any(
            name.startswith(PREFIX) for _, _, name in trace.host):
        return None
    idle = idle_under(trace)
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / trace.window_s


def counters() -> dict | None:
    """The port's fixpoint counters now (cumulative over the process),
    or None where the program keeps none."""
    try:
        from repro_torch.obs import PROGRAM
    except ImportError:
        return None
    return {name: PROGRAM.counter(name).value for name in COUNTERS}
