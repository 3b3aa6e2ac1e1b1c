"""Chrome-trace (`chrome://tracing` / Perfetto) span exporter.

The port's copy of `repro.obs.trace`. Serializes query telemetry as
the Trace Event Format JSON that Chrome's tracing UI and
https://ui.perfetto.dev load directly: one *query* span containing one
span per *dispatch* (engine fixpoint), each containing one span per
*step*, with the per-step frontier stats attached as span ``args`` so
hovering a step shows its active vertices / tiles / blocks fetched.

Timing semantics: the port's fixpoint is host-driven and records real
per-step wall times, which become the step span durations. A dispatch
without them (a `DispatchTelemetry` built by hand) has its step spans
divide the dispatch wall evenly, tagged ``"synthetic_timing": true``.
"""
from __future__ import annotations

import json

import numpy as np


class TraceBuilder:
    """Accumulates Trace Event Format events (timestamps in µs)."""

    def __init__(self, process: str = "flip"):
        self.events: list[dict] = [{
            "ph": "M", "pid": 1, "name": "process_name",
            "args": {"name": process},
        }]

    def thread(self, tid: int, name: str) -> None:
        self.events.append({"ph": "M", "pid": 1, "tid": tid,
                            "name": "thread_name", "args": {"name": name}})

    def span(self, name: str, ts_us: float, dur_us: float,
             tid: int = 0, args: dict | None = None) -> None:
        """One complete ('X') event."""
        ev = {"ph": "X", "pid": 1, "tid": tid, "name": name,
              "ts": float(ts_us), "dur": float(max(dur_us, 0.0))}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, ts_us: float, values: dict,
                tid: int = 0) -> None:
        """One counter ('C') event -- rendered as a stacked area track."""
        self.events.append({"ph": "C", "pid": 1, "tid": tid, "name": name,
                            "ts": float(ts_us),
                            "args": {k: float(v)
                                     for k, v in values.items()}})

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# ------------------------------------------------------------------ #
def add_dispatch_spans(tb: TraceBuilder, disp, t0_us: float,
                       tid: int = 0, label: str = "dispatch") -> float:
    """Emit one dispatch span plus its step spans (and a frontier
    counter track) starting at `t0_us`; returns the dispatch end time."""
    tr = disp.trace
    nsteps = len(tr)
    dur_us = max(disp.wall_s * 1e6, 1e-3)
    tb.span(f"{label} [{disp.backend}/{disp.mode}"
            f"{' compact' if disp.compact else ''} B={disp.batch}]",
            t0_us, dur_us, tid=tid,
            args={"steps": [int(s) for s in np.atleast_1d(disp.steps)],
                  "n_blocks": disp.n_blocks, "truncated": disp.truncated,
                  **{k: v for k, v in disp.meta.items()}})
    if nsteps == 0:
        return t0_us + dur_us
    if tr.step_wall_s is not None:
        durs = np.maximum(np.asarray(tr.step_wall_s, dtype=np.float64),
                          0.0) * 1e6
        synthetic = False
    else:
        durs = np.full(nsteps, dur_us / nsteps)
        synthetic = True
    ts = t0_us
    for i in range(nsteps):
        args = {
            "active_vertices": int(tr.active_vertices[i].sum()),
            "active_tiles": int(tr.active_tiles[i]),
            "blocks_fetched": int(tr.blocks_fetched[i]),
            "blocks_skipped": int(tr.blocks_skipped[i]),
            "live_queries": int((~tr.converged[i]).sum()),
        }
        if synthetic:
            args["synthetic_timing"] = True
        tb.span(f"step {i}", ts, float(durs[i]), tid=tid, args=args)
        tb.counter("frontier", ts,
                   {"active_vertices": int(tr.active_vertices[i].sum()),
                    "active_tiles": int(tr.active_tiles[i])}, tid=tid)
        ts += float(durs[i])
    return max(ts, t0_us + dur_us)


def chrome_trace_from_telemetry(tele, name: str = "query",
                                process: str = "flip") -> dict:
    """query -> dispatch -> step span tree for one `QueryTelemetry`."""
    tb = TraceBuilder(process=process)
    tb.thread(0, "query")
    wall_us = max(tele.wall_s * 1e6, 1e-3)
    args = {"dispatches": len(tele.dispatches),
            "compile_s": tele.compile_s}
    tb.span(name, 0.0, wall_us, tid=0, args=args)
    if tele.compile_s:
        tb.span("compile", 0.0, tele.compile_s * 1e6, tid=0,
                args={"note": "first-dispatch share (kernel build "
                                "and load)"})
    t = (tele.compile_s * 1e6) if tele.compile_s else 0.0
    for i, disp in enumerate(tele.dispatches):
        t = add_dispatch_spans(tb, disp, t, tid=0,
                               label=f"dispatch {i}")
    return tb.to_chrome()


def chrome_trace_from_result(result, name: str | None = None) -> dict:
    """Chrome trace for a traced `QueryResult` (its `.telemetry` must be
    set, i.e. the query ran with ``trace=``)."""
    if getattr(result, "telemetry", None) is None:
        raise ValueError(
            "QueryResult has no telemetry: run the query with "
            "trace=True (CompiledQuery.query(srcs, trace=True))")
    if name is None:
        prog = getattr(result, "program", None)
        name = f"query:{prog.name}" if prog is not None else "query"
    return chrome_trace_from_telemetry(result.telemetry, name=name)


def write_chrome_trace(path: str, result_or_telemetry,
                       name: str | None = None) -> str:
    """Write a Chrome-trace JSON file for a traced QueryResult or a bare
    QueryTelemetry; returns the path."""
    obj = result_or_telemetry
    # QueryResult also has an (int) `dispatches` field, so sniff for the
    # result-only `telemetry` attribute instead of `dispatches`
    if hasattr(obj, "telemetry"):           # QueryResult
        doc = chrome_trace_from_result(obj, name=name)
    else:                                   # bare QueryTelemetry
        doc = chrome_trace_from_telemetry(obj, name=name or "query")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
