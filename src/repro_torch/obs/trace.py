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

Program spans (`span`, `fine_span`, `enable`, `recorded`,
`chrome_trace_from_spans`): the port's host code marks its layer
boundaries -- `flip.query`, `flip.init`, `flip.fixpoint`, `flip.capture`,
`flip.finalize`, and the server's `flip.pump`, `flip.admit`,
`flip.window`, `flip.retire` -- with ``with span(name, **args):``, and
the fixpoint loop's per-chunk work -- `flip.chunk`, `flip.read` -- with
`fine_span`. Three settings:

  * by default, while a `torch.profiler` runs in the process, a `span`
    is the profiler's `record_function(name)`: it shows in the
    profiler's trace as a `user_annotation` on the device trace's own
    clock, over exactly the profiled stretch. A `fine_span` is not
    recorded then: under a profiler a span costs tens of µs, once per
    query or pump for the layer spans but once per chunk for these;
  * `enable(True)` records every span, `fine_span` too, profiler or
    not, into a bounded in-memory list (`recorded`, exported by
    `chrome_trace_from_spans` through `TraceBuilder`), besides
    `record_function`;
  * `enable(False)` records none, even under a profiler.

A span not recorded is one shared null context after a flag read and the
profiler's is-it-running check (`torch.autograd._profiler_enabled`, which
the tests pin): nothing allocated, nothing formatted. Spans sit only in
host code, never in code that a CUDA graph captures.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import threading
import time

import numpy as np
from torch.autograd import _profiler_enabled as _profiling
from torch.profiler import record_function

# the in-memory span list keeps the newest SPAN_CAP spans
SPAN_CAP = 1 << 16

_NULL = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One recorded span: `time.perf_counter_ns` at entry and exit (0
    while open), the span it opened inside (None at the top) and its
    args."""
    name: str
    start_ns: int
    end_ns: int
    parent: "SpanRecord | None"
    args: dict


class _Spans(threading.local):
    """The open spans of this thread, innermost last."""

    def __init__(self):
        self.stack: list[SpanRecord] = []


_forced: bool | None = None     # set by enable(); None: the profiler's
_records: collections.deque = collections.deque(maxlen=SPAN_CAP)
_open = _Spans()


def enable(on: bool | None) -> None:
    """True: record every span, `fine_span` too, with or without a
    profiler, starting a fresh in-memory list. False: record none, even
    under a profiler. None (the default): `span` only, while a
    `torch.profiler` runs, into the profiler's trace alone."""
    global _forced
    _forced = on
    if on:
        _records.clear()


def span(name: str, **args):
    """A context over one layer boundary of the port's host code (see
    `enable` for when it is recorded); else one shared null context."""
    on = _forced
    if on is None:
        return record_function(name) if _profiling() else _NULL
    return _Span(name, args) if on else _NULL


def fine_span(name: str, **args):
    """A span the fixpoint loop opens once per chunk or step: recorded
    only after `enable(True)`, never by a profiler alone."""
    return _Span(name, args) if _forced else _NULL


class _Span:
    __slots__ = ("name", "args", "rec", "rf")

    def __init__(self, name: str, args: dict):
        self.name, self.args = name, args

    def __enter__(self) -> SpanRecord:
        self.rf = record_function(self.name)
        self.rf.__enter__()
        stack = _open.stack
        self.rec = SpanRecord(self.name, time.perf_counter_ns(), 0,
                              stack[-1] if stack else None, self.args)
        stack.append(self.rec)
        _records.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.perf_counter_ns()
        _open.stack.pop()
        self.rf.__exit__(*exc)


def recorded() -> list[SpanRecord]:
    """The in-memory list: the newest `SPAN_CAP` spans, in entry order."""
    return list(_records)


def chrome_trace_from_spans(records=None) -> dict:
    """A Chrome trace of recorded spans (default: `recorded()`), times
    from the first span's start; each span's args carry its parent's
    index in `records` (None at the top, or once the list dropped it)."""
    records = recorded() if records is None else list(records)
    tb = TraceBuilder()
    tb.thread(0, "spans")
    index = {id(r): i for i, r in enumerate(records)}
    t0 = min((r.start_ns for r in records), default=0)
    for r in records:
        end = r.end_ns or r.start_ns
        parent = None if r.parent is None else index.get(id(r.parent))
        tb.span(r.name, (r.start_ns - t0) / 1e3, (end - r.start_ns) / 1e3,
                args={**r.args, "parent": parent})
    return tb.to_chrome()


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
