"""Port vs reference: query tracing, the metrics registry, trace export.

Tracing must be exact -- `query(trace=True)` returns the untraced attrs
and steps bit for bit, solo and batched, compact on and off -- and its
`StepTrace` rows (active vertices, active tiles, blocks fetched and
skipped, the converged mask) must equal the reference's traced rows on
the same graph and sources (`step_wall_s` is a host clock and is not
compared). Then truncation, compile-time attribution, bucketed
collection, the Chrome-trace round trip, the CLI, and the reference's
metrics tests run against the port's classes. Last, the program's spans
and counters: nested as the layers nest, in the profiler's trace only
while they are on, exact (results and steps unchanged), counting what the
fixpoint ran, one admission and one retirement per served request, and
exported through `TraceBuilder`.
"""
import json

import numpy as np
import pytest
import torch

import flip
import flip_torch
from repro import obs as ref_obs
from repro.api import ExecutionPlan as RefPlan
from repro.graphs import make_power_law as ref_power_law
from repro_torch.algebra import ALGEBRAS
from repro_torch.graphs import make_power_law
from repro_torch import obs
from repro_torch.core import engine as eng_mod
from repro_torch.obs import (Counter, Histogram, MetricsRegistry,
                             chrome_trace_from_result, write_chrome_trace)
from repro_torch.serving import AsyncGraphServer

ALGOS = sorted(ALGEBRAS)
TILE = 16
GRAPH_ARGS = dict(n=300, m=900, seed=1)
SRCS4 = [0, 7, 42, 299]
_SESSIONS = {}


def session(algo, compact=True, batch=0):
    key = ("port", algo, compact, batch)
    if key not in _SESSIONS:
        _SESSIONS[key] = flip_torch.compile(
            make_power_law(**GRAPH_ARGS), algo, flip_torch.ExecutionPlan(
                tile=TILE, compact=compact, batch=batch), device="cpu")
    return _SESSIONS[key]


def ref_session(algo, compact=True):
    key = ("ref", algo, compact)
    if key not in _SESSIONS:
        _SESSIONS[key] = flip.compile(
            ref_power_law(**GRAPH_ARGS), algo, RefPlan(
                tile=TILE, compact=compact, relax_mode="jnp"))
    return _SESSIONS[key]


# ------------------------------------------------------------------ #
# tracing is exact
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("shape", ["solo", "batch4"])
@pytest.mark.parametrize("algo", ALGOS)
def test_trace_bit_exact(algo, shape, compact):
    cq = session(algo, compact)
    srcs = 3 if shape == "solo" else SRCS4
    r, rt = cq.query(srcs), cq.query(srcs, trace=True)
    np.testing.assert_array_equal(r.attrs, rt.attrs)
    np.testing.assert_array_equal(r.steps, rt.steps)
    assert r.telemetry is None and rt.telemetry is not None
    d = rt.telemetry.dispatches[0]
    assert len(d.trace) == int(np.max(r.steps)) and not d.truncated
    assert d.backend == "torch" and d.compact == compact
    assert d.trace.active_vertices.shape == (len(d.trace), np.size(srcs))
    assert (d.trace.blocks_fetched + d.trace.blocks_skipped
            == cq.engine.bg.bsrc.numel()).all()
    assert d.trace.step_wall_s.shape == (len(d.trace),)


# ------------------------------------------------------------------ #
# the rows equal the reference's
# ------------------------------------------------------------------ #
ROWS = ("active_vertices", "active_tiles", "blocks_fetched",
        "blocks_skipped", "converged")


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("algo", ["bfs", "sssp", "wcc", "multi_bfs",
                                  "pagerank"])
def test_step_trace_matches_reference(algo, compact):
    got = session(algo, compact).query(SRCS4, trace=True)
    want = ref_session(algo, compact).query(SRCS4, trace=True)
    tp = got.telemetry.dispatches[0]
    tr = want.telemetry.dispatches[0]
    if ALGEBRAS[algo].semiring.idempotent:
        np.testing.assert_array_equal(got.attrs, want.attrs)
        for f in ROWS:
            np.testing.assert_array_equal(getattr(tp.trace, f),
                                          getattr(tr.trace, f), f)
    else:
        # (+, ×) is not bit-stable: the frontier may differ by a step
        assert ALGEBRAS[algo].results_match(got.attrs, want.attrs)
        assert abs(len(tp.trace) - len(tr.trace)) <= 1
    sp, sr = tp.summary(), tr.summary()
    for k in ("mode", "compact", "batch", "feature_dim", "truncated"):
        assert sp[k] == sr[k], k
    for k in ("n", "ntiles", "n_blocks", "tile"):
        assert getattr(tp, k) == getattr(tr, k), k


def test_trace_matches_reference_solo_and_bucketed():
    got = session("bfs", batch=4).query(list(range(10)), trace=True)
    cq_ref = flip.compile(ref_power_law(**GRAPH_ARGS), "bfs", RefPlan(
        tile=TILE, batch=4, relax_mode="jnp"))
    want = cq_ref.query(list(range(10)), trace=True)
    assert len(got.telemetry.dispatches) == got.dispatches == 3
    for dp, dr in zip(got.telemetry.dispatches, want.telemetry.dispatches):
        for f in ROWS:
            np.testing.assert_array_equal(getattr(dp.trace, f),
                                          getattr(dr.trace, f), f)
    assert got.telemetry.steps_histogram() == \
        want.telemetry.steps_histogram()
    assert sum(got.telemetry.steps_histogram().values()) == 12


def test_truncation_flag():
    for compact in (True, False):
        cq = session("bfs", compact)
        r, rt = cq.query(0), cq.query(0, trace=2)
        assert r.steps > 2 and r.steps == rt.steps
        d = rt.telemetry.dispatches[0]
        assert d.truncated and len(d.trace) == 2
        np.testing.assert_array_equal(r.attrs, rt.attrs)


def test_compile_s_first_dispatch_only():
    cq = flip_torch.compile(make_power_law(**GRAPH_ARGS), "bfs",
                            flip_torch.ExecutionPlan(tile=TILE),
                            device="cpu")
    r1, r2 = cq.query(3), cq.query(5)
    assert 0.0 < r1.compile_s == pytest.approx(r1.wall_s, rel=0.05)
    assert r2.compile_s == 0.0 and r2.wall_s > 0.0
    t1, t2 = cq.query(3, trace=True), cq.query(3, trace=True)
    assert t1.compile_s > 0.0 and t2.compile_s == 0.0
    assert t1.telemetry.compile_s == t1.compile_s
    # sessions from update() share the record of dispatched signatures
    cq2, _ = cq.update([(0, 1, 0.5)])
    assert cq2.query(3).compile_s == 0.0


def test_compile_s_bucketed():
    cq = flip_torch.compile(make_power_law(**GRAPH_ARGS), "bfs",
                            flip_torch.ExecutionPlan(tile=TILE, batch=4),
                            device="cpu")
    r1, r2 = cq.query(list(range(10))), cq.query(list(range(10)))
    assert r1.dispatches == r2.dispatches == 3
    assert r1.compile_s > 0.0 and r2.compile_s == 0.0


def test_empty_batch_trace():
    rt = session("bfs").query([], trace=True)
    assert rt.telemetry.dispatches == [] and rt.dispatches == 0


# ------------------------------------------------------------------ #
# exporters
# ------------------------------------------------------------------ #
def test_chrome_trace_roundtrip(tmp_path):
    rt = session("bfs").query([0, 5], trace=True)
    path = str(tmp_path / "trace.json")
    write_chrome_trace(path, rt)
    with open(path) as f:
        doc = json.load(f)
    assert doc == chrome_trace_from_result(rt)
    evs = doc["traceEvents"]
    steps = [e for e in evs if e["ph"] == "X"
             and e["name"].startswith("step ")]
    assert len(steps) == int(np.max(rt.steps))
    assert all(e["dur"] >= 0 and "args" in e for e in steps)
    assert not any("synthetic_timing" in e["args"] for e in steps)
    assert {"active_vertices", "active_tiles", "blocks_fetched",
            "blocks_skipped", "live_queries"} <= set(steps[0]["args"])
    assert any(e["ph"] == "C" and e["name"] == "frontier" for e in evs)
    # the bare telemetry takes the same path through the writer
    write_chrome_trace(path, rt.telemetry)
    with pytest.raises(ValueError, match="trace=True"):
        chrome_trace_from_result(session("bfs").query(0))


def test_telemetry_to_json_roundtrip():
    rt = session("sssp").query(SRCS4, trace=True)
    doc = json.loads(json.dumps(rt.telemetry.to_json()))
    assert doc["summary"]["traced_steps"] == \
        len(rt.telemetry.dispatches[0].trace)
    assert len(doc["dispatches"]) == 1
    tr = doc["dispatches"][0]["trace"]
    assert len(tr["active_vertices"]) == doc["summary"]["traced_steps"]
    assert len(tr["step_wall_s"]) == doc["summary"]["traced_steps"]


def test_graph_run_trace(tmp_path, capsys):
    from repro_torch.launch import graph_run
    path = tmp_path / "t.json"
    graph_run.main(["--algo", "bfs", "--dataset", "SRN", "--src", "2",
                    "--trace", str(path), "--device", "cpu", "--effort", "0"])
    out = capsys.readouterr().out
    assert "[graph] trace:" in out
    assert "[graph] correct vs reference: True" in out
    doc = json.loads(path.read_text())
    assert any(e["name"].startswith("step ") for e in doc["traceEvents"])
    with pytest.raises(SystemExit, match="drop --batch"):
        graph_run.main(["--dataset", "SRN", "--srcs", "0,1", "--batch",
                        "2", "--trace", str(path), "--device", "cpu"])


# ------------------------------------------------------------------ #
# the metrics registry (the reference's tests, on the port's classes)
# ------------------------------------------------------------------ #
def test_counter_monotone():
    c = Counter("x")
    c.inc()
    c.inc(4)
    assert c.snapshot() == 5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_histogram_quantiles_exact_below_capacity():
    h = Histogram("lat", capacity=256)
    for v in range(100):
        h.observe(float(v))
    s = h.snapshot()
    assert s["count"] == 100 and s["min"] == 0.0 and s["max"] == 99.0
    assert s["mean"] == pytest.approx(49.5)
    assert abs(s["p50"] - 49.5) <= 1.0
    assert s["p95"] >= 93.0 and s["p99"] >= 97.0


def test_histogram_reservoir_matches_reference():
    h, hr = Histogram("lat", capacity=64), ref_obs.Histogram("lat",
                                                             capacity=64)
    for v in range(10_000):
        h.observe(float(v % 100))
        hr.observe(float(v % 100))
    assert len(h._reservoir) == 64 and h.count == 10_000
    assert h.snapshot() == hr.snapshot()


def test_registry_snapshot_and_exports(tmp_path):
    m = MetricsRegistry()
    m.counter("req").inc(3)
    m.gauge("depth").set(7)
    m.histogram("lat").observe(0.25)
    snap = m.snapshot()
    assert snap["counters"]["req"] == 3
    assert snap["gauges"]["depth"] == 7.0
    assert snap["histograms"]["lat"]["count"] == 1
    p = m.write_snapshot_json(str(tmp_path / "snap.json"))
    with open(p) as f:
        assert json.load(f) == snap
    assert m.counter("req") is m.counter("req")
    m.counter("shed.bfs").inc(2)
    m.counter("shed.sssp").inc()
    assert m.sum_counters("shed.") == 3


# ------------------------------------------------------------------ #
# program spans and counters
# ------------------------------------------------------------------ #
# each span's parent: the span it nests in directly
QUERY_TREE = {"flip.query": None, "flip.init": "flip.query",
              "flip.fixpoint": "flip.query", "flip.chunk": "flip.fixpoint",
              "flip.read": "flip.fixpoint", "flip.finalize": "flip.query"}


@pytest.fixture
def spans():
    """The span switch, put back to its default after the test."""
    try:
        yield obs.enable
    finally:
        obs.enable(None)


@pytest.fixture(params=["host", "device"])
def route(request, monkeypatch):
    """Either fixpoint loop: the CPU's host loop, or the device loop
    (run eagerly on the CPU, as its captured chunks replay on the card)."""
    if request.param == "device":
        monkeypatch.setattr(eng_mod, "fixpoint_route",
                            lambda *a, **k: "device")
    return request.param


def _profiled(fn, tmp_path):
    """`fn()` under torch.profiler (CPU); the `flip.*` events of its
    Chrome trace as (name, start, end) in µs, in start order."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                  for e in evs if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith("flip."))


def _parents(events):
    """Each (name, start, end) event's innermost enclosing event's name."""
    out = []
    for i, (name, s, e) in enumerate(events):
        around = [(e2 - s2, n2) for j, (n2, s2, e2) in enumerate(events)
                  if j != i and s2 <= s and e <= e2 and (e2 - s2) > (e - s)]
        out.append((name, min(around)[1] if around else None))
    return out


def test_query_spans_nest_under_the_profiler(tmp_path, route, spans):
    cq = session("sssp")
    spans(True)
    events = _profiled(lambda: cq.query(SRCS4), tmp_path)
    names = [n for n, _, _ in events]
    assert set(names) == set(QUERY_TREE)
    assert names.count("flip.query") == names.count("flip.fixpoint") == 1
    assert names.count("flip.chunk") >= 2
    for name, parent in _parents(events):
        assert parent == QUERY_TREE[name], (name, parent)
    # the in-memory list holds the same spans
    assert sorted(r.name for r in obs.recorded()) == sorted(names)


def test_the_profiler_alone_records_the_layer_spans(tmp_path, route,
                                                    spans):
    """By default a profiler turns on the layer spans, into its trace
    alone, and leaves the loop's per-chunk spans off: a gap inside the
    loop falls under `flip.fixpoint`."""
    cq = session("sssp")
    before = obs.recorded()
    cq.query(SRCS4)
    events = _profiled(lambda: cq.query(SRCS4), tmp_path)
    want = {k: v for k, v in QUERY_TREE.items()
            if k not in ("flip.chunk", "flip.read")}
    assert sorted(n for n, _, _ in events) == sorted(want)
    for name, parent in _parents(events):
        assert parent == want[name], (name, parent)
    assert obs.recorded() == before


def test_the_profiler_check_follows_torch_profiler():
    """The spans' default follows `torch.autograd._profiler_enabled`, a
    private torch call: pinned here to `torch.profiler.profile`."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace
    assert trace._profiling() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace._profiling() is True
    assert trace._profiling() is False


@pytest.mark.parametrize("what", ["query", "pump"])
def test_spans_off_leave_no_trace(tmp_path, spans, what):
    spans(False)
    if what == "query":
        call = lambda: session("bfs").query(SRCS4)        # noqa: E731
    else:
        srv = AsyncGraphServer(make_power_law(**GRAPH_ARGS), batch=2,
                               tile=TILE, device="cpu")
        for src in SRCS4:
            srv.submit("bfs", src)
        call = srv.drain
    assert _profiled(call, tmp_path) == []


@pytest.mark.parametrize("algo", ["bfs", "sssp", "pagerank", "multi_bfs"])
def test_spans_change_no_result(algo, route, spans):
    cq = session(algo)
    spans(False)
    off = cq.query(SRCS4)
    spans(True)
    on = cq.query(SRCS4)
    assert len(obs.recorded()) > 0
    np.testing.assert_array_equal(on.attrs, off.attrs)
    np.testing.assert_array_equal(on.steps, off.steps)
    np.testing.assert_array_equal(on.converged, off.converged)


def test_program_counters_count_the_fixpoint(route):
    names = ("chunks", "steps_enqueued", "iterations")

    def now():
        return {k: obs.PROGRAM.counter(f"fixpoint.{k}").value
                for k in names}

    cq = session("bfs")
    before = now()
    r = cq.query(SRCS4)
    d = {k: v - before[k] for k, v in now().items()}
    assert d["iterations"] == int(np.max(r.steps))
    assert d["steps_enqueued"] >= d["iterations"]
    if route == "host":                             # a chunk is one step
        assert d["chunks"] == d["steps_enqueued"] == d["iterations"]
    else:
        chunk = eng_mod.DEVICE_CHUNK
        assert d["steps_enqueued"] - d["iterations"] < chunk
        assert d["chunks"] == -(-d["steps_enqueued"] // chunk)


def test_served_spans_carry_each_request(spans):
    srv = AsyncGraphServer(make_power_law(**GRAPH_ARGS), batch=2,
                           tile=TILE, segment_steps=2, cache_capacity=0,
                           device="cpu")
    spans(True)
    reqs = [srv.submit(algo, src) for algo, src in
            [("bfs", 0), ("sssp", 7), ("bfs", 42), ("sssp", 299),
             ("bfs", 5)]]
    srv.drain()
    assert all(r.ok for r in reqs)
    recs = obs.recorded()
    for kind, child in (("flip.admit", "flip.init"),
                        ("flip.retire", "flip.finalize")):
        mine = [r for r in recs if r.name == kind]
        assert sorted(r.args["req"] for r in mine) == \
            sorted(q.req_id for q in reqs)
        by_id = {q.req_id: q for q in reqs}
        assert all(r.args["algo"] == by_id[r.args["req"]].algo
                   for r in mine)
        assert all(r.parent.name == "flip.pump" for r in mine)
        assert {id(r.parent) for r in recs if r.name == child} \
            <= {id(r) for r in mine}
    windows = [r for r in recs if r.name == "flip.window"]
    assert windows and all(r.parent.name == "flip.pump" for r in windows)
    fix = [r for r in recs if r.name == "flip.fixpoint"]
    assert [id(r.parent) for r in fix] == [id(w) for w in windows]
    assert all(r.end_ns >= r.start_ns > 0 for r in recs)


def test_span_list_exports_through_trace_builder(spans):
    spans(True)
    session("wcc").query(SRCS4)
    recs = obs.recorded()
    doc = json.loads(json.dumps(obs.chrome_trace_from_spans()))
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in evs] == [r.name for r in recs]
    assert evs[0]["name"] == "flip.query" and evs[0]["ts"] == 0.0
    assert evs[0]["args"] == {"batch": len(SRCS4), "parent": None}
    for e, r in zip(evs, recs):
        assert e["dur"] == pytest.approx((r.end_ns - r.start_ns) / 1e3)
        if r.parent is not None:
            p = evs[e["args"]["parent"]]
            assert p["name"] == r.parent.name
            assert p["ts"] <= e["ts"] and \
                e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    chunks = [e for e in evs if e["name"] == "flip.chunk"]
    assert chunks and all(e["args"]["n"] == 1 for e in chunks)
    # enable(True) starts a fresh list
    spans(True)
    assert obs.recorded() == []
