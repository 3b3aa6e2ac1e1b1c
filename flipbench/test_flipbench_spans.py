"""The readers of the program's spans and counters: idle time put down to
the innermost `flip.*` span over each gap, the six per-layer metrics on
synthetic traces with known gaps, and, on the CPU, a traced closed loop
whose profiler turns the port's spans on over exactly its stretch."""
import numpy as np
import pytest

import repro_torch.obs
from flipbench import devtrace, harness, loops, spans, spec
from repro_torch.obs import MetricsRegistry

# the card busy for 0.1 s in every 0.2 s of a 1 s window: five idle gaps
# of 0.1 s, at 0.1, 0.3, 0.5, 0.7 and 0.9
BUSY = [(0.2 * i, 0.2 * i + 0.1, "relax_kernel<0, 8, 1>") for i in range(5)]

CLOSED = [
    (0.00, 0.97, "flipbench.query"),
    (0.05, 0.90, "flip.query"),
    (0.10, 0.20, "flip.init"),                 # gap 1
    (0.20, 0.65, "flip.fixpoint"),             # gap 3: the loop's own
    (0.25, 0.32, "flip.chunk"),
    (0.32, 0.45, "flip.read"),                 # gap 2
    (0.33, 0.38, "cudaMemcpyAsync"),
    (0.70, 0.85, "flip.finalize"),             # gap 4
    (0.72, 0.78, "aten::copy_"),
]                                              # gap 5: flipbench.query only

SERVE = [
    (0.00, 0.48, "flipbench.pump"),
    (0.01, 0.47, "flip.pump"),
    (0.05, 0.22, "flip.admit"),
    (0.12, 0.18, "flip.init"),                 # gap 1
    (0.22, 0.42, "flip.window"),
    (0.23, 0.41, "flip.fixpoint"),
    (0.24, 0.30, "flip.chunk"),
    (0.30, 0.40, "flip.read"),                 # gap 2
    (0.32, 0.39, "cudaMemcpyAsync"),
    (0.50, 0.70, "flipbench.pump"),
    (0.51, 0.69, "flip.pump"),                 # gap 3
    (0.70, 0.86, "flip.retire"),
    (0.71, 0.85, "flip.finalize"),             # gap 4
    (0.72, 0.78, "cudaMemcpyAsync"),
    (0.86, 1.00, "flipbench.idle"),            # gap 5
]


def _trace(host):
    return devtrace.DeviceTrace(window_s=1.0, device=list(BUSY),
                                host=list(host))


def _closed_run(trace):
    q = loops.QueryRecord("sssp", np.zeros(8), np.ones(8), True, True)
    return harness.Run(cell=None, raw=None, device="cpu", setup_s=0.0,
                       queries=[q], trace=trace)


def _served_run(trace):
    r = loops.RequestRecord("bfs", 0, 0.0)
    return harness.Run(cell=None, raw=None, device="cpu", setup_s=0.0,
                       requests=[r], trace=trace)


def test_idle_under_the_innermost_program_span():
    t = _trace(CLOSED)
    got = spans.idle_under(t)
    want = {"flip.init": 0.1, "flip.read": 0.1, "flip.fixpoint": 0.1,
            "flip.finalize": 0.1, "outside": 0.1}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    # the harness's own naming is unchanged: the last gap is its query's
    assert dict(t.idle_gaps())["flipbench.query"] == pytest.approx(0.1)
    assert dict(t.idle_gaps())["cudaMemcpyAsync"] == pytest.approx(0.1)
    # "flip." never takes the harness's flipbench.* spans
    assert not any(k.startswith("flipbench") for k in got)
    assert "flipbench.query" in spans.idle_under(t, prefix="flip")
    assert sum(got.values()) == pytest.approx(1.0 - t.busy_s)


def test_idle_under_the_server():
    got = spans.idle_under(_trace(SERVE))
    want = {"flip.init": 0.1, "flip.read": 0.1, "flip.pump": 0.1,
            "flip.finalize": 0.1, "outside": 0.1}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_closed_loop_readers():
    run = _closed_run(_trace(CLOSED))
    session = _read("idle_session.batch", run)
    fixpoint = _read("idle_fixpoint.batch", run)
    idle = _read("device_idle.batch", run)
    assert session == pytest.approx(20.0)           # init + finalize
    assert fixpoint == pytest.approx(20.0)          # read + the loop's own
    assert idle == pytest.approx(50.0)
    assert session + fixpoint <= idle + 1e-9        # the rest is outside
    for name in ("idle_scheduler.serve", "idle_fixpoint.serve"):
        assert _read(name, run) is None             # not a served run


def test_served_readers():
    run = _served_run(_trace(SERVE))
    scheduler = _read("idle_scheduler.serve", run)
    fixpoint = _read("idle_fixpoint.serve", run)
    assert scheduler == pytest.approx(30.0)         # init, pump, finalize
    assert fixpoint == pytest.approx(10.0)          # the summary read
    assert scheduler + fixpoint <= _read("device_idle.serve", run) + 1e-9
    for name in ("idle_session.batch", "idle_fixpoint.batch",
                 "overrun_steps.batch", "chunks_per_step.batch"):
        assert _read(name, run) is None             # not a closed loop


@pytest.mark.parametrize("name", ["idle_session.batch",
                                  "idle_fixpoint.batch",
                                  "idle_scheduler.serve",
                                  "idle_fixpoint.serve"])
def test_span_readers_read_nothing_without_program_spans(name):
    """A program with no spans (the trace holds only the harness's and
    the runtime's) and a run with no device operation read nothing."""
    make = _served_run if name.endswith(".serve") else _closed_run
    bare = [h for h in CLOSED + SERVE if not h[2].startswith("flip.")]
    assert _read(name, make(_trace(bare))) is None
    idle = devtrace.DeviceTrace(window_s=1.0, device=[],
                                host=CLOSED + SERVE)
    assert _read(name, make(idle)) is None
    assert _read(name, make(None)) is None


@pytest.mark.parametrize("name,want", [("overrun_steps.batch", 19.0),
                                       ("chunks_per_step.batch", 0.125)])
def test_counter_readers_read_the_counters(monkeypatch, name, want):
    reg = MetricsRegistry()
    monkeypatch.setattr(repro_torch.obs, "PROGRAM", reg)
    run = _closed_run(None)
    assert _read(name, run) is None                     # nothing run
    reg.counter("fixpoint.chunks").inc(25)
    reg.counter("fixpoint.steps_enqueued").inc(200)
    reg.counter("fixpoint.iterations").inc(200 - 38)
    assert spans.counters() == {"fixpoint.chunks": 25,
                                "fixpoint.steps_enqueued": 200,
                                "fixpoint.iterations": 162}
    assert _read(name, run) == pytest.approx(
        want if name.startswith("overrun") else 25 / 162)
    monkeypatch.delattr(repro_torch.obs, "PROGRAM")
    assert spans.counters() is None
    assert _read(name, run) is None


def test_the_profiler_turns_the_program_spans_on():
    """A traced closed loop on the CPU: the port's layer spans are in the
    trace of the traced calls, nested in the harness's query spans, its
    per-chunk spans are not, and nothing goes into the in-memory list."""
    from flipbench.generators import road_grid
    import flip_torch
    raw = road_grid.generate({"n": 400, "delete_frac": 0.56,
                              "max_weight": 8}, 3)
    cq = flip_torch.compile(raw.to_port(), "bfs", device="cpu")
    rng = np.random.default_rng(0)
    traffic = {"batch": 2, "program": "bfs", "trace_seconds": 0.0}
    rec = devtrace.Recorder(cuda=False)
    rec.warm()
    before = len(repro_torch.obs.recorded())
    calls, _ = loops.closed_loop(cq, traffic, 0.0, loops.Sources(raw, rng),
                                 loops.Reservoir(1, rng), rec)
    assert len(calls) == 1 and calls[0].traced
    t = rec.read()
    names = [h[2] for h in t.host]
    for name in ("flip.query", "flip.init", "flip.fixpoint",
                 "flip.finalize"):
        assert name in names, name
    assert "flip.chunk" not in names and "flip.read" not in names
    (q0, q1, _), = [h for h in t.host if h[2] == "flip.query"]
    (h0, h1, _), = [h for h in t.host if h[2] == "flipbench.query"]
    assert h0 <= q0 <= q1 <= h1
    cq.query([0, 1])                                  # the profiler is off
    assert len(repro_torch.obs.recorded()) == before
