"""Port vs reference: the segment surface and continuous-batching serving.

The engine's segment surface first: K-step `run_segment`s compose into
the single-call fixpoint, and a `write_slot` lane evolves as its solo
run. Then `AsyncGraphServer` on port sessions (device="cpu") against the
reference's server on the same graph and streams under a `VirtualClock`:
the replay transcript -- request ids, slots, admission windows, waits,
service times, steps, cache hits, warm starts, outcomes and result
bytes -- must be equal, and so must the window count and cache ledger.
Rotation is bit-exact against solo queries for the idempotent programs
(pagerank and labelprop within `VertexAlgebra.atol`); the cache, warm
reuse across one update, deadlines, shedding, step budgets and `stats()`
follow the reference's contract.
"""
import numpy as np
import pytest

import flip
import flip_torch
from repro import resilience as ref_resilience
from repro.api import ExecutionPlan as RefPlan
from repro.graphs import make_power_law as ref_power_law
from repro.serving import AsyncGraphServer as RefServer
from repro.serving import VirtualClock as RefClock
from repro_torch.algebra import ALGEBRAS
from repro_torch.graphs import make_power_law
from repro_torch.resilience import (BackendFailure, CapacityExceeded,
                                    ConvergenceFailure, DeadlineExceeded,
                                    InvalidRequest, classify, finite_guard)
from repro_torch.serving import (AsyncGraphServer, ResultCache,
                                 ServeRequest, VirtualClock)

ALGOS = sorted(ALGEBRAS)
TILE = 16
SRCS = [3, 11, 0, 27, 42, 8, 19]
GRAPH_ARGS = dict(n=60, m=180, seed=3)


@pytest.fixture(scope="module")
def g():
    return make_power_law(**GRAPH_ARGS)


@pytest.fixture(scope="module")
def gr():
    return ref_power_law(**GRAPH_ARGS)


def server(g, **kw):
    kw.setdefault("tile", TILE)
    kw.setdefault("clock", VirtualClock())
    kw.setdefault("device", "cpu")
    return AsyncGraphServer(g, **kw)


def ref_server(gr, **kw):
    kw.setdefault("tile", TILE)
    kw.setdefault("relax_mode", "jnp")
    kw.setdefault("clock", RefClock())
    return RefServer(gr, **kw)


_SOLO = {}


def solo(g, algo, src, **query_kw):
    """The port's solo query, sessions cached per (graph, algo)."""
    key = (g.fingerprint(), algo)
    if key not in _SOLO:
        _SOLO[key] = flip_torch.compile(
            g, algo, flip_torch.ExecutionPlan(tile=TILE), device="cpu")
    return _SOLO[key].query(int(src), **query_kw)


def transcript(reqs):
    """The full observable outcome of a request sequence (the
    reference's own transcript, tests/test_serving_scheduler.py)."""
    return [(r.req_id, r.algo, r.src, r.slot, r.admit_window,
             r.queue_wait_s, r.service_s, r.steps, r.cache_hit,
             r.warm_started, r.converged,
             None if r.error is None else r.error.code,
             None if r.result is None else r.result.tobytes())
            for r in reqs]


def assert_same_result(algo, got, want):
    if ALGEBRAS[algo].semiring.idempotent:
        np.testing.assert_array_equal(got, want)
    else:
        assert ALGEBRAS[algo].results_match(got, want)


# ------------------------------------------------------------------ #
# the segment surface
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("k", [1, 2, 3, 7])
@pytest.mark.parametrize("algo", ["bfs", "sssp", "widest", "multi_bfs",
                                  "pagerank"])
def test_segments_compose_to_fixpoint(g, gr, algo, k):
    cq = flip_torch.compile(g, algo, flip_torch.ExecutionPlan(tile=TILE),
                            device="cpu")
    eng = cq.engine
    srcs = SRCS[:4]
    state = eng.initial_state(srcs)
    total = np.zeros(len(srcs), np.int32)
    conv = np.zeros(len(srcs), bool)
    while not conv.all():
        state, steps, conv = eng.run_segment(state, np.full(len(srcs), k))
        assert (steps <= k).all()
        total += steps
    out = eng.finalize_state(state[0], state[1])
    want = cq.query(srcs)
    np.testing.assert_array_equal(out, want.attrs)
    np.testing.assert_array_equal(total, want.steps)
    ref = flip.compile(gr, algo, RefPlan(tile=TILE, relax_mode="jnp"))
    assert_same_result(algo, out, np.asarray(ref.query(srcs).attrs))


@pytest.mark.parametrize("algo", ["sssp", "multi_bfs"])
def test_write_slot_lane_equals_solo(g, algo):
    cq = flip_torch.compile(g, algo, flip_torch.ExecutionPlan(tile=TILE),
                            device="cpu")
    eng = cq.engine
    idle = eng.idle_state(3)
    state = eng.write_slot(idle, 1, 27)
    assert not idle[2].any()                    # the input is untouched
    state, steps, conv = eng.run_segment(state, np.array([0, 10_000, 0]))
    assert conv.all() and steps[0] == steps[2] == 0
    want = cq.query(27)
    assert steps[1] == want.steps
    np.testing.assert_array_equal(
        eng.finalize_state(state[0][1:2], state[1][1:2])[0], want.attrs)


# ------------------------------------------------------------------ #
# the replay transcript equals the reference's
# ------------------------------------------------------------------ #
def test_replay_transcript_matches_reference(g, gr):
    stream = [("bfs", 3), ("sssp", 9), ("bfs", 27), ("bfs", 3),
              ("sssp", 42), ("wcc", 0), ("bfs", 11), ("sssp", 3)]

    def run(make, graph):
        srv = make(graph, batch=3, segment_steps=2)
        reqs = [srv.submit(a, s) for a, s in stream]
        srv.drain()
        return transcript(reqs), srv.windows, srv.cache.stats()

    got = run(server, g)
    assert got == run(server, g)                # replays itself
    assert got == run(ref_server, gr)


def test_zipf_stream_with_update_matches_reference(g, gr):
    """A seeded Zipf stream over two algebras with a monotone update in
    the middle: warm reuse, cache hits and rotation all at once."""
    rng = np.random.default_rng(11)
    pool = rng.permutation(g.n)[:12]
    ranks = np.minimum(rng.zipf(1.1, size=40), len(pool)) - 1
    eu = g.edge_sources()
    batch = [(int(eu[i]), int(g.indices[i]), float(g.weights[i]) * 0.5)
             for i in (0, 7, 13)] + [(5, 50, 1.0)]
    stream = [(("bfs", "sssp")[i % 2], int(pool[r]))
              for i, r in enumerate(ranks)]
    stream = stream[:24] + [("update", batch)] + stream[24:]

    def run(make, graph):
        srv = make(graph, batch=4, segment_steps=2)
        reqs = srv.serve(stream)
        return transcript(reqs), srv.windows, srv.cache.stats(), srv

    *got, srv = run(server, g)
    *want, _ = run(ref_server, gr)
    assert got == want
    reqs = got[0]
    assert any(t[8] for t in reqs) and any(t[9] for t in reqs)
    assert srv.failed == srv.shed == 0 and srv.updates_applied == 1


# ------------------------------------------------------------------ #
# rotation is invisible
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("algo", ALGOS)
def test_rotation_matches_solo(g, gr, algo):
    """B=3 lanes serving 7 queries, cache off: every request crosses the
    rotating batch and equals the port's solo run bit for bit, and the
    reference's solo run under the program's rule."""
    srv = server(g, batch=3, segment_steps=2, cache_capacity=0)
    reqs = [srv.submit(algo, s) for s in SRCS]
    srv.drain()
    ref = flip.compile(gr, algo, RefPlan(tile=TILE, relax_mode="jnp"))
    for r in reqs:
        assert r.ok, (algo, r.src, r.error)
        want = solo(g, algo, r.src)
        np.testing.assert_array_equal(r.result, want.attrs)
        assert r.steps == want.steps
        assert_same_result(algo, r.result,
                           np.asarray(ref.query(r.src).attrs))
    assert max(r.admit_window for r in reqs) > 0
    assert all(x.device.type == "cpu" for x in srv._batches[algo].state)


# ------------------------------------------------------------------ #
# the cache
# ------------------------------------------------------------------ #
def test_cache_hit_bit_identical_to_cold(g):
    srv = server(g, batch=2)
    cold = srv.submit("bfs", 27)
    srv.drain()
    hit = srv.submit("bfs", 27)
    assert hit.cache_hit and hit.ok and hit.steps == cold.steps
    np.testing.assert_array_equal(hit.result, cold.result)
    np.testing.assert_array_equal(hit.result, solo(g, "bfs", 27).attrs)
    assert srv.cache.stats()["hits"] == 1


def test_cache_lru_bound():
    c = ResultCache(capacity=3)
    for i in range(5):
        c.put("fp", "bfs", i, np.full(4, i, np.float32), i + 1)
    assert len(c) == 3 and c.evictions == 2
    assert c.get("fp", "bfs", 0) is None and c.get("fp", "bfs", 1) is None
    e = c.get("fp", "bfs", 2)
    assert e is not None and e.steps == 3
    c.put("fp", "bfs", 9, np.zeros(4, np.float32), 1)
    assert c.get("fp", "bfs", 2) is not None
    assert c.get("fp", "bfs", 3) is None
    with pytest.raises(ValueError):
        ResultCache(capacity=-1)
    with pytest.raises(ValueError):
        e.attrs[0] = 99.0                   # served entries are frozen
    srv = server(make_power_law(**GRAPH_ARGS), batch=2, cache_capacity=0)
    srv.submit("bfs", 27)
    srv.drain()
    assert not srv.submit("bfs", 27).cache_hit
    assert srv.cache.stats()["entries"] == 0


def test_superseded_fingerprint_never_served(g):
    srv = server(g, batch=2)
    before = srv.submit("sssp", 27)
    srv.drain()
    far = int(np.argmax(np.where(np.isfinite(before.result)
                                 & (before.result > 0), before.result,
                                 -1.0)))
    assert before.result[far] > 0.001
    srv.update([(27, far, 0.001)])
    after = srv.submit("sssp", 27)
    srv.drain()
    assert after.ok and not after.cache_hit
    np.testing.assert_array_equal(after.result,
                                  solo(srv.graph, "sssp", 27).attrs)
    assert not np.array_equal(after.result, before.result)


# ------------------------------------------------------------------ #
# warm reuse across one update
# ------------------------------------------------------------------ #
def test_warm_start_across_one_update(g):
    srv = server(g, batch=2)
    for s in (3, 27):
        srv.submit("sssp", s)
    srv.drain()
    eu = g.edge_sources()
    batch = [(int(eu[i]), int(g.indices[i]), float(g.weights[i]) * 0.5)
             for i in (0, 7, 13)]
    srv.update(batch)
    g2 = g.apply_updates(batch)
    reqs = [srv.submit("sssp", s) for s in (3, 27)]
    srv.drain()
    for r in reqs:
        assert r.ok and r.warm_started, (r.src, r.error)
        np.testing.assert_array_equal(r.result, solo(g2, "sssp", r.src).attrs)
    cold = srv.submit("sssp", 42)
    srv.drain()
    assert cold.ok and not cold.warm_started
    # two back-to-back updates leave nothing to resume from
    srv.update([(3, 50, 0.5)])
    srv.update([(5, 59, 0.5)])
    r = srv.submit("sssp", 3)
    srv.drain()
    assert r.ok and not r.warm_started
    np.testing.assert_array_equal(r.result, solo(srv.graph, "sssp", 3).attrs)


@pytest.mark.parametrize("algo,batch", [("pagerank", [(3, 50, 0.5)]),
                                        ("sssp", "delete")])
def test_non_monotone_never_warm_starts(g, algo, batch):
    srv = server(g, batch=2)
    srv.submit(algo, 3)
    srv.drain()
    if batch == "delete":
        eu = g.edge_sources()
        batch = [(int(eu[i]), int(g.indices[i]), None) for i in (0, 1)]
    srv.update(batch)
    r = srv.submit(algo, 3)
    srv.drain()
    assert r.ok and not r.warm_started
    np.testing.assert_array_equal(r.result, solo(srv.graph, algo, 3).attrs)


# ------------------------------------------------------------------ #
# deadlines, budgets, shedding: on the scheduler's clock
# ------------------------------------------------------------------ #
def test_deadline_expiry_inside_rotating_batch(g):
    srv = server(g, batch=2, segment_steps=2)
    slow = srv.submit("bfs", 27, deadline_s=3.0)
    fast = srv.submit("bfs", 3)
    srv.drain()
    assert not slow.ok and slow.deadline_expired
    assert isinstance(slow.error, DeadlineExceeded)
    assert slow.error.where == "fixpoint"
    assert 0 < slow.steps < solo(g, "bfs", 27).steps
    part = solo(g, "bfs", 27, max_steps=slow.steps)
    np.testing.assert_array_equal(slow.result, part.attrs)
    assert fast.ok
    np.testing.assert_array_equal(fast.result, solo(g, "bfs", 3).attrs)


def test_deadline_expiry_in_queue(g):
    clock = VirtualClock()
    srv = server(g, batch=1, clock=clock)
    first = srv.submit("bfs", 27)
    queued = srv.submit("bfs", 42, deadline_s=1.0)
    clock.advance(2.0)
    srv.drain()
    assert first.ok and not queued.ok and queued.deadline_expired
    assert queued.error.where == "queue" and queued.result is None
    assert queued.queue_wait_s >= 1.0


def test_step_budget_partial_is_exact_prefix(g):
    srv = server(g, batch=2, segment_steps=2)
    r = srv.submit("sssp", 27, max_steps=3)
    srv.drain()
    assert not r.ok and isinstance(r.error, ConvergenceFailure)
    assert not r.converged and r.steps == 3
    np.testing.assert_array_equal(
        r.result, solo(g, "sssp", 27, max_steps=3).attrs)


def test_shed_newest_and_zero_lost(g):
    srv = server(g, batch=1, max_queue_depth=2)
    reqs = [srv.submit("bfs", i) for i in range(6)]
    shed = [r for r in reqs if isinstance(r.error, CapacityExceeded)]
    assert [r.req_id for r in shed] == [2, 3, 4, 5]
    srv.drain()
    assert all(r.done for r in reqs) and sum(r.ok for r in reqs) == 2
    assert srv.shed == 4
    srv2 = server(g, batch=1, quotas={"bfs": 1})
    out = [srv2.submit("bfs", i) for i in range(3)]
    assert sum(isinstance(r.error, CapacityExceeded) for r in out) == 2
    r = ServeRequest(0, "bfs", 1)
    assert not r.done and not r.ok


def test_invalid_requests_raise_synchronously(g):
    srv = server(g)
    for algo, src, kw in (("nope", 0, {}), ("bfs", g.n, {}),
                          ("bfs", -1, {}), ("bfs", 0, {"max_steps": 0}),
                          ("bfs", 0, {"deadline_s": -1.0})):
        with pytest.raises(InvalidRequest):
            srv.submit(algo, src, **kw)
    assert srv.pending == 0
    with pytest.raises(ValueError):
        server(g, segment_steps=0)


def test_window_failure_is_typed_per_request(g, monkeypatch):
    """A window that raises fails its occupied lanes with a typed error
    and the server keeps serving: no request is lost."""
    srv = server(g, batch=2)
    rb = srv._batch("bfs")
    monkeypatch.setattr(rb.engine, "run_segment", lambda *a: 1 / 0)
    reqs = [srv.submit("bfs", s) for s in (3, 27)]
    srv.pump()
    assert all(isinstance(r.error, BackendFailure) for r in reqs)
    assert srv.failed == 2 and srv.pending == 0
    monkeypatch.undo()
    ok = srv.submit("bfs", 27)
    srv.drain()
    assert ok.ok


# ------------------------------------------------------------------ #
# stats, and the two degrade helpers
# ------------------------------------------------------------------ #
def test_stats_keys_match_reference(g, gr):
    import json
    got, want = server(g, batch=2, segment_steps=2), \
        ref_server(gr, batch=2, segment_steps=2)
    for srv in (got, want):
        for s in (3, 27, 3, 42):
            srv.submit("bfs", s)
        srv.drain()
    sg, sw = got.stats(), want.stats()
    json.dumps(sg)
    assert sg.keys() == sw.keys()
    assert sg["metrics"]["counters"].keys() == \
        sw["metrics"]["counters"].keys()
    assert sg["metrics"]["histograms"].keys() == \
        sw["metrics"]["histograms"].keys()
    assert {k: sg[k] for k in ("windows", "completed", "cache", "occupancy",
                               "queue_depth")} == \
        {k: sw[k] for k in ("windows", "completed", "cache", "occupancy",
                            "queue_depth")}


def test_classify_and_finite_guard_match_reference():
    boom = RuntimeError("boom")
    for exc, ref_exc in ((boom, boom),
                         (InvalidRequest("bad", value=1),
                          ref_resilience.InvalidRequest("bad", value=1))):
        got, want = classify(exc, 1), ref_resilience.classify(ref_exc, 1)
        assert got.code == want.code and str(got) == str(want)
    assert classify(boom).cause is boom
    ok = np.array([0.0, np.inf, -np.inf], np.float32)
    finite_guard(ok)
    ref_resilience.finite_guard(ok)
    bad = np.array([[np.nan, 1.0], [np.nan, 2.0]], np.float32)
    with pytest.raises(BackendFailure) as e:
        finite_guard(bad)
    with pytest.raises(ref_resilience.BackendFailure) as er:
        ref_resilience.finite_guard(bad)
    assert str(e.value) == str(er.value)
