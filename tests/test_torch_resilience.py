"""Port vs reference: the degradation ladder, fault injection, the
heartbeat and the bucket `GraphServer`.

The reference's resilience cases (tests/test_resilience.py) run here on
the port's `GraphServer(device="cpu")`, each beside the reference's
server on the same graph, stream and fault schedule. Every case must
show the same rung sequence, the same `faults_fired`, the same typed
error codes and the same results: bit for bit (steps too) for the
idempotent programs, within `VertexAlgebra.atol` for pagerank. The
ladder's shape is held on the CPU ([torch + compact, torch + dense], the
reference's [jnp + compact, jnp + dense]) and, resolved for a CUDA
device, on the card's knobs ([cuda + compact, cuda + dense]: no rung
reaches the plain version there).
"""
import sys
import time

import numpy as np
import pytest

import flip
import flip_torch
from repro.algebra import ALGEBRAS as REF_ALGEBRAS
from repro.distributed.health import HeartbeatMonitor as RefHeartbeat
from repro.graphs import make_power_law as ref_power_law
from repro.launch.serve_graph import GraphServer as RefServer
from repro.resilience import FaultInjector as RefInjector
from repro.resilience import FaultSpec as RefSpec
from repro.resilience import fallback_chain as ref_fallback_chain
from repro_torch.algebra import ALGEBRAS
from repro_torch.distributed.health import HeartbeatMonitor
from repro_torch.graphs import make_power_law, reference
from repro_torch.launch.serve_graph import GraphServer
from repro_torch.resilience import (BackendFailure, CapacityExceeded,
                                    FaultInjector, FaultSpec, FlipError,
                                    InjectedFault, classify, fallback_chain)

TILE = 16
GRAPH_ARGS = dict(n=60, m=180, seed=3)
RELAX = {"jnp": "torch", "pallas": "cuda", "interpret": "cuda"}


@pytest.fixture(scope="module")
def g():
    return make_power_law(**GRAPH_ARGS)


@pytest.fixture(scope="module")
def gr():
    return ref_power_law(**GRAPH_ARGS)


class Side:
    """One package's server surface, so a scenario runs on both."""

    def __init__(self, port: bool, graph):
        self.port = port
        self.graph = graph
        self.Injector = FaultInjector if port else RefInjector
        self.Spec = FaultSpec if port else RefSpec
        self.Heartbeat = HeartbeatMonitor if port else RefHeartbeat

    def server(self, **kw):
        kw.setdefault("tile", TILE)
        if self.port:
            return GraphServer(self.graph, device="cpu", **kw)
        return RefServer(self.graph, **kw)


def outcome(reqs):
    """The observable outcome of a request sequence."""
    return [(r.req_id, r.algo, r.src, r.rung, r.converged,
             r.deadline_expired, r.steps,
             None if r.error is None else r.error.code, r.result is None)
            for r in reqs]


def assert_same(mine, theirs, inj=None, inj_r=None):
    """Equal outcomes, equal results, equal fired faults."""
    assert outcome(mine) == outcome(theirs)
    for a, b in zip(mine, theirs):
        if a.result is None:
            continue
        alg = ALGEBRAS[a.algo]
        if alg.semiring.idempotent:
            np.testing.assert_array_equal(a.result, np.asarray(b.result))
        else:
            np.testing.assert_allclose(a.result, np.asarray(b.result),
                                       rtol=0, atol=alg.atol)
    if inj is not None:
        assert inj.fired == inj_r.fired


def both(g, gr, scenario):
    """Run `scenario(side)` on the port and the reference."""
    return scenario(Side(True, g)), scenario(Side(False, gr))


# ------------------------------------------------------------------ #
# the ladder's shape
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("knobs", [
    dict(mode="data"), dict(mode="op"), dict(mode="data", compact=False),
    dict(mode="op", relax_mode="jnp", compact=False)])
def test_fallback_chain_matches_reference_on_cpu(knobs):
    ref_knobs = dict(knobs, tile=TILE)
    port_knobs = dict(ref_knobs)
    if "relax_mode" in knobs:
        port_knobs["relax_mode"] = RELAX[knobs["relax_mode"]]
    for algo in ("sssp", "pagerank", "multi_bfs"):
        chain = fallback_chain(flip_torch.ExecutionPlan(**port_knobs),
                               ALGEBRAS[algo], "cpu")
        want = ref_fallback_chain(flip.ExecutionPlan(**ref_knobs),
                                  REF_ALGEBRAS[algo])
        assert [(RELAX.get(p.relax_mode), p.compact) for p in want] == \
            [(p.relax_mode, p.compact) for p in chain]
        assert len({p.key() for p in chain}) == len(chain)


def test_fallback_chain_on_the_card_never_reaches_the_plain_version():
    """Resolved for a CUDA device, 'torch' does not resolve and is
    skipped: both rungs launch the kernel, rung 1 densely (an exact
    retry, since the kernel skips inactive blocks either way)."""
    for algo in ("bfs", "sssp", "pagerank"):
        chain = fallback_chain(flip_torch.ExecutionPlan(tile=TILE),
                               ALGEBRAS[algo], "cuda")
        assert [(p.relax_mode, p.compact) for p in chain] == \
            [("cuda", True), ("cuda", False)]
    op = fallback_chain(flip_torch.ExecutionPlan(mode="op"),
                        ALGEBRAS["bfs"], "cuda")
    assert [(p.relax_mode, p.compact) for p in op] == [("cuda", False)]


def test_degraded_rungs_bit_exact(g):
    chain = fallback_chain(flip_torch.ExecutionPlan(tile=TILE),
                           ALGEBRAS["sssp"], "cpu")
    srcs = [0, 7, 13, 21]
    base = flip_torch.compile(g, "sssp", chain[0], device="cpu").query(srcs)
    for rung in chain[1:]:
        got = flip_torch.compile(g, "sssp", rung, device="cpu").query(srcs)
        np.testing.assert_array_equal(got.attrs, base.attrs)
        np.testing.assert_array_equal(got.steps, base.steps)


# ------------------------------------------------------------------ #
# fault injection and the heartbeat
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed,dispatches,algos,rate,stall_s", [
    (0, 8, None, 0.25, 1.0), (13, 40, None, 0.3, 0.0),
    (29, 10, ["bfs", "sssp"], 0.5, 0.2)])
def test_fault_schedule_matches_reference(seed, dispatches, algos, rate,
                                          stall_s):
    a = FaultInjector.random(seed, dispatches, algos=algos, rate=rate,
                             stall_s=stall_s)
    b = RefInjector.random(seed, dispatches, algos=algos, rate=rate,
                           stall_s=stall_s)
    assert [vars(s) for s in a.specs] == [vars(s) for s in b.specs]
    # the NaN poison draws the same entries from the same stream
    x = np.arange(48, dtype=np.float32).reshape(6, 8)
    a = FaultInjector([FaultSpec("nan", 0)], seed=seed)
    b = RefInjector([RefSpec("nan", 0)], seed=seed)
    np.testing.assert_array_equal(np.isnan(a.after_dispatch("bfs", 0, 0, x)),
                                  np.isnan(b.after_dispatch("bfs", 0, 0, x)))
    assert a.fired == b.fired
    with pytest.raises(ValueError):
        FaultSpec("melt", 0)
    assert not isinstance(InjectedFault("x"), FlipError)
    assert isinstance(classify(InjectedFault("x")), BackendFailure)


def test_heartbeat_rearms_after_each_stall():
    hits = []
    hb = HeartbeatMonitor(timeout_s=0.08, poll_s=0.02,
                          on_stall=lambda: hits.append(1)).start()
    try:
        deadline = time.monotonic() + 5.0
        while hb.stall_count < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hb.stalled and hb.stall_count == 1 and len(hits) == 1
        hb.beat()                         # re-arm
        assert not hb.stalled
        while hb.stall_count < 2 and time.monotonic() < deadline:
            time.sleep(0.01)              # second stall episode
        assert hb.stall_count == 2 and len(hits) == 2
    finally:
        hb.stop()


def test_heartbeat_stop_joins_and_silences_callback():
    hits = []
    hb = HeartbeatMonitor(timeout_s=0.05, poll_s=0.01,
                          on_stall=lambda: hits.append(1)).start()
    deadline = time.monotonic() + 5.0
    while not hits and time.monotonic() < deadline:
        time.sleep(0.01)
    hb.stop()                             # synchronous: joins the thread
    assert hb._thread is None
    n = len(hits)
    time.sleep(0.1)                       # several poll intervals
    assert len(hits) == n                 # no callback after stop()
    hb.stop()                             # idempotent


# ------------------------------------------------------------------ #
# the server, beside the reference's
# ------------------------------------------------------------------ #
def test_server_ladder_result_bit_exact_with_primary(g, gr):
    srcs = list(range(8))

    def run(side):
        clean = side.server(batch=4)
        ok = [clean.submit("sssp", s) for s in srcs]
        clean.drain()
        inj = side.Injector(specs=[side.Spec(kind="raise", dispatch=d,
                                             rung=0) for d in range(2)])
        srv = side.server(batch=4, fault_injector=inj)
        degraded = [srv.submit("sssp", s) for s in srcs]
        srv.drain()
        return ok, degraded, inj, srv.stats()["resilience"]
    (ok, deg, inj, res), (ok_r, deg_r, inj_r, res_r) = both(g, gr, run)
    assert all(r.ok and r.rung == 1 for r in deg)
    for a, b in zip(ok, deg):
        np.testing.assert_array_equal(a.result, b.result)
        assert a.steps == b.steps
    assert_same(ok, ok_r)
    assert_same(deg, deg_r, inj, inj_r)
    assert res["fallbacks"] == res_r["fallbacks"] == 2


def test_no_request_loss_when_every_rung_fails(g, gr):
    def run(side):
        inj = side.Injector(specs=[side.Spec(kind="nan", dispatch=0,
                                             rung=r) for r in range(4)])
        srv = side.server(batch=4, fault_injector=inj)
        reqs = [srv.submit("bfs", i) for i in range(4)]
        st = srv.stats()
        after = [srv.submit("bfs", i) for i in range(4)]
        return reqs, after, inj, st
    (reqs, after, inj, st), (reqs_r, after_r, inj_r, st_r) = both(g, gr,
                                                                   run)
    assert all(r.done and isinstance(r.error, BackendFailure)
               and r.result is None for r in reqs)
    assert st["failed"] == st_r["failed"] == 4
    assert st["queue_depth"] == 0
    assert all(r.ok for r in after)
    assert_same(reqs + after, reqs_r + after_r, inj, inj_r)
    assert len(inj.fired) == 2             # both rungs of dispatch 0


def test_failed_bucket_does_not_poison_other_algebras(g, gr):
    def run(side):
        inj = side.Injector(specs=[side.Spec(kind="nan", dispatch=0,
                                             rung=r, algo="bfs")
                                   for r in range(4)])
        srv = side.server(batch=2, fault_injector=inj)
        bfs = [srv.submit("bfs", i) for i in range(2)]
        sssp = [srv.submit("sssp", i) for i in range(2)]
        return bfs + sssp, inj
    (reqs, inj), (reqs_r, inj_r) = both(g, gr, run)
    assert all(isinstance(r.error, BackendFailure) for r in reqs[:2])
    assert all(r.ok for r in reqs[2:])
    assert_same(reqs, reqs_r, inj, inj_r)


def test_admission_sheds_newest_and_enforces_quotas(g, gr):
    def run(side):
        srv = side.server(batch=8, max_queue_depth=2)
        reqs = [srv.submit("bfs", i) for i in range(3)]
        srv.drain()
        q = side.server(batch=8, quotas={"bfs": 1})
        more = [q.submit("bfs", 0), q.submit("bfs", 1), q.submit("sssp", 1)]
        q.drain()
        return reqs + more, srv.stats()
    (reqs, st), (reqs_r, st_r) = both(g, gr, run)
    shed = reqs[2]
    assert isinstance(shed.error, CapacityExceeded)
    assert shed.error.depth == 2 and shed.error.limit == 2
    assert reqs[0].ok and reqs[1].ok
    assert isinstance(reqs[4].error, CapacityExceeded) and reqs[5].ok
    assert (st["shed"], st["completed"]) == (st_r["shed"],
                                             st_r["completed"]) == (1, 2)
    assert_same(reqs, reqs_r)


def test_resilience_off_disables_admission_and_ladder(g, gr):
    def run(side):
        srv = side.server(batch=4, resilience=False, max_queue_depth=1)
        reqs = [srv.submit("bfs", i) for i in range(4)]
        inj = side.Injector(specs=[side.Spec(kind="raise", dispatch=0)])
        bare = side.server(batch=2, resilience=False, fault_injector=inj)
        failed = [bare.submit("bfs", i) for i in range(2)]
        return reqs + failed, inj, srv.shed
    (reqs, inj, shed), (reqs_r, inj_r, shed_r) = both(g, gr, run)
    assert all(r.ok for r in reqs[:4]) and shed == shed_r == 0
    assert all(isinstance(r.error, BackendFailure) for r in reqs[4:])
    assert_same(reqs, reqs_r, inj, inj_r)


def test_server_step_budget_partial_with_typed_error(g, gr):
    def run(side):
        srv = side.server(batch=4)
        base = [srv.submit("sssp", i) for i in range(4)]
        srv.drain()
        cap = max(r.steps for r in base) - 1
        part = [srv.submit("sssp", i, max_steps=cap) for i in range(4)]
        srv.drain()
        return base + part
    reqs, reqs_r = both(g, gr, run)
    hit = [r for r in reqs[4:] if not r.converged]
    assert hit and all(r.error.code == "convergence_failure"
                       and r.result is not None for r in hit)
    assert_same(reqs, reqs_r)


def test_server_deadline_counts_queue_wait(g, gr):
    def run(side):
        srv = side.server(batch=4)
        reqs = [srv.submit("sssp", i, deadline_s=1e-6) for i in range(4)]
        srv.drain()
        return reqs
    reqs, reqs_r = both(g, gr, run)
    assert all(r.deadline_expired and r.error.code == "deadline_exceeded"
               for r in reqs)
    assert_same(reqs, reqs_r)


def test_stall_fault_trips_wired_heartbeat(g, gr):
    def run(side):
        hits = []
        hb = side.Heartbeat(timeout_s=0.1, poll_s=0.02,
                            on_stall=lambda: hits.append(1)).start()
        inj = side.Injector(specs=[side.Spec(kind="stall", dispatch=0,
                                             rung=0, stall_s=0.3)])
        srv = side.server(batch=2, fault_injector=inj, heartbeat=hb)
        try:
            reqs = [srv.submit("bfs", i) for i in range(2)]
            stalled = hb.stalled
        finally:
            hb.stop()
        return reqs, inj, hits, stalled, srv.stats()["resilience"]
    (reqs, inj, hits, stalled, res), \
        (reqs_r, inj_r, hits_r, stalled_r, res_r) = both(g, gr, run)
    assert all(r.ok for r in reqs)        # the stall only delays
    assert hits and hits_r and not stalled and not stalled_r
    assert res["heartbeat_stalls"] >= 1 and res_r["heartbeat_stalls"] >= 1
    assert_same(reqs, reqs_r, inj, inj_r)


# ------------------------------------------------------------------ #
# the chaos replay
# ------------------------------------------------------------------ #
def _chaos_stream(g0, algos, n_requests, n_updates, seed):
    """The reference test's mixed stream + the graph snapshot each query
    is served against (submission order is graph-version order)."""
    rng = np.random.default_rng(seed)
    update_at = set(np.linspace(1, n_requests - 1, n_updates,
                                dtype=int).tolist())
    stream, snaps, g_cur = [], [], g0
    for i in range(n_requests):
        if i in update_at:
            eu = g_cur.edge_sources()
            k = int(rng.integers(1, 4))
            idx = rng.choice(g_cur.m, size=min(k, g_cur.m), replace=False)
            batch = [(int(eu[j]), int(g_cur.indices[j]),
                      float(g_cur.weights[j]) * 0.5) for j in idx]
            batch.append((int(rng.integers(g_cur.n)),
                          int(rng.integers(g_cur.n)),
                          float(rng.integers(1, 9))))
            stream.append(("update", batch))
            g_cur = g_cur.apply_updates(batch)
        stream.append((algos[int(rng.integers(len(algos)))],
                       int(rng.integers(g0.n))))
        snaps.append(g_cur)
    return stream, snaps


def test_chaos_replay_zero_loss_and_matches_reference(g, gr):
    """The reference's chaos replay: 72 requests over 3 algebras with
    interleaved updates, a seeded schedule of raises, NaN poison, a
    ladder-exhausting NaN and a heartbeat-tripping stall, plus deadline
    and step-budget pressure. Zero loss, typed errors, every success
    oracle-exact -- and the port's outcome equals the reference's."""
    algos = ["bfs", "sssp", "pagerank"]

    def run(side):
        stream, snaps = _chaos_stream(side.graph, algos, 72, 3, seed=11)
        specs = side.Injector.random(seed=13, dispatches=40, algos=None,
                                     rate=0.3).specs
        specs += [side.Spec(kind="nan", dispatch=5, rung=r)
                  for r in range(4)]
        specs += [side.Spec(kind="stall", dispatch=8, rung=0,
                            stall_s=0.3)]
        inj = side.Injector(specs=specs, seed=13)
        hb = side.Heartbeat(timeout_s=0.1, poll_s=0.02).start()
        srv = side.server(batch=4, fault_injector=inj, heartbeat=hb)
        rng = np.random.default_rng(17)
        reqs = []
        try:
            for algo, arg in stream:
                if algo == "update":
                    srv.update(arg)
                    continue
                kw = {}
                roll = rng.random()
                if roll < 0.08:
                    kw["max_steps"] = 1
                elif roll < 0.16:
                    kw["deadline_s"] = 1e-6
                reqs.append(srv.submit(algo, arg, **kw))
            srv.drain()
        finally:
            hb.stop()
        return reqs, snaps, inj, hb.stall_count, srv.stats()
    (reqs, snaps, inj, stalls, st), (reqs_r, _, inj_r, stalls_r, st_r) = \
        both(g, gr, run)
    assert len(reqs) == 72 and all(r.done for r in reqs)
    n_ok = 0
    for r, g_snap in zip(reqs, snaps):
        if r.error is not None:
            assert isinstance(r.error, FlipError)
        if r.ok:
            n_ok += 1
            ref, _ = reference.run(r.algo, g_snap, r.src)
            assert ALGEBRAS[r.algo].results_match(r.result, ref)
    assert 0 < n_ok < 72
    assert {f["kind"] for f in inj.fired} >= {"raise", "nan", "stall"}
    assert stalls >= 1 and stalls_r >= 1
    for key in ("completed", "failed", "shed", "queue_depth"):
        assert st[key] == st_r[key], key
    assert st["resilience"]["faults_fired"] == \
        st_r["resilience"]["faults_fired"] == len(inj.fired)
    assert_same(reqs, reqs_r, inj, inj_r)


def test_chaos_replay_is_deterministic(g, gr):
    """Same seeds -> same fault schedule -> identical outcome vector, on
    the port twice and on the reference."""
    def run(side):
        stream, _ = _chaos_stream(side.graph, ["bfs", "sssp"], 16, 1,
                                  seed=23)
        inj = side.Injector.random(seed=29, dispatches=10, rate=0.5)
        srv = side.server(batch=4, fault_injector=inj)
        out = []
        for algo, arg in stream:
            if algo == "update":
                srv.update(arg)
            else:
                out.append(srv.submit(algo, arg))
        srv.drain()
        return out, inj
    (a, inj_a), (r, inj_r) = both(g, gr, run)
    b, inj_b = run(Side(True, g))
    assert outcome(a) == outcome(b) and inj_a.fired == inj_b.fired
    assert_same(a, r, inj_a, inj_r)


# ------------------------------------------------------------------ #
# the CLI
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("flags", [
    ["--scheduler", "bucket", "--fault-rate", "0.25"],
    ["--scheduler", "continuous"]], ids=["bucket", "continuous"])
def test_serve_graph_cli_check(capsys, monkeypatch, flags):
    from repro.launch import serve_graph as ref_serve_graph
    from repro_torch.launch import serve_graph
    argv = ["--dataset", "SRN", "--algos", "bfs,sssp", "--requests", "24",
            "--batch", "8", "--tile", "32", "--updates", "2",
            "--check"] + flags
    serve_graph.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve_graph"] + argv)
    ref_serve_graph.main()
    want = capsys.readouterr().out

    def summary(text):      # the counts of the summary line, no timings
        ln = [x for x in text.splitlines() if " requests in " in x][0]
        return ln.split(" over ", 1)[1]
    assert "[serve] oracle check: 24/24 correct" in out
    assert summary(out) == summary(want)
    assert [x for x in out.splitlines() if "oracle check" in x] == \
        [x for x in want.splitlines() if "oracle check" in x]
    if "continuous" in flags:
        with pytest.raises(SystemExit, match="--scheduler bucket"):
            serve_graph.main(argv + ["--fault-rate", "0.25", "--device",
                                     "cpu"])
