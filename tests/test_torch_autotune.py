"""Port vs reference: the plan autotuner.

`repro_torch.autotune` against `repro.autotune` on the same numpy-seeded
graphs: profiles and fingerprints, the candidate space (the port's
'torch' route is the reference's 'jnp', its 'cuda' route the reference's
'pallas'), the analytic pricing and its budget gate, the cost model, the
store, and model-only tunes (`measure=False`), which must choose the
same knobs. Tuned CPU sessions, measured, answer as the reference's
untuned sessions do: bit for bit for the idempotent programs (steps
included), at `VertexAlgebra.atol` for pagerank and labelprop. Also the
plan's `tuned` flag, `graph_run --autotune` and the sweep CLI.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import flip
import flip_torch
from repro import autotune as ref_at
from repro.algebra import ALGEBRAS as REF_ALGEBRAS
from repro.api.plan import ExecutionPlan as RefPlan
from repro.autotune import measure as ref_measure
from repro.autotune import model as ref_model
from repro.graphs import make_power_law as ref_power_law
from repro.graphs import make_road_network as ref_road
from repro.graphs.csr import Graph as RefGraph
from repro_torch import autotune as at
from repro_torch.algebra import ALGEBRAS
from repro_torch.api.plan import ExecutionPlan
from repro_torch.autotune import measure, model
from repro_torch.autotune import store as store_mod
from repro_torch.autotune.profile import DEGREE_BUCKETS, PROBE_STEPS
from repro_torch.graphs import Graph, make_power_law, make_road_network

CPU = torch.device("cpu")
CUDA = torch.device("cuda")
# the port's routes and their reference counterparts
ROUTE_OF_REF = {"jnp": "torch", "pallas": "cuda"}
GRAPHS = {
    "power_law": (lambda: make_power_law(256, 768, seed=0),
                  lambda: ref_power_law(256, 768, seed=0)),
    "road": (lambda: make_road_network(512, seed=0),
             lambda: ref_road(512, seed=0)),
    "empty": (lambda: Graph.from_edges(0, []),
              lambda: RefGraph.from_edges(0, [])),
}
IDEMPOTENT = ["bfs", "multi_bfs", "reach", "sssp", "wcc", "widest"]
PLUS = ["labelprop", "pagerank"]


def graphs(kind="power_law"):
    port, ref = GRAPHS[kind]
    return port(), ref()


def knobs(plan, rename=False) -> tuple:
    """The knobs both packages' plans share, the route renamed to the
    port's spelling when `rename`."""
    relax = ROUTE_OF_REF.get(plan.relax_mode) if rename else plan.relax_mode
    return (plan.mode, relax, plan.compact, plan.tile, plan.batch,
            plan.warm, plan.feature_dim, plan.max_steps, plan.deadline_s,
            plan.tuned)


def ref_plan_of(plan: ExecutionPlan) -> RefPlan:
    """The reference plan with the same knobs (route renamed back)."""
    route = {v: k for k, v in ROUTE_OF_REF.items()}[plan.relax_mode]
    return RefPlan(mode=plan.mode, relax_mode=route, compact=plan.compact,
                   tile=plan.tile, batch=plan.batch, warm=plan.warm,
                   feature_dim=plan.feature_dim, max_steps=plan.max_steps)


def assert_agree(algo, got, want):
    """Port result vs reference result under the port's hold."""
    if ALGEBRAS[algo].semiring.idempotent:
        np.testing.assert_array_equal(got.attrs, np.asarray(want.attrs))
        np.testing.assert_array_equal(got.steps, np.asarray(want.steps))
    else:
        assert ALGEBRAS[algo].results_match(got.attrs,
                                            np.asarray(want.attrs))


@pytest.fixture
def tmp_store(tmp_path):
    return at.TuningStore(str(tmp_path / "autotune_torch.json"))


# ------------------------------------------------------------------ #
# profile
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("target", [("cpu", "cpu"),
                                    ("cuda", "NVIDIA H100 80GB HBM3")])
def test_profile_matches_reference(kind, target):
    g, gr = graphs(kind)
    for d in (1, 8):
        kw = dict(feature_dim=d, backend=target[0], device_kind=target[1])
        p, r = at.profile_graph(g, **kw), ref_at.profile_graph(gr, **kw)
        assert dataclasses.astuple(p) == dataclasses.astuple(r)
        assert p.fingerprint() == r.fingerprint()
        assert p.to_json() == r.to_json()
        assert (p.mean_density, p.peak_density) == (r.mean_density,
                                                   r.peak_density)
    assert len(p.degree_hist) == DEGREE_BUCKETS
    assert len(p.density_trajectory) <= PROBE_STEPS


def test_profile_reads_the_torch_device(monkeypatch):
    g, _ = graphs()
    p = at.profile_graph(g, device="cpu")
    assert (p.backend, p.device_kind) == ("cpu", "cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    pc = at.profile_graph(g, device=CUDA)
    assert (pc.backend, pc.device_kind) == ("cuda", "NVIDIA H100 80GB HBM3")
    assert pc.fingerprint() != p.fingerprint()
    # no card and no device: raises, as every entry point does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        at.profile_graph(g)


# ------------------------------------------------------------------ #
# space
# ------------------------------------------------------------------ #
BASES = {"default": {}, "batch8": {"batch": 8}, "op": {"mode": "op"}}


@pytest.mark.parametrize("algo", ["bfs", "pagerank", "multi_bfs",
                                  "labelprop"])
@pytest.mark.parametrize("base", sorted(BASES))
def test_space_matches_reference_jnp_candidates(algo, base):
    """On the CPU the port's candidates are the reference's jnp
    candidates, in order, with the route renamed (the reference's
    interpret candidates have no counterpart)."""
    alg, ralg = ALGEBRAS[algo], REF_ALGEBRAS[algo]
    pb = ExecutionPlan(**BASES[base]).resolve(alg, CPU)
    rb = RefPlan(**BASES[base]).resolve(ralg)
    got = at.candidate_plans(pb, alg, device=CPU)
    want = [c for c in ref_at.candidate_plans(rb, ralg, backend="cpu")
            if c.plan.relax_mode == "jnp"]
    assert [knobs(c.plan) for c in got] == \
        [knobs(c.plan, rename=True) for c in want]
    assert knobs(got[0].plan) == knobs(pb)          # the base leads
    if not alg.semiring.idempotent:
        assert {c.plan.tile for c in got} == {pb.tile}


@pytest.mark.parametrize("algo", ["sssp", "pagerank"])
@pytest.mark.parametrize("base", sorted(BASES))
def test_space_on_cuda_keeps_compact(algo, base):
    """On a CUDA device compaction is a no-op (the kernel skips per
    query), so only tile and batch vary; the route is the kernel's.
    Enumeration only resolves plans: no card is touched."""
    alg = ALGEBRAS[algo]
    pb = ExecutionPlan(**BASES[base]).resolve(alg, CUDA)
    got = at.candidate_plans(pb, alg, device=CUDA)
    assert {c.plan.relax_mode for c in got} == {"cuda"}
    assert {c.plan.compact for c in got} == {pb.compact}
    tiles = (64, 128, 256) if alg.semiring.idempotent else (pb.tile,)
    batches = (4, 8, 16) if pb.batch else (0,)
    assert sorted((c.plan.tile, c.plan.batch) for c in got) == \
        sorted((t, b) for t in tiles for b in batches)
    assert knobs(got[0].plan) == knobs(pb)


# ------------------------------------------------------------------ #
# pricing
# ------------------------------------------------------------------ #
def test_bridge_functions_match_reference():
    for n, m, t in [(0, 0, 64), (100, 300, 16), (4096, 12288, 64),
                    (262_144, 1_000_000, 128), (16_384, 40_000, 256)]:
        assert measure.expected_blocks(n, m, t) == \
            ref_measure.expected_blocks(n, m, t)
    for p in (0.0, 3.72e-5, 0.01, 0.5, 1.0, 1.5):
        for t in (64, 128, 256):
            assert measure.active_tile_fraction(p, t) == \
                ref_measure.active_tile_fraction(p, t)
    assert measure.BACKEND_FACTOR == {
        port: ref_measure.BACKEND_FACTOR[ref]
        for ref, port in ROUTE_OF_REF.items()}
    for name in ("PROBE_SOURCES", "SEGMENT_STEPS", "REPEATS",
                 "EXE_UPDATE_CYCLES", "MAC_PER_CYCLE",
                 "STEP_FIXED_CYCLES"):
        assert getattr(measure, name) == getattr(ref_measure, name), name


@pytest.mark.parametrize("kind", ["power_law", "road"])
def test_analytic_prices_match_reference(kind):
    g, gr = graphs(kind)
    for d in (1, 8):
        kw = dict(feature_dim=d, backend="cpu", device_kind="cpu")
        p, r = at.profile_graph(g, **kw), ref_at.profile_graph(gr, **kw)
        for route in ("cuda", "torch"):
            for t in (64, 128, 256):
                for c in (True, False):
                    plan = ExecutionPlan(relax_mode=route, compact=c,
                                         tile=t, feature_dim=d)
                    rplan = ref_plan_of(plan)
                    for exe in (4, 5):
                        assert measure.analytic_step_us(
                            p, plan, exe_update=exe) == \
                            ref_measure.analytic_step_us(r, rplan,
                                                         exe_update=exe)
                    assert measure.estimated_measure_s(p, plan) == \
                        ref_measure.estimated_measure_s(r, rplan)


@pytest.mark.parametrize("budget", [None, 0.0, 1e-4, 2.0])
def test_budget_gate_picks_as_reference(budget, monkeypatch):
    """The gate measures the same candidates, and prices the rest with
    the same analytic numbers (measurement stubbed in both packages)."""
    g, gr = graphs("road")

    def stub(graph, program, plan, **kw):
        return ref_at.Sample(plan=plan, step_us=-1.0, steps=1, wall_s=0.0,
                             source="measured")

    monkeypatch.setattr(measure, "measure_plan", stub)
    monkeypatch.setattr(ref_measure, "measure_plan", stub)
    p = at.profile_graph(g, backend="cpu", device_kind="cpu")
    r = ref_at.profile_graph(gr, backend="cpu", device_kind="cpu")
    for route, rbackend in (("torch", "cpu"), ("cuda", "tpu")):
        dev = CPU if route == "torch" else CUDA
        cands = at.candidate_plans(ExecutionPlan().resolve(
            ALGEBRAS["sssp"], dev), ALGEBRAS["sssp"], device=dev)
        for c in cands:
            got = at.price_candidate(g, "sssp", c.plan, p, budget_s=budget,
                                     device=dev)
            want = ref_at.price_candidate(gr, "sssp", ref_plan_of(c.plan),
                                          r, budget_s=budget)
            assert (got.source, got.step_us) == (want.source, want.step_us)


def test_price_candidate_raises_on_cuda(monkeypatch):
    """A failed measurement on a CUDA device raises; on the CPU it
    degrades to the analytic price, as in the reference."""
    g, _ = graphs()

    def broken(*a, **kw):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(measure, "measure_plan", broken)
    p = at.profile_graph(g, backend="cuda", device_kind="card")
    plan = ExecutionPlan().resolve(None, CUDA)
    with pytest.raises(RuntimeError, match="failed to launch"):
        at.price_candidate(g, "bfs", plan, p, budget_s=None, device=CUDA)
    cpu_plan = ExecutionPlan().resolve(None, CPU)
    s = at.price_candidate(g, "bfs", cpu_plan, p, budget_s=None, device=CPU)
    assert s.source == "analytic"
    assert s.step_us == measure.analytic_step_us(p, cpu_plan)


def test_measured_sample_and_probe_sources():
    g, gr = graphs()
    for seed in (0, 7):
        np.testing.assert_array_equal(measure.probe_sources(g, seed),
                                      ref_measure.probe_sources(gr, seed))
    plan = ExecutionPlan(tile=64).resolve(None, CPU)
    s = at.measure_plan(g, "bfs", plan, seed=0, repeats=1, segment_steps=4,
                        device="cpu")
    assert s.source == "measured"
    assert s.step_us > 0 and s.steps > 0 and s.wall_s > 0
    assert s.to_json()["tile"] == 64
    # the segments' steps are the reference's (same probe sources)
    rs = ref_at.measure_plan(gr, "bfs", ref_plan_of(plan), seed=0,
                             repeats=1, segment_steps=4)
    assert s.steps == rs.steps


# ------------------------------------------------------------------ #
# model
# ------------------------------------------------------------------ #
def test_cost_model_matches_reference():
    g, gr = graphs("road")
    p = at.profile_graph(g, backend="cpu", device_kind="cpu")
    r = ref_at.profile_graph(gr, backend="cpu", device_kind="cpu")
    rng = np.random.default_rng(0)
    plans = [ExecutionPlan(relax_mode=route, tile=t, compact=c,
                           feature_dim=1)
             for route in ("torch", "cuda") for t in (64, 128, 256)
             for c in (True, False)]
    us = rng.uniform(10.0, 500.0, len(plans))
    got = at.CostModel.fit([at.Sample(plan=pl, step_us=float(u), steps=4,
                                      wall_s=1e-3, source="measured")
                            for pl, u in zip(plans, us)], p)
    want = ref_at.CostModel.fit(
        [ref_at.Sample(plan=ref_plan_of(pl), step_us=float(u), steps=4,
                       wall_s=1e-3, source="measured")
         for pl, u in zip(plans, us)], r)
    assert got.n_samples == want.n_samples == len(plans)
    for ref_route, route in ROUTE_OF_REF.items():
        np.testing.assert_allclose(got.coef[route], want.coef[ref_route],
                                   rtol=1e-12)
    for pl in plans:
        np.testing.assert_allclose(got.predict(p, pl),
                                   want.predict(r, ref_plan_of(pl)),
                                   rtol=1e-12)
        np.testing.assert_array_equal(model.features_of(p, pl),
                                      ref_model.features_of(r,
                                                            ref_plan_of(pl)))
    # fewer than 3 samples of a route leave it analytic
    few = at.CostModel.fit([at.Sample(plan=plans[0], step_us=1.0, steps=1,
                                      wall_s=0.0, source="measured")] * 2, p)
    assert few.coef == {}
    assert few.predict(p, plans[0]) == measure.analytic_step_us(p, plans[0])


def test_load_bench_samples_matches_reference(tmp_path):
    root = os.path.join(os.path.dirname(__file__), "..")
    paths = [os.path.join(root, f"BENCH_{t}.json")
             for t in ("kernels", "features", "serving")]
    extra = tmp_path / "BENCH_x.json"
    extra.write_text(json.dumps({"tag": "x", "runs": [{"rows": [
        {"name": "feature_step_min_plus_2k_d8", "us_per_call": 512.3,
         "derived": "power-law |V|=2048 blocks=519 d=8"},
        {"name": "not_a_step_row", "us_per_call": 3.0,
         "derived": "blocks=9"},
    ]}]}))
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text("{corrupt")
    paths += [str(extra), str(bad), str(tmp_path / "missing.json")]
    got = at.load_bench_samples(paths)
    want = ref_at.load_bench_samples(paths)
    assert len(got) == len(want) > 1
    for s, w in zip(got, want):
        assert knobs(s.plan) == knobs(w.plan, rename=True)
        assert (s.step_us, s.steps, s.wall_s, s.source, s.features) == \
            (w.step_us, w.steps, w.wall_s, w.source, w.features)
    # the port reads no bench file by default: none is the card's
    assert at.load_bench_samples() == []


# ------------------------------------------------------------------ #
# store
# ------------------------------------------------------------------ #
def test_store_roundtrip(tmp_store):
    e = tmp_store.put("fp1", "bfs", "cuda",
                      {"tile": 256, "relax_mode": "cuda", "compact": True,
                       "batch": 0}, score_us=12.5, seed=3, why="test")
    got = tmp_store.get("fp1", "bfs", "cuda")
    assert got["plan"]["tile"] == 256
    assert got["seed"] == 3 and got["why"] == "test"
    assert e["schema"] == store_mod.SCHEMA
    assert len(tmp_store) == 1


def test_store_stale_fingerprint_rejected(tmp_store):
    tmp_store.put("fp1", "bfs", "cpu", {"tile": 64}, score_us=1.0, seed=0)
    assert tmp_store.get("fp2", "bfs", "cpu") is None
    assert tmp_store.get("fp1", "sssp", "cpu") is None
    assert tmp_store.get("fp1", "bfs", "cuda") is None


def test_store_schema_drift_rejected(tmp_store):
    tmp_store.put("fp1", "bfs", "cpu", {"tile": 64}, score_us=1.0, seed=0)
    with open(tmp_store.path) as f:
        data = json.load(f)
    data["entries"][at.TuningStore.key("fp1", "bfs", "cpu")]["schema"] = \
        store_mod.SCHEMA + 1
    with open(tmp_store.path, "w") as f:
        json.dump(data, f)
    assert tmp_store.get("fp1", "bfs", "cpu") is None


def test_store_corrupt_is_empty(tmp_path):
    p = tmp_path / "db.json"
    p.write_text("{not json")
    s = at.TuningStore(str(p))
    assert len(s) == 0
    assert s.get("fp", "bfs", "cpu") is None
    s.put("fp", "bfs", "cpu", {"tile": 64}, score_us=1.0, seed=0)
    assert s.get("fp", "bfs", "cpu") is not None
    assert not os.path.exists(str(p) + ".tmp")        # atomic replace


def test_store_default_path_is_not_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("FLIP_TORCH_AUTOTUNE_DB", str(tmp_path / "e.json"))
    assert at.TuningStore().path == str(tmp_path / "e.json")
    # the reference's variable names the reference's file only
    monkeypatch.setenv("FLIP_AUTOTUNE_DB", str(tmp_path / "ref.json"))
    assert at.TuningStore().path == str(tmp_path / "e.json")
    monkeypatch.delenv("FLIP_TORCH_AUTOTUNE_DB")
    monkeypatch.delenv("FLIP_AUTOTUNE_DB")
    assert at.TuningStore().path.endswith(
        os.path.join(".cache", "flip", "autotune_torch.json"))
    assert at.default_store_path() != ref_at.default_store_path()


def test_stored_knobs_cannot_change_semantics(tmp_store):
    """A stored entry rehydrates performance knobs only, and a combo
    that does not resolve on this device is a miss."""
    g, _ = graphs()
    fp = at.profile_graph(g, device="cpu").fingerprint()
    tmp_store.put(fp, "bfs", "cpu",
                  {"tile": 64, "relax_mode": "torch", "compact": True,
                   "batch": 0, "mode": "op", "warm": "never"},
                  score_us=1.0, seed=0)
    rep = at.autotune(g, "bfs", store=tmp_store, measure=False,
                      device="cpu")
    assert rep.cached and rep.chosen.tile == 64
    assert rep.chosen.mode == "data" and rep.chosen.warm == "auto"
    tmp_store.put(fp, "bfs", "cpu", {"tile": 64, "relax_mode": "cuda"},
                  score_us=1.0, seed=0)
    rep2 = at.autotune(g, "bfs", store=tmp_store, measure=False,
                       device="cpu")
    assert not rep2.cached and rep2.samples


# ------------------------------------------------------------------ #
# tuner
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("algo", ["bfs", "sssp", "pagerank", "labelprop"])
@pytest.mark.parametrize("kind", ["power_law", "road"])
@pytest.mark.parametrize("batch", [0, 8])
def test_model_only_tune_chooses_as_reference(algo, kind, batch):
    """measure=False: the same graph, base and seed tune to the same
    tile, compact and batch. The reference reads the JAX package's bench
    rows by default; the port reads none, so the reference runs without
    them here."""
    g, gr = graphs(kind)
    got = at.autotune(g, algo, ExecutionPlan(batch=batch), seed=3,
                      measure=False, device="cpu")
    want = ref_at.autotune(gr, algo, RefPlan(batch=batch), seed=3,
                           measure=False, bench_history=False)
    assert knobs(got.chosen) == knobs(want.chosen, rename=True)
    ref_jnp = [(knobs(s.plan, rename=True), s.step_us)
               for s in want.samples if s.plan.relax_mode == "jnp"]
    assert [(knobs(s.plan), s.step_us) for s in got.samples] == ref_jnp
    assert all(s.source == "analytic" for s in got.samples)


def test_store_hit_report_and_resolve_tuned(tmp_store):
    g, _ = graphs()
    rep1 = at.autotune(g, "bfs", store=tmp_store, measure=False,
                       device="cpu")
    rep2 = at.autotune(g, "bfs", store=tmp_store, measure=False,
                       device="cpu")
    assert not rep1.cached and rep2.cached and rep2.samples == []
    assert rep2.chosen.key() == rep1.chosen.key()
    rep3 = at.autotune(g, "bfs", store=tmp_store, measure=False,
                       force=True, device="cpu")
    assert not rep3.cached and rep3.samples
    j = json.loads(json.dumps(rep1.to_json()))
    assert j["chosen"]["tile"] in (64, 128, 256) and j["why"]
    assert j["profile"]["backend"] == "cpu" and not j["cached"]
    # the store key: (fingerprint, algebra, backend)
    fp = rep1.profile.fingerprint()
    assert tmp_store.get(fp, "bfs", "cpu")["plan"]["relax_mode"] == "torch"
    plan, rep = at.resolve_tuned(g, "bfs", ExecutionPlan.auto(tuned=True),
                                 store=tmp_store, device="cpu")
    assert not plan.tuned and rep.cached
    assert plan.key() == rep.chosen.key()


def test_one_measurement_per_engine(tmp_store, monkeypatch):
    """Bucket widths on one engine share its measurement: the sweep
    measures each (tile, compact) engine once, and every width on it
    scores the same, so the tie-break and not timing noise picks the
    width."""
    g, _ = graphs()
    calls = []
    real = measure.measure_plan

    def counted(graph, program, plan, **kw):
        calls.append(measure.engine_key(plan))
        return real(graph, program, plan, **kw)

    monkeypatch.setattr(measure, "measure_plan", counted)
    rep = at.autotune(g, "bfs", ExecutionPlan(batch=8), store=tmp_store,
                      budget_s=None, device="cpu")
    engines = {measure.engine_key(s.plan) for s in rep.samples}
    assert len(rep.samples) == 3 * len(engines)      # widths 4, 8, 16
    assert sorted(calls) == sorted(engines)
    for e in engines:
        same = [s for s in rep.samples if measure.engine_key(s.plan) == e]
        assert {s.plan.batch for s in same} == {4, 8, 16}
        assert len({(s.step_us, s.wall_s, s.steps) for s in same}) == 1
        assert all(s.source == "measured" for s in same)


def test_store_key_leaves_out_the_base_plan(tmp_path):
    """A fact of the reference, kept by the port: the store key is
    (fingerprint, algebra, backend), so an entry tuned from a batch=8
    base gives a solo tuned plan a serving bucket, in both packages."""
    g, gr = graphs()
    store = at.TuningStore(str(tmp_path / "port.json"))
    rstore = ref_at.TuningStore(str(tmp_path / "ref.json"))
    at.autotune(g, "sssp", ExecutionPlan(batch=8), store=store,
                measure=False, device="cpu")
    ref_at.autotune(gr, "sssp", RefPlan(batch=8), store=rstore,
                    measure=False, bench_history=False)
    got = at.autotune(g, "sssp", ExecutionPlan(), store=store,
                      measure=False, device="cpu")
    want = ref_at.autotune(gr, "sssp", RefPlan(), store=rstore,
                           measure=False, bench_history=False)
    assert got.cached and want.cached
    assert got.chosen.batch == want.chosen.batch > 0


# ------------------------------------------------------------------ #
# bit-exactness: a measured, tuned CPU session answers as the
# reference's untuned one
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def shared_store(tmp_path_factory):
    return at.TuningStore(str(tmp_path_factory.mktemp("at") / "db.json"))


@pytest.mark.parametrize("algo", IDEMPOTENT + PLUS)
def test_tuned_session_matches_reference(algo, shared_store):
    g, gr = graphs()
    cq = flip_torch.compile(g, algo, ExecutionPlan.auto(tuned=True),
                            device="cpu", store=shared_store)
    assert cq.tune is not None and not cq.plan.tuned
    assert all(s.source == "measured" for s in cq.tune.samples)
    ref = flip.compile(gr, algo)
    for srcs in (3, np.array([3, 11, 0, 27])):
        assert_agree(algo, cq.query(srcs), ref.query(srcs))


@pytest.mark.parametrize("algo", ["bfs", "sssp", "pagerank"])
def test_every_candidate_matches_reference(algo):
    g, gr = graphs()
    alg = ALGEBRAS[algo]
    want = flip.compile(gr, algo).query(np.array([5, 11]))
    for c in at.candidate_plans(ExecutionPlan().resolve(alg, CPU), alg,
                                device=CPU):
        got = flip_torch.compile(g, algo, c.plan, device="cpu").query(
            np.array([5, 11]))
        assert_agree(algo, got, want)


def test_batched_tuned_session(tmp_store):
    g, gr = graphs()
    cq = flip_torch.compile(g, "sssp", ExecutionPlan.auto(tuned=True,
                                                          batch=4),
                            device="cpu", store=tmp_store)
    assert cq.plan.batch in (2, 4, 8)
    srcs = np.array([3, 11, 0, 27, 42, 8])
    assert_agree("sssp", cq.query(srcs), flip.compile(gr, "sssp").query(srcs))


def test_telemetry_carries_tuner_provenance(tmp_store):
    g, _ = graphs()
    cq = flip_torch.compile(g, "bfs", ExecutionPlan.auto(tuned=True),
                            device="cpu", store=tmp_store)
    r = cq.query(3, trace=True)
    meta = r.telemetry.dispatches[0].meta["autotune"]
    assert meta["chosen"]["tile"] == cq.plan.tile
    assert meta["why"] == cq.tune.why
    assert meta["fingerprint"] == cq.tune.profile.fingerprint()
    r0 = flip_torch.compile(g, "bfs", device="cpu").query(3, trace=True)
    assert "autotune" not in r0.telemetry.dispatches[0].meta


def test_tuned_with_mapping(tmp_store):
    """compile(mapping=) with tuned=True, as in the reference: the tune
    prices id-order candidates, the session runs in mapping order."""
    from repro_torch.core import compile_mapping, mapping_order
    g, gr = make_road_network(100, seed=0), ref_road(100, seed=0)
    m = compile_mapping(g, effort=0, program=ALGEBRAS["bfs"])
    cq = flip_torch.compile(g, "bfs", ExecutionPlan.auto(tuned=True),
                            mapping=m, device="cpu", store=tmp_store)
    assert cq.tune is not None
    np.testing.assert_array_equal(cq.engine.bg.inv_perm, mapping_order(m))
    assert_agree("bfs", cq.query(7), flip.compile(gr, "bfs").query(7))


# ------------------------------------------------------------------ #
# plan surface and CLI
# ------------------------------------------------------------------ #
def test_tuned_flag_validation():
    with pytest.raises(ValueError, match="tuned"):
        ExecutionPlan(tuned="yes").validate()
    ExecutionPlan(tuned=True).validate()
    # resolve() alone has no graph to tune against
    assert ExecutionPlan(tuned=True).resolve(device="cpu").tuned
    assert ExecutionPlan(tuned=True).key() != ExecutionPlan().key()


def test_graph_run_autotune(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import graph_run
    monkeypatch.setenv("FLIP_TORCH_AUTOTUNE_DB", str(tmp_path / "db.json"))
    argv = ["--algo", "sssp", "--dataset", "SRN", "--engine", "jax",
            "--autotune", "--device", "cpu", "--effort", "0"]
    graph_run.main(argv)
    out = capsys.readouterr().out
    assert "[graph] autotune: measured sweep over" in out
    assert "[graph] correct vs reference: True" in out
    graph_run.main(argv)
    assert "[graph] autotune (store hit):" in capsys.readouterr().out


def test_graph_run_autotune_refuses_sim(monkeypatch):
    from repro.launch import graph_run as ref_graph_run
    from repro_torch.launch import graph_run
    flags = ["--dataset", "SRN", "--engine", "sim", "--autotune"]
    with pytest.raises(SystemExit) as got:
        graph_run.main(flags)
    monkeypatch.setattr(sys, "argv", ["graph_run"] + flags)
    with pytest.raises(SystemExit) as want:
        ref_graph_run.main()
    assert str(got.value) == str(want.value)


def test_autotune_cli(tmp_path, capsys):
    from repro_torch.launch import autotune as cli
    db, js = str(tmp_path / "db.json"), str(tmp_path / "rep.json")
    argv = ["--n", "256", "--deg", "3", "--algo", "sssp", "--no-measure",
            "--store", db, "--device", "cpu"]
    assert cli.main(argv + ["--json", js]) == 0
    out = capsys.readouterr().out
    assert "backend=cpu device=cpu" in out
    assert "[autotune] 6 candidates (seed=0):" in out
    assert out.count("[analytic]") == 6 and "[autotune] chosen:" in out
    assert json.load(open(js))["chosen"]["relax_mode"] == "torch"
    cli.main(argv)
    assert "[autotune] store hit" in capsys.readouterr().out
