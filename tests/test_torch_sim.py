"""Port vs reference: the FLIP mapping compiler and the cycle simulator.

`repro_torch.core` keeps its own numpy copy of the reference's mapping
compiler (`compile_mapping`: beam search, annealing, swap polish), its
routing tables, its event-driven cycle simulator and its baseline cycle
models. The same graphs, built from the same seeds by both packages'
generators, must give equal mappings (`pe_of`, `copy_of`, routing
length, collision sets), equal tables, and equal simulations (cycles,
attrs, the parallelism trace, swaps, packet waits, MTEPS), with no
tolerance: both sides run the same numpy code on the same inputs. On top
of that, `mapping_order`, `flip_torch.compile(..., mapping=)` and the
CLI's ``--engine sim`` are held against the reference.

Mappings are computed once per module fixture, at effort 0 on graphs of
128 vertices or fewer, plus one effort-1 case on an SRN road network.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest

import flip
import flip_torch
from repro import core as ref_core
from repro import graphs as ref_graphs
from repro import obs as ref_obs
from repro_torch import core
from repro_torch import graphs
from repro_torch.algebra import ALGEBRAS
from repro_torch.obs import from_sim

SIM_ALGOS = ["bfs", "sssp", "wcc", "widest", "reach"]

# name -> (generator, kwargs, effort, arch kwargs)
CASES = {
    "srn96": ("make_road_network", dict(n=96, seed=0, delete_frac=0.7), 0,
              {}),
    "tree128": ("make_tree", dict(n=128, seed=1), 0, {}),
    "syn128": ("make_synthetic", dict(n=128, m=384, seed=2), 0, {}),
    # 128 vertices on a 4x4 array of 4-vertex PEs (capacity 64): 2 copies,
    # so the simulator swaps slices at run time
    "road128_2copies": ("make_road_network", dict(n=128, seed=0), 0,
                        dict(width=4, height=4, pe_capacity=4)),
    "srn100_effort1": ("make_road_network",
                       dict(n=100, seed=3, delete_frac=0.7), 1, {}),
}


@dataclasses.dataclass
class Pair:
    g: object          # the port's Graph
    gr: object         # the reference's Graph
    m: object          # the port's Mapping
    mr: object         # the reference's Mapping


_PAIRS = {}


@pytest.fixture(scope="module")
def pairs():
    """Each case's graphs and mappings, computed once for the module."""
    def get(name):
        if name not in _PAIRS:
            gen, kw, effort, arch_kw = CASES[name]
            g = getattr(graphs, gen)(**kw)
            gr = getattr(ref_graphs, gen)(**kw)
            m = core.compile_mapping(g, arch=core.FlipArch(**arch_kw),
                                     effort=effort, seed=0)
            mr = ref_core.compile_mapping(
                gr, arch=ref_core.FlipArch(**arch_kw), effort=effort,
                seed=0)
            _PAIRS[name] = Pair(g, gr, m, mr)
        return _PAIRS[name]
    return get


def sim_pair(p: Pair, algo: str, src: int):
    return (core.simulate(p.m, core.PROGRAMS[algo], src=src),
            ref_core.simulate(p.mr, ref_core.PROGRAMS[algo], src=src))


# ------------------------------------------------------------------ #
# the mapping compiler
# ------------------------------------------------------------------ #
def test_arch_equal():
    for kw in ({}, dict(width=4, height=4, pe_capacity=4)):
        a, b = core.FlipArch(**kw), ref_core.FlipArch(**kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.capacity == b.capacity
        for pe in range(a.num_pes):
            assert a.cluster_of(pe) == b.cluster_of(pe)
            assert a.pe_neighbors(pe) == b.pe_neighbors(pe)
            assert a.yx_route(pe, a.num_pes - 1 - pe) == \
                b.yx_route(pe, b.num_pes - 1 - pe)


@pytest.mark.parametrize("case", list(CASES))
def test_mapping_equal(pairs, case):
    p = pairs(case)
    np.testing.assert_array_equal(p.m.pe_of, p.mr.pe_of)
    np.testing.assert_array_equal(p.m.copy_of, p.mr.copy_of)
    assert p.m.num_copies() == p.mr.num_copies()
    assert p.m.avg_routing_length() == p.mr.avg_routing_length()
    assert p.m.collision_sets() == p.mr.collision_sets()
    np.testing.assert_array_equal(p.m.register_index(),
                                  p.mr.register_index())
    p.m.validate()
    if case == "road128_2copies":
        assert p.m.num_copies() == 2


def test_estimator_swap_benefit_equal(pairs):
    p = pairs("srn96")
    est = core.RuntimeEstimator(p.m.arch, p.g, core.SSSP)
    est_r = ref_core.RuntimeEstimator(p.mr.arch, p.gr, ref_core.SSSP)
    for u, v in ((3, 40), (0, 95), (17, 18)):
        assert est.swap_benefit(p.m, u, v) == est_r.swap_benefit(p.mr, u, v)


def test_mapping_weighted_program_equal():
    """The weighted objective and a program other than SSSP draw the
    same stream too."""
    g = graphs.make_synthetic(64, 160, seed=5)
    gr = ref_graphs.make_synthetic(64, 160, seed=5)
    m = core.compile_mapping(g, program=core.WCC, weighted=True, effort=0,
                             seed=7)
    mr = ref_core.compile_mapping(gr, program=ref_core.WCC, weighted=True,
                                  effort=0, seed=7)
    np.testing.assert_array_equal(m.pe_of, mr.pe_of)
    np.testing.assert_array_equal(m.copy_of, mr.copy_of)


# ------------------------------------------------------------------ #
# routing tables
# ------------------------------------------------------------------ #
def _tables(t):
    inter = {k: {u: [dataclasses.astuple(e) for e in es]
                 for u, es in v.items()} for k, v in t.inter.items()}
    intra = {k: {u: [dataclasses.astuple(e) for e in es]
                 for u, es in v.items()} for k, v in t.intra.items()}
    return inter, intra


@pytest.mark.parametrize("case", ["srn96", "road128_2copies"])
@pytest.mark.parametrize("algo", ["sssp", "wcc", "bfs", "pagerank"])
def test_build_tables_equal(pairs, case, algo):
    p = pairs(case)
    for ff in (True, False):
        t = core.build_tables(p.m, core.PROGRAMS[algo], farthest_first=ff)
        tr = ref_core.build_tables(p.mr, ref_core.PROGRAMS[algo],
                                   farthest_first=ff)
        assert _tables(t) == _tables(tr)
        for name in ("indptr", "indices", "weights"):
            np.testing.assert_array_equal(getattr(t.graph, name),
                                          getattr(tr.graph, name))


# ------------------------------------------------------------------ #
# the cycle simulator
# ------------------------------------------------------------------ #
SIM_CASES = ([("srn96", a, 5) for a in SIM_ALGOS]
             + [("tree128", "bfs", 0), ("syn128", "bfs", 7),
                ("syn128", "sssp", 7), ("road128_2copies", "bfs", 3),
                ("srn100_effort1", "sssp", 2)])


@pytest.mark.parametrize("case,algo,src", SIM_CASES,
                         ids=[f"{c}-{a}" for c, a, _ in SIM_CASES])
def test_simulate_equal(pairs, case, algo, src):
    p = pairs(case)
    r, rr = sim_pair(p, algo, src)
    assert r.cycles == rr.cycles
    np.testing.assert_array_equal(r.attrs, rr.attrs)
    np.testing.assert_array_equal(r.parallelism_trace,
                                  rr.parallelism_trace)
    for f in ("packets_delivered", "edges_relaxed", "avg_parallelism",
              "max_parallelism", "avg_pkt_wait", "max_aluin_depth",
              "swaps", "mteps"):
        assert getattr(r, f) == getattr(rr, f), f
    ref, _ = graphs.reference.run(algo, p.g, src)
    assert ALGEBRAS[algo].results_match(r.attrs, ref)
    if case == "road128_2copies":
        assert r.swaps > 0                      # slices really swapped
    if case == "tree128":
        assert r.edges_relaxed == p.g.m         # each tree edge once


def test_simulate_unsorted_tables_and_refusal(pairs):
    p = pairs("srn96")
    t = core.build_tables(p.m, core.SSSP, farthest_first=False)
    tr = ref_core.build_tables(p.mr, ref_core.SSSP, farthest_first=False)
    r = core.simulate(p.m, core.SSSP, src=2, tables=t)
    rr = ref_core.simulate(p.mr, ref_core.SSSP, src=2, tables=tr)
    assert r.cycles == rr.cycles
    np.testing.assert_array_equal(r.attrs, rr.attrs)
    with pytest.raises(ValueError, match="not expressible"):
        core.simulate(p.m, core.PAGERANK, src=0)


# ------------------------------------------------------------------ #
# baselines and the telemetry bridge
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("algo", ["bfs", "sssp", "wcc"])
def test_baselines_equal(pairs, algo):
    p = pairs("srn96")
    for fn in ("mcu_cycles", "cgra_cycles"):
        a = getattr(core.baselines, fn)(algo, p.g, 5)
        b = getattr(ref_core.baselines, fn)(algo, p.gr, 5)
        assert (a.cycles, a.freq_mhz, a.time_us, a.mteps(p.g.m)) == \
            (b.cycles, b.freq_mhz, b.time_us, b.mteps(p.gr.m))
    for u in (1, 2, 4, 8):
        assert core.baselines.unroll_speedup(u) == \
            ref_core.baselines.unroll_speedup(u)


def test_from_sim_equal(pairs):
    p = pairs("srn96")
    r, rr = sim_pair(p, "bfs", 5)
    got = from_sim(r, freq_mhz=100.0).to_json()
    want = ref_obs.from_sim(rr, freq_mhz=100.0).to_json()
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


# ------------------------------------------------------------------ #
# mapping order and compile(mapping=)
# ------------------------------------------------------------------ #
def test_mapping_order_equal(pairs):
    from repro.core.engine import mapping_order as ref_mapping_order
    for case in ("srn96", "road128_2copies"):
        p = pairs(case)
        np.testing.assert_array_equal(core.mapping_order(p.m),
                                      ref_mapping_order(p.mr))


@pytest.mark.parametrize("algo", sorted(ALGEBRAS))
def test_compile_with_mapping_matches_reference(pairs, algo):
    """A mapping-ordered session answers as the reference's: bit for bit
    (steps too) for the idempotent programs, within the algebra's atol
    for pagerank and labelprop."""
    p = pairs("srn96")
    srcs = [0, 5, 40]
    got = flip_torch.compile(p.g, algo, flip_torch.ExecutionPlan(tile=16),
                             mapping=p.m, device="cpu")
    want = flip.compile(p.gr, algo, flip.ExecutionPlan(tile=16),
                        mapping=p.mr)
    np.testing.assert_array_equal(got.engine.bg.inv_perm,
                                  core.mapping_order(p.m))
    a, b = got.query(srcs), want.query(srcs)
    alg = ALGEBRAS[algo]
    if alg.semiring.idempotent:
        np.testing.assert_array_equal(a.attrs, np.asarray(b.attrs))
        np.testing.assert_array_equal(a.steps, np.asarray(b.steps))
    else:
        np.testing.assert_allclose(a.attrs, np.asarray(b.attrs), rtol=0,
                                   atol=alg.atol)
    assert a.check()
    # the id-order session reaches the same fixpoint
    if alg.semiring.idempotent:
        ido = flip_torch.compile(p.g, algo,
                                 flip_torch.ExecutionPlan(tile=16),
                                 device="cpu").query(srcs)
        np.testing.assert_array_equal(a.attrs, ido.attrs)


def test_build_rejects_mapping_and_order(pairs):
    p = pairs("srn96")
    with pytest.raises(ValueError, match="not both"):
        flip_torch.compile(p.g, "bfs", mapping=p.m,
                           order=np.arange(p.g.n), device="cpu")


# ------------------------------------------------------------------ #
# the CLI: --engine sim
# ------------------------------------------------------------------ #
def _ref_cli(monkeypatch, capsys, argv):
    from repro.launch import graph_run as ref_graph_run
    monkeypatch.setattr(sys, "argv", ["graph_run"] + argv)
    ref_graph_run.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("algo", ["sssp", "wcc"])
def test_graph_run_sim_matches_reference(monkeypatch, capsys, tmp_path,
                                         algo):
    from repro_torch.launch import graph_run
    argv = ["--algo", algo, "--dataset", "SRN", "--engine", "sim",
            "--src", "5", "--effort", "0"]
    graph_run.main(argv + ["--trace", str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    want = _ref_cli(monkeypatch, capsys,
                    argv + ["--trace", str(tmp_path / "r.json")])

    def lines(text, prefix):        # the trace line without its path
        return [ln.split(" -> ")[0] for ln in text.splitlines()
                if ln.startswith(prefix)]
    for prefix in ("[graph] sim:", "[graph] speedup", "[graph] trace:",
                   "[graph] correct vs reference:"):
        assert lines(out, prefix) == lines(want, prefix), prefix
    assert "[graph] correct vs reference: True" in out
    got_doc = json.loads((tmp_path / "t.json").read_text())
    want_doc = json.loads((tmp_path / "r.json").read_text())
    assert got_doc == want_doc


def test_graph_run_sim_guards():
    from repro_torch.launch import graph_run
    base = ["--dataset", "SRN", "--engine", "sim", "--effort", "0"]
    with pytest.raises(SystemExit, match="non-idempotent"):
        graph_run.main(base + ["--algo", "pagerank"])
    with pytest.raises(SystemExit, match="scalar vertex state"):
        graph_run.main(base + ["--algo", "multi_bfs"])
    with pytest.raises(SystemExit, match="--srcs needs"):
        graph_run.main(base + ["--srcs", "0,1"])
