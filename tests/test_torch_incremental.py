"""Port vs reference: streaming edge updates and warm recompute.

`BlockedGraph.apply_updates` of the port against the reference's on the
same graph and the same batches -- value-only, grow (an empty tile pair
gains an edge) and drop (an off-diagonal block loses its last edge) --
for every registered algebra: `blocks`, `bsrc`, `bdst`, `dst_start` and
the `UpdateDelta` fields must be equal, and equal to a from-scratch
`build_blocks` of the new graph. Then the session surface:
`update` + `query(warm=)` against the reference's, bit for bit in attrs
and steps for the idempotent programs (pagerank and labelprop recompute
from scratch and agree at `VertexAlgebra.atol`), and the warm-policy
errors on the same inputs.
"""
import json

import numpy as np
import pytest

import flip
import flip_torch
from repro.api import ExecutionPlan as RefPlan
from repro.core.engine import WarmStart as RefWarmStart
from repro.graphs import make_power_law as ref_power_law
from repro.graphs import make_road_network as ref_road
from repro.kernels.frontier import build_blocks as ref_build_blocks
from repro_torch.algebra import ALGEBRAS
from repro_torch.core.engine import WarmStart
from repro_torch.graphs import make_power_law, make_road_network
from repro_torch.kernels.frontier import build_blocks

ALGOS = sorted(ALGEBRAS)
TILE = 16
GRAPH_ARGS = dict(n=200, m=400, seed=3)     # 13 tiles, the last ragged
SRCS8 = np.array([3, 11, 0, 27, 42, 8, 19, 33])


def graphs():
    return make_power_law(**GRAPH_ARGS), ref_power_law(**GRAPH_ARGS)


def value_batch(g, rng):
    """Halve three existing weights: every touched pair keeps a block."""
    eu = g.edge_sources()
    idx = rng.choice(g.m, size=3, replace=False)
    return [(int(eu[i]), int(g.indices[i]), float(g.weights[i]) * 0.5)
            for i in idx]


def grow_batch(g):
    """One edge into a tile pair that holds no edge in either direction
    (so no algebra has a block there yet)."""
    eu, ev = g.edge_sources(), g.indices.astype(np.int64)
    nt = -(-g.n // TILE)
    full = set(zip(eu // TILE, ev // TILE))
    full |= {(d, s) for s, d in full}
    s, d = next((s, d) for s in range(nt) for d in range(nt)
                if s != d and (s, d) not in full)
    return [(s * TILE + 1, d * TILE + 2, 3.0)]


def drop_batch(g):
    """Delete every edge between the off-diagonal tile pair with the
    fewest edges, in both directions: its blocks empty out."""
    eu, ev = g.edge_sources(), g.indices.astype(np.int64)
    pair = np.minimum(eu // TILE, ev // TILE) * 1000 + \
        np.maximum(eu // TILE, ev // TILE)
    off = (eu // TILE) != (ev // TILE)
    keys, counts = np.unique(pair[off], return_counts=True)
    k = keys[np.argmin(counts)]
    return [(int(u), int(v), None)
            for u, v in zip(eu[off & (pair == k)], ev[off & (pair == k)])]


def assert_layout(bg, want):
    for f in ("blocks", "bsrc", "bdst", "dst_start"):
        np.testing.assert_array_equal(np.asarray(getattr(bg, f)),
                                      np.asarray(getattr(want, f)), f)


def assert_delta(got, want):
    assert (got.monotone, got.shape_changed, got.n_blocks_rebuilt,
            got.version) == (want.monotone, want.shape_changed,
                             want.n_blocks_rebuilt, want.version)
    np.testing.assert_array_equal(got.affected_src, want.affected_src)


# ------------------------------------------------------------------ #
# the blocked layout: port == reference == from scratch
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("algo", ALGOS)
def test_apply_updates_matches_reference(algo):
    g, gr = graphs()
    bg = build_blocks(g, algo, tile=TILE, device="cpu")
    bgr = ref_build_blocks(gr, algo, tile=TILE)
    rng = np.random.default_rng(0)
    kinds = []
    for make in (lambda x: value_batch(x, rng), grow_batch, drop_batch,
                 lambda x: []):
        batch = make(g)
        g, gr = g.apply_updates(batch), gr.apply_updates(batch)
        prev = bg
        bg, delta = bg.apply_updates(g, batch)
        bgr, delta_r = bgr.apply_updates(gr, batch)
        assert_delta(delta, delta_r)
        assert_layout(bg, bgr)
        assert_layout(bg, build_blocks(g, algo, tile=TILE, device="cpu"))
        assert bg.version == g.version and bg.graph_fp == g.fingerprint()
        if not delta.shape_changed:
            assert bg.bsrc is prev.bsrc and bg.bdst is prev.bdst
            assert bg.dst_start is prev.dst_start
        kinds.append(delta.shape_changed)
    assert kinds == [False, True, True, False]


def test_apply_updates_undirected_mirror():
    """Undirected CSR: one (u, v, w) lands in both half-edge tiles."""
    g = make_road_network(64, seed=2, delete_frac=0.5)
    gr = ref_road(64, seed=2, delete_frac=0.5)
    batch = [(0, int(g.neighbors(0)[0]), 0.25), (3, 40, 1.5)]
    g2, gr2 = g.apply_updates(batch), gr.apply_updates(batch)
    bg2, delta = build_blocks(g, "sssp", tile=TILE,
                              device="cpu").apply_updates(g2, batch)
    bgr2, delta_r = ref_build_blocks(gr, "sssp",
                                     tile=TILE).apply_updates(gr2, batch)
    assert_delta(delta, delta_r)
    assert_layout(bg2, bgr2)
    assert_layout(bg2, build_blocks(g2, "sssp", tile=TILE, device="cpu"))


def test_value_only_update_keeps_old_layout():
    """The value-only path clones the block tensor: the pre-update
    layout keeps its values, so the old session still answers."""
    g, _ = graphs()
    cq = flip_torch.compile(g, "sssp", flip_torch.ExecutionPlan(tile=TILE),
                            device="cpu")
    before = cq.engine.bg.blocks.clone()
    r0 = cq.query(SRCS8)
    cq2, delta = cq.update(value_batch(g, np.random.default_rng(1)))
    assert not delta.shape_changed
    assert cq2.engine.bg.blocks is not cq.engine.bg.blocks
    assert cq2.engine.bg.bsrc is cq.engine.bg.bsrc
    assert torch_equal(cq.engine.bg.blocks, before)
    r1 = cq.query(SRCS8)
    np.testing.assert_array_equal(r1.attrs, r0.attrs)
    np.testing.assert_array_equal(r1.steps, r0.steps)


def torch_equal(a, b):
    return bool((a == b).all())


# ------------------------------------------------------------------ #
# update + warm query through the session
# ------------------------------------------------------------------ #
def monotone_batch(g, rng):
    """Improving reweights (halved) plus two inserts: monotone for the
    min-plus programs, a no-op reweight for the hop/reach rules."""
    return value_batch(g, rng) + [(5, 150, 1.0), (70, 2, 2.0)]


def sessions(algo, batch=0, warm="auto"):
    g, gr = graphs()
    port = flip_torch.compile(g, algo, flip_torch.ExecutionPlan(
        tile=TILE, batch=batch, warm=warm), device="cpu")
    ref = flip.compile(gr, algo, RefPlan(tile=TILE, batch=batch, warm=warm,
                                         relax_mode="jnp"))
    return port, ref


def assert_agree(algo, got, want):
    alg = ALGEBRAS[algo]
    assert np.shape(got.attrs) == np.shape(want.attrs)
    if alg.semiring.idempotent:
        np.testing.assert_array_equal(got.attrs, want.attrs)
        np.testing.assert_array_equal(got.steps, want.steps)
    else:
        assert alg.results_match(got.attrs, want.attrs)


@pytest.mark.parametrize("shape", ["solo", "batch8"])
@pytest.mark.parametrize("algo", ALGOS)
def test_warm_query_matches_reference(algo, shape):
    port, ref = sessions(algo)
    srcs = 3 if shape == "solo" else SRCS8
    r, rr = port.query(srcs), ref.query(srcs)
    batch = monotone_batch(port.graph, np.random.default_rng(2))
    port2, delta = port.update(batch)
    ref2, delta_r = ref.update(batch)
    assert_delta(delta, delta_r)
    w, wr = port2.query(srcs, warm=r), ref2.query(srcs, warm=rr)
    assert_agree(algo, w, wr)
    scratch = port2.query(srcs)
    if ALGEBRAS[algo].semiring.idempotent:
        np.testing.assert_array_equal(w.attrs, scratch.attrs)
        assert np.all(np.asarray(w.steps) <= np.asarray(scratch.steps))
    assert w.check()


def test_warm_bucketed_slices_per_query_rows():
    """plan.batch = 4 over 8 sources: per-query warm rows follow their
    bucket (padded like the sources)."""
    port, ref = sessions("sssp", batch=4)
    r, rr = port.query(SRCS8[:6]), ref.query(SRCS8[:6])
    batch = monotone_batch(port.graph, np.random.default_rng(3))
    port2, _ = port.update(batch)
    ref2, _ = ref.update(batch)
    w, wr = port2.query(SRCS8[:6], warm=r), ref2.query(SRCS8[:6], warm=rr)
    assert w.dispatches == wr.dispatches == 2
    assert_agree("sssp", w, wr)


def test_delete_recomputes_from_scratch():
    port, ref = sessions("bfs")
    r, rr = port.query(SRCS8), ref.query(SRCS8)
    batch = drop_batch(port.graph)
    port2, delta = port.update(batch)
    ref2, delta_r = ref.update(batch)
    assert not delta.monotone and delta.shape_changed
    assert_delta(delta, delta_r)
    w, wr = port2.query(SRCS8, warm=r), ref2.query(SRCS8, warm=rr)
    assert_agree("bfs", w, wr)
    np.testing.assert_array_equal(w.steps, port2.query(SRCS8).steps)


def raised(fn):
    with pytest.raises((ValueError, TypeError)) as e:
        fn()
    return type(e.value), str(e.value)


def test_warm_validation_errors_match_reference():
    rng = np.random.default_rng(4)
    g, gr = graphs()
    b1 = monotone_batch(g, rng)
    b2 = [(9, 90, 1.0)]
    cases = []
    for pkg, comp, plan_cls, ws_cls, gg in (
            ("port", lambda *a: flip_torch.compile(*a, device="cpu"),
             flip_torch.ExecutionPlan, WarmStart, g),
            ("ref", flip.compile, lambda **kw: RefPlan(relax_mode="jnp",
                                                       **kw),
             RefWarmStart, gr)):
        cq = comp(gg, "sssp", plan_cls(tile=TILE))
        r = cq.query([3, 11])
        cq2, _ = cq.update(b1)
        cq3, _ = cq2.update(b2)
        never = comp(gg, "sssp", plan_cls(tile=TILE, warm="never"))
        always = comp(gg, "sssp", plan_cls(tile=TILE, warm="always"))
        al2, _ = always.update(drop_batch(gg))
        vec = comp(gg, "multi_bfs", plan_cls(tile=TILE))
        errs = [
            raised(lambda: never.query([3, 11], warm=r)),
            raised(lambda: cq2.query([3, 27], warm=r)),     # other sources
            raised(lambda: cq3.query([3, 11], warm=r)),     # stale version
            raised(lambda: al2.query(3, warm=always.query(3))),
            raised(lambda: comp(gg, "pagerank",
                                plan_cls(tile=TILE, warm="always"))),
            raised(lambda: comp(gg, "pagerank", plan_cls(tile=TILE)).query(
                0, warm=ws_cls(np.zeros(gg.n, np.float32), np.array([0])))),
            raised(lambda: vec.query(0, warm=ws_cls(
                np.zeros(gg.n, np.float32), np.array([0])))),
            raised(lambda: cq.query([3, 11], warm=ws_cls(
                np.zeros((3, gg.n), np.float32), np.array([0])))),
            raised(lambda: cq.query(3, warm="x")),
        ]
        # the empty seed set: nothing to relax, zero steps, result kept
        base = cq.query(2)
        out = cq.query(2, warm=ws_cls(base.attrs, np.zeros(0, np.int64)))
        assert out.steps == 0
        np.testing.assert_array_equal(out.attrs, base.attrs)
        cases.append(errs)
    assert cases[0] == cases[1]


def test_empty_update_batch_is_noop():
    port, ref = sessions("sssp")
    r = port.query(2)
    port2, delta = port.update([])
    _, delta_r = ref.update([])
    assert_delta(delta, delta_r)
    assert delta.monotone and delta.affected_src.size == 0
    w = port2.query(2, warm=r)
    assert w.steps == 0
    np.testing.assert_array_equal(w.attrs, r.attrs)


def test_graph_run_updates(tmp_path, capsys):
    from repro_torch.launch import graph_run
    path = tmp_path / "upd.json"
    path.write_text(json.dumps([[[0, 5, 0.5], [1, 40, 2.0]],
                                [[0, 5, None]]]))
    graph_run.main(["--algo", "sssp", "--dataset", "SRN", "--src", "3",
                    "--updates", str(path), "--device", "cpu",
                    "--effort", "0"])
    out = capsys.readouterr().out
    assert "update[0]" in out and "warm recompute" in out
    assert "update[1]" in out and "full recompute" in out
    assert "[graph] correct vs reference: True" in out
    with pytest.raises(SystemExit, match="single --src"):
        graph_run.main(["--dataset", "SRN", "--srcs", "0,1", "--updates",
                        str(path), "--device", "cpu"])
