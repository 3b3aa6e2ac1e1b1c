"""Port vs reference: the device loop of the fixpoint.

`FlipEngine._fixpoint_device` (the port's counterpart of the reference's
on-device `_dense_fixpoint_jit`: the live mask on the device, chunks of
up to `DEVICE_CHUNK` steps, one host read per chunk; captured as a CUDA
graph on the card) runs eagerly here on the CPU against the reference's
jitted while_loop, which a reference engine built with
``compact=False, relax_mode="jnp"`` reaches. A power-law graph (n=300,
tile 16), one reference compile per (algebra, B, trace capacity) shared
across the cases. The idempotent programs must agree bit for bit
(attrs, per-query steps, the converged mask, the frozen frontier);
pagerank and labelprop at `VertexAlgebra.atol` (1e-4), since (+, x) is
not bit-stable inside the reference. The distributed fixpoint's rank
step in the device loop is held in tests/test_torch_distributed.py; here
its route, a chunk with no host read and the captured loops' keys.
"""
import dataclasses
import functools
import gc
import weakref

import numpy as np
import pytest
import torch

from repro.core.engine import FlipEngine as RefEngine
from repro.graphs import make_power_law as ref_make_power_law
from repro_torch.algebra import ALGEBRAS
from repro_torch.core import engine as eng_mod
from repro_torch.core.engine import FlipEngine, fixpoint_route
from repro_torch.graphs import make_power_law

N, M, TILE = 300, 900, 16
BATCH = [3, 7, 11, 250]
ALGOS = sorted(ALGEBRAS)
EXACT = [a for a in ALGOS if ALGEBRAS[a].semiring.idempotent]


@functools.cache
def _graphs():
    g, rg = make_power_law(N, M, seed=1), ref_make_power_law(N, M, seed=1)
    np.testing.assert_array_equal(g.indptr, rg.indptr)
    np.testing.assert_array_equal(g.indices, rg.indices)
    np.testing.assert_array_equal(g.weights, rg.weights)
    return g, rg


@functools.cache
def _engines(algo: str):
    g, rg = _graphs()
    ref = RefEngine.build(rg, algo, tile=TILE, relax_mode="jnp",
                          compact=False)
    return ref, FlipEngine.build(g, algo, tile=TILE, device="cpu")


@functools.cache
def _ref_run(algo: str, srcs: tuple, trace_cap: int = 0,
             budgets: tuple | None = None):
    """The reference's `_fixpoint` on its dense jitted while_loop:
    (attrs in vertex order, steps, converged, frontier, trace)."""
    ref, _ = _engines(algo)
    st = ref.initial_state(np.asarray(srcs))
    out = ref._fixpoint(*st, trace_cap, budgets=None if budgets is None
                        else np.asarray(budgets, np.int32))
    assert trace_cap in ref._fixpoint_cache     # the on-device loop ran
    attrs = ref.bg.to_orig(ref.algebra.finalize(out[0], out[1]),
                           features=ref.feature_dim > 1)
    return (np.asarray(attrs), np.asarray(out[3]), np.asarray(out[5]),
            np.asarray(out[2]), out[4])


def _port_run(algo: str, srcs, trace_cap: int = 0, budgets=None):
    _, eng = _engines(algo)
    if trace_cap:
        # the reference engine streams dense: every block is fetched on
        # every row (the port's compaction changes only that count)
        eng = dataclasses.replace(eng, compact=False)
    out = eng._fixpoint_device(*eng.initial_state(srcs), trace_cap,
                               None if budgets is None
                               else np.asarray(budgets, np.int32))
    return (eng.finalize_state(out[0], out[1]), out[3], out[5],
            out[2].numpy(), out[4])


def _assert_matches(algo, got, want):
    if algo in EXACT:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0],
                                   atol=ALGEBRAS[algo].atol, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("batch", [False, True], ids=["solo", "B4"])
@pytest.mark.parametrize("algo", ALGOS)
def test_device_loop_matches_reference(algo, batch):
    srcs = tuple(BATCH) if batch else (BATCH[0],)
    _assert_matches(algo, _port_run(algo, list(srcs)), _ref_run(algo, srcs))


@pytest.mark.parametrize("algo", ["sssp", "multi_bfs", "pagerank"])
def test_budgets_freeze_and_flag(algo):
    srcs = (3, 7, 11)
    full = _ref_run(algo, srcs)
    budgets = (1, 3, int(full[1].max()))
    want = _ref_run(algo, srcs, budgets=budgets)
    got = _port_run(algo, list(srcs), budgets=budgets)
    _assert_matches(algo, got, want)
    np.testing.assert_array_equal(got[1], np.minimum(budgets, full[1]))
    cut = np.asarray(budgets) < full[1]
    assert cut[:2].all() and not got[2][cut].any() and got[2][~cut].all()
    # a cut query keeps its frontier, so it resumes where it stopped
    assert got[3][cut].reshape(cut.sum(), -1).any(axis=1).all()


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("algo", ["bfs", "widest", "labelprop"])
def test_chunk_length_changes_nothing(algo, chunk, monkeypatch):
    monkeypatch.setattr(eng_mod, "DEVICE_CHUNK", chunk)
    budgets = (2, 5, 100_000, 9)
    _assert_matches(algo, _port_run(algo, BATCH, budgets=budgets),
                    _ref_run(algo, tuple(BATCH), budgets=budgets))


def test_chunks_and_reads(monkeypatch):
    """One chunk per DEVICE_CHUNK steps and one host read per chunk;
    a chunk of a budget-capped segment is never longer than its budget,
    and no tensor is read on the host inside a chunk."""
    _, eng = _engines("sssp")
    lengths = []
    chunk = eng._device_chunk

    def counted(state, budgets, n, trace_cap, step=None):
        lengths.append(n)
        with _no_host_reads():
            return chunk(state, budgets, n, trace_cap, step=step)

    monkeypatch.setattr(eng, "_device_chunk", counted)
    monkeypatch.setattr(eng_mod, "DEVICE_CHUNK", 3)
    out = eng._fixpoint_device(*eng.initial_state(BATCH))
    iters = int(out[3].max())
    assert sum(lengths) - iters in range(3)
    assert lengths == [3] * len(lengths)
    lengths.clear()
    eng._fixpoint_device(*eng.initial_state(BATCH), 2,
                         np.asarray([4, 2, 4, 1], np.int32))
    assert lengths == [3, 1]


class _no_host_reads:
    """Make every tensor -> host read raise (a CUDA graph cannot
    capture one)."""
    NAMES = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__", "__index__")

    def __enter__(self):
        self.saved = {k: getattr(torch.Tensor, k) for k in self.NAMES}

        def refuse(*a, **k):
            raise AssertionError("host read inside a device-loop chunk")
        for k in self.NAMES:
            setattr(torch.Tensor, k, refuse)

    def __exit__(self, *exc):
        for k, f in self.saved.items():
            setattr(torch.Tensor, k, f)


@pytest.mark.parametrize("algo", ALGOS)
def test_chunk_makes_no_host_read(algo):
    """The chunk's body as the card captures it: K1's place taken by the
    plain dense version (no compaction, whose `nonzero` is the CPU's
    alone), traced and untraced."""
    _, eng = _engines(algo)
    eng = dataclasses.replace(eng, compact=False)
    st = eng.initial_state(BATCH)
    steps = torch.zeros(len(BATCH), dtype=torch.int32)
    it = torch.zeros((), dtype=torch.int32)
    bufs = (torch.zeros((5, 4), dtype=torch.int32),
            torch.zeros(5, dtype=torch.int32),
            torch.zeros(5, dtype=torch.int32),
            torch.zeros((5, 4), dtype=torch.bool))
    bud = torch.full((4,), 100, dtype=torch.int32)
    with _no_host_reads():
        eng._device_chunk(st + (steps, it), bud, 2, 0)
        eng._device_chunk(st + (steps, it) + bufs, bud, 2, 4)


@pytest.mark.parametrize("algo", ALGOS)
def test_rank_step_chunk_makes_no_host_read(algo):
    """A chunk of the distributed fixpoint's rank step, as the card
    captures it: one rank with no group (world 1, no collective), K1's
    place taken by the plain dense version (the whole-rank idle test,
    which reads the device, runs only on the CPU's compacted route)."""
    _, eng = _engines(algo)
    eng = dataclasses.replace(eng, compact=False)
    step = eng._dist_step(None)
    assert step.capturable and step.key == (0, 1, None)
    st = step.pad(eng, eng.initial_state(BATCH))
    steps = torch.zeros(len(BATCH), dtype=torch.int32)
    it = torch.zeros((), dtype=torch.int32)
    bud = torch.full((4,), 100, dtype=torch.int32)
    with _no_host_reads():
        state, _ = eng._device_chunk(st + (steps, it), bud, 2, 0,
                                     step=step)
    want = eng._device_chunk(st + (steps, it), bud, 2, 0)[0]
    assert all(torch.equal(a, b) for a, b in zip(state, want))


def test_captured_loop_keys_local_and_rank_steps_apart():
    """A local query and a rank step's query of the same B (at world 1
    the padded state has the local shape) never share a graph, nor do
    rank steps of another rank, world or group."""
    _, eng = _engines("sssp")
    eng = dataclasses.replace(eng)          # a fresh __dict__
    st = eng.initial_state(BATCH) + (
        torch.zeros(len(BATCH), dtype=torch.int32),
        torch.zeros((), dtype=torch.int32))
    bud = torch.full((4,), 100, dtype=torch.int32)
    step = eng._dist_step(None)
    other = object()                        # stands in for a group
    local = eng._captured_loop(st, bud, 0)
    rank = eng._captured_loop(st, bud, 0, step)
    grouped = eng._captured_loop(st, bud, 0,
                                 dataclasses.replace(step, group=other))
    rank1 = eng._captured_loop(st, bud, 0,
                               dataclasses.replace(step, rank=1, world=2))
    loops = [local, rank, grouped, rank1]
    assert len({id(x) for x in loops}) == 4
    assert local.step is None and rank.step is step
    assert eng._captured_loop(st, bud, 0) is local
    assert eng._captured_loop(st, bud, 0, eng._dist_step(None)) is rank
    assert eng._captured_loop(st, bud, 8) is not local
    assert len(eng.__dict__["_captured"]) == 5


def test_engine_with_rank_step_loops_is_freed_without_gc():
    """A distributed engine whose captured loops keep rank steps is freed
    by reference counting alone once dropped (as `apply_updates` drops
    the old engine): no step refers back to the engine, so its slabs and
    graphs go with it, not at the cycle collector's next run."""
    _, eng = _engines("sssp")
    eng = dataclasses.replace(eng, _slabs={})   # not the cached engine
    st = eng.initial_state(BATCH) + (
        torch.zeros(len(BATCH), dtype=torch.int32),
        torch.zeros((), dtype=torch.int32))
    bud = torch.full((4,), 100, dtype=torch.int32)
    step = eng._dist_step(None)
    eng._captured_loop(st, bud, 0, step)
    assert eng.__dict__["_slabs"] and eng.__dict__["_captured"]
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng, step
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("algo", ["sssp", "pagerank"])
def test_segments_compose_into_one_call(algo):
    """`run_segment`'s use: segments of 4 steps, each resuming from the
    last one's state, end where one call ends."""
    _, eng = _engines(algo)
    want = _ref_run(algo, tuple(BATCH))
    state = eng.initial_state(BATCH)
    total = np.zeros(len(BATCH), np.int32)
    for _ in range(100):
        left = np.minimum(4, 100_000 - total).astype(np.int32)
        out = eng._fixpoint_device(*state, 0, left)
        state, total = out[:3], total + out[3]
        if out[5].all():
            break
    got = (eng.finalize_state(state[0], state[1]), total, out[5],
           state[2].numpy())
    _assert_matches(algo, got, want)


@pytest.mark.parametrize("algo", ["bfs", "labelprop"])
def test_trace_matches_reference(algo):
    for cap in (64, 2):
        want = _ref_run(algo, tuple(BATCH), trace_cap=cap)
        got = _port_run(algo, BATCH, trace_cap=cap)
        _assert_matches(algo, got, want)
        (tr, trunc), (rtr, rtrunc) = got[4], want[4]
        assert trunc == rtrunc == (cap == 2)
        assert len(tr) == len(rtr) == min(cap, int(want[1].max()))
        for f in ("active_vertices", "active_tiles", "blocks_fetched",
                  "blocks_skipped", "converged"):
            np.testing.assert_array_equal(getattr(tr, f), getattr(rtr, f))
            assert getattr(tr, f).dtype == getattr(rtr, f).dtype
        assert tr.step_wall_s is None and rtr.step_wall_s is None


def test_zero_budgets_run_nothing():
    _, eng = _engines("bfs")
    st = eng.initial_state(BATCH)
    out = eng._fixpoint_device(*st, 0, np.zeros(4, np.int32))
    np.testing.assert_array_equal(out[3], 0)
    assert not out[5].any()
    assert all(torch.equal(a, b) for a, b in zip(out[:3], st))


# a rank step is True (its collective not known capturable) or names its
# group's backend ("nccl", "gloo") or "no group" (one rank, no collective)
@pytest.mark.parametrize("device, relax, deadlined, rank_step, want", [
    ("cuda", "cuda", False, False, "device"),
    ("cuda", "cuda", True, False, "host"),
    ("cuda", "cuda", False, True, "host"),
    ("cpu", "torch", False, False, "host"),
    ("cpu", "torch", True, False, "host"),
    ("cpu", "torch", False, True, "host"),
    ("cuda", "cuda", False, "nccl", "device"),
    ("cuda", "cuda", False, "no group", "device"),
    ("cuda", "cuda", False, "gloo", "host"),
    ("cuda", "cuda", True, "nccl", "host"),
    ("cuda", "torch", False, "nccl", "host"),
    ("cpu", "torch", False, "no group", "host"),
    ("cpu", "torch", False, "gloo", "host"),
])
def test_route_table(device, relax, deadlined, rank_step, want):
    capturable = rank_step in ("nccl", "no group")
    assert fixpoint_route(device, relax, deadlined, bool(rank_step),
                          capturable) == want


def test_cpu_engine_keeps_the_host_loop(monkeypatch):
    _, eng = _engines("sssp")

    def refuse(*a, **k):
        raise AssertionError("a CPU engine reached the device loop")
    monkeypatch.setattr(eng, "_fixpoint_device", refuse)
    _, steps, tele = eng.execute(BATCH, trace=True)
    trace = tele.trace
    assert trace.step_wall_s is not None and len(trace) == steps.max()


def test_replace_drops_captured_graphs():
    """A CUDA graph holds pointers to its engine's blocks: an engine made
    by `apply_updates` (dataclasses.replace) must never find one."""
    g, _ = _graphs()
    eng = FlipEngine.build(g, "sssp", tile=TILE, device="cpu")
    eng.__dict__["_captured"] = {(4, 0): "captured on this engine"}
    eng2, _ = eng.apply_updates(g.apply_updates([(0, 5, 0.5)]),
                                [(0, 5, 0.5)])
    assert "_captured" not in eng2.__dict__
    assert "_captured" not in dataclasses.replace(eng, max_steps=9).__dict__
