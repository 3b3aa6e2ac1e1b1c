"""The port's distributed graph fixpoint held against the reference.

`ExecutionPlan(distributed=True)` runs over gloo ranks on the CPU: one
spawn per world size (1, 2 and 4), every case inside it. The reference's
distributed fixpoint runs in one subprocess with 4 forced host devices
(as tests/test_distributed.py does), over meshes of 1, 2 and 4, and its
local fixpoint in this process. Idempotent programs (bfs, sssp, wcc,
widest, reach, multi_bfs) must be bit-equal, steps included; pagerank
and labelprop agree at `VertexAlgebra.atol`. Every rank must report the
same steps. Inside the same spawns the device loop runs with the rank
step (eagerly here; captured as CUDA graphs over NCCL on the card) and
must equal the host loop of the same step bit for bit, at any chunk
length, with every rank reading the same summary after every chunk.
"""
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import flip_torch
from repro.core.engine import FlipEngine as RefEngine
from repro.graphs import make_road_network as ref_road
from repro_torch.algebra import ALGEBRAS
from repro_torch.core import engine as eng_mod
from repro_torch.core.engine import DEVICE_CHUNK, FlipEngine
from repro_torch.graphs import make_road_network
from repro_torch.resilience.errors import InvalidRequest
from repro_torch.serving import AsyncGraphServer

ALGOS = ["bfs", "sssp", "wcc", "widest", "reach", "pagerank", "multi_bfs",
         "labelprop"]
SRCS = [2, 5, 9]
ZERO_SRCS = [5, 0, 17, 23]
ZERO_ALGOS = ("sssp", "pagerank", "multi_bfs")   # scalar, (+, x), d = 8
WORLDS = (1, 2, 4)
CHUNKS = (1, 3, 8)            # the device loop's chunk lengths held
TIMEOUT_S = 120


def _plan(**kw):
    return flip_torch.ExecutionPlan(distributed=True, tile=32, **kw)


def _monotone_update(g):
    """Three halved weights: monotone under min-plus."""
    u = g.edge_sources()[:3]
    v = g.indices[:3]
    w = g.weights[:3] * 0.5
    return [(int(a), int(b), float(c)) for a, b, c in zip(u, v, w)]


# ------------------------------------------------------------------ #
# the gloo ranks: every case of one world size in one spawn
# ------------------------------------------------------------------ #
def _rank_cases(world: int) -> dict:
    out = {}
    g = make_road_network(128, seed=3)
    for algo in ALGOS:
        r = flip_torch.compile(g, algo, _plan(), device="cpu").query(SRCS)
        out[f"{algo}/attrs"], out[f"{algo}/steps"] = r.attrs, r.steps
    # ntiles = 2: at world 4 two ranks own only padding tiles, no block
    g48 = make_road_network(48, seed=1)
    for algo in ZERO_ALGOS:
        r = flip_torch.compile(g48, algo, _plan(), device="cpu").query(
            ZERO_SRCS)
        out[f"zero/{algo}/attrs"], out[f"zero/{algo}/steps"] = \
            r.attrs, r.steps
    # batched = solo, steps included
    cq = flip_torch.compile(g, "sssp", _plan(), device="cpu")
    solo = [cq.query(s) for s in SRCS]
    out["solo/attrs"] = np.stack([r.attrs for r in solo])
    out["solo/steps"] = np.asarray([r.steps for r in solo])
    # a warm start after a monotone update = scratch on the new graph
    base = cq.query(SRCS[0])
    cq2, delta = cq.update(_monotone_update(g))
    warm = cq2.query(SRCS[0], warm=base)
    scratch = cq2.query(SRCS[0])
    out["warm/monotone"] = np.asarray(delta.monotone)
    out["warm/attrs"], out["warm/steps"] = warm.attrs, warm.steps
    out["scratch/attrs"] = scratch.attrs
    # step budgets: flagged partials
    r = cq.query(SRCS, max_steps=[3, 1000, 5])
    out["budget/attrs"], out["budget/steps"] = r.attrs, r.steps
    out["budget/converged"] = r.converged
    # the bucket GraphServer passes the distributed plan through
    from repro_torch.launch.serve_graph import GraphServer
    srv = GraphServer(g, plan=_plan(batch=2), device="cpu")
    reqs = srv.serve(("sssp", s) for s in SRCS)
    out["server/attrs"] = np.stack([r.result for r in reqs])
    out["server/ok"] = np.asarray([r.ok for r in reqs])
    # graph_run over the group that is already joined
    buf = io.StringIO()
    from repro_torch.launch import graph_run
    with contextlib.redirect_stdout(buf):
        graph_run.main(["--algo", "sssp", "--dataset", "SRN", "--src", "3",
                        "--engine", "dist", "--device", "cpu", "--effort",
                        "0"])
    out["graph_run"] = np.asarray(buf.getvalue())
    out.update(_device_loop_cases(g, g48))
    return out


def _device_loop_cases(g, g48) -> dict:
    """The device loop with the rank step (`_fixpoint_device(...,
    step=)`, eager on the CPU, its gather over gloo; on the card over
    NCCL it is captured) and the host loop of the same step, for every
    program, with and without step budgets (at chunk lengths 1, 3 and
    8); and the summary each chunk's read gives this rank."""
    out = {}
    cases = [(g, algo, SRCS, "") for algo in ALGOS] + [
        (g48, algo, ZERO_SRCS, "zero/") for algo in ZERO_ALGOS]
    for graph, algo, srcs, tag in cases:
        eng = flip_torch.compile(graph, algo, _plan(), device="cpu").engine
        step = eng._dist_step()
        st = step.pad(eng, eng.initial_state(srcs))
        summaries = []
        chunk = eng._device_chunk

        def recorded(*a, **k):
            state, summary = chunk(*a, **k)
            summaries.append(summary.clone())
            return state, summary
        eng._device_chunk = recorded
        budget_sets = (("full", None), ("budget", np.asarray(
            [3, 1000, 5, 2][:len(srcs)], np.int32)))
        try:
            for name, budgets in budget_sets:
                key = f"loop/{tag}{algo}/{name}"
                host = eng._fixpoint(*st, 0, budgets=budgets, step=step)
                # query 1 of the budgeted set runs to its fixpoint: the
                # chunk lengths are held there
                for k in CHUNKS if budgets is not None else (8,):
                    eng_mod.DEVICE_CHUNK = k
                    dev = eng._fixpoint_device(*st, 0, budgets, step=step)
                    for which, r in (("host", host), (f"device{k}", dev)):
                        out[f"{key}/{which}/attrs"] = eng.finalize_state(
                            r[0][:, :eng.bg.ntiles], r[1][:, :eng.bg.ntiles])
                        out[f"{key}/{which}/steps"] = r[3]
                        out[f"{key}/{which}/converged"] = r[5]
                        out[f"{key}/{which}/frontier"] = r[2].numpy()
        finally:
            eng_mod.DEVICE_CHUNK = DEVICE_CHUNK
            del eng._device_chunk
        out[f"loop/{tag}{algo}/summaries"] = torch.stack(summaries).numpy()
    return out


def _worker(rank: int, world: int, store: str, q) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            q.put((rank, _rank_cases(world)))
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        q.put((rank, repr(e)))
        raise


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request):
    """{rank: results} of one gloo spawn at this world size."""
    world = request.param
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_worker,
                             args=(r, world, os.path.join(tmp, "store"), q))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = dict(q.get(timeout=TIMEOUT_S) for _ in procs)
        for p in procs:
            p.join(timeout=30)
            assert not p.is_alive()
    for r, res in got.items():
        assert isinstance(res, dict), f"rank {r}: {res}"
    return world, got


@pytest.fixture(scope="module")
def reference():
    """The reference's distributed results over meshes of 1, 2 and 4
    forced host devices, in one subprocess."""
    code = textwrap.dedent(f"""
    import os, sys
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.core.engine import FlipEngine
    from repro.graphs import make_road_network
    g = make_road_network(128, seed=3)
    g48 = make_road_network(48, seed=1)
    out = {{}}
    for w in {WORLDS}:
        mesh = Mesh(np.array(jax.devices()[:w]), ("data",))
        for algo in {ALGOS}:
            eng = FlipEngine.build(g, algo, tile=32)
            o, s = eng.execute(np.asarray({SRCS}), distributed=True,
                               mesh=mesh)
            out[f"{{w}}/{{algo}}/attrs"], out[f"{{w}}/{{algo}}/steps"] = o, s
        for algo in {ZERO_ALGOS}:
            eng = FlipEngine.build(g48, algo, tile=32)
            o, s = eng.execute(np.asarray({ZERO_SRCS}), distributed=True,
                               mesh=mesh)
            out[f"{{w}}/zero/{{algo}}/attrs"] = o
            out[f"{{w}}/zero/{{algo}}/steps"] = s
    np.savez(sys.argv[1], **out)
    """)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                           "src"))
        proc = subprocess.run([sys.executable, "-c", code, path], env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with np.load(path) as z:
            return dict(z)


def _same(algo: str, got, want) -> None:
    alg = ALGEBRAS[algo]
    if alg.semiring.idempotent:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=alg.atol, rtol=0)


# ------------------------------------------------------------------ #
# against the reference
# ------------------------------------------------------------------ #
def test_matches_reference_distributed_and_local(ranks, reference):
    world, got = ranks
    g = ref_road(128, seed=3)
    for algo in ALGOS:
        mine = got[0][f"{algo}/attrs"]
        _same(algo, mine, reference[f"{world}/{algo}/attrs"])
        local, local_steps = RefEngine.build(g, algo, tile=32).execute(
            np.asarray(SRCS))
        _same(algo, mine, local)
        if ALGEBRAS[algo].semiring.idempotent:
            np.testing.assert_array_equal(
                got[0][f"{algo}/steps"], reference[f"{world}/{algo}/steps"])
            np.testing.assert_array_equal(got[0][f"{algo}/steps"],
                                          local_steps)


def test_device_loop_equals_host_loop(ranks):
    """The device loop with the rank step equals the host loop of the
    same step bit for bit, steps, convergence and the final frontier
    included, for every program, with and without budgets (at chunk
    lengths 1, 3 and 8)."""
    _, got = ranks
    cases = [f"loop/{a}" for a in ALGOS] + [f"loop/zero/{a}"
                                            for a in ZERO_ALGOS]
    for case in cases:
        for name in ("full", "budget"):
            key = f"{case}/{name}"
            for k in CHUNKS if name == "budget" else (8,):
                for f in ("attrs", "steps", "converged", "frontier"):
                    np.testing.assert_array_equal(
                        got[0][f"{key}/device{k}/{f}"],
                        got[0][f"{key}/host/{f}"], err_msg=f"{key} {k} {f}")
        full = got[0][f"{case}/full/host/converged"]
        budget = got[0][f"{case}/budget/host/converged"]
        assert full.all() and not budget.all(), case


def test_device_loop_matches_reference(ranks, reference):
    """The device loop against the reference's `dist_fix` on the same
    mesh size: idempotent programs bit for bit, steps included; pagerank
    and labelprop at `atol`. Budgets: equal to the plain step budgets of
    the distributed query (`test_step_budgets_flag_partials`)."""
    world, got = ranks
    for algo in ALGOS:
        key = f"loop/{algo}/full/device8"
        _same(algo, got[0][f"{key}/attrs"], reference[f"{world}/{algo}/attrs"])
        if ALGEBRAS[algo].semiring.idempotent:
            np.testing.assert_array_equal(
                got[0][f"{key}/steps"], reference[f"{world}/{algo}/steps"])
    for algo in ZERO_ALGOS:
        _same(algo, got[0][f"loop/zero/{algo}/full/device8/attrs"],
              reference[f"{world}/zero/{algo}/attrs"])
    np.testing.assert_array_equal(
        got[0]["loop/sssp/budget/device8/attrs"], got[0]["budget/attrs"])
    np.testing.assert_array_equal(
        got[0]["loop/sssp/budget/device8/steps"], got[0]["budget/steps"])


def test_ranks_read_the_same_chunk_summaries(ranks):
    """Every rank reads the same summary after every chunk, so every rank
    runs, captures and replays the same chunk lengths in the same order
    and leaves the loop on the same chunk."""
    world, got = ranks
    keys = [k for k in got[0] if k.endswith("/summaries")]
    assert len(keys) == len(ALGOS) + len(ZERO_ALGOS)
    for key in keys:
        assert got[0][key].shape[0] > 0, key
        for r in range(1, world):
            np.testing.assert_array_equal(got[r][key], got[0][key],
                                          err_msg=f"rank {r} {key}")


def test_ranks_without_blocks(ranks, reference):
    """ntiles = 2 over 4 ranks: ranks 2 and 3 own only padding tiles."""
    world, got = ranks
    for algo in ZERO_ALGOS:
        _same(algo, got[0][f"zero/{algo}/attrs"],
              reference[f"{world}/zero/{algo}/attrs"])
    for algo in ("sssp", "multi_bfs"):
        np.testing.assert_array_equal(
            got[0][f"zero/{algo}/steps"],
            reference[f"{world}/zero/{algo}/steps"])


def test_every_rank_reports_the_same_result(ranks):
    world, got = ranks
    assert sorted(got) == list(range(world))
    for r in range(1, world):
        for key, val in got[0].items():
            if key.endswith("steps") or key.endswith("converged"):
                np.testing.assert_array_equal(got[r][key], val, err_msg=key)
            elif key.endswith("attrs"):
                np.testing.assert_array_equal(got[r][key], val, err_msg=key)


def test_batched_equals_solo(ranks):
    _, got = ranks
    np.testing.assert_array_equal(got[0]["solo/attrs"],
                                  got[0]["sssp/attrs"])
    np.testing.assert_array_equal(got[0]["solo/steps"],
                                  got[0]["sssp/steps"])


def test_bucket_server_serves_a_distributed_plan(ranks):
    _, got = ranks
    assert got[0]["server/ok"].all()
    np.testing.assert_array_equal(got[0]["server/attrs"],
                                  got[0]["sssp/attrs"])


def test_warm_start_after_monotone_update_equals_scratch(ranks):
    _, got = ranks
    assert bool(got[0]["warm/monotone"])
    np.testing.assert_array_equal(got[0]["warm/attrs"],
                                  got[0]["scratch/attrs"])


def test_step_budgets_flag_partials(ranks):
    """max_steps stops queries 0 and 2 as flagged partials equal to the
    local engine's under the same budgets; query 1 converges."""
    _, got = ranks
    np.testing.assert_array_equal(got[0]["budget/converged"],
                                  [False, True, False])
    np.testing.assert_array_equal(got[0]["budget/steps"][[0, 2]], [3, 5])
    g = make_road_network(128, seed=3)
    local = flip_torch.compile(g, "sssp", flip_torch.ExecutionPlan(tile=32),
                               device="cpu").query(
        SRCS, max_steps=[3, 1000, 5])
    np.testing.assert_array_equal(got[0]["budget/attrs"], local.attrs)
    np.testing.assert_array_equal(got[0]["budget/steps"], local.steps)


def test_graph_run_dist_over_the_group(ranks):
    world, got = ranks
    out = str(got[0]["graph_run"])
    assert "dist/data: fixpoint in" in out and f"{world} ranks" in out
    assert "[graph] correct vs reference: True" in out


# ------------------------------------------------------------------ #
# one rank, no process group
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("algo", ["bfs", "pagerank", "multi_bfs"])
def test_one_rank_without_a_group(algo):
    assert not dist.is_initialized()
    g = make_road_network(128, seed=3)
    r = flip_torch.compile(g, algo, _plan(), device="cpu").query(SRCS)
    local = flip_torch.compile(g, algo, flip_torch.ExecutionPlan(tile=32),
                               device="cpu").query(SRCS)
    np.testing.assert_array_equal(r.attrs, local.attrs)
    np.testing.assert_array_equal(r.steps, local.steps)
    assert r.plan.distributed and r.check()


def test_host_layout_runs_distributed_only():
    """A distributed session keeps its blocks on the host; the local
    fixpoint refuses such an engine."""
    g = make_road_network(48, seed=1)
    eng = FlipEngine.build(g, "sssp", tile=32, device="cpu",
                           host_layout=True)
    out, _ = eng.execute(0, distributed=True)
    assert out.shape == (g.n,)
    with pytest.raises(ValueError, match="distributed plan"):
        eng.execute(0)


# ------------------------------------------------------------------ #
# the refusals the reference makes
# ------------------------------------------------------------------ #
def test_refusals():
    g = make_road_network(48, seed=1)
    cq = flip_torch.compile(g, "sssp", _plan(), device="cpu")
    with pytest.raises(ValueError, match="trace"):
        cq.query(0, trace=True)
    with pytest.raises(InvalidRequest, match="deadline_s"):
        cq.engine.execute(0, distributed=True, deadline_s=1.0)
    with pytest.raises(ValueError, match="deadline_s"):
        _plan(deadline_s=1.0).resolve(device="cpu")
    with pytest.raises(ValueError, match="tuned"):
        _plan(tuned=True).resolve(device="cpu")
    with pytest.raises(ValueError, match="continuous batching"):
        AsyncGraphServer(g, plan=_plan(batch=4), device="cpu")


def test_plan_surface():
    from repro_torch.api.plan import plan_from_cli
    assert plan_from_cli("dist", "data").distributed
    assert not plan_from_cli("jax", "data").distributed
    grp = object()
    p = flip_torch.ExecutionPlan(mesh=grp).resolve(device="cpu")
    assert p.distributed and p.key() != _plan().resolve(device="cpu").key()
    assert p.key() == flip_torch.ExecutionPlan(mesh=grp).resolve(
        device="cpu").key()
