"""Port vs reference: the whole graph query slice.

`flip_torch.compile(g, algo, plan, device="cpu").query(...)` against
`flip.compile(g, algo, ExecutionPlan(relax_mode="jnp")).query(...)` for
every registered program, in data and op mode, solo, B = 8 and bucketed
(batch = 4). The idempotent programs must agree bit for bit in attrs and
per-query steps; pagerank and labelprop agree at `VertexAlgebra.atol`
with steps not compared ((+, ×) is not bit-stable even inside the
reference). Also: budgets and deadlines, source validation, the device
rule, and that the port imports neither jax nor `repro`.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flip
import flip_torch
from repro.api import ExecutionPlan as RefPlan
from repro.graphs import make_road_network as ref_road
from repro_torch.algebra import ALGEBRAS
from repro_torch.graphs import make_road_network

ALGOS = sorted(ALGEBRAS)
SRCS8 = np.array([3, 11, 0, 27, 42, 8, 19, 33])
GRAPH_ARGS = dict(n=100, seed=1, delete_frac=0.5)   # 100 = 6 * 16 + 4
TILE = 16
_SESSIONS = {}


def sessions(algo, mode, batch=0, ref_relax="jnp"):
    """(port session, reference session), compiled once per key."""
    key = (algo, mode, batch, ref_relax)
    if key not in _SESSIONS:
        g = make_road_network(**GRAPH_ARGS)
        gr = ref_road(**GRAPH_ARGS)
        port = flip_torch.compile(
            g, algo, flip_torch.ExecutionPlan(mode=mode, tile=TILE,
                                              batch=batch), device="cpu")
        ref = flip.compile(gr, algo, RefPlan(mode=mode, tile=TILE,
                                             batch=batch,
                                             relax_mode=ref_relax))
        _SESSIONS[key] = (port, ref)
    return _SESSIONS[key]


def assert_agree(algo, got, want, steps=True):
    alg = ALGEBRAS[algo]
    assert np.shape(got.attrs) == np.shape(want.attrs)
    if alg.semiring.idempotent:
        np.testing.assert_array_equal(got.attrs, want.attrs)
    else:
        assert alg.results_match(got.attrs, want.attrs)
    if steps and alg.semiring.idempotent:
        np.testing.assert_array_equal(got.steps, want.steps)
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_array_equal(got.deadline_expired,
                                  want.deadline_expired)


@pytest.mark.parametrize("shape", ["solo", "batch8", "bucketed4"])
@pytest.mark.parametrize("mode", ["data", "op"])
@pytest.mark.parametrize("algo", ALGOS)
def test_query_matches_reference(algo, mode, shape):
    batch = 4 if shape == "bucketed4" else 0
    port, ref = sessions(algo, mode, batch)
    srcs = 5 if shape == "solo" else SRCS8
    got, want = port.query(srcs), ref.query(srcs)
    assert_agree(algo, got, want)
    assert got.all_converged and got.check()
    if shape == "bucketed4":
        assert got.dispatches == want.dispatches == 2
    assert got.plan.relax_mode == "torch" and got.plan.compact == \
        (mode == "data")


@pytest.mark.parametrize("algo", ["bfs", "pagerank"])
def test_query_matches_pallas_interpret(algo):
    port, ref = sessions(algo, "data", 0, ref_relax="interpret")
    got, want = port.query(7), ref.query(7)
    assert_agree(algo, got, want)


@pytest.mark.parametrize("algo", ["sssp", "widest", "multi_bfs",
                                  "pagerank"])
def test_step_budgets_flag_partials(algo):
    port, ref = sessions(algo, "data")
    budgets = [1, 2, 3, 50_000, 4, 5, 6, 7]
    got = port.query(SRCS8, max_steps=budgets)
    want = ref.query(SRCS8, max_steps=budgets)
    assert_agree(algo, got, want)
    assert not got.all_converged and got.converged[3]
    np.testing.assert_array_equal(got.steps[[0, 1, 2]], [1, 2, 3])
    with pytest.raises(flip_torch.ConvergenceFailure):
        got.check()
    solo = port.query(5, max_steps=2)
    assert solo.steps == 2 and solo.converged is False


@pytest.mark.parametrize("algo", ["bfs", "labelprop"])
def test_spent_deadline_expires_every_query(algo):
    port, ref = sessions(algo, "data")
    got = port.query(SRCS8, deadline_s=1e-9)
    want = ref.query(SRCS8, deadline_s=1e-9)
    assert_agree(algo, got, want)
    assert got.deadline_expired.all() and not got.converged.any()
    np.testing.assert_array_equal(got.steps, 0)


def test_invalid_requests():
    port, _ = sessions("bfs", "data")
    for bad in (100, -1, [0, 100], 2.5):
        with pytest.raises(flip_torch.InvalidRequest):
            port.query(bad)
    for kw in (dict(max_steps=0), dict(max_steps=[1, 2]),
               dict(deadline_s=0.0), dict(max_steps=1.5)):
        with pytest.raises(flip_torch.InvalidRequest):
            port.query(SRCS8, **kw)
    with pytest.raises(TypeError, match="QueryResult or WarmStart"):
        port.query(0, warm=object())
    with pytest.raises(ValueError, match="no update delta"):
        port.query(0, warm=port.query(0))
    empty = port.query([])
    assert empty.attrs.shape == (0, port.graph.n) and empty.dispatches == 0


def test_plan_validation():
    g = make_road_network(**GRAPH_ARGS)
    plan = flip_torch.ExecutionPlan
    for bad in (plan(mode="fast"), plan(relax_mode="pallas"),
                plan(compact=True, mode="op"), plan(tile=0),
                plan(batch=-1), plan(tuned="yes"), plan(max_steps=0),
                plan(feature_dim=3), plan(deadline_s=-1.0),
                plan(relax_mode="cuda")):
        with pytest.raises(ValueError):
            flip_torch.compile(g, "multi_bfs" if bad.feature_dim == 3
                               else "bfs", bad, device="cpu")
    r = plan().resolve(ALGEBRAS["multi_bfs"], "cpu")
    assert (r.relax_mode, r.compact, r.feature_dim) == ("torch", True, 8)
    assert r.resolve(ALGEBRAS["multi_bfs"], "cpu") == r
    assert plan(mode="op").resolve(None, "cpu").compact is False
    assert plan().resolve(None, "cuda").relax_mode == "cuda"
    with pytest.raises(ValueError, match="plain version"):
        plan(relax_mode="torch").resolve(None, "cuda")


def test_scalar_program_at_feature_width():
    """A scalar program at d > 1 runs d broadcast lanes, like the
    reference."""
    g, gr = make_road_network(**GRAPH_ARGS), ref_road(**GRAPH_ARGS)
    got = flip_torch.compile(g, "sssp", flip_torch.ExecutionPlan(
        tile=TILE, feature_dim=4), device="cpu").query([1, 2])
    want = flip.compile(gr, "sssp", RefPlan(tile=TILE, feature_dim=4,
                                            relax_mode="jnp")).query([1, 2])
    assert got.attrs.shape == (2, g.n, 4)
    assert_agree("sssp", got, want)


def test_program_define_round_trip():
    """A user-defined program registers in the port's registries only."""
    from repro.algebra import ALGEBRAS as REF_ALGEBRAS
    from repro_torch.algebra import MIN_PLUS
    from repro_torch.graphs import reference

    @flip_torch.Program.define("hop2", MIN_PLUS, weight_rule="hop")
    def hop2(g, src):
        return reference.bfs(g, src)

    try:
        assert "hop2" in ALGEBRAS and "hop2" not in REF_ALGEBRAS
        g = make_road_network(**GRAPH_ARGS)
        assert flip_torch.compile(g, "hop2", flip_torch.ExecutionPlan(
            tile=TILE), device="cpu").query(3).check()
    finally:
        hop2.unregister()
    assert "hop2" not in ALGEBRAS


# ------------------------------------------------------------------ #
# (g) the device rule
# ------------------------------------------------------------------ #
def test_compile_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = make_road_network(**GRAPH_ARGS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flip_torch.compile(g, "bfs")
    with pytest.raises(ValueError, match="CUDA device"):
        flip_torch.compile(g, "bfs", flip_torch.ExecutionPlan(
            relax_mode="cuda"), device="cpu")
    assert flip_torch.compile(g, "bfs", device="cpu").device.type == "cpu"


# ------------------------------------------------------------------ #
# (f) no jax, no repro
# ------------------------------------------------------------------ #
def test_port_imports_neither_jax_nor_repro():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import importlib, pkgutil, sys\n"
        "import flip_torch, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'flip'))\n"
        "assert not bad, bad\n"
        "for name in ('launch.graph_run', 'launch.serve_graph', 'core.arch',"
        " 'core.vertex_program', 'core.mapping', 'core.tables', 'core.sim',"
        " 'core.baselines', 'distributed.health', 'resilience.faults',"
        " 'autotune.profile', 'autotune.space', 'autotune.measure',"
        " 'autotune.model', 'autotune.store', 'autotune.tuner',"
        " 'launch.autotune'):\n"
        "    assert 'repro_torch.' + name in sys.modules, name\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# ------------------------------------------------------------------ #
# the CLI
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("argv", [
    ["--algo", "sssp", "--dataset", "SRN", "--src", "3"],
    ["--algo", "bfs", "--dataset", "SRN", "--srcs", "0,5,9", "--mode",
     "op"],
    ["--algo", "multi_bfs", "--dataset", "Tree", "--srcs", "0,5,9",
     "--batch", "2"],
])
def test_graph_run_self_check(argv, capsys):
    from repro_torch.launch import graph_run
    graph_run.main(argv + ["--engine", "jax", "--device", "cpu",
                           "--effort", "0"])
    out = capsys.readouterr().out
    assert "[graph] correct vs reference: True" in out


@pytest.mark.parametrize("flags", [["--engine", "dist"],
                                   ["--engine", "dist", "--updates",
                                    "u.json"]])
def test_graph_run_rejects_unported(flags):
    from repro_torch.launch import graph_run
    with pytest.raises(SystemExit, match="not ported yet"):
        graph_run.main(["--dataset", "SRN", "--device", "cpu"] + flags)


@pytest.mark.parametrize("trace", [False, True], ids=["sim", "sim-trace"])
def test_graph_run_sim(tmp_path, capsys, trace):
    """`--engine sim` (the cycle simulator over a FLIP mapping) runs on
    SRN and self-checks; with --trace it writes the simulated cycles
    through `from_sim` as a Chrome trace."""
    from repro_torch.launch import graph_run
    path = tmp_path / "sim.json"
    graph_run.main(["--algo", "sssp", "--dataset", "SRN", "--engine", "sim",
                    "--effort", "0"]
                   + (["--trace", str(path)] if trace else []))
    out = capsys.readouterr().out
    assert "[graph] sim:" in out
    assert "[graph] correct vs reference: True" in out
    if trace:
        assert "cycle spans" in out
        assert json.loads(path.read_text())["traceEvents"]
