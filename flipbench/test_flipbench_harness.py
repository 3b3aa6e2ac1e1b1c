"""The harness's own machinery: the import check, the entry's refusals
without a card or without the program, the trace reading, percentiles and
the traffic streams."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from flipbench import devtrace, harness, loops, spec


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.api", "flip_torch", "numpy"], []),
    (["repro_torch", "repro.api"], ["repro"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib", "flax.linen", "benchmarks.roofline"],
     ["benchmarks", "flax", "jaxlib"]),
    (["reprox", "jaxtyping"], []),
])
def test_forbidden_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_a_run_loads_nothing_forbidden():
    code = ("import sys, time; sys.path[:0] = ['.', 'src']\n"
            "from flipbench import harness, spec\n"
            "c = spec.find_cell(spec.load_benchmark(), 'road-ny.bfs1', 0)\n"
            "c.config['n'] = 300\n"
            "harness.run_cell(c, 1, 0.1, False, 'cpu', time.perf_counter())\n"
            "print(harness.forbidden_modules(sys.modules))")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def _entry(cwd, *extra):
    return subprocess.run(
        [sys.executable, "flipbench/run.py", "--workload", "road-ny.bfs1",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_entry_refuses_without_a_card():
    p = _entry(spec.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_entry_refuses_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "flipbench", tmp_path / "flipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _entry(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_busy_ops_and_named_gaps():
    events = [
        _x("user_annotation", devtrace.WINDOW, 1000, 100),
        _x("kernel", "relax_kernel<0>", 1000, 20),
        _x("kernel", "where", 1010, 20),          # overlaps: busy 1000-1030
        _x("gpu_memcpy", "Memcpy DtoH", 1060, 10),
        _x("kernel", "relax_kernel<0>", 1090, 20),  # clipped at 1100
        _x("kernel", "outside", 1200, 5),
        _x("user_annotation", "flipbench.query", 1000, 100),
        _x("cpu_op", "aten::item", 1030, 30),       # covers gap 1030-1060
        json.loads('{"ph": "i", "name": "marker", "ts": 1050}'),
    ]
    t = devtrace.parse_events(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.ops == 4
    assert t.busy_s == pytest.approx(50e-6)
    assert t.seconds_of("relax_kernel") == pytest.approx(40e-6)
    assert t.top_ops(1)[0][0] == "relax_kernel<0>"
    gaps = dict(t.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(30e-6)
    assert gaps["flipbench.query"] == pytest.approx(20e-6)
    assert devtrace.parse_events(events[1:]) is None


def test_percentile_nearest_rank():
    assert devtrace.percentile(list(range(1, 101)), 95) == 95
    assert devtrace.percentile([5.0], 95) == 5.0
    assert devtrace.percentile([1.0] * 19 + [np.inf], 95) == 1.0
    assert devtrace.percentile([1.0] * 18 + [np.inf] * 2, 95) == np.inf
    assert devtrace.percentile([], 95) is None


def test_arrivals_keep_their_sizes_across_seeds():
    traffic = spec.load_traffic("serve")
    from flipbench.generators import road_grid
    raw = road_grid.generate({"n": 500, "delete_frac": 0.56,
                              "max_weight": 8}, 0)
    plans = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        plans.append(loops.arrivals(traffic, 30.0,
                                    loops.Sources(raw, rng), rng))
    a, b = plans
    n = round(traffic["rate_per_s"] * 30)
    assert len(a) == len(b) == n
    gaps = [np.diff([r.t_sched for r in p] + [30.0]) for p in plans]
    np.testing.assert_allclose(np.sort(gaps[0]), np.sort(gaps[1]))
    assert gaps[0].sum() == pytest.approx(30.0)
    assert [r.t_sched for r in a] != [r.t_sched for r in b]
    for p in plans:
        algos = [r.algo for r in p]
        assert abs(algos.count("sssp") - algos.count("bfs")) <= 1


def test_reservoir_keeps_k_and_the_longest():
    rng = np.random.default_rng(0)
    res = loops.Reservoir(3, rng)
    for i in range(50):
        res.offer(100 if i == 17 else i % 7, i)
    items = res.items()
    assert 17 in items and 3 <= len(items) <= 4


def test_k1_roofline_reads_the_traced_calls():
    from flipbench import work
    from flipbench.generators import road_grid
    from flipbench.reference import Reference
    raw = road_grid.generate({"n": 1000, "delete_frac": 0.56,
                              "max_weight": 8}, 2)
    srcs = np.array([0, 500, 999])
    calls = [loops.QueryRecord("sssp", srcs, np.zeros(3), True, True),
             loops.QueryRecord("sssp", srcs, np.zeros(3), True, False)]
    k1 = [(0.0, 1e-3, "relax_kernel<0, 8, 1>"), (0.002, 0.003, "where")]
    run = harness.Run(cell=None, raw=raw, device="cpu", setup_s=0.0,
                      queries=calls, reference=Reference(raw, "cpu"),
                      trace=devtrace.DeviceTrace(0.01, k1, []))
    _, _, tiles = run.reference.run("sssp", srcs, record_tiles=True)
    nbytes, ops, _ = work.step_work(tiles.numpy(),
                                    work.blocks_per_source_tile(raw))
    assert run.traced_work() == (nbytes, ops)        # the traced call only
    read = spec.metric_reader("k1_roofline")
    assert read(run) == pytest.approx(100 * work.bound_s(nbytes, ops) / 1e-3)
    run.trace = devtrace.DeviceTrace(0.01, k1[1:], [])
    assert read(run) is None                         # no K1 in the trace
