"""One run of one cell: set-up, the measured window, the check, the
metrics and the result line.

The order is fixed: make the graph and the sources from the seed, build
the program and warm up the cell's own shapes (set-up), run the window,
read the peak device memory, free the program, hold the sampled answers
against the reference, then let each metric's reader read the run.
"""
from __future__ import annotations

import dataclasses
import gc
import resource
import sys
import time

import numpy as np
import torch

from flipbench import check, devtrace, loops, spec, work
from flipbench.reference import Reference

# top-level module names that may not be loaded in a run: the JAX stack,
# the JAX package (`repro`; the port is `repro_torch`) and the JAX
# package's benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(names) -> list[str]:
    """Whole top-level names among `names` that are forbidden."""
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[flipbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""
    cell: spec.Cell
    raw: object                     # RawGraph
    device: torch.device
    setup_s: float
    window_s: float = 0.0
    queries: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)
    trace: devtrace.DeviceTrace | None = None
    reference: Reference | None = None
    _work: tuple | None = None

    def traced_queries(self) -> list:
        return [q for q in self.queries if q.traced]

    def traced_work(self) -> tuple[int, int]:
        """(bytes, operations) that K1 needs over the traced calls, worked
        out from the reference's frontiers."""
        if self._work is None:
            per_tile = work.blocks_per_source_tile(self.raw)
            nbytes = ops = 0
            for q in self.traced_queries():
                _, _, tiles = self.reference.run(q.program, q.srcs,
                                                 record_tiles=True)
                b, o, _ = work.step_work(tiles.cpu().numpy(), per_tile)
                nbytes, ops = nbytes + b, ops + o
            self._work = (nbytes, ops)
        return self._work


def log_requests(plan: list, pumps: list) -> None:
    """The served window's spread, for reading a run's noise: latency,
    its two parts, the requests' steps and the pumps' times."""
    def ms(values, what):
        v = np.asarray(values, dtype=np.float64) * 1e3
        v = v[np.isfinite(v)]
        if v.size == 0:
            return f"{what} none"
        return (f"{what} p50 {np.median(v):.1f} mean {v.mean():.1f} p95 "
                f"{devtrace.percentile(v, 95):.1f} p99 "
                f"{devtrace.percentile(v, 99):.1f}")
    steps = np.asarray([r.steps for r in plan if r.ok])
    busy = np.asarray([d for d, _ in pumps])
    log(f"requests (ms): {ms([r.latency_s for r in plan], 'latency')}; "
        f"{ms([r.service_s for r in plan], 'service')}; "
        f"{ms([r.queue_wait_s for r in plan], 'queue wait')}, "
        f"{int(sum(r.queue_wait_s > 1e-3 for r in plan))} waited > 1 ms")
    if steps.size and busy.size:
        log(f"steps a request p50 {np.median(steps):.0f} p95 "
            f"{devtrace.percentile(steps, 95):.0f} max {steps.max()}; "
            f"{busy.size} pumps, {busy.sum():.3f} s in all, "
            f"{ms(busy, 'ms a pump')}")


def make_inputs(cell: spec.Cell, seed: int):
    """The raw graph and the independent random streams of a seed."""
    raw = spec.generator(cell.config["generator"]).generate(cell.config,
                                                            seed)
    warm, queries, sample = (np.random.default_rng(s) for s in
                             np.random.SeedSequence(seed).spawn(3))
    return raw, warm, queries, sample


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_process: float) -> dict:
    """Run `cell` once; returns the result line's object."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    traffic = cell.traffic
    log(f"{cell.name} seed {seed}: imports done "
        f"{time.perf_counter() - t_process:.3f} s in")
    raw, warm_rng, query_rng, sample_rng = make_inputs(cell, seed)
    log(f"graph n={raw.n} m={raw.m} made "
        f"{time.perf_counter() - t_process:.3f} s in")
    graph = raw.to_port()
    import flip_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier import frontier
    built = _build.library_path(frontier.SOURCE).exists()
    recorder = devtrace.Recorder(cuda) if trace else None
    closed = traffic["loop"] == "closed"
    if closed:
        program = flip_torch.compile(graph, traffic["program"],
                                     device=device)
        log(f"compiled {time.perf_counter() - t_process:.3f} s in")
        warm_src = loops.Sources(raw, warm_rng).draw(int(traffic["batch"]))
        program.query(int(warm_src[0]) if traffic.get("scalar")
                      else warm_src)
    else:
        from repro_torch.serving import AsyncGraphServer
        program = AsyncGraphServer(
            graph, batch=int(traffic["batch"]),
            segment_steps=int(traffic["segment_steps"]),
            cache_capacity=int(traffic["cache_capacity"]), device=device)
        warm_src = loops.Sources(raw, warm_rng).draw(
            len(traffic["programs"]))
        for algo, src in zip(sorted(traffic["programs"]), warm_src):
            program.submit(algo, int(src))
        program.drain()
        program.cache.clear()
    if recorder is not None:
        recorder.warm()
    if cuda:
        torch.cuda.synchronize(device)
    run = Run(cell=cell, raw=raw, device=device,
              setup_s=time.perf_counter() - t_process)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"set-up {run.setup_s:.3f} s (K1 library "
        f"{'found built' if built else 'built in this run'}); host peak "
        f"RSS {rss:.2f} GiB")

    sources = loops.Sources(raw, query_rng)
    if closed:
        sample = loops.Reservoir(int(traffic["check_queries"]), sample_rng)
        run.queries, run.window_s = loops.closed_loop(
            program, traffic, seconds, sources, sample, recorder)
        items = sample.items()
        attempted = sum(len(q.srcs) for q in run.queries)
        failed = sum(len(q.srcs) for q in run.queries if not q.converged)
        log(f"window {run.window_s:.3f} s: {len(run.queries)} calls, "
            f"{attempted} queries, steps per call median "
            f"{np.median([q.steps.max() for q in run.queries]):.0f}")
    else:
        plan = loops.arrivals(traffic, seconds, sources, query_rng)
        keep = set(sample_rng.choice(
            len(plan), min(len(plan), int(traffic["check_requests"])),
            replace=False).tolist())
        kept, lateness, pumps = loops.open_loop(program, traffic, seconds,
                                                plan, keep, recorder)
        run.requests, run.window_s = plan, float(seconds)
        items = [kept[j] for j in sorted(kept)]
        attempted = len(plan)
        failed = sum(not r.ok for r in plan)
        late_ms = np.asarray(lateness) * 1e3
        log(f"window {seconds:.3f} s: {attempted} requests at "
            f"{traffic['rate_per_s']} /s; generator lateness ms p50 "
            f"{np.median(late_ms):.3f} p95 "
            f"{devtrace.percentile(late_ms, 95):.3f} max "
            f"{late_ms.max():.3f}; longest pumps (ms at s): "
            + ", ".join(f"{d * 1e3:.1f} at {t:.2f}"
                        for d, t in sorted(pumps, reverse=True)[:5]))
        log_requests(plan, pumps)
    if recorder is not None:
        run.trace = recorder.read()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    run.reference = Reference(raw, device)
    wrong, answers = check.wrong_values(run.reference, items)
    numbers = {"wrong_values": wrong, "unanswered": failed}
    correct = check.verdict(numbers)
    log(f"check: {answers} sampled answers against the reference in "
        f"{time.perf_counter() - t_check:.3f} s")

    metrics = {}
    for m in cell.metrics:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = check.report(numbers)
    return out
