"""Find the highest request rate an open-loop mix sustains: serve it at
each rate for a while on one server, in one process, and report the
latency and the backlog. Run on the card:

    python3 flipbench/sweep.py --workload road-ny.serve --seed 5 \
        --seconds 20 --rates 8 12 16 20 24

A rate is sustained when the backlog (requests arrived and not yet
retired), averaged over the window's second half, is no larger than over
its first. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def backlog(plan, t: float) -> int:
    return sum(r.t_sched <= t < r.t_retire for r in plan)


def mean_backlog(plan, t0: float, t1: float) -> float:
    """The backlog sampled every 0.25 s over [t0, t1)."""
    import numpy as np
    return float(np.mean([backlog(plan, t)
                          for t in np.arange(t0, t1, 0.25)]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np

    from flipbench import devtrace, harness, loops, spec
    from repro_torch.serving import AsyncGraphServer
    cell = spec.find_cell(spec.load_benchmark(), args.workload, False)
    t = dict(cell.traffic)
    raw, warm_rng, query_rng, _ = harness.make_inputs(cell, args.seed)
    server = AsyncGraphServer(raw.to_port(), batch=int(t["batch"]),
                              segment_steps=int(t["segment_steps"]),
                              cache_capacity=int(t["cache_capacity"]),
                              device="cuda:0")
    for algo, src in zip(sorted(t["programs"]),
                         loops.Sources(raw, warm_rng).draw(len(t["programs"]))):
        server.submit(algo, int(src))
    server.drain()
    sources = loops.Sources(raw, query_rng)
    for rate in args.rates:
        t["rate_per_s"] = rate
        server.cache.clear()
        plan = loops.arrivals(t, args.seconds, sources, query_rng)
        t0 = time.monotonic()
        _, _, pumps = loops.open_loop(server, t, args.seconds, plan,
                                      set())
        lat = [r.latency_s * 1e3 for r in plan]
        start, half = plan[0].t_sched, args.seconds / 2
        first = mean_backlog(plan, start, start + half)
        second = mean_backlog(plan, start + half, start + 2 * half)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(plan),
            "failed": sum(not r.ok for r in plan),
            "latency_p50_ms": devtrace.percentile(lat, 50),
            "latency_p95_ms": devtrace.percentile(lat, 95),
            "service_p50_ms": float(np.median([r.service_s * 1e3
                                               for r in plan])),
            "backlog_first_half": first, "backlog_second_half": second,
            "drain_s": time.monotonic() - t0 - args.seconds,
            "longest_pumps_s": sorted(pumps, reverse=True)[:5]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
