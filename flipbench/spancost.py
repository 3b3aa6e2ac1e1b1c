"""Traced runs of a cell with the port's spans on and off, in turns, on
the card: what the spans cost when a profiler turns them on, and where
the card's idle time goes by program span.

    python3 flipbench/spancost.py --workload road-ny.bfs1 --seed 7 \
        --seconds 10 --order on,off,off,on --trace-seconds 10

Each run is `harness.run_cell` with `--trace 1`, reporting the cell's
end-to-end metrics beside its per-layer ones. "on" is a `--trace 1` run
as the benchmark makes it (the profiler turns the layer spans on); "off"
keeps them off under the same profiler (`repro_torch.obs.enable(False)`);
"fine" records the loop's per-chunk spans too (`enable(True)`), for the
split inside the loop at their cost.
`--trace-seconds` replaces the mix's traced part, so that the whole
window can be traced and the end-to-end metric then reads the traced
stretch. Runs 2k and 2k + 1 share the seed `--seed` + k, so each pair
compares both settings on one graph and one stream of sources. Prints
one JSON line a run: its spans, metrics, idle seconds under each
innermost `flip.*` span and the port's counters over the run, with
`overrun_steps.batch` and `chunks_per_step.batch` read from the run's own
counts (the benchmark's readers count every fixpoint of the process). A
chip tool: the benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--order", default="on,off,off,on")
    p.add_argument("--trace-seconds", type=float, default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from flipbench import devtrace, harness, spans, spec
    from repro_torch import obs
    if not torch.cuda.is_available():
        print("spancost: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    kept = {}
    read = devtrace.Recorder.read

    def keep(self):
        kept["trace"] = read(self)
        return kept["trace"]

    devtrace.Recorder.read = keep
    for i, mode in enumerate(args.order.split(",")):
        cell = spec.find_cell(bench, args.workload, True)
        cell.metrics = [m for m in bench["end_to_end"]
                        if spec.applies(m, args.workload)] + cell.metrics
        torch.set_num_threads(int(cell.traffic.get("host_threads", 4)))
        if args.trace_seconds is not None:
            cell.traffic["trace_seconds"] = args.trace_seconds
        obs.enable({"on": None, "off": False, "fine": True}[mode])
        before = spans.counters()
        seed = args.seed + i // 2
        out = harness.run_cell(cell, seed, args.seconds, True, "cuda:0",
                               time.perf_counter())
        after = spans.counters()
        obs.enable(None)
        trace = kept.pop("trace")
        d = {k: after[k] - before[k] for k in after}
        metrics = {k: v["value"] for k, v in out["metrics"].items()}
        if cell.traffic["loop"] == "closed" and d["fixpoint.iterations"]:
            enq = d["fixpoint.steps_enqueued"]
            metrics["overrun_steps.batch"] = (
                100.0 * (enq - d["fixpoint.iterations"]) / enq)
            metrics["chunks_per_step.batch"] = (
                d["fixpoint.chunks"] / d["fixpoint.iterations"])
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "spans": mode, "correct": out["correct"],
            "metrics": metrics,
            "window_s": trace.window_s, "busy_s": trace.busy_s,
            "idle_under": spans.idle_under(trace),
            "counters": d,
            "device": out["device"]["kind"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
