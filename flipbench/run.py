"""Run one cell of BENCHMARK.json once, from the checkout's root:

    python3 flipbench/run.py --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Prints the result as one JSON line, the last of standard output, and the
numbers compared against the reference, each beside its limit, as the
last lines of standard error. Exits non-zero, printing no result, when
no CUDA device is present, when the cell asks for more cards than there
are, when the program (`src/repro_torch`) is not in the checkout, or
when a module of the JAX stack or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the checkout's own compile caches, at fixed paths: only a cell's first
# run in a checkout builds
CACHE = ROOT / ".flipbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - process_age_s()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("flipbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    print(f"[flipbench] torch imported {time.perf_counter() - T_PROCESS:.3f}"
          " s in", file=sys.stderr)

    from flipbench import harness, spec
    if not torch.cuda.is_available():
        print("flipbench: no CUDA device; the benchmark measures the card "
              "only", file=sys.stderr)
        return 2
    cell = spec.find_cell(spec.load_benchmark(), args.workload,
                          bool(args.trace))
    if torch.cuda.device_count() < cell.chips:
        print(f"flipbench: {cell.name} needs {cell.chips} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # host threads for torch's CPU work: a mix may ask for fewer
    torch.set_num_threads(int(cell.traffic.get("host_threads", 4)))
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_PROCESS)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"flipbench: forbidden modules loaded in this run: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
