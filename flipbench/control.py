"""Read a control: the reference put in the program's place, computed below
what the configuration states, on a cell's own graph and as many answers
as a run compares. Run on the card, at the cell's own size:

    python3 flipbench/control.py --workload road-ny.sssp8 \
        --control bf16 --seeds 11 12 13

For each seed it prints `wrong_values` of the control's answers against
the float32 reference: the number a run compares, whose limit is 0. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def sample_queries(cell, raw, query_rng):
    """As many (program, srcs) as a run of `cell` compares, drawn from the
    seed's query stream as the run draws its traffic."""
    from flipbench import loops
    t = cell.traffic
    sources = loops.Sources(raw, query_rng)
    if t["loop"] == "closed":
        return [(t["program"], sources.draw(int(t["batch"])))
                for _ in range(int(t["check_queries"]))]
    plan = loops.arrivals(t, 30.0, sources, query_rng)
    return [(r.algo, [r.src]) for r in plan[:int(t["check_requests"])]]


def read_control(cell, seed: int, control: str, device) -> dict:
    """The control's reading on one seed of `cell`."""
    from flipbench import check, harness
    from flipbench.reference import Reference
    raw, _, query_rng, _ = harness.make_inputs(cell, seed)
    ref = Reference(raw, device)
    items = [(p, s, None) for p, s in sample_queries(cell, raw, query_rng)]
    answers = check.control_answers(ref, items, control)
    wrong, n = check.wrong_values(ref, answers)
    return {"workload": cell.name, "seed": seed, "control": control,
            "answers": n, "wrong_values": wrong}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from flipbench import spec
    cell = spec.find_cell(spec.load_benchmark(), args.workload, False)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = read_control(cell, seed, args.control, args.device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
