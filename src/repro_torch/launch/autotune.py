"""Plan-autotuner sweep CLI: tune, show the evidence, fill the store.

    PYTHONPATH=src python -m repro_torch.launch.autotune --dataset LRN \\
        --algo bfs                           # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.autotune --n 4096 \\
        --deg 3 --algo sssp --no-measure --json tune.json --device cpu

The counterpart of the reference's ``tools/autotune.py``, with the same
flags plus ``--device``. Profiles the graph, sweeps the legal
ExecutionPlan candidates, prices each (measured capped segments by
default -- through the frontier-relax kernel on a CUDA device -- or the
analytic model with ``--no-measure``), prints the full score table, and
writes the chosen knobs to the tuning store (``--store`` /
$FLIP_TORCH_AUTOTUNE_DB / ~/.cache/flip/autotune_torch.json) so later
`flip_torch.compile(..., ExecutionPlan.auto(tuned=True))` sessions over
the same shape on the same device start tuned.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="sweep ExecutionPlan candidates for one graph")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--dataset", default=None,
                     choices=["Tree", "SRN", "LRN", "Syn", "ExtLRN"],
                     help="a Table-4 dataset (default: a power-law "
                          "graph of --n vertices)")
    src.add_argument("--n", type=int, default=4096,
                     help="power-law graph size when no --dataset")
    ap.add_argument("--deg", type=int, default=3,
                    help="power-law mean out-degree (m = deg * n)")
    ap.add_argument("--graph-seed", type=int, default=0)
    ap.add_argument("--algo", default="bfs")
    ap.add_argument("--feature-dim", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0,
                    help="base serving bucket width (0 = solo plan)")
    ap.add_argument("--seed", type=int, default=0,
                    help="probe-source seed (the tune is deterministic "
                         "in it)")
    ap.add_argument("--no-measure", action="store_true",
                    help="price everything through the analytic cost "
                         "model: no clocks, fully deterministic")
    ap.add_argument("--budget-s", type=float, default=2.0,
                    help="per-candidate measurement budget gate")
    ap.add_argument("--segment-steps", type=int, default=8)
    ap.add_argument("--sources", type=int, default=4)
    ap.add_argument("--store", default=None,
                    help="tuning-store path (default "
                         "FLIP_TORCH_AUTOTUNE_DB / "
                         "~/.cache/flip/autotune_torch.json)")
    ap.add_argument("--force", action="store_true",
                    help="re-sweep even on a store hit (result is "
                         "written back)")
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="also write the full TuneReport as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device to tune for (default: the CUDA "
                         "device; 'cpu' tunes the plain PyTorch version)")
    args = ap.parse_args(argv)

    from repro_torch.api.plan import ExecutionPlan
    from repro_torch.autotune import TuningStore, autotune
    from repro_torch.graphs import make_dataset, make_power_law

    if args.dataset:
        g = next(make_dataset(args.dataset, 1, seed0=args.graph_seed))
    else:
        g = make_power_law(args.n, args.deg * args.n,
                           seed=args.graph_seed)
    print(f"[autotune] graph: |V|={g.n} |E|={g.m} algo={args.algo}")

    store = TuningStore(args.store)
    base = ExecutionPlan(batch=args.batch, feature_dim=args.feature_dim)
    report = autotune(
        g, args.algo, base_plan=base, seed=args.seed, store=store,
        force=args.force, measure=not args.no_measure,
        budget_s=args.budget_s, segment_steps=args.segment_steps,
        sources=args.sources, device=args.device)

    prof = report.profile
    print(f"[autotune] profile: fp={prof.fingerprint()} "
          f"backend={prof.backend} device={prof.device_kind} "
          f"mean_density={prof.mean_density:.4f} d={prof.feature_dim}")
    if report.cached:
        print(f"[autotune] store hit ({store.path}): {report.why}")
    else:
        print(f"[autotune] {len(report.samples)} candidates "
              f"(seed={report.seed}):")
        rows = sorted(zip(report.samples, report.scores.values()),
                      key=lambda t: t[1])
        for s, score in rows:
            p = s.plan
            mark = "*" if p.key() == report.chosen.key() else " "
            print(f"  {mark} tile={p.tile:<4} relax={p.relax_mode:<10}"
                  f" compact={str(p.compact):<5} batch={p.batch:<4}"
                  f" {score:10.1f} us/step  [{s.source}]")
        print(f"[autotune] chosen: {report.why}")
        print(f"[autotune] stored -> {store.path}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=1)
        print(f"[autotune] report -> {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
