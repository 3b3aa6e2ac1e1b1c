"""FLIP graph-workload launcher for the PyTorch/CUDA port.

The counterpart of `repro.launch.graph_run`, with the same flags and the
same ``[graph] ... correct vs reference: True`` self-check line. It runs
any registered program on a Table-4 dataset through
`flip_torch.compile(graph, algo, plan).query(...)`, on the CUDA device
unless ``--device cpu`` asks for the CPU:

  --engine jax     the local frontier engine (the flag keeps the
                   reference's spelling; here it is the port's engine)
  --mode data|op   FLIP packet-triggered vs classic-CGRA full sweep

Not ported yet, and rejected with the ROADMAP item that brings them:
``--engine sim`` and the FLIP mapping compiler (Queue 1 item 9; the port
tiles vertices in id order), ``--engine dist`` (item 10), ``--updates``
and ``--trace`` (item 3), ``--autotune`` (item 8).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo sssp \\
      --dataset LRN --engine jax --src 5
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo bfs \\
      --dataset LRN --engine jax --srcs 0,5,9,12 --mode op --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import api as flip
from repro_torch.algebra import ALGEBRAS
from repro_torch.graphs import make_dataset, reference

_NOT_PORTED = {
    "updates": "--updates (warm starts and updates: ROADMAP Queue 1 item 3)",
    "trace": "--trace (tracing: ROADMAP Queue 1 item 3)",
    "autotune": "--autotune (the autotuner: ROADMAP Queue 1 item 8)",
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="bfs", choices=sorted(ALGEBRAS))
    ap.add_argument("--dataset", default="LRN",
                    choices=["Tree", "SRN", "LRN", "Syn", "ExtLRN"])
    ap.add_argument("--engine", default="jax",
                    choices=["sim", "jax", "dist", "op"])
    ap.add_argument("--mode", default="data", choices=["data", "op"],
                    help="fabric mode of the engine")
    ap.add_argument("--graph-seed", type=int, default=0)
    ap.add_argument("--src", type=int, default=0)
    ap.add_argument("--srcs", default=None,
                    help="comma list of sources: batched multi-query run")
    ap.add_argument("--batch", type=int, default=0,
                    help="with --srcs: dispatch in fixed-size buckets of "
                         "this many queries (0 = one fixpoint over all "
                         "sources)")
    ap.add_argument("--compact", default="auto",
                    choices=["auto", "on", "off"],
                    help="frontier-compacted block streaming of the plain "
                         "version (auto = on for data mode); the CUDA "
                         "kernel always skips inactive blocks")
    ap.add_argument("--feature-dim", type=int, default=0,
                    help="feature width d of the vertex state: 0 adopts "
                         "the program's native width")
    ap.add_argument("--updates", default=None, metavar="FILE")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--effort", type=int, default=1,
                    help="mapping effort of the reference; unused until "
                         "the mapping compiler is ported")
    ap.add_argument("--trace", default=None, metavar="FILE")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch version)")
    args = ap.parse_args(argv)
    compact = {"auto": "auto", "on": True, "off": False}[args.compact]
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"{what} is not ported yet")
    try:
        plan = flip.plan_from_cli(args.engine, args.mode, compact=compact,
                                  batch=args.batch,
                                  feature_dim=args.feature_dim)
    except ValueError as e:                # --engine sim / dist
        raise SystemExit(str(e)) from None

    g = next(make_dataset(args.dataset, 1, seed0=args.graph_seed))
    print(f"[graph] {args.dataset}: |V|={g.n} |E|={g.m}")
    t0 = time.time()
    cq = flip.compile(g, args.algo, plan, device=args.device)
    print(f"[graph] compiled on {cq.device} in {time.time() - t0:.2f}s "
          f"({cq.engine.bg.bsrc.numel()} blocks of tile {plan.tile})")
    alg = ALGEBRAS[args.algo]

    if args.srcs:
        srcs = [int(s) for s in args.srcs.split(",")]
        t0 = time.time()
        res = cq.query(np.asarray(srcs))
        how = (f"{res.dispatches} dispatches of B={args.batch}"
               if args.batch else f"one batch of B={len(srcs)}")
        print(f"[graph] jax/{plan.mode}: {len(srcs)} queries via {how}, "
              f"per-query steps {list(map(int, res.steps))} "
              f"({time.time() - t0:.2f}s wall)")
        ok = True
        for s, out in zip(srcs, res.attrs):
            ref, _ = reference.run(args.algo, g, s)
            ok &= bool(alg.results_match(out, ref))
        print(f"[graph] correct vs reference: {ok}")
        return

    t0 = time.time()
    res = cq.query(args.src)
    print(f"[graph] jax/{plan.mode}: fixpoint in {res.steps} relaxation "
          f"steps ({time.time() - t0:.2f}s wall)")
    ref, _ = reference.run(args.algo, g, args.src)
    print(f"[graph] correct vs reference: "
          f"{alg.results_match(res.attrs, ref)}")


if __name__ == "__main__":
    main()
