"""FLIP graph-workload launcher for the PyTorch/CUDA port.

The counterpart of `repro.launch.graph_run`, with the same flags and the
same ``[graph] ... correct vs reference: True`` self-check line. It runs
any registered program on a Table-4 dataset through
`flip_torch.compile(graph, algo, plan).query(...)`, on the CUDA device
unless ``--device cpu`` asks for the CPU:

  --engine jax     the local frontier engine (the flag keeps the
                   reference's spelling; here it is the port's engine)
  --mode data|op   FLIP packet-triggered vs classic-CGRA full sweep
  --updates FILE   replay JSON edge-mutation batches after the base
                   query, each re-solved warm (monotone batch) or from
                   scratch, with a single --src
  --trace FILE     write a Chrome-trace JSON of the query's per-step
                   frontier spans

Not ported yet, and rejected with the ROADMAP item that brings them:
``--engine sim`` and the FLIP mapping compiler (Queue 1 item 9; the port
tiles vertices in id order), ``--engine dist`` (item 10), ``--autotune``
(item 8). ``--batch`` dispatches through the session's buckets; the
reference's bucket `GraphServer` is not ported yet (item 5).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo sssp \\
      --dataset LRN --engine jax --src 5
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo bfs \\
      --dataset LRN --engine jax --srcs 0,5,9,12 --mode op --device cpu
  echo '[[0, 5, 0.5], [1, 40, 2.0]]' > upd.json
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo sssp \\
      --dataset SRN --src 3 --updates upd.json --trace trace.json
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import api as flip
from repro_torch.algebra import ALGEBRAS
from repro_torch.graphs import make_dataset, reference
from repro_torch.obs import write_chrome_trace


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
    ap.add_argument("--updates", default=None, metavar="FILE",
                    help="JSON file of streaming edge mutations: a list "
                         "of [u, v, w] entries (w = null deletes, "
                         "omitted w inserts with weight 1) or a list of "
                         "such batches, each re-solved incrementally "
                         "after the base query")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--effort", type=int, default=1,
                    help="mapping effort of the reference; unused until "
                         "the mapping compiler is ported")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write a Chrome-trace JSON (chrome://tracing / "
                         "Perfetto) of the query's per-step frontier "
                         "spans")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch version)")
    args = ap.parse_args(argv)
    compact = {"auto": "auto", "on": True, "off": False}[args.compact]
    if args.autotune:
        raise SystemExit("--autotune (the autotuner: ROADMAP Queue 1 item "
                         "8) is not ported yet")
    try:
        plan = flip.plan_from_cli(args.engine, args.mode, compact=compact,
                                  batch=args.batch,
                                  feature_dim=args.feature_dim)
    except ValueError as e:                # --engine sim / dist
        raise SystemExit(str(e)) from None
    if args.updates and args.srcs:
        raise SystemExit("--updates replays mutations through the "
                         "incremental engine; use it with a single --src")
    if args.trace and args.batch:
        raise SystemExit("--trace traces one query/fixpoint; drop --batch")

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
        res = cq.query(np.asarray(srcs), trace=bool(args.trace))
        how = (f"{res.dispatches} dispatches of B={args.batch}"
               if args.batch else f"one batch of B={len(srcs)}")
        print(f"[graph] jax/{plan.mode}: {len(srcs)} queries via {how}, "
              f"per-query steps {list(map(int, res.steps))} "
              f"({time.time() - t0:.2f}s wall)")
        if args.trace:
            _write_trace(args.trace, res, args.algo)
        ok = True
        for s, out in zip(srcs, res.attrs):
            ref, _ = reference.run(args.algo, g, s)
            ok &= bool(alg.results_match(out, ref))
        print(f"[graph] correct vs reference: {ok}")
        return

    t0 = time.time()
    res = cq.query(args.src, trace=bool(args.trace))
    print(f"[graph] jax/{plan.mode}: fixpoint in {res.steps} relaxation "
          f"steps ({time.time() - t0:.2f}s wall)")
    if args.trace:
        _write_trace(args.trace, res, args.algo)
    if args.updates:
        cq, res = _replay_updates(args, cq, res)
    ref, _ = reference.run(args.algo, cq.graph, args.src)
    print(f"[graph] correct vs reference: "
          f"{alg.results_match(res.attrs, ref)}")


def _write_trace(path, res, algo):
    """Write a traced QueryResult as Chrome-trace JSON and print the
    telemetry summary line."""
    write_chrome_trace(path, res, name=f"query:{algo}")
    s = res.telemetry.summary()
    print(f"[graph] trace: {s['traced_steps']} step spans over "
          f"{s['dispatches']} dispatch(es), mean active-tile fraction "
          f"{s['mean_active_tile_fraction']:.3f}, compile "
          f"{res.compile_s:.2f}s -> {path}")


def _load_update_batches(path):
    """JSON `--updates` file: a single batch (list of [u, v, w?] entries,
    w = null deletes, omitted w = 1.0) or a list of such batches."""
    with open(path) as f:
        data = json.load(f)

    def is_update(e):
        return (isinstance(e, list) and 2 <= len(e) <= 3
                and all(isinstance(x, (int, float)) for x in e[:2])
                and (len(e) == 2 or e[2] is None
                     or isinstance(e[2], (int, float))))

    if not isinstance(data, list) or not data:
        raise SystemExit("--updates: JSON must be a non-empty list")
    if all(is_update(e) for e in data):        # one flat batch
        data = [data]
    elif not all(isinstance(b, list) and all(is_update(e) for e in b)
                 for b in data):
        raise SystemExit(
            "--updates: entries must be [u, v] / [u, v, w] / [u, v, null]"
            " triples, or a list of batches of them")
    return [[(int(e[0]), int(e[1]),
              (1.0 if len(e) < 3 else
               (None if e[2] is None else float(e[2]))))
             for e in batch] for batch in data]


def _replay_updates(args, cq, res):
    """Apply each update batch and re-solve: the session resumes from
    the previous fixpoint when the batch is monotone under the algebra
    and recomputes from scratch otherwise (the plan's warm='auto')."""
    for i, batch in enumerate(_load_update_batches(args.updates)):
        t0 = time.time()
        cq, delta = cq.update(batch)
        res = cq.query(args.src, warm=res)
        print(f"[graph] update[{i}]: {len(batch)} edges -> "
              f"{delta.n_blocks_rebuilt} tiles rebuilt"
              f"{' (shape changed)' if delta.shape_changed else ''}, "
              f"{'warm' if delta.monotone else 'full'} recompute in "
              f"{res.steps} steps ({time.time() - t0:.2f}s, "
              f"{len(delta.affected_src)} vertices affected)")
    return cq, res


if __name__ == "__main__":
    main()
