"""FLIP graph-workload launcher for the PyTorch/CUDA port.

The counterpart of `repro.launch.graph_run`, with the same flags and the
same ``[graph] ... correct vs reference: True`` self-check line. It runs
any registered program on a Table-4 dataset, compiling a FLIP mapping
(`repro_torch.core.compile_mapping`, ``--effort``) on every run as the
reference does, through one of two execution layers:

  --engine jax     the local frontier engine (the flag keeps the
                   reference's spelling), through
                   `flip_torch.compile(graph, algo, plan, mapping=)`:
                   the mapping's vertex order becomes the tiling
  --engine sim     the cycle-level FLIP simulator (`core.simulate`) on
                   the host: simulated cycles, parallelism, MTEPS at
                   100 MHz and the speedups against the MCU and
                   op-centric CGRA baselines. Scalar programs with an
                   idempotent merge only (no pagerank), one --src
  --mode data|op   FLIP packet-triggered vs classic-CGRA full sweep
  --srcs / --batch a batched multi-query run; --batch B dispatches
                   through the bucket `serve_graph.GraphServer` in
                   buckets of B, as the reference does
  --updates FILE   replay JSON edge-mutation batches after the base
                   query, each re-solved warm (monotone batch) or from
                   scratch, with a single --src
  --trace FILE     write a Chrome-trace JSON: per-step frontier spans
                   for jax, the simulated per-cycle parallelism (through
                   `obs.from_sim`) for sim
  --autotune       let the plan autotuner pick tile / route / compaction
                   / bucket for this graph on this device (jax engine
                   only), consulting the tuning store
                   ($FLIP_TORCH_AUTOTUNE_DB); prints the tuner's choice

The default engine is ``jax`` on the CUDA device, where the reference's
is ``sim``: the port's entry points run on the card unless asked
otherwise (``--device cpu``). Not ported yet, and rejected with the
ROADMAP item that brings it: ``--engine dist`` (Queue 1 item 10).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo sssp \\
      --dataset LRN --engine jax --src 5
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo sssp \\
      --dataset SRN --engine sim --src 5
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo sssp \\
      --dataset SRN --engine jax --autotune --device cpu
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo bfs \\
      --dataset LRN --engine jax --srcs 0,5,9,12 --mode op --device cpu
  echo '[[0, 5, 0.5], [1, 40, 2.0]]' > upd.json
  PYTHONPATH=src python -m repro_torch.launch.graph_run --algo sssp \\
      --dataset SRN --src 3 --updates upd.json --trace trace.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch import api as flip
from repro_torch.algebra import ALGEBRAS
from repro_torch.core import baselines, compile_mapping, simulate
from repro_torch.graphs import make_dataset, reference
from repro_torch.obs import from_sim, write_chrome_trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="bfs", choices=sorted(ALGEBRAS))
    ap.add_argument("--dataset", default="LRN",
                    choices=["Tree", "SRN", "LRN", "Syn", "ExtLRN"])
    ap.add_argument("--engine", default="jax",
                    choices=["sim", "jax", "dist", "op"])
    ap.add_argument("--mode", default="data", choices=["data", "op"],
                    help="fabric mode of the jax engine")
    ap.add_argument("--graph-seed", type=int, default=0)
    ap.add_argument("--src", type=int, default=0)
    ap.add_argument("--srcs", default=None,
                    help="comma list of sources: batched multi-query run "
                         "(jax engine)")
    ap.add_argument("--batch", type=int, default=0,
                    help="with --srcs: dispatch through the bucket "
                         "serving front-end in fixed-size buckets of this "
                         "many queries (0 = one fixpoint over all "
                         "sources)")
    ap.add_argument("--compact", default="auto",
                    choices=["auto", "on", "off"],
                    help="frontier-compacted block streaming of the plain "
                         "version (auto = on for data mode); the CUDA "
                         "kernel always skips inactive blocks")
    ap.add_argument("--feature-dim", type=int, default=0,
                    help="feature width d of the vertex state: 0 adopts "
                         "the program's native width. jax engine only")
    ap.add_argument("--updates", default=None, metavar="FILE",
                    help="JSON file of streaming edge mutations: a list "
                         "of [u, v, w] entries (w = null deletes, "
                         "omitted w inserts with weight 1) or a list of "
                         "such batches, each re-solved incrementally "
                         "after the base query. jax engine only")
    ap.add_argument("--autotune", action="store_true",
                    help="let the plan autotuner pick the performance "
                         "knobs (tile / route / compaction / bucket) for "
                         "this graph on this device, consulting the "
                         "tuning store (FLIP_TORCH_AUTOTUNE_DB). jax "
                         "engine only; answers as the untuned plan does")
    ap.add_argument("--effort", type=int, default=1,
                    help="FLIP mapping effort: 0 = beam search only, 1 = "
                         "+ annealing, 2 = heavy")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write a Chrome-trace JSON (chrome://tracing / "
                         "Perfetto) of the run: per-step frontier spans "
                         "for the jax engine, simulated per-cycle "
                         "parallelism for sim")
    ap.add_argument("--device", default=None,
                    help="torch device of the jax engine (default: the "
                         "CUDA device; 'cpu' runs the plain PyTorch "
                         "version)")
    args = ap.parse_args(argv)
    args.compact = {"auto": "auto", "on": True, "off": False}[args.compact]
    if args.engine == "op":                # deprecated spelling
        args.engine, args.mode = "jax", "op"
    if args.engine == "dist":
        raise SystemExit("--engine dist (the distributed fixpoint: ROADMAP "
                         "Queue 1 item 10) is not ported yet")
    srcs = ([int(s) for s in args.srcs.split(",")]
            if args.srcs else None)
    if srcs is not None and args.engine == "sim":
        raise SystemExit("--srcs needs --engine jax (the cycle simulator "
                         "runs one query per sweep)")
    if args.batch and args.engine != "jax":
        raise SystemExit("--batch dispatches through the single-device "
                         "serving front-end; use it with --engine jax")
    if args.updates and (args.engine != "jax" or srcs is not None):
        raise SystemExit("--updates replays mutations through the "
                         "incremental engine; use it with --engine jax "
                         "and a single --src")
    if args.trace and args.batch:
        raise SystemExit("--trace traces one query/fixpoint; drop --batch "
                         "(use serve_graph --stats for serving telemetry)")
    if args.autotune and args.engine != "jax":
        raise SystemExit("--autotune tunes the single-device jax plan "
                         "(sim has no ExecutionPlan; the distributed "
                         "fixpoint is not tunable) -- use --engine jax")
    if args.engine == "sim" and (args.feature_dim > 1
                                 or ALGEBRAS[args.algo].feature_dim > 1):
        raise SystemExit("--engine sim runs scalar vertex state only; "
                         "vector programs / --feature-dim > 1 need "
                         "--engine jax")

    g = next(make_dataset(args.dataset, 1, seed0=args.graph_seed))
    print(f"[graph] {args.dataset}: |V|={g.n} |E|={g.m}")
    alg = ALGEBRAS[args.algo]
    t0 = time.time()
    mapping = compile_mapping(g, effort=args.effort, program=alg)
    print(f"[graph] FLIP compile {time.time() - t0:.2f}s  "
          f"avg routing length {mapping.avg_routing_length():.2f}")

    if srcs is not None:
        ok = _run_batched(args, g, mapping, srcs)
        print(f"[graph] correct vs reference: {ok}")
        return

    if args.engine == "sim":
        if not alg.sim_ok:
            raise SystemExit(
                f"--engine sim cannot run {args.algo} (non-idempotent "
                "merge); use --engine jax")
        r = simulate(mapping, alg, src=args.src)
        attrs = r.attrs
        if args.trace:
            tele = from_sim(r, freq_mhz=mapping.arch.freq_mhz)
            write_chrome_trace(args.trace, tele, name=f"sim:{args.algo}")
            print(f"[graph] trace: {len(tele.dispatches[0].trace)} "
                  f"cycle spans -> {args.trace}")
        mteps = g.m / (r.cycles / mapping.arch.freq_mhz)
        print(f"[graph] sim: {r.cycles} cycles "
              f"({r.cycles / mapping.arch.freq_mhz:.1f}us @100MHz), "
              f"parallelism avg={r.avg_parallelism:.1f} "
              f"max={r.max_parallelism}, {mteps:.0f} MTEPS, "
              f"pkt wait {r.avg_pkt_wait:.2f}cyc, swaps={r.swaps}")
        if args.algo in ("bfs", "sssp", "wcc"):   # calibrated baselines
            mcu = baselines.mcu_cycles(args.algo, g, args.src)
            cgra = baselines.cgra_cycles(args.algo, g, args.src)
            t_f = r.cycles / mapping.arch.freq_mhz
            print(f"[graph] speedup vs MCU {mcu.time_us / t_f:.1f}x, "
                  f"vs op-centric CGRA {cgra.time_us / t_f:.1f}x")
    else:
        plan = _cli_plan(args)
        t0 = time.time()
        cq = flip.compile(g, args.algo, plan, mapping=mapping,
                          device=args.device)
        print(f"[graph] compiled on {cq.device} in {time.time() - t0:.2f}s "
              f"({cq.engine.bg.bsrc.numel()} blocks of tile {plan.tile}, "
              "mapping order)")
        if cq.tune is not None:
            print(f"[graph] autotune"
                  f"{' (store hit)' if cq.tune.cached else ''}: "
                  f"{cq.tune.why}")
        t0 = time.time()
        res = cq.query(args.src, trace=bool(args.trace))
        attrs = res.attrs
        print(f"[graph] jax/{plan.mode}: fixpoint in {res.steps} "
              f"relaxation steps ({time.time() - t0:.2f}s wall)")
        if args.trace:
            _write_trace(args.trace, res, args.algo)
        if args.updates:
            cq, res = _replay_updates(args, cq, res)
            g, attrs = cq.graph, res.attrs

    ref, _ = reference.run(args.algo, g, args.src)
    print(f"[graph] correct vs reference: "
          f"{alg.results_match(attrs, ref)}")


def _cli_plan(args, **kw):
    """Fold the CLI knobs into one plan; --autotune sets the tuned flag
    so `compile` routes through the plan autotuner."""
    plan = flip.plan_from_cli(args.engine, args.mode, compact=args.compact,
                              feature_dim=args.feature_dim, **kw)
    if args.autotune:
        plan = dataclasses.replace(plan, tuned=True)
    return plan


def _run_batched(args, g, mapping, srcs) -> bool:
    """--srcs path: one batched fixpoint, or bucket-server dispatch."""
    t0 = time.time()
    if args.batch:
        from repro_torch.launch.serve_graph import GraphServer
        plan = _cli_plan(args, batch=args.batch)
        srv = GraphServer(g, plan=plan, mapping=mapping, device=args.device)
        reqs = srv.serve((args.algo, s) for s in srcs)
        outs = [r.result for r in reqs]
        steps = [r.steps for r in reqs]
        how = f"{srv.dispatches} serving dispatches of B={args.batch}"
    else:
        plan = _cli_plan(args)
        res = flip.compile(g, args.algo, plan, mapping=mapping,
                           device=args.device).query(
            np.asarray(srcs), trace=bool(args.trace))
        outs, steps = res.attrs, res.steps
        how = f"one batch of B={len(srcs)}"
        if args.trace:
            _write_trace(args.trace, res, args.algo)
    print(f"[graph] jax/{args.mode}: {len(srcs)} queries via {how}, "
          f"per-query steps {list(map(int, steps))} "
          f"({time.time() - t0:.2f}s wall)")
    ok = True
    for s, out in zip(srcs, outs):
        ref, _ = reference.run(args.algo, g, s)
        ok &= bool(ALGEBRAS[args.algo].results_match(out, ref))
    return ok


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
