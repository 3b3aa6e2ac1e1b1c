#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases (every failure raises and exits nonzero):
  1. device  -- the card's name, and its name and power limit from
                nvidia-smi;
  2. build   -- compile the CUDA frontier-relax kernel from the sources in
                this checkout (nvcc, sm_90a);
  3. kernel  -- hold the kernel against its plain PyTorch version,
                `frontier_relax_torch`, on the card: 4 semirings x dense /
                frontier-masked / empty states x B in {1, 8} x d in {1, 8},
                a destination tile with no block, a ragged vertex count,
                and full-size states of the main path's graph. min_plus,
                max_min and or_and must be bit-equal; plus_times within
                atol 1e-5 (summation order differs). Times the kernel and
                the plain version at the main path's shapes and computes
                the card's bound for the same work;
  4. main path -- a 262,144-vertex road network (the repo's generator at
                the Ext. LRN setting) through `flip_torch.compile(...)
                .query(...)` with the default plan and device: sssp over 8
                sources, bfs, and bfs with mode="op". Each result passes
                `QueryResult.check()` against the numpy oracles, and the
                kernel's launch count equals the fixpoint iterations;
                then sssp and bfs once more under torch.profiler: device
                time by kernel against the query's wall;
  5. programs -- pagerank, wcc, widest, reach, multi_bfs and labelprop on
                the 16,384-vertex Ext. LRN graph, each checked the same way.

The last lines are one JSON object describing each kernel and then
``{"ok": true, "device": {...}}``. Needs one CUDA card; without one it
exits 2 and prints no result. Imports nothing of JAX or of `repro`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import flip_torch  # noqa: E402
from repro_torch.algebra import ALGEBRAS  # noqa: E402
from repro_torch.graphs import make_road_network  # noqa: E402
from repro_torch.kernels.frontier import frontier as relax  # noqa: E402
from repro_torch.kernels.frontier.ops import (BlockedGraph,  # noqa: E402
                                              build_blocks,
                                              frontier_relax_torch)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 rate outside the tensor cores
FULL_N = 262_144              # DIMACS USA-road-d.NY scale (264,346 nodes)
PROGRAM_N = 16_384            # Ext. LRN, the paper's largest group
PLUS_TIMES_ATOL = 1e-5


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b|, with equal infinities counting as no error."""
    d = torch.where(a == b, 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def state(bg: BlockedGraph, b: int, d: int, density: str,
          rng: np.random.Generator):
    """(src_vals, carry) on the card: carry random, src_vals the carry
    where the frontier is active and the ⊕-identity elsewhere. density:
    'all' (every lane), 'sparse' (10% of source tiles, half their
    lanes), 'none'."""
    sr = bg.semiring
    shape = (b, bg.ntiles, bg.tile) + ((d,) if d > 1 else ())
    if sr.name == "or_and":
        carry = (rng.random(shape) < 0.5).astype(np.float32)
    else:
        carry = rng.uniform(0.5, 9.0, shape).astype(np.float32)
    if density == "all":
        mask = np.ones(shape, dtype=bool)
    elif density == "none":
        mask = np.zeros(shape, dtype=bool)
    else:
        tiles = rng.random((b, bg.ntiles)) < 0.1
        mask = rng.random(shape) < 0.5
        mask &= tiles.reshape(tiles.shape + (1,) * (len(shape) - 2))
    sv = np.where(mask, carry, np.float32(sr.zero)).astype(np.float32)
    dev = bg.device
    return torch.from_numpy(sv).to(dev), torch.from_numpy(carry).to(dev)


def work(bg: BlockedGraph, sv: torch.Tensor, d: int) -> dict:
    """Bytes and operations one relax step needs on these inputs: each
    active block read once (a block is active when some query's source
    tile holds a non-identity lane), the source values and carry read
    once, the output written once; 2 operations (⊗ and ⊕) per active
    (query, block, source lane, destination lane, feature)."""
    zero = bg.semiring.zero
    act = (sv != zero).reshape(sv.shape[0], bg.ntiles, -1).any(dim=-1)
    per_block = act[:, bg.bsrc.long()].sum(dim=0)          # (nb,) queries
    active_blocks = int((per_block > 0).sum())
    state_bytes = sv.numel() * 4
    nbytes = (active_blocks * bg.tile * bg.tile * 4 + 3 * state_bytes
              + bg.bsrc.numel() * 4 + bg.dst_start.numel() * 4)
    ops = int(per_block.sum()) * bg.tile * bg.tile * d * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"active_blocks": active_blocks, "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of `fn` over `reps` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(label: str, bg: BlockedGraph, sv, carry, d: int) -> float:
    """One kernel call against the plain version on the same inputs;
    raises unless bit-equal (idempotent ⊕) or within atol (plus_times)."""
    sr = bg.semiring
    out = relax.frontier_relax_cuda(sv, carry, bg.blocks, bg.bsrc,
                                    bg.dst_start, sr, feature_dim=d)
    torch.cuda.synchronize()
    ref = frontier_relax_torch(sv, carry, bg.blocks, bg.bsrc, bg.bdst, sr,
                               feature_dim=d)
    err = max_abs_err(out, ref)
    if sr.idempotent:
        ok = torch.equal(out, ref)
        rule = "bit-equal"
    else:
        ok = err <= PLUS_TIMES_ATOL
        rule = f"atol {PLUS_TIMES_ATOL:g}"
    log(f"kernel {label}: max|err| {err:.3e} ({rule}: {ok})")
    require(ok, f"kernel disagrees with the plain version: {label}")
    return err


def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        sys.exit(2)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"device {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    print(smi, flush=True)
    return {"platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    path, seconds, text = relax.build(verbose=True)
    regs = [ln.split(":", 1)[1].strip() for ln in text.splitlines()
            if "registers" in ln]
    log(f"built {path.name} in {seconds:.2f} s; ptxas: "
        f"{sorted(set(regs))}")
    relax._library()


def phase_kernel_small(rng) -> float:
    """All semirings, densities, B and d on a ragged 3,000-vertex graph,
    plus a smaller tile and the empty-destination layout."""
    errs = [0.0]
    g = make_road_network(3000, seed=0, delete_frac=0.56)   # 3000 % 128
    for algo in ("sssp", "widest", "reach", "pagerank"):
        bg = build_blocks(g, algo, tile=128, device="cuda")
        for density in ("all", "sparse", "none"):
            for b in (1, 8):
                for d in (1, 8):
                    sv, carry = state(bg, b, d, density, rng)
                    errs.append(compare(
                        f"{bg.semiring.name} n=3000 T=128 {density} "
                        f"B={b} d={d}", bg, sv, carry, d))
        sv, carry = state(bg, 3, 1, "sparse", rng)           # solo layout
        errs.append(compare(f"{bg.semiring.name} solo", bg, sv[0],
                            carry[0], 1))
    bg = build_blocks(g, "sssp", tile=32, device="cuda")
    sv, carry = state(bg, 8, 8, "sparse", rng)
    errs.append(compare("min_plus n=3000 T=32 sparse B=8 d=8", bg, sv,
                        carry, 8))
    # a destination tile no block writes keeps its carry
    t = 8
    empty = BlockedGraph(
        n=3 * t, tile=t, ntiles=3,
        blocks=torch.as_tensor(rng.uniform(1, 5, (1, t, t)).astype(
            np.float32), device="cuda"),
        bsrc=torch.tensor([2], dtype=torch.int32, device="cuda"),
        bdst=torch.tensor([0], dtype=torch.int32, device="cuda"),
        perm=np.arange(3 * t), inv_perm=np.arange(3 * t),
        algebra=ALGEBRAS["sssp"])
    for b in (1, 2):
        sv, carry = state(empty, b, 1, "all", rng)
        errs.append(compare(f"empty destination B={b}", empty, sv, carry,
                            1))
        out = relax.frontier_relax_cuda(sv, carry, empty.blocks, empty.bsrc,
                                        empty.dst_start, empty.semiring)
        require(torch.equal(out[:, 1:], carry[:, 1:]),
                "a destination with no block lost its carry")
    return max(errs)


def phase_kernel_full(bg: BlockedGraph, rng) -> tuple[float, dict]:
    """Full-size states of the main path's graph, and the timings at the
    main path's shapes (sssp over 8 queries, d = 1)."""
    errs = [0.0]
    for density in ("all", "sparse"):
        for b in (1, 8):
            for d in (1, 8):
                sv, carry = state(bg, b, d, density, rng)
                errs.append(compare(
                    f"min_plus n={FULL_N} {density} B={b} d={d}", bg, sv,
                    carry, d))
    sr = bg.semiring
    timing = {}
    for density in ("all", "sparse"):
        sv, carry = state(bg, 8, 1, density, rng)
        w = work(bg, sv, 1)
        ms = time_ms(lambda: relax.frontier_relax_cuda(
            sv, carry, bg.blocks, bg.bsrc, bg.dst_start, sr), reps=20)
        plain_ms = time_ms(lambda: frontier_relax_torch(
            sv, carry, bg.blocks, bg.bsrc, bg.bdst, sr), reps=3, warmup=1)
        log(f"time {density} B=8 d=1: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {w['bound_ms']:.4f} ms "
            f"({w['bound_by']}; {w['active_blocks']} of "
            f"{bg.bsrc.numel()} blocks active, {w['bytes']} B, "
            f"{w['ops']} ops)")
        timing[density] = dict(w, ms=ms, plain_ms=plain_ms)
    return max(errs), timing


def run_query(cq, srcs, label: str) -> int:
    """One query on the card; checks it against the oracle and that the
    kernel ran once per fixpoint iteration. Returns the launches."""
    relax.frontier_relax_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = cq.query(srcs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = relax.frontier_relax_cuda.launches
    steps = np.atleast_1d(r.steps)
    iters = int(steps.max())
    nq = steps.size
    bg = cq.engine.bg
    log(f"{label}: |V|={cq.graph.n} |E|={cq.graph.m} nb={bg.bsrc.numel()} "
        f"steps={steps.tolist()} wall {wall:.3f} s, {nq / wall:.3f} "
        f"queries/s, {wall / max(iters, 1) * 1e3:.4f} ms/step, "
        f"launches {launches}")
    require(launches == iters,
            f"{label}: {launches} kernel launches for {iters} fixpoint "
            "iterations -- the main path did not go through the kernel")
    t0 = time.perf_counter()
    require(r.check(), f"{label}: result disagrees with the numpy oracle")
    log(f"{label}: check() passed ({time.perf_counter() - t0:.1f} s)")
    return launches


def profile_query(cq, srcs, label: str) -> None:
    """Where one query's time goes on the card: device time by kernel
    (torch.profiler over the whole query) against the profiled wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = cq.query(srcs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")), reverse=True)
    iters = int(np.max(r.steps))
    if not rows:
        log(f"profile {label}: device time not measured (no device events)")
        return
    busy = sum(ms for ms, _, _ in rows)
    log(f"profile {label}: {iters} steps, profiled wall {wall_ms:.1f} ms, "
        f"device busy {busy:.1f} ms ({busy / wall_ms:.1%}), "
        f"{sum(c for _, c, _ in rows) / max(iters, 1):.1f} device ops/step")
    for ms, count, key in rows[:8]:
        log(f"  {ms:9.3f} ms {count:6d}x {ms / count * 1e3:8.2f} us  "
            f"{key[:90]}")


def main() -> None:
    device = phase_device()
    rng = np.random.default_rng(0)
    phase_build()
    err_small = phase_kernel_small(rng)

    t0 = time.perf_counter()
    g = make_road_network(FULL_N, seed=0, delete_frac=0.56)
    log(f"graph |V|={g.n} |E|={g.m} generated in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sssp = flip_torch.compile(g, "sssp")
    bg = sssp.engine.bg
    log(f"compiled sssp in {time.perf_counter() - t0:.1f} s: "
        f"{bg.bsrc.numel()} blocks, "
        f"{bg.blocks.numel() * 4 / 2**20:.1f} MiB on {bg.device}")
    require(bg.device.type == "cuda", "the default session is not on CUDA")
    err_full, timing = phase_kernel_full(bg, rng)

    # the main path: counts start at 0 here
    srcs = np.sort(rng.choice(g.n, size=8, replace=False))
    bfs = flip_torch.compile(g, "bfs")
    launches = run_query(sssp, srcs, "sssp x8")
    launches += run_query(bfs, 0, "bfs")
    launches += run_query(
        flip_torch.compile(g, "bfs", flip_torch.ExecutionPlan(mode="op")),
        0, "bfs/op")
    profile_query(sssp, srcs, "sssp x8")
    profile_query(bfs, 0, "bfs")

    g2 = make_road_network(PROGRAM_N, seed=0, delete_frac=0.56)
    for algo in ("pagerank", "wcc", "widest", "reach", "multi_bfs",
                 "labelprop"):
        launches += run_query(flip_torch.compile(g2, algo), 0, algo)

    t = timing["all"]
    print(json.dumps({"kernels": [{
        "name": "frontier_relax",
        "route": "cuda",
        "source": "src/repro_torch/kernels/frontier/csrc/frontier_relax.cu",
        "replaces": "src/repro/kernels/frontier/frontier.py:137",
        "launches": launches,
        "max_abs_err": max(err_small, err_full),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
