#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases (every failure raises and exits nonzero):
  1. device  -- the card's name, and its name and power limit from
                nvidia-smi;
  2. build   -- compile the CUDA kernels (frontier relax, flash attention
                on the CUDA cores and on the tensor cores, SSD
                intra-chunk) from the sources in this checkout, one nvcc
                each, all at once (sm_90a); log ptxas registers, spills
                and warnings, and fail if the tensor-core attention kernel
                or any function of the SSD kernel spills, if the attention
                kernel's wgmma is serialized (C7510) or its setmaxnreg
                ignored (C7508), or if the SSD kernel's SASS waits after
                every wgmma;
  3. kernel  -- hold the kernel against its plain PyTorch version,
                `frontier_relax_torch`, on the card: 4 semirings x dense /
                frontier-masked / empty states x B in {1, 8} x d in {1, 8},
                min_plus, max_min and or_and at the tuner's tiles 64 and
                256 (dense and masked, B in {1, 8}, d in {1, 8}; T=256
                with d=8 needs 64 KiB of shared memory, past the default),
                a destination tile with no block, a ragged vertex count,
                and full-size states of the main path's graph; NaN in a
                weight block, a source lane and a carry lane for min_plus,
                max_min and or_and at B in {1, 8}. min_plus, max_min and
                or_and must be bit-equal, NaN positions included; plus_times
                within atol 1e-5 (summation order differs). Times the kernel and
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
                the 16,384-vertex Ext. LRN graph, each checked the same way;
  6. attention kernel -- flash attention against `attention_ref` on the
                card: causal x window {None, 128} x GQA ratio {1, 2, 8} x
                {f32, bf16} x hd {64, 128, 256}, ragged lengths (S=200 and
                S=5, shorter than one tile), and
                qwen3-0.6b's layer at B=1, S=4096 (f32 atol 2e-5, bf16 atol
                2e-2 against the f32 reference, and at that layer also a
                relative Frobenius error of 1e-2); each case logs its route
                ("wgmma": bf16 at hd 64-256 on the tensor cores; "fma": the
                CUDA cores) and must have taken `flash.route`'s. Timed at
                the prefill shape: the wgmma kernel beside the CUDA-core
                kernel at the same shape, the plain version and SDPA
                (yardstick only);
  7. SSD kernel -- logs the kernel's route (3xTF32 tensor-core products,
                the head group sharing one G panel); holds the
                intra-chunk kernel against `ssd_intra_ref` (and
                `ssd_cuda` against `ssd_ref`) at the reference tests'
                shapes (chunk 16), a ragged chunk (100), N=20 / P=12 /
                chunk 72 (no multiple of 8, 16 or 64), N=5 / P=6 /
                chunk 48 (4-byte staging), P over 64 (two 64-column
                slots per head: P=100, 70, 128), a strong-decay case (cums
                below -500 inside a chunk, where a factored exp
                overflows) and mamba2-370m's shape, at atol 1e-4 x
                max(1, max|ref|); timed beside its plain version, with
                the route's bound (3xTF32 tensor cores) and the f32
                CUDA-core bound;
  8. LM paths -- for qwen3-0.6b and mamba2-370m at full width in bf16: a
                B=4 x 4,096 prefill through `make_prefill_step` (kernel
                launches = layers x prefills; for qwen3 every one on the
                wgmma route), the float32 prefill of a
                256-token prompt against a token-by-token `decode_step`
                replay (rtol 2e-2, atol 2e-3), `launch.serve.main` with 8
                slots answering 16 requests, one profiled prefill and one
                profiled decode step at 8 slots;
  9. updates -- on phase 4's road network: sssp x8, then a monotone edge
                batch (64 weights halved, 4 two-hop shortcuts) through
                `cq.update`; the warm query must equal the scratch query
                bit for bit and pass `check()`; then 16 deletions: warm
                'auto' recomputes from scratch and passes `check()`,
                'always' raises. Logs update() seconds, blocks rebuilt,
                warm/scratch steps and walls;
 10. trace   -- sssp x8 and bfs with `trace=True` equal their untraced
                results bit for bit; one trace row per step, fetched +
                skipped = every block on each row; the Chrome trace is
                written and read back. Logs the traced/untraced wall
                ratio and blocks fetched per step;
 11. serving -- `AsyncGraphServer(batch=8, segment_steps=4)` on the real
                clock over bfs + sssp: a seeded Zipf (s = 1.1) stream of
                64 requests over 24 sources, one monotone update, 32 more.
                Every request is ok (none failed or shed) and equals one
                batched query per algebra and graph version bit for bit,
                two per version pass `check()`, warm starts follow the
                update, every lane state lives on the card, and the
                kernel's launches equal the windows' iterations. Logs
                queries/s, latency and queue-wait quantiles, occupancy,
                cache hit rate, and a profiled 16-request burst.

 12. mapping -- the FLIP mapping compiler and cycle simulator on the Table-4
                LRN graph (seed 0) for bfs, sssp and wcc: `compile_mapping`
                (effort 1), then `simulate` from vertex 0, which must match
                the oracle; logs simulated FLIP cycles at 100 MHz (a model
                of the CGRA fabric computed on the host, never a time on
                the card), parallelism, and the MCU and op-centric CGRA
                speedups. Then `flip_torch.compile(g, algo, plan,
                mapping=m)` on the card at tile 128 and 32 over 8 sources:
                bit-equal to the id-order session, `check()` passes, block
                counts logged under both orders; and `graph_run.main` with
                `--engine sim` and `--engine jax` on SRN, each printing
                `correct vs reference: True`;
 13. bucket server -- `GraphServer(batch=8)` over bfs + sssp on phase 4's
                network with a started `HeartbeatMonitor(timeout_s=0.5)`
                and `FaultInjector.random(seed=0, rate=0.25, stall_s=1.0)`
                plus one pinned NaN and one pinned stall: a Zipf stream of
                48 requests with a monotone update in the middle. Every
                request is ok and equals one batched query per algebra and
                graph version bit for bit; `faults_fired` equals the
                schedule, every raise and NaN is served by rung 1 (the
                finite guard trips on the NaN), the heartbeat flags every
                stall, and the ladder is [cuda+compact, cuda+dense]. Then
                the 6-vertex NaN graph (card == CPU, NaN positions
                included) and a copy of the network with one NaN weight
                go through servers where every rung trips the finite
                guard and every request carries a typed BackendFailure.
 14. autotune -- the plan autotuner on phase 4's network, with a tuning
                store in a fresh temporary directory: `autotune(g, "sssp",
                budget_s=None)` measures all three candidates (tile 64 /
                128 / 256 on the cuda route) by timing capped segments
                through the kernel; its chosen plan answers phase 4's
                sssp x8 bit for bit, steps included, and passes `check()`.
                `compile(g, "bfs", ExecutionPlan.auto(tuned=True,
                batch=8))` tunes under the default budget (logs which
                candidates the gate measured), answers 8 sources as the
                untuned session does, traced too, with `meta["autotune"]`
                on every dispatch record; a second compile is a store hit
                with no kernel launch. Then `graph_run --autotune` on SRN
                prints `correct vs reference: True`. Logs each candidate's
                us/step, best segment wall, blocks and the gate's estimate.

In phases 4, 5 and 9-14 every fixpoint step is one launch of the
frontier-relax kernel: each path resets the launch count before it runs
and requires launches = iterations after it (for the bucket servers, the
iterations of every dispatch, retries included; for a tuning sweep, one
warm-up and three timed segments per measured engine, which prices
every bucket width on it).

The last lines are one JSON object describing each kernel and then
``{"ok": true, "device": {...}}``. Needs one CUDA card; without one it
exits 2 and prints no result. Imports nothing of JAX or of `repro`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import flip_torch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.algebra import ALGEBRAS  # noqa: E402
from repro_torch.autotune import (TuningStore, autotune,  # noqa: E402
                                  profile_graph)
from repro_torch.autotune import measure as at_measure  # noqa: E402
from repro_torch.autotune.tuner import DEFAULT_BUDGET_S  # noqa: E402
from repro_torch.core import (baselines, compile_mapping,  # noqa: E402
                              mapping_order, simulate)
from repro_torch.distributed.health import HeartbeatMonitor  # noqa: E402
from repro_torch.graphs import (Graph, make_dataset,  # noqa: E402
                                make_road_network, reference)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import flash  # noqa: E402
from repro_torch.kernels.attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.frontier import frontier as relax  # noqa: E402
from repro_torch.kernels.frontier.ops import (BlockedGraph,  # noqa: E402
                                              build_blocks,
                                              frontier_relax_torch)
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import (chunk_inputs,  # noqa: E402
                                         ssd_intra_ref, ssd_ref)
from repro_torch.launch import graph_run, serve, steps  # noqa: E402
from repro_torch.launch.serve_graph import GraphServer  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.obs import write_chrome_trace  # noqa: E402
from repro_torch.resilience import (BackendFailure,  # noqa: E402
                                    FaultInjector, FaultSpec,
                                    fallback_chain)
from repro_torch.serving import AsyncGraphServer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
TF32_OPS_PER_S = 495e12       # H100 SXM dense TF32 tensor-core rate
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


def compare(label: str, bg: BlockedGraph, sv, carry, d: int,
            blocks: torch.Tensor | None = None) -> float:
    """One kernel call against the plain version on the same inputs;
    raises unless bit-equal (idempotent ⊕; NaN positions equal and the
    rest equal) or within atol (plus_times). `blocks` replaces the
    layout's weight blocks (the NaN cases)."""
    sr = bg.semiring
    w = bg.blocks if blocks is None else blocks
    out = relax.frontier_relax_cuda(sv, carry, w, bg.bsrc, bg.dst_start, sr,
                                    feature_dim=d)
    torch.cuda.synchronize()
    ref = frontier_relax_torch(sv, carry, w, bg.bsrc, bg.bdst, sr,
                               feature_dim=d)
    nan = torch.isnan(ref)
    err = max_abs_err(out[~nan], ref[~nan])
    if sr.idempotent:
        ok = torch.equal(torch.isnan(out), nan) and torch.equal(
            out[~nan], ref[~nan])
        rule = "bit-equal"
        if bool(nan.any()):
            rule += f", {int(nan.sum())} NaN at equal positions"
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


def demangle(names: list[str]) -> list[str]:
    """Kernel names as `flash_fwd<float, (int)16>`, through the toolkit's
    cu++filt (the mangled names where it is missing)."""
    filt = Path(_build.nvcc()).parent / "cu++filt"
    if not filt.exists():
        return names
    out = subprocess.run([str(filt)], input="\n".join(names),
                         capture_output=True, text=True, timeout=60).stdout
    short = []
    for sig in out.splitlines():
        sig = sig.replace("(anonymous namespace)::", "").removeprefix("void ")
        depth = 0
        for i, ch in enumerate(sig):       # cut at the parameter list
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0:
                sig = sig[:i]
                break
        short.append(sig)
    return short if len(short) == len(names) else names


def wgmma_waits(library: Path) -> dict:
    """Per kernel of a built library, (HGMMA, WARPGROUP.DEPBAR) counts in
    its SASS, through the toolkit's cuobjdump. A wait after every HGMMA
    means ptxas serialized the wgmma batch."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    require(tool.exists(), f"no {tool}: the SSD kernel's wgmma batches "
            "cannot be checked")
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    names, counts = [], []
    for ln in sass.splitlines():
        if "Function :" in ln:
            names.append(ln.split("Function :", 1)[1].strip())
            counts.append([0, 0])
        elif names and "HGMMA" in ln:
            counts[-1][0] += 1
        elif names and "WARPGROUP.DEPBAR" in ln:
            counts[-1][1] += 1
    return dict(zip(demangle(names), map(tuple, counts)))


def phase_build() -> None:
    sources = (relax.SOURCE, flash.SOURCE, flash.WGMMA_SOURCE, ssd.SOURCE)
    t0 = time.perf_counter()
    for source, (path, seconds, text) in zip(
            sources, _build.build_all(sources, verbose=True)):
        log(f"built {path.name} in {seconds:.2f} s; ptxas:")
        names, props = [], []
        for ln in text.splitlines():
            if "warning" in ln:
                log(f"  {ln.strip()}")
            if "Compiling entry function" in ln:
                names.append(ln.split("'")[1])
                props.append([])
            elif names and ("spill" in ln or "registers" in ln):
                props[-1].append(ln.split(":", 1)[-1].strip())
        for name, prop in zip(demangle(names), props):
            log(f"  {name}: {'; '.join(prop)}")
        if source == flash.WGMMA_SOURCE:
            require("C7510" not in text and "C7508" not in text,
                    f"{source.name}: ptxas serialized wgmma (C7510) or "
                    "ignored setmaxnreg (C7508)")
        if source in (flash.WGMMA_SOURCE, ssd.SOURCE):
            require(" 0 bytes spill stores" in text
                    and text.count("spill stores") == text.count(
                        " 0 bytes spill stores"),
                    f"{source.name}: ptxas reports spills")
        if source == ssd.SOURCE:
            # ptxas gives no C7510 when it serializes these wgmma (a
            # register-A operand): only the SASS shows it
            waits = wgmma_waits(path)
            for name, (n_mma, n_wait) in waits.items():
                if n_mma:
                    log(f"  {name}: {n_mma} HGMMA, {n_wait} wgmma waits in "
                        "the SASS")
                    require(2 * n_wait < n_mma,
                            f"{source.name}: ptxas serialized the wgmma "
                            f"of {name} (a wait after each)")
    log(f"all kernels built in {time.perf_counter() - t0:.2f} s")
    relax._library()
    flash._library("fma")
    flash._library("wgmma")
    ssd._library()


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
    errs.append(tile_cases(g))
    errs.append(nan_cases(g))
    return max(errs)


def tile_cases(g) -> float:
    """The autotuner's other tiles (phase 14 runs the kernel at 64 and
    256 too): min_plus, max_min and or_and at T in {64, 256}, dense and
    frontier-masked, B in {1, 8}, d in {1, 8}. At T=256 and d=8 a block
    stages 8 queries x 256 lanes x 8 features, 64 KiB, which is past the
    48 KiB default and takes the opt-in to more shared memory. Draws
    from a generator of its own, so the later phases' seeded draws are
    those of earlier PRs."""
    rng = np.random.default_rng(2)
    errs = []
    for tile in (64, 256):
        for algo in ("sssp", "widest", "reach"):
            bg = build_blocks(g, algo, tile=tile, device="cuda")
            for density in ("all", "sparse"):
                for b in (1, 8):
                    for d in (1, 8):
                        sv, carry = state(bg, b, d, density, rng)
                        errs.append(compare(
                            f"{bg.semiring.name} n=3000 T={tile} {density} "
                            f"B={b} d={d}", bg, sv, carry, d))
    return max(errs)


def nan_cases(g) -> float:
    """NaN must propagate through the kernel as through the plain version
    (torch.minimum/maximum): a NaN weight, a NaN source lane and a NaN
    carry lane, for the three min/max semirings at B in {1, 8}. The NaN
    weight sits in a block every query relaxes (all lanes active): the
    kernel skips an inactive source tile per query, the dense plain
    version does not, and a NaN weight is the one operand for which
    ``zero ⊗ w != zero``. Draws from a generator of its own, so the
    later phases' seeded draws are those of earlier PRs."""
    rng = np.random.default_rng(1)
    errs = []
    for algo in ("sssp", "widest", "reach"):
        bg = build_blocks(g, algo, tile=128, device="cuda")
        name = bg.semiring.name
        for b in (1, 8):
            sv, carry = state(bg, b, 1, "all", rng)
            w = bg.blocks.clone()
            i = int(rng.integers(w.shape[0]))
            w[i, int(rng.integers(bg.tile)), int(rng.integers(bg.tile))] = \
                float("nan")
            errs.append(compare(f"{name} NaN weight B={b}", bg, sv, carry,
                                1, blocks=w))
            sv, carry = state(bg, b, 1, "sparse", rng)
            q, t = int(rng.integers(b)), int(rng.integers(bg.ntiles))
            sv[q, t, int(rng.integers(bg.tile))] = float("nan")
            errs.append(compare(f"{name} NaN source lane B={b}", bg, sv,
                                carry, 1))
            sv, carry = state(bg, b, 1, "sparse", rng)
            carry[int(rng.integers(b)), int(rng.integers(bg.ntiles)),
                  int(rng.integers(bg.tile))] = float("nan")
            errs.append(compare(f"{name} NaN carry lane B={b}", bg, sv,
                                carry, 1))
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


def counted_query(cq, srcs, label: str, **kw):
    """One query on the card with the kernel's count set to 0 just
    before it; requires one launch per fixpoint iteration. Returns
    ``(result, wall_s, launches)``."""
    relax.frontier_relax_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = cq.query(srcs, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = relax.frontier_relax_cuda.launches
    iters = int(np.max(r.steps))
    require(launches == iters,
            f"{label}: {launches} kernel launches for {iters} fixpoint "
            "iterations -- the path did not go through the kernel")
    return r, wall, launches


def check(r, label: str) -> None:
    t0 = time.perf_counter()
    require(r.check(), f"{label}: result disagrees with the numpy oracle")
    log(f"{label}: check() passed ({time.perf_counter() - t0:.1f} s)")


def run_query(cq, srcs, label: str):
    """One query on the card; checks it against the oracle and that the
    kernel ran once per fixpoint iteration. Returns ``(launches,
    result)``."""
    r, wall, launches = counted_query(cq, srcs, label)
    steps = np.atleast_1d(r.steps)
    iters = int(steps.max())
    bg = cq.engine.bg
    log(f"{label}: |V|={cq.graph.n} |E|={cq.graph.m} nb={bg.bsrc.numel()} "
        f"steps={steps.tolist()} wall {wall:.3f} s, {steps.size / wall:.3f} "
        f"queries/s, {wall / max(iters, 1) * 1e3:.4f} ms/step, "
        f"launches {launches}")
    check(r, label)
    return launches, r


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


# ------------------------------------------------------------------ #
# the graph-serving surface: updates (9), tracing (10), serving (11)
# ------------------------------------------------------------------ #
def monotone_batch(g, rng, reweights: int = 64, inserts: int = 4):
    """Weights halved on `reweights` random existing edges, plus
    `inserts` new two-hop shortcuts u -> x (x a neighbour's neighbour,
    not adjacent to u) at 0.9 x the two-hop length: a road batch of
    repaired and new segments, ⊕-improving under min_plus."""
    eu = g.edge_sources()
    idx = rng.choice(g.m, size=reweights, replace=False)
    batch = [(int(eu[i]), int(g.indices[i]), float(g.weights[i]) * 0.5)
             for i in idx]
    while len(batch) < reweights + inserts:
        u = int(rng.integers(g.n))
        nbr, w1 = g.neighbors(u), g.edge_weights(u)
        if nbr.size == 0:
            continue
        j = int(rng.integers(nbr.size))
        v = int(nbr[j])
        far, w2 = g.neighbors(v), g.edge_weights(v)
        k = int(rng.integers(far.size))
        x = int(far[k])
        if x != u and x not in set(nbr.tolist()):
            batch.append((u, x, 0.9 * float(w1[j] + w2[k])))
    return batch


def phase_updates(sssp, srcs, rng) -> int:
    """Phase 9 (module docstring). Returns the kernel's launches."""
    label = f"update sssp x{len(srcs)}"
    r, _, launches = counted_query(sssp, srcs, f"{label} base")
    batch = monotone_batch(sssp.graph, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cq2, delta = sssp.update(batch)
    torch.cuda.synchronize()
    upd_s = time.perf_counter() - t0
    require(delta.monotone and not delta.shape_changed,
            f"{label}: the reweight + shortcut batch is not a monotone "
            f"value-only update ({delta.monotone}, {delta.shape_changed})")
    w, w_wall, n = counted_query(cq2, srcs, f"{label} warm", warm=r)
    launches += n
    s, s_wall, n = counted_query(cq2, srcs, f"{label} scratch")
    launches += n
    require(np.array_equal(w.attrs, s.attrs),
            f"{label}: warm and scratch results differ")
    log(f"{label}: monotone batch of {len(batch)} edges, update() "
        f"{upd_s:.3f} s, {delta.n_blocks_rebuilt} blocks rebuilt, "
        f"shape_changed {delta.shape_changed}, "
        f"{delta.affected_src.size} sources seeded; warm steps "
        f"{np.asarray(w.steps).tolist()} in {w_wall:.3f} s vs scratch "
        f"{np.asarray(s.steps).tolist()} in {s_wall:.3f} s; launches = "
        "iterations on every query")
    check(w, f"{label} warm (bit-equal to scratch)")

    eu = cq2.graph.edge_sources()
    idx = rng.choice(cq2.graph.m, size=16, replace=False)
    dels = [(int(eu[i]), int(cq2.graph.indices[i]), None) for i in idx]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cq3, delta3 = cq2.update(dels)
    torch.cuda.synchronize()
    upd3_s = time.perf_counter() - t0
    require(not delta3.monotone,
            f"{label}: a batch of deletions reads as monotone")
    w3, w3_wall, n = counted_query(cq3, srcs, f"{label} after deletes",
                                   warm=w)
    launches += n
    log(f"{label}: 16 deletions, update() {upd3_s:.3f} s, "
        f"{delta3.n_blocks_rebuilt} blocks rebuilt, shape_changed "
        f"{delta3.shape_changed}; warm='auto' recomputed from scratch in "
        f"{np.asarray(w3.steps).tolist()} steps, {w3_wall:.3f} s")
    check(w3, f"{label} after deletes")
    always = dataclasses.replace(cq3, plan=dataclasses.replace(
        cq3.plan, warm="always"))
    try:
        always.query(srcs, warm=w)
    except ValueError as e:
        log(f"{label}: warm='always' refused the deletions: {e}")
    else:
        raise RuntimeError(f"{label}: warm='always' resumed across a "
                           "non-monotone batch")
    return launches


def phase_trace(sssp, bfs, srcs) -> int:
    """Phase 10 (module docstring). Returns the kernel's launches."""
    launches = 0
    for cq, q, label in ((sssp, srcs, f"trace sssp x{len(srcs)}"),
                         (bfs, 0, "trace bfs")):
        r, wall, n = counted_query(cq, q, f"{label} untraced")
        rt, t_wall, nt = counted_query(cq, q, label, trace=True)
        launches += n + nt
        require(np.array_equal(r.attrs, rt.attrs)
                and np.array_equal(r.steps, rt.steps),
                f"{label}: traced and untraced results differ")
        disp = rt.telemetry.dispatches[0]
        tr, nb = disp.trace, cq.engine.bg.bsrc.numel()
        require(len(tr) == int(np.max(r.steps)) and not disp.truncated,
                f"{label}: {len(tr)} trace rows for {np.max(r.steps)} "
                "steps")
        require(bool(((tr.blocks_fetched + tr.blocks_skipped) == nb).all()),
                f"{label}: fetched + skipped != {nb} blocks on some row")
        with tempfile.TemporaryDirectory() as tmp:
            path = write_chrome_trace(str(Path(tmp) / "trace.json"), rt)
            with open(path) as f:
                doc = json.load(f)
        spans = [e for e in doc["traceEvents"]
                 if e.get("name", "").startswith("step ")]
        require(len(spans) == len(tr),
                f"{label}: {len(spans)} step spans in the Chrome trace")
        bf = tr.blocks_fetched
        log(f"{label}: {len(tr)} rows, traced/untraced wall "
            f"{t_wall:.3f} / {wall:.3f} s = {t_wall / wall:.3f}, blocks "
            f"fetched per step min {int(bf.min())} median "
            f"{float(np.median(bf)):.1f} max {int(bf.max())} of {nb}, "
            f"mean active tiles {float(tr.active_tiles.mean()):.1f} of "
            f"{cq.engine.bg.ntiles}; Chrome trace of {len(spans)} step "
            "spans read back")
    return launches


def zipf_stream(rng, pool, n: int):
    """`n` (algo, src) requests, bfs and sssp alternating, sources drawn
    from `pool` by a Zipf (s = 1.1) rank law."""
    ranks = np.minimum(rng.zipf(1.1, size=n), len(pool)) - 1
    return [(("bfs", "sssp")[i % 2], int(pool[k]))
            for i, k in enumerate(ranks)]


def phase_serving(g, rng) -> int:
    """Phase 11 (module docstring). Returns the kernel's launches."""
    srv = AsyncGraphServer(g, batch=8, segment_steps=4)
    for algo in ("bfs", "sssp"):
        srv.session(algo)                  # build both layouts up front
    pool = rng.choice(g.n, size=24, replace=False)
    streams = [zipf_stream(rng, pool, 64), zipf_stream(rng, pool, 32)]
    batch = monotone_batch(g, rng)
    relax.frontier_relax_cuda.launches = 0
    versions, walls, upd_s = [], [], 0.0
    for i, stream in enumerate(streams):
        if i:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.update(batch)
            torch.cuda.synchronize()
            upd_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = srv.serve(stream)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        versions.append(({a: srv.session(a) for a in ("bfs", "sssp")},
                         reqs))
    launches = relax.frontier_relax_cuda.launches
    st = srv.stats()
    iters = st["metrics"]["histograms"]["window_iters"]
    require(launches == int(iters["sum"]),
            f"serving: {launches} kernel launches for {iters['sum']} "
            "window iterations")
    require(all(x.is_cuda for rb in srv._batches.values()
                for x in rb.state),
            "serving: a rotating-batch state tensor is not on CUDA")
    reqs = [r for _, rs in versions for r in rs]
    bad = [(r.req_id, r.error) for r in reqs if not r.ok]
    require(not bad and st["failed"] == st["shed"] == 0,
            f"serving: {len(bad)} requests not ok, failed {st['failed']}, "
            f"shed {st['shed']}: {bad[:3]}")
    warm = sum(r.warm_started for r in versions[1][1])
    require(warm > 0, "serving: no request warm-started after the update")

    # every result against one batched query per algebra and version
    # (comparison launches, outside the count above)
    checked = 0
    for sessions, rs in versions:
        for algo, cq in sessions.items():
            mine = [r for r in rs if r.algo == algo]
            distinct = sorted({r.src for r in mine})
            ref = cq.query(distinct)
            row = {s: i for i, s in enumerate(distinct)}
            for r in mine:
                # a warm start (or a hit on one) takes fewer steps than
                # scratch, to the same fixpoint
                cold = not (r.warm_started or r.cache_hit)
                require(np.array_equal(r.result, ref.attrs[row[r.src]])
                        and (r.steps == int(ref.steps[row[r.src]])
                             or not cold),
                        f"serving: request {r.req_id} ({algo}, src "
                        f"{r.src}) differs from the batched query")
            require(cq.program.check(cq.graph, mine[0].src,
                                     mine[0].result),
                    f"serving: {algo} src {mine[0].src} fails check()")
            checked += 1
    m = st["metrics"]["histograms"]
    nq = len(reqs)
    lat = " ".join(
        f"{a} p50/p95/p99 {m[f'latency_s.{a}']['p50'] * 1e3:.1f}/"
        f"{m[f'latency_s.{a}']['p95'] * 1e3:.1f}/"
        f"{m[f'latency_s.{a}']['p99'] * 1e3:.1f} ms, queue wait p50/p95 "
        f"{m[f'queue_wait_s.{a}']['p50'] * 1e3:.1f}/"
        f"{m[f'queue_wait_s.{a}']['p95'] * 1e3:.1f} ms;"
        for a in ("bfs", "sssp"))
    # lane occupancy: steps the lanes took over the lane-steps offered
    occ = ((m["steps.bfs"]["sum"] + m["steps.sssp"]["sum"])
           / max(1.0, 8 * iters["sum"]))
    log(f"serving: {nq} requests ({len(streams[0])} + update + "
        f"{len(streams[1])}) in {sum(walls):.3f} s = "
        f"{nq / sum(walls):.2f} queries/s (update() {upd_s:.3f} s); {lat} "
        f"{st['windows']} windows, {int(iters['sum'])} iterations = "
        f"launches {launches}, lane occupancy {occ:.3f}, cache hit rate "
        f"{st['cache']['hit_rate']:.3f}, {warm} warm starts; all equal "
        f"their batched queries, {checked} pass check()")

    # a profiled burst of 16 fresh sources (not counted above)
    from torch.profiler import ProfilerActivity, profile
    fresh = [int(s) for s in rng.choice(g.n, size=64, replace=False)
             if s not in set(pool.tolist())][:16]
    w0 = srv.windows
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        burst = srv.serve([(("bfs", "sssp")[i % 2], s)
                           for i, s in enumerate(fresh)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    require(all(r.ok for r in burst), "serving: a burst request failed")
    rows = [(e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    nwin = srv.windows - w0
    if rows:
        busy = sum(ms for ms, _ in rows)
        log(f"serving profile: 16 requests, {nwin} windows, wall "
            f"{wall_ms:.1f} ms, device busy {busy:.1f} ms "
            f"({busy / wall_ms:.1%}), {sum(c for _, c in rows) / nwin:.1f} "
            f"device ops/window, {wall_ms / nwin:.3f} ms/window")
    else:
        log("serving profile: device time not measured (no device events)")
    return launches


# ------------------------------------------------------------------ #
# the FLIP mapping and cycle simulator (12), the bucket server (13)
# ------------------------------------------------------------------ #
def graph_run_main(argv: list[str]) -> str:
    """`graph_run.main(argv)` with its stdout captured and logged."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graph_run.main(argv)
    out = buf.getvalue()
    for ln in out.splitlines():
        log(f"  {ln}")
    return out


def phase_mapping(rng) -> int:
    """Phase 12 (module docstring). Returns the kernel's launches."""
    g = next(make_dataset("LRN", 1, seed0=0))
    srcs = np.sort(rng.choice(g.n, size=8, replace=False))
    launches = 0
    for algo in ("bfs", "sssp", "wcc"):
        alg = ALGEBRAS[algo]
        t0 = time.perf_counter()
        m = compile_mapping(g, effort=1, program=alg)
        map_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = simulate(m, alg, src=0)
        sim_s = time.perf_counter() - t0
        ref, _ = reference.run(algo, g, 0)
        require(alg.results_match(r.attrs, ref),
                f"sim {algo}: the simulated result disagrees with the oracle")
        t_f = r.cycles / m.arch.freq_mhz
        mcu = baselines.mcu_cycles(algo, g, 0)
        cgra = baselines.cgra_cycles(algo, g, 0)
        log(f"sim {algo} LRN |V|={g.n} |E|={g.m}: mapping (effort 1) "
            f"{map_s:.1f} s on the host, avg routing length "
            f"{m.avg_routing_length():.3f}; simulated FLIP fabric at "
            f"{m.arch.freq_mhz:.0f} MHz, computed on the host (not card "
            f"time): {r.cycles} cycles = {t_f:.2f} us, parallelism avg "
            f"{r.avg_parallelism:.2f} max {r.max_parallelism}, "
            f"{g.m / t_f:.1f} MTEPS, pkt wait {r.avg_pkt_wait:.2f} cycles, "
            f"swaps {r.swaps}; simulated speedup vs MCU "
            f"{mcu.time_us / t_f:.1f}x, vs op-centric CGRA "
            f"{cgra.time_us / t_f:.1f}x; oracle match (sim {sim_s:.2f} s)")
        order = mapping_order(m)
        for tile in (128, 32):
            plan = flip_torch.ExecutionPlan(tile=tile)
            ido = flip_torch.compile(g, algo, plan)
            mo = flip_torch.compile(g, algo, plan, mapping=m)
            require(np.array_equal(mo.engine.bg.inv_perm, order),
                    f"{algo} T={tile}: the session is not in mapping order")
            label = f"{algo} x{len(srcs)} T={tile}"
            a, a_wall, n1 = counted_query(ido, srcs, f"{label} id order")
            b, b_wall, n2 = counted_query(mo, srcs,
                                          f"{label} mapping order")
            launches += n1 + n2
            require(np.array_equal(a.attrs, b.attrs)
                    and np.array_equal(a.steps, b.steps),
                    f"{label}: mapping order differs from id order")
            check(b, f"{label} mapping order")
            log(f"{label}: blocks id order {ido.engine.bg.bsrc.numel()}, "
                f"mapping order {mo.engine.bg.bsrc.numel()} "
                f"({mo.engine.bg.ntiles} tiles); steps "
                f"{np.asarray(b.steps).tolist()}, bit-equal to id order; "
                f"launches = iterations ({n2}); wall {b_wall * 1e3:.1f} ms "
                f"(id order {a_wall * 1e3:.1f} ms)")
    for engine in ("sim", "jax"):
        relax.frontier_relax_cuda.launches = 0
        out = graph_run_main(["--engine", engine, "--dataset", "SRN"])
        require("[graph] correct vs reference: True" in out,
                f"graph_run --engine {engine}: no correct self-check")
        n = relax.frontier_relax_cuda.launches
        if engine == "jax":
            steps = int(out.split("fixpoint in ", 1)[1].split()[0])
            require(n == steps, f"graph_run --engine jax: {n} launches for "
                    f"{steps} iterations")
        else:
            require(n == 0, "graph_run --engine sim launched the kernel")
        launches += n
    return launches


def bucket_dispatches(items, b: int) -> int:
    """Bucket dispatches a `GraphServer(batch=b)` makes for a stream:
    one per full bucket, and one per non-empty bucket at each update
    (which drains first) and at the end."""
    n, pending = 0, {}
    for algo, _ in items + [("update", None)]:
        if algo == "update":
            n += sum(1 for k in pending.values() if k)
            pending = {}
            continue
        pending[algo] = pending.get(algo, 0) + 1
        if pending[algo] == b:
            n += 1
            pending[algo] = 0
    return n


def served_launches(srv, label: str) -> int:
    """The kernel's launches since the count was set to 0, held equal to
    the server's engine iterations (every dispatch, retries included)."""
    launches = relax.frontier_relax_cuda.launches
    iters = int(srv.metrics.histogram("dispatch_iters").total)
    require(launches == iters, f"{label}: {launches} kernel launches for "
            f"{iters} dispatch iterations")
    return launches


def nan_road_copy(g, src: int):
    """`g` with one NaN weight, on an out-edge of `src` (so every query
    from `src` relaxes it in its first step)."""
    w = g.weights.copy()
    w[int(g.indptr[src])] = np.float32("nan")
    return dataclasses.replace(g, weights=w)


def phase_bucket_server(g, rng) -> int:
    """Phase 13 (module docstring). Returns the kernel's launches."""
    for algo in ("bfs", "sssp"):
        chain = fallback_chain(flip_torch.ExecutionPlan(batch=8),
                               ALGEBRAS[algo])
        rungs = [(p.relax_mode, p.compact) for p in chain]
        require(rungs == [("cuda", True), ("cuda", False)],
                f"{algo}: the card's ladder is {rungs}")
    log("ladder on the card: [cuda+compact, cuda+dense] for bfs and sssp")
    pool = rng.choice(g.n, size=24, replace=False)
    stream = zipf_stream(rng, pool, 48)
    items = stream[:24] + [("update", monotone_batch(g, rng))] + stream[24:]
    n_disp = bucket_dispatches(items, 8)
    specs = FaultInjector.random(seed=0, dispatches=n_disp, rate=0.25,
                                 stall_s=1.0).specs
    # the seeded schedule, plus one NaN and one stall pinned where it left
    # room, so every fault kind runs (as the reference's chaos test does)
    free = [d for d in range(n_disp) if d not in {f.dispatch for f in specs}]
    specs += [FaultSpec(kind="nan", dispatch=free[0]),
              FaultSpec(kind="stall", dispatch=free[1], stall_s=1.0)]
    inj = FaultInjector(specs=specs, seed=0)
    flagged = []                  # dispatch ordinal at each stall flag
    hb = HeartbeatMonitor(
        timeout_s=0.5,
        on_stall=lambda: flagged.append(srv._dispatch_seq - 1))
    srv = GraphServer(g, batch=8, fault_injector=inj, heartbeat=hb)
    for algo in ("bfs", "sssp"):
        srv.session(algo)                  # build both layouts up front
    hb.beat()
    hb.start()
    relax.frontier_relax_cuda.launches = 0
    versions, reqs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for algo, arg in items:
            if algo == "update":
                versions.append(({a: srv.session(a) for a in ("bfs", "sssp")},
                                 reqs))
                srv.update(arg)
                reqs = []
            else:
                reqs.append(srv.submit(algo, arg))
        srv.drain()
        torch.cuda.synchronize()
    finally:
        hb.stop()
    wall = time.perf_counter() - t0
    versions.append(({a: srv.session(a) for a in ("bfs", "sssp")}, reqs))
    launches = served_launches(srv, "bucket server")
    st = srv.stats()
    allreq = [r for _, rs in versions for r in rs]
    bad = [(r.req_id, r.error) for r in allreq if not r.ok]
    require(len(allreq) == 48 and not bad,
            f"bucket server: {len(bad)} requests not ok: {bad[:3]}")
    require(srv._dispatch_seq == n_disp,
            f"bucket server: {srv._dispatch_seq} dispatches, expected "
            f"{n_disp}")
    fired = sorted((f["dispatch"], f["kind"]) for f in inj.fired)
    require(fired == sorted((f.dispatch, f.kind) for f in specs)
            and st["resilience"]["faults_fired"] == len(specs),
            f"bucket server: faults fired {fired}, schedule "
            f"{[(f.dispatch, f.kind) for f in specs]}")
    n_err = sum(f.kind in ("raise", "nan") for f in specs)
    snap = st["metrics"]["counters"]
    require(snap.get("dispatch_errors.backend_failure", 0) == n_err
            and snap.get("fallback_rung.1", 0) == n_err
            and st["resilience"]["fallbacks"] == n_err,
            f"bucket server: {n_err} raise/nan faults but counters {snap}")
    stalls = sorted(f.dispatch for f in specs if f.kind == "stall")
    require(set(stalls) <= set(flagged) and hb.stall_count >= len(stalls),
            f"bucket server: stalls at {stalls}, heartbeat flagged "
            f"{flagged}")
    served_by = sorted({r.rung for r in allreq})
    require(served_by == [0, 1], f"bucket server: rungs {served_by}")

    # every result against one batched query per algebra and version
    # (comparison launches, outside the count above)
    for sessions, rs in versions:
        for algo, cq in sessions.items():
            mine = [r for r in rs if r.algo == algo]
            distinct = sorted({r.src for r in mine})
            ref = cq.query(distinct)
            row = {s: i for i, s in enumerate(distinct)}
            for r in mine:
                require(np.array_equal(r.result, ref.attrs[row[r.src]])
                        and r.steps == int(ref.steps[row[r.src]]),
                        f"bucket server: request {r.req_id} ({algo}, src "
                        f"{r.src}) differs from the batched query")
            require(cq.program.check(cq.graph, mine[0].src, mine[0].result),
                    f"bucket server: {algo} src {mine[0].src} fails check()")
    h = st["metrics"]["histograms"]
    log(f"bucket server: 48 requests + 1 update in {wall:.3f} s "
        f"({48 / wall:.2f} queries/s, stalls included) over {n_disp} "
        f"dispatches of B=8; faults fired {fired}; "
        f"{n_err} served by rung 1, {len(stalls)} stall(s) flagged by the "
        f"heartbeat (flags at dispatches {flagged}); launches = dispatch "
        f"iterations = {launches}; latency p50/p95 "
        f"{h['latency_s.sssp']['p50'] * 1e3:.1f}/"
        f"{h['latency_s.sssp']['p95'] * 1e3:.1f} ms (sssp), "
        f"{h['latency_s.bfs']['p50'] * 1e3:.1f}/"
        f"{h['latency_s.bfs']['p95'] * 1e3:.1f} ms (bfs); every request "
        "equals its batched query bit for bit")

    # NaN weights: every rung trips the finite guard on the card
    with np.errstate(invalid="ignore"):    # numpy's ⊕.at over a NaN weight
        return launches + nan_servers(g, pool)


def nan_servers(g, pool) -> int:
    """Phase 13's NaN part: the 6-vertex NaN graph on the card against
    the CPU, then servers over it and over a copy of `g` with one NaN
    weight, where every rung trips the finite guard. Returns the
    kernel's launches."""
    launches = 0
    nan = float("nan")
    g6 = Graph.from_edges(6, [(0, 1), (1, 2), (2, 3), (0, 4), (4, 3),
                              (3, 5)], [1, nan, 1, 5, 1, 1])
    for algo in ("sssp", "widest"):
        card = flip_torch.compile(g6, algo).query(0)
        cpu = flip_torch.compile(g6, algo, device="cpu").query(0)
        require(np.array_equal(card.attrs, cpu.attrs, equal_nan=True)
                and card.steps == cpu.steps,
                f"6-vertex NaN graph {algo}: card {card.attrs} != cpu "
                f"{cpu.attrs}")
        log(f"6-vertex NaN graph {algo}: card == cpu, NaN positions "
            f"included: {card.attrs.tolist()}")
    src = int(pool[0])
    for label, graph, algos, srcs in (
            ("6-vertex", g6, ("sssp", "widest"), [0, 3]),
            ("road NaN copy", nan_road_copy(g, src), ("sssp",),
             [src] + [int(x) for x in pool[1:8]])):
        srv = GraphServer(graph, batch=len(srcs))
        relax.frontier_relax_cuda.launches = 0
        reqs = [srv.submit(a, s) for a in algos for s in srcs]
        srv.drain()
        torch.cuda.synchronize()
        n = served_launches(srv, f"{label} server")
        launches += n
        runs = srv.metrics.histogram("dispatch_iters").count
        require(all(r.done and isinstance(r.error, BackendFailure)
                    and r.result is None for r in reqs)
                and srv.failed == len(reqs)
                and runs == 2 * len(algos),
                f"{label} server: not every request failed typed after "
                f"both rungs ({runs} runs)")
        log(f"{label} server: {len(reqs)} requests, {runs} runs (every "
            f"rung tripped finite_guard), all carry BackendFailure "
            f"('{reqs[0].error}'), none lost; launches = iterations = {n}")
    return launches


# ------------------------------------------------------------------ #
# the plan autotuner (14)
# ------------------------------------------------------------------ #
def id_order_blocks(g, tile: int) -> int:
    """Weight blocks of `g` at `tile` in id order, as `build_blocks`
    counts them: the distinct (destination, source) tile pairs of the
    edges plus the diagonal."""
    nt = max(1, -(-g.n // tile))
    key = (g.indices.astype(np.int64) // tile) * nt \
        + g.edge_sources() // tile
    return int(np.union1d(key, np.arange(nt, dtype=np.int64) * (nt + 1))
               .size)


def segment_iters(cq, graph) -> tuple[int, int]:
    """(iterations, summed query steps) of one capped tuning segment on
    `graph`: the tuner's probe sources (seed 0) for `SEGMENT_STEPS` steps
    through `cq`. The fixpoint's steps do not depend on the plan, so
    every candidate's segments run these. Launches outside any count."""
    probe = at_measure.probe_sources(graph, 0, at_measure.PROBE_SOURCES)
    r = cq.query(probe, max_steps=at_measure.SEGMENT_STEPS)
    return int(np.max(r.steps)), int(np.sum(r.steps))


def bucket_iters(steps, b: int) -> int:
    """Fixpoint iterations of a query dispatched in buckets of `b` (0 =
    one dispatch): the sum of each bucket's longest query."""
    steps = np.atleast_1d(steps)
    b = b or steps.size
    return int(sum(steps[i:i + b].max() for i in range(0, steps.size, b)))


def tuned_launches(label: str, samples, seg: tuple[int, int]) -> int:
    """The kernel's launches since the count was set to 0, held equal to
    the sweep's: one warm-up and `REPEATS` timed segments per measured
    engine (bucket widths on one engine share its segments), `seg[0]`
    iterations each."""
    engines = len({at_measure.engine_key(s.plan) for s in samples
                   if s.source == "measured"})
    want = engines * (1 + at_measure.REPEATS) * seg[0]
    n = relax.frontier_relax_cuda.launches
    require(n == want, f"{label}: {n} kernel launches for {want} segment "
            f"iterations ({engines} engines x {1 + at_measure.REPEATS} "
            f"segments x {seg[0]})")
    return n


def phase_autotune(g, srcs, sssp, bfs, sssp_r) -> int:
    """Phase 14 (module docstring). Returns the kernel's launches."""
    prof = profile_graph(g, feature_dim=1)
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        store = TuningStore(str(Path(tmp) / "autotune_torch.json"))
        # a fully measured sweep: sssp over tiles 64 / 128 / 256
        seg = segment_iters(sssp, g)
        relax.frontier_relax_cuda.launches = 0
        t0 = time.perf_counter()
        rep = autotune(g, "sssp", flip_torch.ExecutionPlan(), store=store,
                       budget_s=None, seed=0)
        tune_s = time.perf_counter() - t0
        launches += tuned_launches("tune sssp", rep.samples, seg)
        require(sorted(s.plan.tile for s in rep.samples) == [64, 128, 256]
                and all(s.source == "measured" and s.plan.relax_mode == "cuda"
                        and s.steps == seg[1] for s in rep.samples),
                f"tune sssp: not three measured cuda candidates of "
                f"{seg[1]} steps: {[s.to_json() for s in rep.samples]}")
        log(f"tune sssp (road-262k, budget none): {tune_s:.3f} s, "
            f"{len(rep.samples)} candidates, each {1 + at_measure.REPEATS} "
            f"segments of {seg[0]} iterations ({seg[1]} query steps); "
            f"launches = segment iterations ({relax.frontier_relax_cuda.launches})")
        for s in rep.samples:
            t = s.plan.tile
            log(f"  tile {t:3d} compact {s.plan.compact}: {s.step_us:.3f} "
                f"us/step, best segment {s.wall_s * 1e3:.3f} ms, "
                f"{id_order_blocks(g, t)} blocks (analytic model "
                f"{at_measure.expected_blocks(g.n, g.m, t):.0f}; gate "
                f"estimate {at_measure.estimated_measure_s(prof, s.plan):.3f}"
                f" s) [{s.source}]")
        log(f"tune sssp: {rep.why}")

        # the chosen plan answers as the default: phase 4's sssp x8
        cq = flip_torch.compile(g, "sssp", rep.chosen)
        r, wall, n = counted_query(cq, srcs, f"tuned sssp x{len(srcs)}")
        launches += n
        require(np.array_equal(r.attrs, sssp_r.attrs)
                and np.array_equal(r.steps, sssp_r.steps),
                "tuned sssp: the chosen plan's result differs from phase 4's")
        log(f"tuned sssp x{len(srcs)} (tile {cq.plan.tile}): bit-equal to "
            f"phase 4, steps included; wall {wall:.3f} s, launches {n}")
        check(r, "tuned sssp")
        del cq

        # the session surface: bfs, tuned=True, batch=8, default budget
        plan = flip_torch.ExecutionPlan.auto(tuned=True, batch=8)
        seg = segment_iters(bfs, g)
        want = bfs.query(srcs)               # comparison, outside the count
        relax.frontier_relax_cuda.launches = 0
        t0 = time.perf_counter()
        cq = flip_torch.compile(g, "bfs", plan, store=store)
        compile_s = time.perf_counter() - t0
        tune = cq.tune
        require(not tune.cached, "tune bfs: a store hit in a fresh store")
        launches += tuned_launches("tune bfs", tune.samples, seg)
        log(f"tune bfs (tuned=True, batch=8, budget "
            f"{DEFAULT_BUDGET_S} s): compile {compile_s:.3f} s; "
            + ", ".join(f"T={s.plan.tile}/B={s.plan.batch} {s.source} "
                        f"{s.step_us:.3f} us (gate "
                        f"{at_measure.estimated_measure_s(prof, s.plan):.3f} s)"
                        for s in tune.samples))
        log(f"tune bfs: {tune.why}")
        for trace in (False, True):
            relax.frontier_relax_cuda.launches = 0
            r = cq.query(srcs, trace=trace)
            torch.cuda.synchronize()
            n = relax.frontier_relax_cuda.launches
            iters = bucket_iters(r.steps, cq.plan.batch)
            require(n == iters, f"tuned bfs (trace={trace}): {n} launches "
                    f"for {iters} iterations")
            launches += n
            require(np.array_equal(r.attrs, want.attrs)
                    and np.array_equal(r.steps, want.steps),
                    f"tuned bfs (trace={trace}): differs from the untuned "
                    "session")
            if trace:
                metas = [d.meta.get("autotune")
                         for d in r.telemetry.dispatches]
                require(all(m is not None and m["chosen"]["tile"]
                            == cq.plan.tile and m["why"] == tune.why
                            for m in metas),
                        "tuned bfs: a traced dispatch lacks its autotune "
                        "stamp")
        log(f"tuned bfs x{len(srcs)} (tile {cq.plan.tile}, batch "
            f"{cq.plan.batch}): bit-equal to the untuned session, steps "
            f"included, traced too; {len(metas)} dispatch records carry "
            "meta['autotune']")
        check(r, "tuned bfs")
        del cq
        relax.frontier_relax_cuda.launches = 0
        t0 = time.perf_counter()
        cq = flip_torch.compile(g, "bfs", plan, store=store)
        hit_s = time.perf_counter() - t0
        require(cq.tune.cached and relax.frontier_relax_cuda.launches == 0,
                f"tune bfs again: cached {cq.tune.cached}, "
                f"{relax.frontier_relax_cuda.launches} launches")
        log(f"tune bfs again: store hit in {hit_s:.3f} s (layout build "
            "included), no kernel launch")
        del cq

        # the CLI, its store in the same temporary directory
        srn = next(make_dataset("SRN", 1, seed0=0))
        seg = segment_iters(flip_torch.compile(srn, "sssp"), srn)
        relax.frontier_relax_cuda.launches = 0
        with mock.patch.dict(os.environ, FLIP_TORCH_AUTOTUNE_DB=str(
                Path(tmp) / "cli.json")):
            out = graph_run_main(["--dataset", "SRN", "--algo", "sssp",
                                  "--autotune", "--effort", "0"])
        require("[graph] correct vs reference: True" in out
                and "[graph] autotune: measured sweep over 3 candidates"
                in out, "graph_run --autotune: no tuned, correct run")
        steps = int(out.split("fixpoint in ", 1)[1].split()[0])
        n = relax.frontier_relax_cuda.launches
        want_n = 3 * (1 + at_measure.REPEATS) * seg[0] + steps
        require(n == want_n, f"graph_run --autotune: {n} launches for "
                f"{want_n} iterations (sweep and query)")
        launches += n
    return launches


# ------------------------------------------------------------------ #
# the LM kernels: flash attention (K2) and the SSD intra-chunk form (K3)
# ------------------------------------------------------------------ #
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ATTN_REL_TOL = 1e-2           # bf16 at the qwen3 layer, relative Frobenius
SSD_ATOL = 1e-4               # scaled by max(1, max|ref|)
LM_BATCH, LM_SEQ = 4, 4_096   # the prefill cell (prefill_32k cut to fit)
KERNELS = (relax.frontier_relax_cuda, flash.flash_attention_cuda,
           ssd.ssd_intra_cuda)
REPLAY_LEN = 256              # float32 prefill-vs-decode prompt


def randn(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def attention_check(label: str, q, k, v, causal: bool,
                    window: int | None, quiet: bool = False,
                    rel_tol: float | None = None) -> float:
    """The kernel against `attention_ref` on the same inputs (upcast to
    f32 for a bf16 kernel, as tests/test_kernels_attention.py does); the
    call must take `flash.route`'s route. With `rel_tol`, also holds the
    relative Frobenius error ||out - ref|| / ||ref||."""
    name = flash.route(q.dtype, q.shape[-1])
    before = dict(flash.flash_attention_cuda.route_launches)
    out = flash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    taken = [r for r, n in flash.flash_attention_cuda.route_launches.items()
             if n != before[r]]
    require(taken == [name], f"attention {label}: took {taken}, not {name}")
    ref = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                        window=window)
    err = float((out.float() - ref).abs().max())
    atol = ATTN_ATOL[q.dtype]
    ok = err <= atol and bool(torch.isfinite(out).all())
    rel = ""
    if rel_tol is not None:
        r = float((out.float() - ref).norm() / ref.norm())
        ok = ok and r <= rel_tol
        rel = f", relative Frobenius {r:.3e} (tol {rel_tol:g})"
    if not (quiet and ok):
        log(f"attention {label} [{name}]: max|err| {err:.3e} (atol "
            f"{atol:g}){rel}: {ok}")
    require(ok, f"flash attention disagrees with attention_ref: {label}")
    return err


def attention_work(b, s, h, kh, hd, dtype) -> dict:
    """Causal FLOPs 4*B*H*S^2/2*hd over the bf16 tensor-core rate, and
    q, k, v, out bytes over the memory rate."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * h * hd + 2 * b * s * kh * hd) * size
    ops = 4 * b * h * s * s / 2 * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_attention(gen) -> tuple[float, dict]:
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128, 256):
            group = []
            for kh in (8, 4, 1):                    # GQA ratio 1, 2, 8
                q = randn(gen, (2, 320, 8, hd), dtype)
                k = randn(gen, (2, 320, kh, hd), dtype)
                v = randn(gen, (2, 320, kh, hd), dtype)
                for causal in (True, False):
                    for window in (None, 128):
                        group.append(attention_check(
                            f"{str(dtype)[6:]} hd={hd} g={8 // kh} "
                            f"causal={causal} window={window} S=320",
                            q, k, v, causal, window, quiet=True))
            log(f"attention {str(dtype)[6:]} hd={hd} "
                f"[{flash.route(dtype, hd)}]: 12 cases (GQA ratio 1/2/8 x "
                "causal x window None/128, B=2, S=320, H=8): max|err| "
                f"{max(group):.3e} (atol {ATTN_ATOL[dtype]:g})")
            errs += group
    # ragged lengths; S=5 is shorter than one tile of either kernel
    for dtype, hd, n, window in ((torch.float32, 32, 200, 50),
                                 (torch.bfloat16, 64, 200, 50),
                                 (torch.bfloat16, 256, 200, 50),
                                 (torch.bfloat16, 128, 5, None)):
        q = randn(gen, (1, n, 4, hd), dtype)
        k = randn(gen, (1, n, 2, hd), dtype)
        v = randn(gen, (1, n, 2, hd), dtype)
        errs.append(attention_check(
            f"{str(dtype)[6:]} hd={hd} ragged S={n} window={window}", q, k,
            v, True, window))
    qcfg = configs.get("qwen3_0_6b")
    shape = (qcfg.num_heads, qcfg.num_kv_heads, qcfg.head_dim)
    # at S=4096 a row's output is ~0.03, under the bf16 atol: the f32
    # case at atol 2e-5 holds the long causal range on the CUDA cores, and
    # the relative error holds it on the tensor cores
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(gen, (1, LM_SEQ, shape[0], shape[2]), dtype)
        k = randn(gen, (1, LM_SEQ, shape[1], shape[2]), dtype)
        v = randn(gen, (1, LM_SEQ, shape[1], shape[2]), dtype)
        errs.append(attention_check(
            f"qwen3 layer {str(dtype)[6:]} B=1 S={LM_SEQ}", q, k, v, True,
            None, rel_tol=ATTN_REL_TOL if dtype == torch.bfloat16 else None))

    # timing at the main path's shape: the qwen3 prefill's layer
    b, s = LM_BATCH, LM_SEQ
    q = randn(gen, (b, s, shape[0], shape[2]), torch.bfloat16)
    k = randn(gen, (b, s, shape[1], shape[2]), torch.bfloat16)
    v = randn(gen, (b, s, shape[1], shape[2]), torch.bfloat16)
    w = attention_work(b, s, *shape, torch.bfloat16)
    ms = time_ms(lambda: flash.flash_attention_cuda(q, k, v), reps=20)
    # the CUDA-core kernel at the same shape, launched directly: the
    # wrapper never routes bf16 at hd=128 there
    fma_ms = time_ms(lambda: flash._launch("fma", q, k, v, True, None),
                     reps=3, warmup=1)
    plain_ms = time_ms(lambda: attention_ref(q, k, v), reps=2, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), reps=10)
    log(f"time attention bf16 B={b} S={s} H={shape[0]} KH={shape[1]} "
        f"hd={shape[2]} causal: wgmma kernel {ms:.4f} ms "
        f"({w['ops'] / ms / 1e9:.2f} TFLOP/s), CUDA-core kernel "
        f"{fma_ms:.4f} ms ({w['ops'] / fma_ms / 1e9:.2f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
        f"{w['bound_ms']:.4f} ms ({w['bound_by']}; {w['ops']:.4g} ops, "
        f"{w['bytes']} B)")
    return max(errs), dict(w, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms)


def ssd_inputs(gen, b, l, h, p, n, a_shift=0.0):
    """The reference tests' distribution: x, B, C, A_log, D normal (A_log
    shifted by `a_shift`); dt uniform in [0.01, 0.2)."""
    return (randn(gen, (b, l, h, p)),
            0.01 + 0.19 * torch.rand((b, l, h), generator=gen,
                                     device="cuda"),
            randn(gen, (b, l, n)), randn(gen, (b, l, n)),
            randn(gen, (h,)) + a_shift, randn(gen, (h,)))


def ssd_check(label: str, gen, b, l, h, p, n, chunk, a_shift=0.0) -> float:
    x, dt, Bm, Cm, A_log, D = ssd_inputs(gen, b, l, h, p, n, a_shift)
    C_c, B_c, dtx, cums = chunk_inputs(x, dt, Bm, Cm, A_log, chunk)
    if a_shift:
        # exp(-cums_j) overflows f32 below -88: a factored decay gives NaN
        require(float(cums.min()) < -500,
                f"ssd {label}: cums min {float(cums.min()):.1f} is not "
                "below -500")
        label += f", cums min {float(cums.min()):.1f}"
    y, S = ssd.ssd_intra_cuda(C_c, B_c, dtx, cums)
    torch.cuda.synchronize()
    y_ref, S_ref = ssd_intra_ref(C_c, B_c, dtx, cums)
    yf, hf = ssd.ssd_cuda(x, dt, Bm, Cm, A_log, D, chunk=chunk)
    yf_ref, hf_ref = ssd_ref(x, dt, Bm, Cm, A_log, D, chunk=chunk)
    torch.cuda.synchronize()
    errs = []
    ok = True
    for got, ref in ((y, y_ref), (S, S_ref), (yf, yf_ref), (hf, hf_ref)):
        err = float((got - ref).abs().max())
        tol = SSD_ATOL * max(1.0, float(ref.abs().max()))
        ok = ok and err <= tol and bool(torch.isfinite(got).all())
        errs.append((err, tol))
    log(f"ssd {label}: max|err| y {errs[0][0]:.3e} (tol {errs[0][1]:.3g}), "
        f"S {errs[1][0]:.3e} (tol {errs[1][1]:.3g}), ssd_cuda y "
        f"{errs[2][0]:.3e}, h {errs[3][0]:.3e}: {ok}")
    require(ok, f"SSD kernel disagrees with the plain version: {label}")
    return max(e for e, _ in errs[:2])


def ssd_work(b, nc, q, n, h, p) -> dict:
    """What the intra-chunk function needs: G over the i >= j pairs once
    per chunk, then per head the decay product, att @ dtx and the state;
    C, B, dtx, cums read once, y and S written once. `bound_ms` is the
    route's own: every product as three TF32 products on the tensor cores
    (3 x ops / 495 TFLOP/s) against the bytes; `f32_bound_ms` the same
    work as f32 FMAs on the CUDA cores (ops / 67 TFLOP/s)."""
    pairs = q * (q + 1) // 2
    ops = b * nc * (2 * pairs * n + h * (pairs + 2 * pairs * p
                                         + 2 * q * n * p))
    nbytes = 4 * b * nc * (2 * q * n + q * h * p + q * h + q * h * p
                           + h * n * p)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * ops / TF32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": "3xTF32: 3 x ops / 495 TFLOP/s",
            "f32_bound_ms": max(t_bytes, ops / FP32_OPS_PER_S) * 1e3}


def phase_ssd(gen) -> tuple[float, dict]:
    mcfg = configs.get("mamba2_370m")
    h, p, n, q = (mcfg.ssm_heads, mcfg.ssm_head_dim, mcfg.ssm_state,
                  mcfg.ssm_chunk)
    errs = [ssd_check(f"B={b} L={l} H={hh} P={pp} N={nn} chunk=16", gen,
                      b, l, hh, pp, nn, 16)
            for b, l, hh, pp, nn in ((1, 32, 2, 8, 4), (2, 64, 4, 16, 8),
                                     (1, 128, 1, 32, 16))]
    log(f"ssd route: {ssd.ROUTE}")
    errs.append(ssd_check("ragged B=1 L=200 H=3 P=24 N=20 chunk=100", gen,
                          1, 200, 3, 24, 20, 100))
    errs.append(ssd_check("ragged B=2 L=144 H=3 P=12 N=20 chunk=72", gen,
                          2, 144, 3, 12, 20, 72))
    # N and P off a multiple of 4: the kernel stages with 4-byte copies
    errs.append(ssd_check("ragged B=1 L=96 H=2 P=6 N=5 chunk=48", gen, 1,
                          96, 2, 6, 5, 48))
    # P over 64: two 64-column slots per head, the second one ragged
    # (P=100, and P=70 with 4-byte copies), and the widest head (P=128);
    # H=9 puts a second head group behind a ragged chunk of three i tiles
    errs.append(ssd_check("two slots B=1 L=320 H=9 P=100 N=36 chunk=160",
                          gen, 1, 320, 9, 100, 36, 160))
    errs.append(ssd_check("two slots B=1 L=200 H=3 P=70 N=20 chunk=100",
                          gen, 1, 200, 3, 70, 20, 100))
    errs.append(ssd_check(f"two slots B=1 L=512 H=3 P=128 N={n} chunk={q}",
                          gen, 1, 512, 3, 128, n, q))
    errs.append(ssd_check(f"strong decay B=1 L=512 H=4 P={p} N={n} "
                          f"chunk={q} A_log+4", gen, 1, 512, 4, p, n, q,
                          a_shift=4.0))
    errs.append(ssd_check(f"mamba2 B={LM_BATCH} L={LM_SEQ} H={h} P={p} "
                          f"N={n} chunk={q}", gen, LM_BATCH, LM_SEQ, h, p,
                          n, q))

    x, dt, Bm, Cm, A_log, D = ssd_inputs(gen, LM_BATCH, LM_SEQ, h, p, n)
    C_c, B_c, dtx, cums = chunk_inputs(x, dt, Bm, Cm, A_log, q)
    w = ssd_work(LM_BATCH, LM_SEQ // q, q, n, h, p)
    ms = time_ms(lambda: ssd.ssd_intra_cuda(C_c, B_c, dtx, cums), reps=10)
    plain_ms = time_ms(lambda: ssd_intra_ref(C_c, B_c, dtx, cums), reps=3,
                       warmup=1)
    log(f"time ssd_intra f32 B={LM_BATCH} nc={LM_SEQ // q} Q={q} N={n} "
        f"H={h} P={p}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{w['bound_ms']:.4f} ms ({w['bound_by']}, {w['bound_rate']}; "
        f"{w['ops']:.4g} ops, {w['bytes']} B), f32 CUDA-core bound "
        f"{w['f32_bound_ms']:.4f} ms; {w['ops'] / ms / 1e9:.2f} TFLOP/s of "
        "needed work")
    return max(errs), dict(w, ms=ms, plain_ms=plain_ms, library_ms=None)


def profile_call(fn, label: str) -> None:
    """Where one call's time goes: device time by kernel and host time by
    op (torch.profiler) against the profiled wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events
                   if str(e.device_type).endswith("CUDA")), reverse=True)
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in events if e.key.startswith("aten::")),
                  reverse=True)
    if not rows:
        log(f"profile {label}: device time not measured (no device events)")
        return
    busy = sum(ms for ms, _, _ in rows)
    log(f"profile {label}: profiled wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), "
        f"{sum(c for _, c, _ in rows)} device ops, "
        f"{sum(c for _, c, _ in host)} aten ops on the host")
    for ms, count, key in rows[:8]:
        log(f"  device {ms:9.3f} ms {count:6d}x {ms / count * 1e3:8.2f} us  "
            f"{key[:80]}")
    for ms, count, key in host[:5]:
        log(f"  host   {ms:9.3f} ms {count:6d}x {ms / count * 1e3:8.2f} us  "
            f"{key[:80]}")


def profile_decode(params, cfg, label: str) -> None:
    """One decode step at the serving shape (8 slots, a 4,096-deep cache,
    position 16): ms per step over 10 steps, then one profiled step."""
    decode = steps.make_decode_step(cfg)
    cache = M.init_cache(cfg, 8, 4_096)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1), device="cuda")
    pos = torch.full((8,), 16, device="cuda")
    for _ in range(3):
        decode(params, cache, tokens, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        decode(params, cache, tokens, pos)
    torch.cuda.synchronize()
    log(f"{label}: {(time.perf_counter() - t0) * 100:.3f} ms per step "
        "(10 steps, host clock)")
    profile_call(lambda: decode(params, cache, tokens, pos), label)


def lm_path(arch: str, kernel, rng) -> int:
    """One architecture's serving path at full width (see the module
    docstring, phase 8). `kernel` is the wrapper the path must launch.
    Returns its launches in the bf16 prefills."""
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    require(params.device.type == "cuda", f"{arch}: the model is not on CUDA")
    nparam = sum(t.numel() for t in params.parameters())
    nbytes = sum(t.numel() * t.element_size() for t in params.parameters())
    log(f"{arch}: {nparam} parameters, {nbytes / 2**30:.2f} GiB on "
        f"{params.device}, initialised in {time.perf_counter() - t0:.1f} s")
    prefill = steps.make_prefill_step(cfg)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ))).cuda()
    batch = {"tokens": tokens}

    # the main path: counts start at 0 here
    for wrapper in KERNELS:
        wrapper.launches = 0
    routes = flash.flash_attention_cuda.route_launches
    for name in routes:
        routes[name] = 0
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = kernel.launches
    require(launches == 2 * cfg.num_layers,
            f"{arch}: {launches} kernel launches for 2 prefills of "
            f"{cfg.num_layers} layers -- the path did not go through the "
            "kernel")
    if kernel is flash.flash_attention_cuda:
        require(routes == {"wgmma": launches, "fma": 0},
                f"{arch}: bf16 prefill routes {routes}; every launch must "
                "take the wgmma kernel")
    require(tuple(logits.shape) == (LM_BATCH, 1, cfg.padded_vocab)
            and bool(torch.isfinite(logits).all()),
            f"{arch}: prefill logits {tuple(logits.shape)} not finite or "
            "of the wrong shape")
    ntok = LM_BATCH * LM_SEQ
    by_route = (f" ({routes['wgmma']} wgmma, {routes['fma']} fma)"
                if kernel is flash.flash_attention_cuda else "")
    log(f"{arch} prefill B={LM_BATCH} S={LM_SEQ}: wall {walls[0]:.3f} / "
        f"{walls[1]:.3f} s, {ntok / walls[1]:.1f} tokens/s (second call), "
        f"launches {launches}{by_route}")
    profile_call(lambda: prefill(params, batch), f"{arch} prefill")
    profile_decode(params, cfg, f"{arch} decode step B=8")
    del params, logits

    # float32: prefill through the kernels == token-by-token decode replay
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    params = M.init_params(cfg32, seed=1)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, REPLAY_LEN))).cuda()
    before = kernel.launches
    full = steps.make_prefill_step(cfg32)(params, {"tokens": prompt})
    require(kernel.launches == before + cfg.num_layers,
            f"{arch}: the f32 prefill did not go through the kernel")
    decode = steps.make_decode_step(cfg32)
    cache = M.init_cache(cfg32, 1, REPLAY_LEN)
    t0 = time.perf_counter()
    for t in range(REPLAY_LEN):
        logits, cache = decode(params, cache, prompt[:, t:t + 1],
                               torch.full((1,), t, device="cuda"))
    torch.cuda.synchronize()
    require(kernel.launches == before + cfg.num_layers,
            f"{arch}: decode launched the prefill kernel")
    diff = (logits - full).abs()
    tol = 2e-3 + 2e-2 * full.abs()
    log(f"{arch} f32 prefill vs {REPLAY_LEN}-step decode replay "
        f"({time.perf_counter() - t0:.1f} s): max|diff| "
        f"{float(diff.max()):.3e}, max|logit| {float(full.abs().max()):.3e}, "
        f"worst diff/tol {float((diff / tol).max()):.3f}")
    require(bool((diff <= tol).all()),
            f"{arch}: float32 prefill and decode replay disagree "
            "(rtol 2e-2, atol 2e-3)")
    del params, cache

    out = serve.main(["--arch", arch, "--preset", "full", "--slots", "8",
                      "--requests", "16", "--max-new", "32", "--max-seq",
                      "4096"])
    require(out["done"] == 16 and out["device"].startswith("cuda"),
            f"{arch}: serve answered {out['done']} of 16 requests on "
            f"{out['device']}")
    log(f"{arch} serve: 16 requests, {out['tokens']} tokens in "
        f"{out['steps']} steps, {out['seconds']:.3f} s, "
        f"{out['tokens'] / out['seconds']:.1f} decode tokens/s")
    torch.cuda.empty_cache()
    return launches


def kernel_row(name, source, replaces, launches, err, t) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


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
    launches, sssp_r = run_query(sssp, srcs, "sssp x8")
    launches += run_query(bfs, 0, "bfs")[0]
    launches += run_query(
        flip_torch.compile(g, "bfs", flip_torch.ExecutionPlan(mode="op")),
        0, "bfs/op")[0]
    profile_query(sssp, srcs, "sssp x8")
    profile_query(bfs, 0, "bfs")

    g2 = make_road_network(PROGRAM_N, seed=0, delete_frac=0.56)
    for algo in ("pagerank", "wcc", "widest", "reach", "multi_bfs",
                 "labelprop"):
        launches += run_query(flip_torch.compile(g2, algo), 0, algo)[0]
    del g2

    # the LM kernels, then the LM paths (each resets its kernel's count)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    err_attn, t_attn = phase_attention(gen)
    err_ssd, t_ssd = phase_ssd(gen)
    attn_launches = lm_path("qwen3_0_6b", flash.flash_attention_cuda, rng)
    ssd_launches = lm_path("mamba2_370m", ssd.ssd_intra_cuda, rng)

    # the graph-serving surface on phase 4's network and sessions
    for phase, fn in (("9 updates", lambda: phase_updates(sssp, srcs, rng)),
                      ("10 trace", lambda: phase_trace(sssp, bfs, srcs)),
                      ("11 serving", lambda: phase_serving(g, rng)),
                      ("12 mapping", lambda: phase_mapping(rng)),
                      ("13 bucket server",
                       lambda: phase_bucket_server(g, rng)),
                      ("14 autotune",
                       lambda: phase_autotune(g, srcs, sssp, bfs, sssp_r))):
        t0 = time.perf_counter()
        n = fn()
        launches += n
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s, {n} kernel "
            "launches")

    print(json.dumps({"kernels": [
        kernel_row("frontier_relax",
                   "src/repro_torch/kernels/frontier/csrc/frontier_relax.cu",
                   "src/repro/kernels/frontier/frontier.py:137", launches,
                   max(err_small, err_full),
                   dict(timing["all"], library_ms=None)),
        dict(kernel_row(
            "flash_attention",
            "src/repro_torch/kernels/attention/csrc/flash_attention_wgmma.cu",
            "src/repro/kernels/attention/flash.py:84", attn_launches,
            err_attn, t_attn), kernel_route="wgmma"),
        dict(kernel_row("ssd_intra",
                        "src/repro_torch/kernels/ssd/csrc/ssd_intra.cu",
                        "src/repro/kernels/ssd/ssd.py:50", ssd_launches,
                        err_ssd, t_ssd),
             bound_rate=t_ssd["bound_rate"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
