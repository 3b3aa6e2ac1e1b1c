"""Cycle models of the paper's baseline architectures (Sec. 5.1).

The port's copy of `repro.core.baselines`, over the port's
`graphs.reference` oracles.

MCU: ARM Cortex-M4F @64MHz running the textbook-optimal algorithms
(BFS O(V+E), binary-heap Dijkstra, WCC label propagation). Per-operation
cycle costs are calibrated so the model reproduces Table 5's measured
1.1 MTEPS on LRN (~58 cycles per traversed edge including queue
maintenance and flash/SRAM wait states on the M4F).

Classic op-centric CGRA: 8x8 @100MHz, statically-scheduled modulo mapping
(HyCUBE-class). Per the paper: BFS/WCC need 34/38 ops per edge iteration
and process one vertex at a time; the motivating example (Sec. 1.2) works
out to ~15 cycles per edge (dependence-limited II, SPM round trips); Table
5's 7.1 MTEPS on LRN implies ~14 cycles/edge -- we use 15/16 (BFS,
SSSP / WCC) with an unrolling model that saturates at ~1.3x (Fig. 4).
SSSP on the classic CGRA uses the O(V^2) algorithm (two kernels, 10/31
ops: vertex search + update), because the priority queue cannot be mapped
(Sec. 5.1).
"""
from __future__ import annotations

import dataclasses

from repro_torch.graphs import reference
from repro_torch.graphs.csr import Graph

MCU_FREQ_MHZ = 64.0
CGRA_FREQ_MHZ = 100.0

# MCU per-op costs (cycles)
MCU_EDGE = 50        # inner-loop edge relaxation incl. loads/branches
MCU_VERTEX = 35      # queue pop + bookkeeping per vertex
MCU_HEAP_OP = 70     # binary heap push/pop (log V levels, cache misses)

# Classic CGRA per-edge-iteration cycles (modulo-scheduled kernel)
CGRA_EDGE = {"bfs": 15, "wcc": 16}
CGRA_SSSP_SCAN_II = 2     # pipelined vertex-search kernel (10 ops)
CGRA_SSSP_EDGE = 14       # update kernel (31 ops)
# Fig. 4: unrolling saturates due to inter-vertex dependencies
UNROLL_ALPHA = 0.65


@dataclasses.dataclass
class BaselineResult:
    cycles: float
    freq_mhz: float

    @property
    def time_us(self) -> float:
        return self.cycles / self.freq_mhz

    def mteps(self, edges: int) -> float:
        return edges / self.time_us if self.time_us > 0 else 0.0


def mcu_cycles(algo: str, g: Graph, src: int = 0) -> BaselineResult:
    if algo == "bfs":
        _, st = reference.bfs(g, src)
        cyc = st["edges_relaxed"] * MCU_EDGE + g.n * MCU_VERTEX
    elif algo == "sssp":
        _, st = reference.sssp(g, src)
        cyc = (st["edges_relaxed"] * MCU_EDGE
               + st["heap_pops"] * MCU_HEAP_OP + g.n * MCU_VERTEX)
    elif algo == "wcc":
        _, st = reference.wcc(g)
        cyc = st["edges_relaxed"] * (MCU_EDGE * 0.6) + g.n * MCU_VERTEX
    else:
        raise ValueError(algo)
    return BaselineResult(cycles=float(cyc), freq_mhz=MCU_FREQ_MHZ)


def unroll_speedup(unroll: int) -> float:
    """Effective parallelism from unrolling on the op-centric CGRA."""
    u = max(1, unroll)
    return u / (1.0 + UNROLL_ALPHA * (u - 1))


def cgra_cycles(algo: str, g: Graph, src: int = 0,
                unroll: int = 1) -> BaselineResult:
    if algo == "bfs":
        _, st = reference.bfs(g, src)
        cyc = st["edges_relaxed"] * CGRA_EDGE["bfs"] / unroll_speedup(unroll)
    elif algo == "wcc":
        _, st = reference.wcc(g)
        cyc = st["edges_relaxed"] * CGRA_EDGE["wcc"] / unroll_speedup(unroll)
    elif algo == "sssp":
        # O(V^2): V iterations x (scan all vertices + relax out-edges)
        deg = g.out_degree()
        cyc = 0.0
        for u in range(g.n):
            cyc += g.n * CGRA_SSSP_SCAN_II + float(deg[u]) * CGRA_SSSP_EDGE
        cyc /= unroll_speedup(unroll)
    else:
        raise ValueError(algo)
    return BaselineResult(cycles=float(cyc), freq_mhz=CGRA_FREQ_MHZ)
