"""FLIP fabric description + timing constants (paper Sec. 3, Sec. 5.1).

The port's copy of `repro.core.arch` (pure Python).

The prototype in the paper: 8x8 PE array @100MHz, 4 vertices per PE (DRF has
4 registers), 2x2 PE clusters as the data-swap unit, 16KB distributed PE
memory + 16KB SPM, 256KB off-chip backing store, YX dimension-ordered
routing with credit-based flow control.

Timing model (derived from the paper's motivating example, Sec. 1.2 and
Sec. 3.2):
  * vertex program execution: 4/5/5 instructions (WCC/BFS/SSSP) on update,
    2/4/4 when the attribute does not change (one instruction/cycle).
  * scatter issue: ALUout injects one packet per cycle.
  * one-hop NoC latency `t_hop` is "close to the computation time of one
    packet" (Sec. 4.1) -- we use 5 cycles; links are pipelined (a link
    accepts a new packet every cycle, credit permitting).
  * Intra-Table search: hashed linked list, avg < 2 cycles -> t_tab = 2.
  * slice swap: load/store of a 2x2-cluster slice through the SPM
    (~260B/PE * 4 PEs at 4B/cycle) + fixed control overhead.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FlipArch:
    width: int = 8                 # PE columns
    height: int = 8                # PE rows
    pe_capacity: int = 4           # vertices per PE (DRF registers)
    cluster: int = 2               # data-swap unit is cluster x cluster PEs
    input_buffer_depth: int = 8    # packets per input port (credit window)
    t_hop: int = 5                 # cycles per NoC hop (latency)
    t_tab: int = 2                 # Intra-Table search cycles
    t_swap: int = 300              # cycles to swap one slice in/out
    freq_mhz: float = 100.0

    @property
    def num_pes(self) -> int:
        return self.width * self.height

    @property
    def capacity(self) -> int:
        """Total vertices resident on-chip."""
        return self.num_pes * self.pe_capacity

    @property
    def clusters_per_row(self) -> int:
        return self.width // self.cluster

    def pe_xy(self, pe: int) -> tuple[int, int]:
        return pe % self.width, pe // self.width

    def pe_id(self, x: int, y: int) -> int:
        return y * self.width + x

    def cluster_of(self, pe: int) -> int:
        x, y = self.pe_xy(pe)
        return (y // self.cluster) * self.clusters_per_row + (x // self.cluster)

    def manhattan(self, pe_a: int, pe_b: int) -> int:
        ax, ay = self.pe_xy(pe_a)
        bx, by = self.pe_xy(pe_b)
        return abs(ax - bx) + abs(ay - by)

    def pe_neighbors(self, pe: int) -> list[int]:
        x, y = self.pe_xy(pe)
        out = []
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = x + dx, y + dy
            if 0 <= nx < self.width and 0 <= ny < self.height:
                out.append(self.pe_id(nx, ny))
        return out

    def yx_route(self, src: int, dst: int) -> list[int]:
        """YX dimension-ordered route: move along Y first, then X.

        Returns the sequence of PEs visited after `src` (ending at `dst`).
        """
        sx, sy = self.pe_xy(src)
        dx, dy = self.pe_xy(dst)
        hops = []
        y = sy
        while y != dy:
            y += 1 if dy > y else -1
            hops.append(self.pe_id(sx, y))
        x = sx
        while x != dx:
            x += 1 if dx > x else -1
            hops.append(self.pe_id(x, dy))
        return hops


DEFAULT_ARCH = FlipArch()
