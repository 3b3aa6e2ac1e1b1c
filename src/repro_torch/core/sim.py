"""Cycle-level simulator of FLIP's data-centric mode (paper Sec. 3, 5.1).

The port's copy of `repro.core.sim`: an event-driven model of the CGRA
fabric that runs on the host in numpy. Its cycles are simulated FLIP
cycles at `arch.freq_mhz`, never a time measured on any device.

Models, per cycle:
  * YX dimension-ordered routing with per-link arbitration (one packet per
    directed link per cycle), pipelined hop latency `t_hop`, and
    credit-based flow control (bounded input buffers, Sec. 3.2.3);
  * packet delivery: slice-id check, Intra-Table search (t_tab), ALUin
    queueing; mismatched slices park in the cluster Memory Buffer;
  * vertex execution: 1 instruction/cycle, 4/5/5 (resp. 2/4/4) instructions
    with (resp. without) an attribute update; updates scatter one packet
    per destination PE per cycle from the ALUout buffer, farthest-first;
  * runtime data swapping (Sec. 3.3): an idle 2x2 cluster loads the slice
    with the earliest pending cached packet (t_swap cycles).

The simulator is the paper-faithful evaluation vehicle: Fig. 10/11/12 and
Table 8 are reproduced from its outputs (the reference's benchmarks/).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.arch import FlipArch
from repro_torch.core.mapping import Mapping
from repro_torch.core.tables import RoutingTables, build_tables
from repro_torch.core.vertex_program import VertexProgram


@dataclasses.dataclass
class Packet:
    src_vertex: int
    value: float
    dst_pe: int
    dst_slice: int
    cur_pe: int
    born: int
    queue_wait: int = 0


@dataclasses.dataclass
class SimResult:
    cycles: int
    attrs: np.ndarray
    packets_delivered: int
    edges_relaxed: int
    avg_parallelism: float        # mean #busy PEs over busy cycles
    max_parallelism: int
    avg_pkt_wait: float           # cycles waiting for arbitration/credit
    max_aluin_depth: int
    swaps: int
    parallelism_trace: np.ndarray

    @property
    def mteps(self) -> float:
        """MTEPS at arch frequency is computed by callers (needs freq)."""
        return self.edges_relaxed / max(self.cycles, 1)


class _PE:
    __slots__ = ("inq", "aluin", "aluout", "busy_until", "pending_scatter",
                 "cur_task")

    def __init__(self):
        # input queues: one per port (4 directions); modeled as a single
        # arbiter-fed pool of per-port FIFOs
        self.inq = {d: deque() for d in ("N", "S", "E", "W", "L")}
        self.aluin: deque = deque()
        self.aluout: deque = deque()
        self.busy_until = -1
        self.cur_task = None         # (dst_vertex, value, src_vertex)
        self.pending_scatter: deque = deque()


def _port_from(arch: FlipArch, frm: int, to: int) -> str:
    fx, fy = arch.pe_xy(frm)
    tx, ty = arch.pe_xy(to)
    if ty > fy:
        return "N"      # arriving from south side
    if ty < fy:
        return "S"
    if tx > fx:
        return "W"
    return "E"


def _next_hop(arch: FlipArch, cur: int, dst: int) -> int:
    """YX dimension-ordered: travel Y first, then X."""
    cx, cy = arch.pe_xy(cur)
    dx, dy = arch.pe_xy(dst)
    if cy != dy:
        return arch.pe_id(cx, cy + (1 if dy > cy else -1))
    return arch.pe_id(cx + (1 if dx > cx else -1), cy)


def simulate(mapping: Mapping, program: VertexProgram,
             src: int = 0,
             tables: RoutingTables | None = None,
             max_cycles: int = 5_000_000) -> SimResult:
    if not program.sim_ok:
        raise ValueError(
            f"program {program.name!r} is not expressible on the "
            "asynchronous cycle simulator (non-idempotent merge); run it "
            "on the JAX engine instead")
    arch = mapping.arch
    g = mapping.graph
    tables = tables or build_tables(mapping, program)

    # NB: the bootstrap tasks below (src_v < 0) always scatter, so the
    # source's first update propagates even though its attribute is
    # pre-set by initial_attrs (a regular merge would see no change).
    attrs = program.initial_attrs(g.n, src).copy()
    pes = [_PE() for _ in range(arch.num_pes)]
    # intra-table fast lookup of a vertex's (copy, pe)
    pe_of, copy_of = mapping.pe_of, mapping.copy_of
    num_clusters = (arch.width // arch.cluster) * (arch.height // arch.cluster)
    num_copies = mapping.num_copies()

    # cluster state for data swapping
    loaded = np.zeros(num_clusters, dtype=np.int64)
    cluster_swap_until = np.full(num_clusters, -1, dtype=np.int64)
    membuf: dict[int, dict[int, deque]] = {c: {} for c in range(num_clusters)}

    cluster_pes = {c: [p for p in range(arch.num_pes)
                       if arch.cluster_of(p) == c]
                   for c in range(num_clusters)}

    # initial activations
    pending_initial: dict[tuple[int, int], list[int]] = {}
    if program.all_start:
        for v in range(g.n):
            key = (arch.cluster_of(int(pe_of[v])), int(copy_of[v]))
            pending_initial.setdefault(key, []).append(v)
        # the loaded slice per cluster starts at copy 0
        for (c, cp), vs in list(pending_initial.items()):
            if cp == 0:
                for v in vs:
                    pes[int(pe_of[v])].aluin.append((v, attrs[v], -1, 0))
                del pending_initial[(c, cp)]
    else:
        src_cluster = arch.cluster_of(int(pe_of[src]))
        loaded[src_cluster] = int(copy_of[src])
        pes[int(pe_of[src])].aluin.append((src, program.source_value, -1, 0))

    in_flight: list[tuple[int, Packet]] = []   # (arrive_cycle, pkt)
    cycle = 0
    delivered = 0
    relaxed = 0
    swaps = 0
    pkt_waits: list[int] = []
    max_aluin = 0
    par_trace: list[int] = []

    def cluster_idle(c: int) -> bool:
        if cluster_swap_until[c] >= cycle:
            return False
        for p in cluster_pes[c]:
            pe = pes[p]
            if pe.busy_until >= cycle or pe.aluin or pe.aluout or \
               pe.pending_scatter or any(pe.inq[d] for d in pe.inq):
                return False
        return True

    def occupancy(pe_idx: int) -> int:
        pe = pes[pe_idx]
        return sum(len(pe.inq[d]) for d in pe.inq)

    rr = 0  # round-robin arbiter offset
    while cycle < max_cycles:
        # ---------------- arrivals from the NoC ----------------------- #
        still = []
        for t, pkt in in_flight:
            if t == cycle:
                port = _port_from(arch, pkt.cur_pe, pkt.dst_pe) \
                    if pkt.cur_pe != pkt.dst_pe else "L"
                # cur_pe tracks the hop the packet just completed
                pes[pkt.cur_pe].inq[port].append(pkt)
            else:
                still.append((t, pkt))
        in_flight = still

        # ---------------- routing / delivery --------------------------- #
        # one packet per output link per cycle; round-robin over ports
        for p in range(arch.num_pes):
            pe = pes[p]
            link_used: set[int] = set()
            ports = ["L", "N", "S", "E", "W"]
            ports = ports[rr % 5:] + ports[:rr % 5]
            for d in ports:
                q = pe.inq[d]
                if not q:
                    continue
                pkt = q[0]
                if pkt.dst_pe == p:
                    # delivery: slice check then Intra-Table search
                    c = arch.cluster_of(p)
                    if pkt.dst_slice == loaded[c] and cluster_swap_until[c] < cycle:
                        q.popleft()
                        delivered += 1
                        pkt_waits.append(pkt.queue_wait)
                        for e in tables.intra_entries(pkt.dst_slice, p,
                                                      pkt.src_vertex):
                            pe.aluin.append((e.dst_vertex, pkt.value,
                                             pkt.src_vertex, e.weight))
                        max_aluin = max(max_aluin, len(pe.aluin))
                    else:
                        q.popleft()
                        membuf[c].setdefault(pkt.dst_slice,
                                             deque()).append(pkt)
                else:
                    nxt = _next_hop(arch, p, pkt.dst_pe)
                    if nxt in link_used:
                        pkt.queue_wait += 1
                        continue
                    # credit-based flow control: bounded downstream buffer
                    if occupancy(nxt) >= arch.input_buffer_depth:
                        pkt.queue_wait += 1
                        continue
                    link_used.add(nxt)
                    q.popleft()
                    pkt.cur_pe = nxt
                    in_flight.append((cycle + arch.t_hop, pkt))

        # ---------------- scatter issue (ALUout, 1 pkt/cycle) ---------- #
        for p in range(arch.num_pes):
            pe = pes[p]
            if pe.pending_scatter and len(pe.aluout) < arch.input_buffer_depth:
                pe.aluout.append(pe.pending_scatter.popleft())
            if pe.aluout:
                entry, value = pe.aluout[0]
                if entry.dst_pe == p:
                    # local destination: no NoC, straight to delivery
                    pe.aluout.popleft()
                    c = arch.cluster_of(p)
                    if entry.dst_slice == loaded[c] and \
                            cluster_swap_until[c] < cycle:
                        delivered += 1
                        for e in tables.intra_entries(entry.dst_slice, p,
                                                      entry.src_vertex):
                            pe.aluin.append((e.dst_vertex, value,
                                             entry.src_vertex, e.weight))
                    else:
                        membuf[c].setdefault(entry.dst_slice, deque()).append(
                            Packet(entry.src_vertex, value, p,
                                   entry.dst_slice, p, cycle))
                else:
                    pkt = Packet(entry.src_vertex, value, entry.dst_pe,
                                 entry.dst_slice, p, cycle)
                    nxt = _next_hop(arch, p, entry.dst_pe)
                    if occupancy(nxt) < arch.input_buffer_depth:
                        pe.aluout.popleft()
                        pkt.cur_pe = nxt
                        in_flight.append((cycle + arch.t_hop, pkt))

        # ---------------- execution ------------------------------------ #
        busy = 0
        for p in range(arch.num_pes):
            pe = pes[p]
            if pe.busy_until >= cycle:
                busy += 1
                continue
            if pe.cur_task is not None:
                # retire: apply merge, maybe scatter. Bootstrap/initial
                # tasks (src_v < 0) always scatter their value.
                v, value, src_v, w = pe.cur_task
                pe.cur_task = None
                if src_v < 0:
                    attrs[v] = program.merge(attrs[v], np.float32(value))
                    for e in tables.inter_entries(int(copy_of[v]), p, v):
                        pe.pending_scatter.append((e, float(attrs[v])))
                else:
                    msg = program.message(np.float32(value), np.float32(w))
                    relaxed += 1
                    if bool(program.improved_np(msg, attrs[v])):
                        attrs[v] = msg
                        for e in tables.inter_entries(int(copy_of[v]), p, v):
                            pe.pending_scatter.append((e, float(attrs[v])))
            if pe.aluin and pe.cur_task is None and pe.busy_until < cycle:
                v, value, src_v, w = pe.aluin.popleft()
                # table search + program execution; update/no-update cost
                # decided by a peek at the merge result
                msg = program.message(np.float32(value), np.float32(w)) \
                    if src_v >= 0 else np.float32(value)
                updated = src_v < 0 or bool(program.improved_np(msg, attrs[v]))
                cost = arch.t_tab + program.exe_cycles(updated)
                pe.busy_until = cycle + cost - 1
                pe.cur_task = (v, value, src_v, w)
                busy += 1
        par_trace.append(busy)

        # ---------------- runtime data swapping ------------------------ #
        for c in range(num_clusters):
            if cluster_swap_until[c] >= cycle:
                continue
            pend = {s: q for s, q in membuf[c].items() if q}
            pend_init = {cp for (cc, cp) in pending_initial if cc == c}
            if (pend or pend_init) and cluster_idle(c):
                # earliest pending task first
                cand = []
                for s, q in pend.items():
                    cand.append((q[0].born, s))
                for cp in pend_init:
                    cand.append((-1, cp))
                cand.sort()
                _, s = cand[0]
                cluster_swap_until[c] = cycle + arch.t_swap
                loaded[c] = s
                swaps += 1
                # replay buffered packets for slice s
                q = membuf[c].pop(s, deque())
                while q:
                    pkt = q.popleft()
                    for e in tables.intra_entries(s, pkt.dst_pe,
                                                  pkt.src_vertex):
                        pes[pkt.dst_pe].aluin.append(
                            (e.dst_vertex, pkt.value, pkt.src_vertex,
                             e.weight))
                    delivered += 1
                if (c, s) in pending_initial:
                    for v in pending_initial.pop((c, s)):
                        pes[int(pe_of[v])].aluin.append((v, attrs[v], -1, 0))

        rr += 1
        cycle += 1

        # ---------------- termination ---------------------------------- #
        if not in_flight and not any(
                pe.busy_until >= cycle or pe.cur_task is not None or pe.aluin
                or pe.aluout or pe.pending_scatter
                or any(pe.inq[d] for d in pe.inq) for pe in pes):
            if not any(q for bufs in membuf.values() for q in bufs.values()) \
                    and not pending_initial:
                break
            if not any(cluster_swap_until[c] >= cycle
                       for c in range(num_clusters)):
                # idle but pending swaps exist -> they trigger next cycle
                continue

    trace = np.asarray(par_trace, dtype=np.int64)
    busy_cycles = trace[trace > 0]
    return SimResult(
        cycles=cycle,
        attrs=attrs,
        packets_delivered=delivered,
        edges_relaxed=relaxed,
        avg_parallelism=float(busy_cycles.mean()) if len(busy_cycles) else 0.0,
        max_parallelism=int(trace.max()) if len(trace) else 0,
        avg_pkt_wait=float(np.mean(pkt_waits)) if pkt_waits else 0.0,
        max_aluin_depth=max_aluin,
        swaps=swaps,
        parallelism_trace=trace,
    )
