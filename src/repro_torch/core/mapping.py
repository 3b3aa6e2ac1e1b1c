"""FLIP mapping compiler (paper Sec. 4, Algorithms 1 & 2).

The port's copy of `repro.core.mapping` (numpy only). It draws from the
same `np.random.default_rng(seed)` stream in the same order, so a
mapping's `pe_of`/`copy_of` equal the reference's for the same graph,
arch, program, effort and seed (tests/test_torch_sim.py).

Maps graph vertices onto the (possibly replicated, for data swapping) PE
array, minimizing total YX routing length while avoiding sequentialization
(two co-located vertices sharing an in-neighbor must execute serially).

Phase 1: beam search (k = 10) seeded with the graph center at the array
center, scoring partial mappings by total Manhattan routing length over
fully-mapped edges.
Phase 2: local pairwise swaps between a random PE and its neighbors,
accepted when the partial-runtime estimation model (Algorithm 2) predicts
an improvement; stops when stable.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core.arch import FlipArch, DEFAULT_ARCH
from repro_torch.core.vertex_program import VertexProgram, SSSP
from repro_torch.graphs.csr import Graph


@dataclasses.dataclass
class Mapping:
    """Many-to-one vertex -> (replica copy, physical PE) assignment."""

    arch: FlipArch
    graph: Graph
    pe_of: np.ndarray      # (n,) int32: physical PE id of each vertex
    copy_of: np.ndarray    # (n,) int32: replica (slice) index of each vertex

    # ------------------------------------------------------------------ #
    def slice_of(self, v: int) -> int:
        """Slice id = replica copy (slices are per 2x2 cluster, one copy
        of a cluster's vertices per replica)."""
        return int(self.copy_of[v])

    def cluster_of(self, v: int) -> int:
        return self.arch.cluster_of(int(self.pe_of[v]))

    def vertices_on(self, pe: int, copy: int | None = None) -> list[int]:
        sel = self.pe_of == pe
        if copy is not None:
            sel &= self.copy_of == copy
        return list(np.nonzero(sel)[0])

    def register_index(self) -> np.ndarray:
        """DRF register slot of each vertex within its (copy, PE)."""
        reg = np.zeros(self.graph.n, dtype=np.int32)
        seen: dict[tuple[int, int], int] = {}
        for v in range(self.graph.n):
            key = (int(self.copy_of[v]), int(self.pe_of[v]))
            reg[v] = seen.get(key, 0)
            seen[key] = reg[v] + 1
        return reg

    def route_length(self, u: int, v: int) -> int:
        return self.arch.manhattan(int(self.pe_of[u]), int(self.pe_of[v]))

    def total_routing_length(self) -> int:
        return sum(self.route_length(u, v) for u, v, _ in self.graph.edge_list())

    def avg_routing_length(self) -> float:
        m = self.graph.m
        return self.total_routing_length() / max(m, 1)

    def num_copies(self) -> int:
        return int(self.copy_of.max()) + 1 if self.graph.n else 1

    def validate(self) -> None:
        """Invariants: every vertex mapped, capacity respected."""
        assert self.pe_of.shape == (self.graph.n,)
        assert (self.pe_of >= 0).all() and (self.pe_of < self.arch.num_pes).all()
        counts: dict[tuple[int, int], int] = {}
        for v in range(self.graph.n):
            key = (int(self.copy_of[v]), int(self.pe_of[v]))
            counts[key] = counts.get(key, 0) + 1
            assert counts[key] <= self.arch.pe_capacity, (
                f"PE {key} over capacity")

    # ------------------------------------------------------------------ #
    def collision_sets(self) -> dict[tuple[int, int], list[int]]:
        """Sequentialization barriers (Sec. 4.1): vertices co-located on one
        (copy, PE) that share an in-neighbor. Key: (pe, src_vertex)."""
        out: dict[tuple[int, int], list[int]] = {}
        for u in range(self.graph.n):
            targets: dict[int, list[int]] = {}
            for v in self.graph.neighbors(u):
                key = (int(self.copy_of[v]), int(self.pe_of[v]))
                targets.setdefault(key[1], []).append(int(v))
            for pe, vs in targets.items():
                if len(vs) > 1:
                    out[(pe, u)] = vs
        return out


# ====================================================================== #
# Algorithm 2: partial run-time estimation model
# ====================================================================== #
class RuntimeEstimator:
    """Estimates the time for updates to pass through the one-hop
    neighborhood of a vertex pair (paper Algorithm 2)."""

    def __init__(self, arch: FlipArch, graph: Graph,
                 program: VertexProgram = SSSP,
                 epsilon: int | None = None):
        self.arch = arch
        self.graph = graph
        self.program = program
        self.epsilon = arch.t_swap if epsilon is None else epsilon
        self.in_map = graph.in_neighbors_map()

    def _edges_of(self, v: int):
        """Incoming and outgoing edges of v as (src, dst) pairs."""
        out = [(v, int(w)) for w in self.graph.neighbors(v)]
        inc = [(int(u), v) for u, _ in self.in_map[v]]
        return out + inc

    def edge_time(self, pe_of, copy_of, src: int, dst: int) -> float:
        arch = self.arch
        hops = arch.manhattan(int(pe_of[src]), int(pe_of[dst]))
        t_trans = hops * arch.t_hop
        # same physical cluster but different slice -> swap overhead
        if (arch.cluster_of(int(pe_of[src])) == arch.cluster_of(int(pe_of[dst]))
                and copy_of[src] != copy_of[dst]):
            t_trans += self.epsilon
        # congestion: siblings of dst on the same PE sharing the source
        siblings = [v for v in self.graph.neighbors(src)
                    if pe_of[v] == pe_of[dst] and copy_of[v] == copy_of[dst]]
        t_proc = self.arch.t_tab + self.program.exe_update
        if len(siblings) > 1:
            # worst case: dst is the last vertex in sequential processing
            return t_trans + len(siblings) * t_proc
        return t_trans + t_proc

    def partial_runtime(self, pe_of, copy_of, u: int, v: int) -> float:
        t = 0.0
        for s, d in set(self._edges_of(u)) | set(self._edges_of(v)):
            t += self.edge_time(pe_of, copy_of, s, d)
        return t

    def swap_benefit(self, mapping: Mapping, u: int, v: int) -> float:
        """Benefit (>0 is good) of swapping the placements of u and v."""
        pe_of, copy_of = mapping.pe_of, mapping.copy_of
        before = self.partial_runtime(pe_of, copy_of, u, v)
        pe2, cp2 = pe_of.copy(), copy_of.copy()
        pe2[u], pe2[v] = pe_of[v], pe_of[u]
        cp2[u], cp2[v] = copy_of[v], copy_of[u]
        after = self.partial_runtime(pe2, cp2, u, v)
        return before - after


def _weighted_adjacency(graph: Graph, weighted: bool = False):
    """Per-vertex (neighbor ids, edge weights) arrays over the undirected
    closure. The paper's placement objective is UNWEIGHTED routing length
    (weighted=False: every edge counts 1 per direction); the MoE placement
    bridge passes weighted=True to use affinity weights."""
    acc: list[dict[int, float]] = [dict() for _ in range(graph.n)]
    for u, v, w in graph.edge_list():
        ww = w if weighted else 1.0
        acc[u][v] = acc[u].get(v, 0.0) + ww
        acc[v][u] = acc[v].get(u, 0.0) + ww
    out = []
    for d in acc:
        ns = np.asarray(sorted(d), dtype=np.int64)
        ws = np.asarray([d[k] for k in sorted(d)], dtype=np.float64)
        out.append((ns, ws))
    return out


# ====================================================================== #
# Algorithm 1: two-phase mapping
# ====================================================================== #
def _beam_search(graph: Graph, arch: FlipArch, num_copies: int,
                 beam_width: int, rng: np.random.Generator,
                 weighted: bool = False):
    """Phase 1: routing-length-driven placement.

    State: (cost, pe_of, copy_of, free list) with incremental cost updates.
    Candidate vertices are the frontier (unmapped neighbors of mapped
    vertices); candidate PEs are slots adjacent to used PEs (plus used PEs
    with spare capacity), across all replica copies.
    """
    n = graph.n
    adj = graph.undirected_adjacency()
    wadj = _weighted_adjacency(graph, weighted)
    center_v = graph.center_vertex()
    center_pe = arch.pe_id(arch.width // 2, arch.height // 2)

    # A slot is (copy, pe). Capacity per slot = arch.pe_capacity.
    def new_state():
        pe_of = np.full(n, -1, dtype=np.int32)
        copy_of = np.full(n, -1, dtype=np.int32)
        used = np.zeros((num_copies, arch.num_pes), dtype=np.int32)
        return [0.0, pe_of, copy_of, used]

    root = new_state()
    root[1][center_v] = center_pe
    root[2][center_v] = 0
    root[3][0, center_pe] = 1
    beams = [root]

    # order of placement: BFS from the center (matches the frontier-like
    # candidate set of the paper and guarantees every vertex gets placed,
    # including vertices unreachable from the center)
    order = []
    seen = {center_v}
    queue = [center_v]
    while queue:
        u = queue.pop(0)
        order.append(u)
        for w in sorted(adj[u]):
            if w not in seen:
                seen.add(w)
                queue.append(w)
    for v in range(n):
        if v not in seen:
            order.append(v)

    xs = np.array([arch.pe_xy(p)[0] for p in range(arch.num_pes)])
    ys = np.array([arch.pe_xy(p)[1] for p in range(arch.num_pes)])

    for v in order[1:]:
        nbrs, nbr_ws = wadj[v]
        candidates = []  # (total_cost, beam_idx, pe, copy)
        for bi, (cost, pe_of, copy_of, used) in enumerate(beams):
            sel = pe_of[nbrs] >= 0
            mapped_nbrs = nbrs[sel]
            # incremental (weighted) routing length to each physical PE
            if len(mapped_nbrs):
                delta = np.zeros(arch.num_pes)
                for w, ew in zip(mapped_nbrs, nbr_ws[sel]):
                    wx, wy = arch.pe_xy(int(pe_of[w]))
                    delta += ew * (np.abs(xs - wx) + np.abs(ys - wy))
            else:
                delta = np.zeros(arch.num_pes)
            # candidate PEs: any slot with capacity left, preferring ones
            # near used PEs; scan copies in order (earlier copies first)
            free = used < arch.pe_capacity
            for copy in range(num_copies):
                pes = np.nonzero(free[copy])[0]
                if len(pes) == 0:
                    continue
                costs = cost + delta[pes]
                top = np.argsort(costs, kind="stable")[:beam_width]
                for t in top:
                    candidates.append((float(costs[t]), bi, int(pes[t]), copy))
                break_after = len(mapped_nbrs) > 0
                if break_after and len(pes) > 0:
                    # with mapped neighbors the best physical PE dominates;
                    # still allow later copies only when this copy is full
                    break
        candidates.sort(key=lambda c: c[0])
        next_beams = []
        sig_seen = set()
        for tot, bi, pe, copy in candidates:
            if len(next_beams) >= beam_width:
                break
            sig = (bi, pe, copy)
            if sig in sig_seen:
                continue
            sig_seen.add(sig)
            cost, pe_of, copy_of, used = beams[bi]
            pe2, cp2, used2 = pe_of.copy(), copy_of.copy(), used.copy()
            pe2[v] = pe
            cp2[v] = copy
            used2[copy, pe] += 1
            next_beams.append([tot, pe2, cp2, used2])
        beams = next_beams
    best = min(beams, key=lambda b: b[0])
    return best[1], best[2]


def _sa_refine(graph: Graph, arch: FlipArch, pe_of, copy_of,
               rng: np.random.Generator, sweeps: int = 10,
               t0: float = 2.0, cooling: float = 0.85,
               t_min: float = 0.02, slice_pen: float = 6.0,
               weighted: bool = False):
    """Routing-length refinement with the paper's local-swap move set plus
    occasional uphill acceptance (simulated annealing). Same objective as
    beam search (total routing length) with the Sec. 4.4 cross-slice
    penalty; Algorithm 2's estimator-guided pass runs afterwards to handle
    sequentialization.
    """
    n = graph.n
    wadj = _weighted_adjacency(graph, weighted)
    if weighted:
        mean_w = np.mean([w.mean() for _, w in wadj if len(w)]) or 1.0
        t0, t_min = t0 * mean_w, t_min * mean_w
    xs = np.array([arch.pe_xy(p)[0] for p in range(arch.num_pes)])
    ys = np.array([arch.pe_xy(p)[1] for p in range(arch.num_pes)])
    cl = np.array([arch.cluster_of(p) for p in range(arch.num_pes)])
    pe_of = pe_of.astype(np.int64)
    copy_of = copy_of.astype(np.int64)

    def vcost(v: int, pe: int, cp: int) -> float:
        ns, ws = wadj[v]
        if len(ns) == 0:
            return 0.0
        pn = pe_of[ns]
        c = float((ws * (np.abs(xs[pn] - xs[pe])
                         + np.abs(ys[pn] - ys[pe]))).sum())
        if slice_pen:
            c += slice_pen * float(np.sum((cl[pn] == cl[pe])
                                          & (copy_of[ns] != cp)))
        return c

    temp = t0
    iters_per_t = max(1000, 12 * n)
    while temp > t_min:
        for _ in range(iters_per_t):
            u = int(rng.integers(0, n))
            v = int(rng.integers(0, n))
            pu, pv = int(pe_of[u]), int(pe_of[v])
            cu, cv = int(copy_of[u]), int(copy_of[v])
            if u == v or (pu == pv and cu == cv):
                continue
            before = vcost(u, pu, cu) + vcost(v, pv, cv)
            pe_of[u], pe_of[v] = pv, pu
            copy_of[u], copy_of[v] = cv, cu
            after = vcost(u, pv, cv) + vcost(v, pu, cu)
            d = after - before
            if d < 0 or rng.random() < np.exp(-d / temp):
                pass
            else:
                pe_of[u], pe_of[v] = pu, pv
                copy_of[u], copy_of[v] = cu, cv
        temp *= cooling
    return pe_of.astype(np.int32), copy_of.astype(np.int32)


def compile_mapping(graph: Graph, arch: FlipArch = DEFAULT_ARCH,
                    program: VertexProgram = SSSP,
                    beam_width: int = 10,
                    opt_iters: int | None = None,
                    stable_after: int = 60,
                    effort: int = 1,
                    weighted: bool = False,
                    seed: int = 0) -> Mapping:
    """Full Algorithm 1: beam-search init + local-swap refinement +
    estimator-guided sequentialization polish.

    effort: 0 = beam search only (fastest), 1 = default (+SA refinement),
    2 = heavy (longer anneal; for offline/Table-8-quality mappings).
    """
    rng = np.random.default_rng(seed)
    num_copies = max(1, -(-graph.n // arch.capacity))   # ceil
    pe_of, copy_of = _beam_search(graph, arch, num_copies, beam_width,
                                  rng, weighted=weighted)
    if effort >= 1:
        pe_of, copy_of = _sa_refine(
            graph, arch, pe_of, copy_of, rng,
            t0=2.0 if effort == 1 else 3.0,
            cooling=0.85 if effort == 1 else 0.92, weighted=weighted)
    mapping = Mapping(arch=arch, graph=graph, pe_of=pe_of, copy_of=copy_of)
    mapping.validate()

    est = RuntimeEstimator(arch, graph, program)
    if opt_iters is None:
        opt_iters = 4 * arch.num_pes * num_copies
    since_improved = 0
    it = 0
    while it < opt_iters and since_improved < stable_after:
        it += 1
        p = int(rng.integers(0, arch.num_pes))
        cp = int(rng.integers(0, num_copies))
        vs_here = mapping.vertices_on(p, cp)
        if not vs_here:
            since_improved += 1
            continue
        nbr_pes = mapping.arch.pe_neighbors(p)
        vs_nbr = [v for q in nbr_pes for v in mapping.vertices_on(q)]
        if not vs_nbr:
            since_improved += 1
            continue
        best_pair, best_c = None, 0.0
        for u in vs_here:
            for v in vs_nbr:
                c = est.swap_benefit(mapping, int(u), int(v))
                if c > best_c:
                    best_pair, best_c = (int(u), int(v)), c
        if best_pair is not None:
            u, v = best_pair
            mapping.pe_of[u], mapping.pe_of[v] = mapping.pe_of[v], mapping.pe_of[u]
            mapping.copy_of[u], mapping.copy_of[v] = (mapping.copy_of[v],
                                                      mapping.copy_of[u])
            since_improved = 0
        else:
            since_improved += 1
    mapping.validate()
    return mapping
