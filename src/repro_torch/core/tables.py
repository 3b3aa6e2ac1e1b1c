"""Inter-PE / Intra-PE routing tables (paper Sec. 3.2, Fig. 7) and the
"farthest-one-first" data layout (Sec. 4.3).

The port's copy of `repro.core.tables` (numpy only).

Inter-Table (per PE): for each locally-stored vertex u, the destination PEs
of u's outgoing edges with their x/y offsets and destination slice ids.
One entry per (u, destination PE); entries are sorted by descending route
length so the longest (likely critical-path) packet is issued first.

Intra-Table (per PE): for each incoming edge (u -> v) with v stored locally,
the DRF register of v and the edge's ⊗ operand, hashed by src id (src % 8)
into short linked lists (avg search < 2 cycles -> arch.t_tab).

Stored weights are materialized through the program's algebra
(`edge_value`): BFS stores the hop constant 1, WCC the ⊗-identity,
SSSP/widest the raw graph weight -- so the simulator's
`message = attr ⊗ weight` needs no per-algorithm branching.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.mapping import Mapping
from repro_torch.core.vertex_program import VertexProgram
from repro_torch.graphs.csr import Graph


@dataclasses.dataclass(frozen=True)
class InterEntry:
    src_vertex: int
    dst_pe: int
    dst_slice: int
    route_len: int


@dataclasses.dataclass(frozen=True)
class IntraEntry:
    src_vertex: int
    dst_vertex: int
    dst_register: int
    weight: float


def scatter_graph(graph: Graph, program: VertexProgram) -> Graph:
    """Edge set actually scattered along: undirected programs (WCC) send
    updates along both edge directions."""
    if not program.undirected:
        return graph
    edges, ws = [], []
    for u, v, w in graph.edge_list():
        edges.append((u, v)); ws.append(w)
        edges.append((v, u)); ws.append(w)
    return Graph.from_edges(graph.n, edges, ws, directed=True)


@dataclasses.dataclass
class RoutingTables:
    # inter[(copy, pe)][u] -> [InterEntry...] farthest-first
    inter: dict
    # intra[(copy, pe)][src_vertex] -> [IntraEntry...]
    intra: dict
    graph: Graph          # the scatter graph (symmetrized for WCC)

    def inter_entries(self, copy: int, pe: int, u: int):
        return self.inter.get((copy, pe), {}).get(u, [])

    def intra_entries(self, copy: int, pe: int, src: int):
        return self.intra.get((copy, pe), {}).get(src, [])


def build_tables(mapping: Mapping, program: VertexProgram,
                 farthest_first: bool = True) -> RoutingTables:
    g = scatter_graph(mapping.graph, program)
    outdeg = g.out_degree()
    reg = mapping.register_index()
    inter: dict = {}
    intra: dict = {}
    for u in range(g.n):
        u_key = (mapping.slice_of(u), int(mapping.pe_of[u]))
        # group u's out edges by destination PE: one packet per (u, dst PE)
        by_pe: dict[tuple[int, int], list[tuple[int, float]]] = {}
        for k in range(g.indptr[u], g.indptr[u + 1]):
            v = int(g.indices[k])
            w = program.edge_value(u, v, float(g.weights[k]), outdeg)
            v_key = (mapping.slice_of(v), int(mapping.pe_of[v]))
            by_pe.setdefault(v_key, []).append((v, w))
            intra.setdefault(v_key, {}).setdefault(u, []).append(
                IntraEntry(src_vertex=u, dst_vertex=v,
                           dst_register=int(reg[v]), weight=w))
        entries = [
            InterEntry(src_vertex=u, dst_pe=pe, dst_slice=sl,
                       route_len=mapping.arch.manhattan(
                           int(mapping.pe_of[u]), pe))
            for (sl, pe) in by_pe
        ]
        if farthest_first:
            entries.sort(key=lambda e: -e.route_len)
        inter.setdefault(u_key, {})[u] = entries
    return RoutingTables(inter=inter, intra=intra, graph=g)
