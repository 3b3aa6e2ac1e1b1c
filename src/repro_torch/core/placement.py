"""Data-centric expert placement: the FLIP mapping compiler applied to MoE.

The port of `repro.core.placement`, on the port's mapping compiler
(`repro_torch.core.mapping.compile_mapping`), host numpy like the
reference: the same router decisions give the same permutation.

FLIP's insight is that *data* should be pinned to compute sites and the
dynamic traffic routed between them, with placement compiled to minimize
expected routing cost. MoE expert-parallel dispatch is the same problem:

  vertices  = experts                (pinned to devices, like DRF slots)
  edges     = co-activation affinity (tokens routed to expert i AND j pay
                                      cross-device hops if i, j are far)
  PE array  = the expert-parallel ranks laid out as a virtual grid
              (neighbouring ranks are 1 hop)

`place_experts` reuses `compile_mapping` verbatim on the affinity graph and
returns an expert permutation: experts that co-fire land on the same or
adjacent ranks, shrinking the all-to-all fan-out per token
(`repro_torch.distributed.moe_ep`).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core.arch import FlipArch
from repro_torch.core.mapping import compile_mapping
from repro_torch.graphs.csr import Graph


def expert_affinity(topk_indices: np.ndarray, num_experts: int) -> np.ndarray:
    """Co-activation counts from router decisions.

    topk_indices: (tokens, k) int array of routed expert ids.
    Returns (E, E) symmetric affinity: #tokens routed to both i and j.
    """
    aff = np.zeros((num_experts, num_experts), dtype=np.float64)
    for row in topk_indices:
        row = np.unique(row)
        for a in range(len(row)):
            for b in range(a + 1, len(row)):
                aff[row[a], row[b]] += 1
                aff[row[b], row[a]] += 1
    return aff


@dataclasses.dataclass
class ExpertPlacement:
    perm: np.ndarray          # new order: perm[k] = original expert id at
                              # slot k (slots are contiguous per device)
    device_of: np.ndarray     # (E,) device index of each original expert
    est_cost: float           # affinity-weighted routing length
    baseline_cost: float      # same metric for the identity placement


def _grid_dims(n: int) -> tuple[int, int]:
    h = int(np.sqrt(n))
    while n % h:
        h -= 1
    return n // h, h


def place_experts(affinity: np.ndarray, num_devices: int,
                  seed: int = 0, effort: int = 1) -> ExpertPlacement:
    """Map experts onto `num_devices` devices (laid out as a virtual grid)
    minimizing affinity-weighted routing length via the FLIP compiler."""
    num_experts = affinity.shape[0]
    if num_experts % num_devices:
        raise ValueError(f"{num_experts} experts do not divide over "
                         f"{num_devices} devices")
    cap = num_experts // num_devices
    gw, gh = _grid_dims(num_devices)
    arch = FlipArch(width=gw, height=gh, pe_capacity=cap, cluster=1,
                    t_swap=0)

    # affinity graph: keep edges above the mean to bound compile cost
    edges, weights = [], []
    thresh = affinity[affinity > 0].mean() if (affinity > 0).any() else 0.0
    for i in range(num_experts):
        for j in range(i + 1, num_experts):
            if affinity[i, j] > thresh:
                edges.append((i, j))
                weights.append(float(affinity[i, j]))
    g = Graph.from_edges(num_experts, edges, weights, directed=False) \
        if edges else Graph.from_edges(
            num_experts, [(i, (i + 1) % num_experts)
                          for i in range(num_experts)], directed=False)

    mapping = compile_mapping(g, arch=arch, effort=effort, seed=seed,
                              weighted=True)

    # routing cost weighted by full affinity (not just kept edges)
    def cost(device_of):
        xs = np.array([arch.pe_xy(p)[0] for p in range(arch.num_pes)])
        ys = np.array([arch.pe_xy(p)[1] for p in range(arch.num_pes)])
        c = 0.0
        for i in range(num_experts):
            for j in range(i + 1, num_experts):
                if affinity[i, j]:
                    pi, pj = device_of[i], device_of[j]
                    c += affinity[i, j] * (abs(xs[pi] - xs[pj])
                                           + abs(ys[pi] - ys[pj]))
        return c

    device_of = mapping.pe_of.astype(np.int64)
    ident = np.arange(num_experts) // cap
    # perm: experts sorted by (device, register) -> contiguous device slots
    order = np.asarray(
        [v for _, v in sorted((int(device_of[e]), e)
                              for e in range(num_experts))])
    return ExpertPlacement(perm=order, device_of=device_of,
                           est_cost=cost(device_of),
                           baseline_cost=cost(ident))
