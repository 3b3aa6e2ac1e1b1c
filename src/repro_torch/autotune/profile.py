"""GraphProfile: the cheap runtime-shape summary the plan autotuner
keys on.

The port of `repro.autotune.profile`. A `GraphProfile` captures the
runtime shape of the data from a few capped numpy probe steps (no
device work):

  * size:       n, m;
  * degrees:    log2-bucketed out-degree histogram (hub-dominated
                power-law graphs and flat road networks land in
                visibly different buckets);
  * trajectory: estimated frontier density per step from a capped
                BFS-style reachability probe -- the fraction of
                vertices newly activated each step;
  * execution:  feature width d, the torch device type ('cuda' or
                'cpu') and device kind (the GPU's name, or 'cpu'): a
                tuning result measured on the CPU, or on another card,
                is never served to this session.

`fingerprint()` is a stable content hash of all of the above, computed
exactly as the reference computes it: two sessions over the same graph
shape on the same device share one tuning-store entry, and any change
-- a mutation batch, a different d, a different card -- changes the
fingerprint, so stale entries are structurally unreachable (see
`repro_torch.autotune.store`).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph

# probe caps: the profile must stay O(m) numpy work no matter the graph
PROBE_STEPS = 12           # frontier-expansion steps recorded
DEGREE_BUCKETS = 16        # log2 out-degree histogram buckets
SCHEMA = 1                 # bumped when the profile features change


@dataclasses.dataclass(frozen=True)
class GraphProfile:
    """Immutable runtime-shape summary of one (graph, d, device)."""

    n: int
    m: int
    degree_hist: tuple          # (DEGREE_BUCKETS,) log2 out-deg counts
    density_trajectory: tuple   # per-probe-step newly-active fraction
    feature_dim: int
    backend: str                # torch device type at profile time
    device_kind: str            # the GPU's name, or 'cpu'

    # -------------------------------------------------------------- #
    @property
    def mean_density(self) -> float:
        """Mean per-step frontier density over the probe trajectory --
        the single scalar the analytic cost model leans on hardest."""
        t = self.density_trajectory
        return float(np.mean(t)) if t else 1.0

    @property
    def peak_density(self) -> float:
        t = self.density_trajectory
        return float(np.max(t)) if t else 1.0

    def fingerprint(self) -> str:
        """Stable content hash: the tuning-store key for this shape."""
        h = hashlib.blake2b(digest_size=16)
        h.update(f"{SCHEMA}|{self.n}|{self.m}|{self.feature_dim}|"
                 f"{self.backend}|{self.device_kind}".encode())
        h.update(np.asarray(self.degree_hist, dtype=np.int64).tobytes())
        # round so float noise can never fork the key
        h.update(np.round(np.asarray(self.density_trajectory,
                                     dtype=np.float64), 4).tobytes())
        return h.hexdigest()

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA, "n": self.n, "m": self.m,
            "degree_hist": list(self.degree_hist),
            "density_trajectory": [round(float(x), 6)
                                   for x in self.density_trajectory],
            "feature_dim": self.feature_dim, "backend": self.backend,
            "device_kind": self.device_kind,
            "fingerprint": self.fingerprint(),
        }


def _probe_trajectory(graph: Graph, steps: int = PROBE_STEPS,
                      src: int | None = None) -> tuple:
    """Frontier-density trajectory from a capped reachability probe.

    Pure numpy BFS-style expansion from a deterministic source (the
    max-out-degree vertex, so the profile -- and the fingerprint -- is
    reproducible): per step, the fraction of vertices *newly*
    activated. Stops early when the frontier dies. O(m) total cost.
    """
    n = graph.n
    if n == 0:
        return ()
    if src is None:
        src = int(np.argmax(graph.out_degree()))
    indptr = np.asarray(graph.indptr, dtype=np.int64)
    indices = np.asarray(graph.indices, dtype=np.int64)
    starts = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    visited = np.zeros(n, dtype=bool)
    frontier = np.zeros(n, dtype=bool)
    visited[src] = frontier[src] = True
    traj = [1.0 / n]
    for _ in range(steps - 1):
        # successors of the frontier, via the flat CSR expansion
        sel = frontier[starts]
        nxt = np.zeros(n, dtype=bool)
        nxt[indices[sel]] = True
        nxt &= ~visited
        if not nxt.any():
            break
        visited |= nxt
        frontier = nxt
        traj.append(float(nxt.sum()) / n)
    return tuple(traj)


def profile_graph(graph: Graph, *, feature_dim: int = 1,
                  backend: str | None = None,
                  device_kind: str | None = None,
                  probe_steps: int = PROBE_STEPS,
                  device=None) -> GraphProfile:
    """Profile one graph for the autotuner (see module doc). Backend
    and device kind default to those of `device` (default: the CUDA
    device; raises without one); pass them explicitly to profile *for*
    a target (or in tests)."""
    if backend is None or device_kind is None:
        dev = resolve_device(device, "profile_graph")
        backend = backend or dev.type
        if device_kind is None:
            device_kind = (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else dev.type)
    deg = graph.out_degree()
    buckets = np.minimum(
        np.log2(np.maximum(deg, 1)).astype(np.int64),
        DEGREE_BUCKETS - 1)
    hist = np.bincount(buckets, minlength=DEGREE_BUCKETS)
    return GraphProfile(
        n=int(graph.n), m=int(graph.m),
        degree_hist=tuple(int(x) for x in hist),
        density_trajectory=_probe_trajectory(graph, steps=probe_steps),
        feature_dim=int(feature_dim), backend=str(backend),
        device_kind=str(device_kind))
