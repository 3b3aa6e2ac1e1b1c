"""Vertex algebras: a semiring plus everything an algorithm needs to run
on the port's engine (PyTorch state hooks, CUDA relax kernel).

The port of `repro.algebra.programs`: the numpy parts (`landmarks`,
`edge_value(s)`, `initial_attrs/frontier`, the cycle simulator's scalar
hooks `source_value`/`message`/`merge`/`improved_np`/`exe_cycles`,
`results_match`) are carried over verbatim, the engine hooks
(`scatter_carry`, `post_step`, `finalize`) are written in torch.

A `VertexAlgebra` is the generalized vertex program (paper Fig. 5): the
message along edge (u, v) is `attr_u ⊗ W[u, v]`, destinations merge with
⊕, and a vertex scatters iff it became "active". Two activity kinds:

  * monotone  -- attrs improve monotonically under an idempotent ⊕
    (min/max/or); a vertex is active exactly when its attribute strictly
    improved. BFS / SSSP / WCC / widest-path / reachability. These run
    on the asynchronous cycle simulator too (`sim_ok=True`): idempotence
    makes the fixpoint order-independent.
  * residual  -- attrs are un-pushed residual mass over a non-idempotent
    ⊕ (+,x); a vertex is active while its residual exceeds `tol`, and an
    auxiliary per-vertex accumulator (the PageRank score) absorbs every
    pushed residual. Delta-PageRank. Not expressible on the async
    simulator (duplicated in-flight mass would double-count), so
    `sim_ok=False`.

Edge weights are materialized once at table/block build time via
`edge_value` (the ⊗ operand), so every execution layer sees the same
numbers: BFS stores 1 (hop), WCC stores the ⊗-identity (pure label
copy), PageRank stores damping/outdeg(u).

Registering a new algorithm == one `VertexAlgebra(...)` entry in
`ALGEBRAS` plus a numpy oracle in `repro_torch.graphs.reference`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.algebra.semiring import (MAX_MIN, MIN_PLUS, OR_AND,
                                          PLUS_TIMES, Semiring)


def landmarks(n: int, src, d: int) -> np.ndarray:
    """The d landmark vertices feature column f is seeded from.

    Deterministic and shared verbatim by the algebra inits, the numpy
    oracles and the examples: landmark f is the query source advanced by
    f strides of ~n/d, so landmarks spread over the vertex id space and
    landmark 0 is always the source itself. `src` may be a scalar or a
    (B,) batch; the result gains a matching leading axis.
    """
    srcs = np.asarray(src, dtype=np.int64)
    lm = (srcs[..., None] + np.arange(d, dtype=np.int64)
          * max(1, n // d)) % n
    return lm


@dataclasses.dataclass(frozen=True, eq=False)
class VertexAlgebra:
    name: str
    semiring: Semiring
    kind: str = "monotone"       # 'monotone' | 'residual'
    weight_rule: str = "graph"   # 'graph' | 'hop' | 'identity' | 'degree_damped'
    undirected: bool = False     # scatter along both half-edges (WCC)
    all_start: bool = False      # every vertex starts active (WCC, PageRank)
    sim_ok: bool | None = None   # async-simulator expressibility; None =
                                 # derive (idempotent ⊕ and monotone kind)
    exe_update: int = 5          # instructions when the attribute changes
    exe_noupdate: int = 4        # instructions when it does not
    tol: float = 0.0             # residual activity threshold ('residual')
    damping: float = 0.85        # PageRank damping ('degree_damped')
    atol: float = 1e-6           # oracle-comparison tolerance
    feature_dim: int = 1         # native width of the vertex state: 1 =
                                 # classic scalar programs; d > 1 = (n, d)
                                 # feature blocks (multi-landmark / labels)
    feature_init: str = "broadcast"  # how column f of a (n, d) init is
                                 # seeded: 'broadcast' repeats the scalar
                                 # init, 'landmarks' seeds column f at
                                 # landmark f of `landmarks(n, src, d)`

    def __post_init__(self):
        # The asynchronous simulator re-merges in-flight duplicates, which
        # is only sound when ⊕ is idempotent and there is no side
        # accumulator; sim_ok can opt out of that but never opt in. The
        # packet-level simulator is scalar-state only.
        sound = (self.semiring.idempotent and self.kind == "monotone"
                 and self.feature_dim == 1)
        object.__setattr__(
            self, "sim_ok",
            sound if self.sim_ok is None else (self.sim_ok and sound))
        if self.feature_dim < 1:
            raise ValueError(
                f"{self.name}: feature_dim must be >= 1, "
                f"got {self.feature_dim}")
        if self.feature_init not in ("broadcast", "landmarks"):
            raise ValueError(
                f"{self.name}: unknown feature_init {self.feature_init!r}")

    # ------------------------------------------------------------------ #
    # edge materialization (blocks, routing tables)
    # ------------------------------------------------------------------ #
    def edge_value(self, u: int, v: int, w: float,
                   outdeg: np.ndarray) -> float:
        """The ⊗ operand stored for edge (u, v) of raw weight w (scalar
        view of `edge_values`, used by the routing tables). The
        simulator casts through float32 in `message`, so the f32
        production here loses nothing."""
        return float(self.edge_values(np.asarray([u]), np.asarray([v]),
                                      np.asarray([w], dtype=np.float32),
                                      outdeg)[0])

    def edge_values(self, u: np.ndarray, v: np.ndarray, w: np.ndarray,
                    outdeg: np.ndarray) -> np.ndarray:
        """Vectorized ⊗ operands over whole edge arrays (the block-build
        hot path)."""
        u = np.asarray(u)
        if self.weight_rule == "graph":
            return np.asarray(w, dtype=np.float32)
        if self.weight_rule == "hop":
            return np.ones(u.shape, dtype=np.float32)
        if self.weight_rule == "identity":
            return np.full(u.shape, np.float32(self.semiring.one),
                           dtype=np.float32)
        if self.weight_rule == "degree_damped":
            return (self.damping /
                    outdeg[u].astype(np.float64)).astype(np.float32)
        raise ValueError(f"unknown weight_rule {self.weight_rule!r}")

    # ------------------------------------------------------------------ #
    # initial state (original vertex order; engine re-tiles it)
    #
    # `src` is a single source vertex or a sequence of B of them: a scalar
    # yields the classic (n,) vectors, a sequence yields (B, n) -- one
    # independent query per row, the layout every batched layer threads
    # through as (B, ntiles, T).
    #
    # At feature_dim d > 1 (passed explicitly, or the algebra's native
    # width) the state grows a trailing feature axis -- (n, d) / (B, n, d)
    # -- seeded per `feature_init`; the frontier stays per-vertex.
    # ------------------------------------------------------------------ #
    def initial_attrs(self, n: int, src, feature_dim: int | None = None
                      ) -> np.ndarray:
        sr = self.semiring
        d = self.feature_dim if feature_dim is None else feature_dim
        srcs = np.atleast_1d(np.asarray(src, dtype=np.int64))
        b = srcs.shape[0]
        if d > 1 and self.feature_init == "landmarks":
            lm = landmarks(n, srcs, d)                       # (b, d)
            seed = ((1.0 - self.damping) if self.kind == "residual"
                    else sr.one)
            base = 0.0 if self.kind == "residual" else sr.zero
            a = np.full((b, n, d), base, dtype=np.float32)
            a[np.arange(b)[:, None], lm, np.arange(d)[None, :]] = \
                np.float32(seed)
            return a if np.ndim(src) else a[0]
        if self.kind == "residual":
            # un-pushed residual of the series p = sum_k M^k b
            a = np.full((b, n), (1.0 - self.damping) / n, dtype=np.float32)
        elif self.all_start:         # WCC: label = own id
            a = np.broadcast_to(np.arange(n, dtype=np.float32),
                                (b, n)).copy()
        else:
            a = np.full((b, n), sr.zero, dtype=np.float32)
            a[np.arange(b), srcs] = np.float32(sr.one)
        if d > 1:                    # 'broadcast': d identical columns
            a = np.repeat(a[..., None], d, axis=-1)
        return a if np.ndim(src) else a[0]

    def initial_frontier(self, n: int, src, feature_dim: int | None = None
                         ) -> np.ndarray:
        d = self.feature_dim if feature_dim is None else feature_dim
        srcs = np.atleast_1d(np.asarray(src, dtype=np.int64))
        b = srcs.shape[0]
        if d > 1 and self.feature_init == "landmarks":
            # active exactly at the seeded landmarks (per-vertex frontier)
            f = np.zeros((b, n), dtype=bool)
            f[np.arange(b)[:, None], landmarks(n, srcs, d)] = True
        elif self.all_start or self.kind == "residual":
            f = np.ones((b, n), dtype=bool)
        else:
            f = np.zeros((b, n), dtype=bool)
            f[np.arange(b), srcs] = True
        return f if np.ndim(src) else f[0]

    # ------------------------------------------------------------------ #
    # simulator-side scalar ops (numpy)
    # ------------------------------------------------------------------ #
    @property
    def source_value(self) -> float:
        """Bootstrap packet value installed at the source vertex."""
        return float(self.semiring.one)

    def message(self, attr_u, w):
        """Value carried by a packet along edge (u, v) with stored w."""
        return self.semiring.mul_np(np.float32(attr_u), np.float32(w))

    def merge(self, attr_v, msg):
        return self.semiring.add_np(attr_v, msg)

    def improved_np(self, new, old):
        """Strict ⊕-improvement (direction-free: works for min and max)."""
        return np.logical_and(self.semiring.add_np(new, old) == new,
                              new != old)

    def exe_cycles(self, updated: bool) -> int:
        return self.exe_update if updated else self.exe_noupdate

    # ------------------------------------------------------------------ #
    # engine-side step hooks (torch)
    #
    # All hooks are elementwise over the state tensors, so they accept any
    # leading query axes unchanged: the engine passes (B, ntiles, T) and
    # each row of the batch behaves exactly like an independent
    # single-query run.
    #
    # With `features=True` the state carries a trailing feature axis
    # ((..., T, d)) while the frontier stays per-vertex ((..., T)): the
    # frontier broadcasts over the lanes on scatter, and per-lane
    # activity any-reduces back to the vertex on post-step.
    # ------------------------------------------------------------------ #
    def improved(self, new, old):
        return torch.logical_and(self.semiring.add(new, old) == new,
                                 new != old)

    def scatter_carry(self, attrs, frontier, op_mode: bool,
                      features: bool = False):
        """(src_vals, carry) for one relax step.

        The kernel computes  new = carry ⊕ (⊕_u src_vals[u] ⊗ W[u, ·]);
        monotone algebras carry their current attrs (merge folds "no
        update" in), residual algebras carry only the *un-absorbed*
        residual -- active lanes push theirs out, so they carry zero.
        """
        sr = self.semiring
        f = frontier[..., None] if features else frontier
        if self.kind == "residual":
            if op_mode:
                return attrs, torch.zeros_like(attrs)
            sv = torch.where(f, attrs, sr.zero)
            return sv, torch.where(f, sr.zero, attrs)
        sv = attrs if op_mode else torch.where(f, attrs, sr.zero)
        return sv, attrs

    def post_step(self, attrs, aux, src_vals, new_attrs,
                  features: bool = False):
        """(attrs', aux', frontier') after a relax step."""
        if self.kind == "residual":
            act = new_attrs > self.tol
            return (new_attrs, aux + src_vals,
                    act.any(dim=-1) if features else act)
        imp = self.improved(new_attrs, attrs)
        return (new_attrs, aux, imp.any(dim=-1) if features else imp)

    def finalize(self, attrs, aux):
        """Result tensor reported to the caller."""
        return aux if self.kind == "residual" else attrs

    # ------------------------------------------------------------------ #
    # result comparison (tests, CLI self-check, examples)
    # ------------------------------------------------------------------ #
    @staticmethod
    def finite(x):
        """Map ±inf to distinguishable sentinels: widest-path results
        legitimately contain both +inf (source) and -inf (unreached)."""
        return np.clip(np.nan_to_num(np.asarray(x, dtype=np.float64),
                                     posinf=1e30, neginf=-1e30),
                       -1e30, 1e30)

    def results_match(self, got, ref) -> bool:
        """Oracle comparison at this algebra's tolerance.

        A scalar program run at feature_dim d > 1 ('broadcast' init)
        yields d identical columns; comparing such a `(n, d)` result
        against the scalar `(n,)` oracle broadcasts the oracle over the
        feature axis.
        """
        got, ref = np.asarray(got), np.asarray(ref)
        if got.ndim == ref.ndim + 1:
            ref = ref[..., None]
        return bool(np.allclose(self.finite(got), self.finite(ref),
                                atol=self.atol))


# ---------------------------------------------------------------------- #
# registry
# ---------------------------------------------------------------------- #
BFS = VertexAlgebra("bfs", MIN_PLUS, weight_rule="hop",
                    exe_update=5, exe_noupdate=4)
SSSP = VertexAlgebra("sssp", MIN_PLUS, weight_rule="graph",
                     exe_update=5, exe_noupdate=4)
WCC = VertexAlgebra("wcc", MIN_PLUS, weight_rule="identity",
                    undirected=True, all_start=True,
                    exe_update=4, exe_noupdate=2)
WIDEST = VertexAlgebra("widest", MAX_MIN, weight_rule="graph",
                       exe_update=5, exe_noupdate=4)
REACH = VertexAlgebra("reach", OR_AND, weight_rule="identity",
                      exe_update=4, exe_noupdate=2)
PAGERANK = VertexAlgebra("pagerank", PLUS_TIMES, kind="residual",
                         weight_rule="degree_damped", all_start=True,
                         exe_update=6, exe_noupdate=3,
                         tol=1e-9, damping=0.85, atol=1e-4)
# Vector-state programs (feature_dim > 1): column f runs from landmark f
# of `landmarks(n, src, d)`. multi_bfs embeds every vertex by its hop
# distance to d landmarks (one min_plus relaxation amortizing each weight
# block over d lanes); labelprop diffuses d seeded label masses through
# the damped-walk (+, x) operator -- argmax over the feature axis is the
# propagated community label (seeded label spreading).
MULTI_BFS = VertexAlgebra("multi_bfs", MIN_PLUS, weight_rule="hop",
                          exe_update=5, exe_noupdate=4,
                          feature_dim=8, feature_init="landmarks")
LABELPROP = VertexAlgebra("labelprop", PLUS_TIMES, kind="residual",
                          weight_rule="degree_damped",
                          exe_update=6, exe_noupdate=3,
                          tol=1e-9, damping=0.85, atol=1e-4,
                          feature_dim=8, feature_init="landmarks")

ALGEBRAS: dict[str, VertexAlgebra] = {
    a.name: a for a in (BFS, SSSP, WCC, WIDEST, REACH, PAGERANK,
                        MULTI_BFS, LABELPROP)
}


def get_algebra(name: str) -> VertexAlgebra:
    try:
        return ALGEBRAS[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: "
            f"{sorted(ALGEBRAS)}") from None


def register_algebra(algebra: VertexAlgebra) -> VertexAlgebra:
    """Add a new algorithm to every execution layer at once."""
    ALGEBRAS[algebra.name] = algebra
    return algebra
