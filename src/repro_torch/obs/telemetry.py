"""Per-step query telemetry: the schema every execution layer emits.

The port's copy of `repro.obs.telemetry` (numpy only). FLIP's step
cost tracks the evolving frontier, so the engine records, per fixpoint
step, the quantities the relax step already implies:

  * ``active_vertices``  (steps, B) -- live frontier lanes per query;
  * ``active_tiles``     (steps,)   -- tiles with any active source lane
    (the kernel's packet-trigger condition, any query of the batch);
  * ``blocks_fetched``   (steps,)   -- weight blocks with an active
    source tile (the reference's compacted-stream count), or every
    block under dense streaming;
  * ``blocks_skipped``   (steps,)   -- the rest of the block list;
  * ``converged``        (steps, B) -- per-query convergence mask
    *entering* the step (a converged query is frozen by the engine);
  * ``step_wall_s``      (steps,)   -- host-measured per-step wall time.

One engine fixpoint produces one `DispatchTelemetry`; a `QueryResult`
carries a `QueryTelemetry` aggregating the dispatches of that query
(one for a solo or batched run, several for bucketed dispatch).
Tracing is opt-in (``query(trace=True)``) and exact: the stats are
extra outputs that the step never reads, so attrs and step counts are
bit-identical with tracing on.

`backend` names the relax route: 'cuda' (the kernel) or 'torch' (the
plain version), or 'sim' for the cycle simulator.

The cycle simulator re-emits its per-cycle parallelism trace through
the same schema (`from_sim`), so simulator and engine runs are
comparable row for row: busy PEs play the role of active vertices and
one simulated cycle plays the role of one step.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StepTrace:
    """Fixed-schema per-step record of one fixpoint (see module doc)."""
    active_vertices: np.ndarray          # (steps, B) i32
    active_tiles: np.ndarray             # (steps,)   i32
    blocks_fetched: np.ndarray           # (steps,)   i32
    blocks_skipped: np.ndarray           # (steps,)   i32
    converged: np.ndarray                # (steps, B) bool
    step_wall_s: np.ndarray | None = None   # (steps,) f64

    def __len__(self) -> int:
        return int(self.active_tiles.shape[0])

    def to_json(self) -> dict:
        d = {
            "active_vertices": self.active_vertices.tolist(),
            "active_tiles": self.active_tiles.tolist(),
            "blocks_fetched": self.blocks_fetched.tolist(),
            "blocks_skipped": self.blocks_skipped.tolist(),
            "converged": self.converged.tolist(),
        }
        if self.step_wall_s is not None:
            d["step_wall_s"] = [float(x) for x in self.step_wall_s]
        return d


@dataclasses.dataclass
class DispatchTelemetry:
    """One engine fixpoint's telemetry: where it ran, its static sizes,
    per-query step counts, and the per-step trace."""
    backend: str            # 'cuda' | 'torch' | 'sim'
    mode: str               # 'data' | 'op'
    compact: bool
    batch: int              # B of this dispatch (padded serving size)
    n: int                  # vertices
    ntiles: int
    n_blocks: int           # real weight blocks (sentinel excluded)
    steps: np.ndarray       # (B,) i32 per-query step counts
    trace: StepTrace
    wall_s: float = 0.0
    truncated: bool = False   # fixpoint outran the trace row capacity
    tile: int = 0           # T (0 when unknown, e.g. the sim bridge)
    feature_dim: int = 1    # feature width d of the vertex state
    meta: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        """Aggregates the autotuner's cost model and the benches consume.

        The HBM-bytes estimates scale with the feature width d: the
        weight stream is d-independent (each fetched block is (T, T)
        f32), while the per-step state stream -- the (B, ntiles, T, d)
        read + write every relax step performs -- carries a factor of d.
        That asymmetry IS the vector-state win: the same weight traffic
        feeds d feature lanes.
        """
        tr, nt = self.trace, max(self.ntiles, 1)
        nsteps = len(tr)
        t, d = self.tile, max(self.feature_dim, 1)
        state_lane_bytes = 2 * self.batch * nt * t * d * 4  # rd + wr
        return {
            "backend": self.backend,
            "mode": self.mode,
            "compact": self.compact,
            "batch": self.batch,
            "feature_dim": d,
            "steps_max": int(self.steps.max()) if self.steps.size else 0,
            "steps_mean": float(self.steps.mean()) if self.steps.size
            else 0.0,
            "traced_steps": nsteps,
            "truncated": self.truncated,
            "mean_active_vertices": (
                float(tr.active_vertices.sum(axis=1).mean())
                if nsteps else 0.0),
            "mean_active_tile_fraction": (
                float(tr.active_tiles.mean()) / nt if nsteps else 0.0),
            "blocks_fetched_total": int(tr.blocks_fetched.sum()),
            "blocks_skipped_total": int(tr.blocks_skipped.sum()),
            "hbm_weight_bytes_est": int(tr.blocks_fetched.sum()) * t * t
            * 4,
            "hbm_state_bytes_est": nsteps * state_lane_bytes,
            "wall_s": self.wall_s,
        }

    def to_json(self) -> dict:
        return {
            "backend": self.backend, "mode": self.mode,
            "compact": self.compact, "batch": self.batch,
            "n": self.n, "ntiles": self.ntiles,
            "n_blocks": self.n_blocks, "tile": self.tile,
            "feature_dim": self.feature_dim,
            "steps": [int(s) for s in np.atleast_1d(self.steps)],
            "wall_s": self.wall_s, "truncated": self.truncated,
            "meta": self.meta, "trace": self.trace.to_json(),
        }


@dataclasses.dataclass
class QueryTelemetry:
    """Everything one `query()` call did: its dispatches (each with a
    per-step trace), total wall, and the compile-attributed share."""
    dispatches: list[DispatchTelemetry]
    wall_s: float = 0.0
    compile_s: float = 0.0

    def summary(self) -> dict:
        """Cross-dispatch aggregate (weighted by traced steps)."""
        out = {
            "dispatches": len(self.dispatches),
            "wall_s": self.wall_s,
            "compile_s": self.compile_s,
            "steps_max": 0, "traced_steps": 0, "truncated": False,
            "mean_active_vertices": 0.0,
            "mean_active_tile_fraction": 0.0,
            "blocks_fetched_total": 0, "blocks_skipped_total": 0,
            "hbm_weight_bytes_est": 0, "hbm_state_bytes_est": 0,
        }
        w = 0
        for d in self.dispatches:
            s = d.summary()
            k = s["traced_steps"]
            out["steps_max"] = max(out["steps_max"], s["steps_max"])
            out["traced_steps"] += k
            out["truncated"] |= s["truncated"]
            out["blocks_fetched_total"] += s["blocks_fetched_total"]
            out["blocks_skipped_total"] += s["blocks_skipped_total"]
            out["hbm_weight_bytes_est"] += s["hbm_weight_bytes_est"]
            out["hbm_state_bytes_est"] += s["hbm_state_bytes_est"]
            if k:
                out["mean_active_vertices"] += s["mean_active_vertices"] * k
                out["mean_active_tile_fraction"] += \
                    s["mean_active_tile_fraction"] * k
                w += k
        if w:
            out["mean_active_vertices"] /= w
            out["mean_active_tile_fraction"] /= w
        return out

    def steps_histogram(self, edges=(1, 2, 4, 8, 16, 32, 64, 128)) -> dict:
        """Steps-to-converge histogram over every query of every
        dispatch: ``{"<=1": c, "<=2": c, ..., ">128": c}``."""
        steps = np.concatenate(
            [np.atleast_1d(d.steps) for d in self.dispatches]
        ) if self.dispatches else np.zeros(0, np.int32)
        hist, prev = {}, 0
        for e in edges:
            hist[f"<={e}"] = int(((steps > prev) & (steps <= e)).sum())
            prev = e
        hist[f">{edges[-1]}"] = int((steps > edges[-1]).sum())
        if steps.size:
            hist["<=1"] += int((steps <= 0).sum())   # 0-step queries
        return hist

    def to_json(self) -> dict:
        return {"wall_s": self.wall_s, "compile_s": self.compile_s,
                "summary": self.summary(),
                "dispatches": [d.to_json() for d in self.dispatches]}


# ------------------------------------------------------------------ #
# cycle-sim bridge: one schema for both evaluation vehicles
# ------------------------------------------------------------------ #
def from_sim(sim_result, freq_mhz: float = 100.0,
             mode: str = "data") -> QueryTelemetry:
    """Re-emit a `SimResult`'s per-cycle parallelism trace through the
    query-telemetry schema: one simulated cycle = one step, busy PEs =
    active vertices (the sim relaxes one vertex per busy PE per cycle),
    and wall time = simulated time at `freq_mhz` (a model of the FLIP
    fabric, not a time measured on any device). Packet/swap counters
    ride in `meta`."""
    trace = np.asarray(sim_result.parallelism_trace, dtype=np.int32)
    cycles = int(trace.shape[0])
    zeros = np.zeros(cycles, dtype=np.int32)
    steps = np.asarray([sim_result.cycles], dtype=np.int32)
    st = StepTrace(
        active_vertices=trace.reshape(cycles, 1),
        active_tiles=trace.copy(),           # busy PEs ~ active tiles
        blocks_fetched=zeros,
        blocks_skipped=zeros,
        converged=(trace == 0).reshape(cycles, 1),
        step_wall_s=np.full(cycles, 1e-6 / freq_mhz),
    )
    wall = sim_result.cycles * 1e-6 / freq_mhz
    disp = DispatchTelemetry(
        backend="sim", mode=mode, compact=True, batch=1,
        n=int(np.asarray(sim_result.attrs).shape[0]), ntiles=0,
        n_blocks=0, steps=steps, trace=st, wall_s=wall,
        meta={"cycles": sim_result.cycles,
              "packets_delivered": sim_result.packets_delivered,
              "edges_relaxed": sim_result.edges_relaxed,
              "avg_parallelism": sim_result.avg_parallelism,
              "max_parallelism": sim_result.max_parallelism,
              "swaps": sim_result.swaps,
              "freq_mhz": freq_mhz})
    return QueryTelemetry(dispatches=[disp], wall_s=wall)
