"""Fitted cost model: measured samples in, per-step cost predictor out.

The port of `repro.autotune.model`. The analytic bridge
(`measure.analytic_step_us`) is ordinally honest but its absolute scale
is guessed from arch constants. The fitted model closes that gap with
data: a least-squares fit of per-step cost against the regressors

    x0 = 1                               (fixed per-step dispatch)
    x1 = streamed blocks                 (expected blocks x active frac
                                          under compaction, all blocks
                                          dense)
    x2 = streamed element volume         (x1 * T^2 * d)

per route ('cuda' and 'torch' have distinct throughput, so each gets
its own coefficients; a route with fewer than 3 measured samples falls
back to the analytic estimate). The prediction is clamped to a strictly
positive floor.

Training data is the tune-time measured `Sample`s of the current sweep.
`load_bench_samples(paths)` keeps the reference's parser of recorded
bench rows for a caller who has rows of this port; it reads no file by
default, since the repo's ``BENCH_*.json`` hold CPU and TPU runs of the
JAX package and none of their numbers is this port's or the card's.
"""
from __future__ import annotations

import dataclasses
import json
import re

import numpy as np

from repro_torch.api.plan import ExecutionPlan
from repro_torch.autotune.measure import (Sample, active_tile_fraction,
                                          analytic_step_us, expected_blocks)
from repro_torch.autotune.profile import GraphProfile


def features_of(profile: GraphProfile, plan: ExecutionPlan) -> np.ndarray:
    """The regressor vector [1, streamed_blocks, streamed_volume]."""
    t, d = plan.tile, max(profile.feature_dim, 1)
    nb = expected_blocks(profile.n, profile.m, t)
    af = active_tile_fraction(profile.mean_density, t)
    fetched = nb * (af if plan.compact else 1.0)
    return np.asarray([1.0, fetched, fetched * t * t * d],
                      dtype=np.float64)


@dataclasses.dataclass
class CostModel:
    """Per-route least-squares fit of step_us over `features_of`."""

    coef: dict                 # relax_mode -> (3,) float64 coefficients
    n_samples: int = 0

    @classmethod
    def fit(cls, samples: list, profile: GraphProfile) -> "CostModel":
        """Fit from measured samples (analytic-sourced ones are
        excluded: fitting the model to its own fallback would launder
        guesses into 'data'). Needs >= 3 points per route for the
        3-coefficient fit; fewer points leave that route analytic."""
        by_backend: dict[str, list] = {}
        for s in samples:
            if getattr(s, "source", "measured") != "measured":
                continue
            by_backend.setdefault(s.plan.relax_mode, []).append(s)
        coef = {}
        for backend, ss in by_backend.items():
            if len(ss) < 3:
                continue
            x = np.stack([np.asarray(s.features, dtype=np.float64)
                          if s.features is not None
                          else features_of(profile, s.plan)
                          for s in ss])
            y = np.asarray([s.step_us for s in ss], dtype=np.float64)
            sol, *_ = np.linalg.lstsq(x, y, rcond=None)
            coef[backend] = sol
        return cls(coef=coef,
                   n_samples=sum(len(v) for v in by_backend.values()))

    def predict(self, profile: GraphProfile,
                plan: ExecutionPlan) -> float:
        """Predicted step_us; analytic fallback for routes the fit
        never saw, and clamped to a strictly positive floor."""
        c = self.coef.get(plan.relax_mode)
        if c is None:
            return analytic_step_us(profile, plan)
        return float(max(features_of(profile, plan) @ c, 1e-3))


# ------------------------------------------------------------------ #
# recorded bench rows -> extra training samples
# ------------------------------------------------------------------ #
# rows like:  feature_step_min_plus_2k_d8 , 512.3 ,
#             "power-law |V|=2048 blocks=519 d=8 eff_gflops=..."
_ROW_RE = re.compile(r"(?:feature|frontier)_step_")
_KV_RE = re.compile(r"\b(blocks|d|\|V\|)=(\d+)")


def load_bench_samples(paths=None, tile_default: int = 64) -> list:
    """Best-effort parse of recorded bench files into Samples.

    `paths=None` reads nothing: the repo's ``BENCH_*.json`` are CPU and
    TPU runs of the JAX package's jnp route, and none is a measurement
    of this port or of the card. Pass paths to fold in rows recorded
    elsewhere; each parsed row becomes a sample of the plain route
    ('torch', jnp's counterpart). Every failure mode -- missing file,
    corrupt JSON, legacy layout, unparseable derived string --
    contributes zero samples, never an exception."""
    out: list = []
    for path in paths or ():
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            continue
        runs = data.get("runs", []) if isinstance(data, dict) else []
        for run in runs:
            for row in run.get("rows", []) or []:
                s = _row_to_sample(row, tile_default)
                if s is not None:
                    out.append(s)
    return out


def _row_to_sample(row: dict, tile_default: int):
    """One bench row -> Sample, or None when it isn't a step-cost row
    with a parseable shape."""
    try:
        name, us = row.get("name", ""), float(row.get("us_per_call", 0))
    except (TypeError, ValueError):
        return None
    if not _ROW_RE.match(name) or us <= 0:
        return None
    kv = dict(_KV_RE.findall(row.get("derived", "") or ""))
    if "blocks" not in kv:
        return None
    d = int(kv.get("d", 1))
    blocks = float(kv["blocks"])
    # bench step rows are dense relax steps at the bench tile, so their
    # regressors are exact: every block streamed, T^2*d volume
    plan = ExecutionPlan(relax_mode="torch", compact=False,
                         tile=tile_default,
                         feature_dim=d if d > 1 else 0)
    feats = (1.0, blocks, blocks * tile_default * tile_default * d)
    return Sample(plan=plan, step_us=us, steps=1, wall_s=us * 1e-6,
                  source="measured", features=feats)
