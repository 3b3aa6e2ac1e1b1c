"""TuningStore: the JSON database tuning amortizes through.

The port of `repro.autotune.store`, with the same schema and rules. The
store keys chosen plans on ``(profile fingerprint, algebra, backend)``
-- the fingerprint holds the GPU's name -- so every later
`compile(..., ExecutionPlan.auto(tuned=True))` over the same graph shape
on the same card resolves instantly from disk.

Safety rules, all load-bearing:

  * **Stale entries are rejected, never served.** Every entry records
    the profile fingerprint and a schema version; `get` re-checks both
    (plus the algebra/backend of the key) and treats any mismatch as a
    miss. A graph mutation changes the fingerprint.
  * **A broken store is an empty store.** Corrupt JSON, a partial
    write, a foreign file at the path -- all degrade to "no entries".
  * **Writes are atomic** (tmp + `os.replace`).

The default path is ``$FLIP_TORCH_AUTOTUNE_DB`` when set, else
``~/.cache/flip/autotune_torch.json`` -- never the reference's file: on
the CPU both packages would write under the same ``…|cpu`` key and
evict each other's entries, whose routes ('torch' vs 'jnp') do not
resolve in the other package.
"""
from __future__ import annotations

import json
import os
import time

SCHEMA = 1


def default_store_path() -> str:
    env = os.environ.get("FLIP_TORCH_AUTOTUNE_DB")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "flip",
                        "autotune_torch.json")


class TuningStore:
    """Append/overwrite JSON map of tuning entries (see module doc)."""

    def __init__(self, path: str | None = None):
        self.path = path or default_store_path()

    # -------------------------------------------------------------- #
    @staticmethod
    def key(profile_fp: str, algebra: str, backend: str) -> str:
        return f"{profile_fp}|{algebra}|{backend}"

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return {}
        entries = data.get("entries") if isinstance(data, dict) else None
        return entries if isinstance(entries, dict) else {}

    def get(self, profile_fp: str, algebra: str,
            backend: str) -> dict | None:
        """The stored entry for this exact (shape, algebra, backend),
        or None -- where None covers missing, corrupt, schema-drifted,
        and stale-fingerprint entries alike (they all mean re-tune)."""
        e = self._load().get(self.key(profile_fp, algebra, backend))
        if not isinstance(e, dict):
            return None
        if (e.get("schema") != SCHEMA
                or e.get("profile_fp") != profile_fp
                or e.get("algebra") != algebra
                or e.get("backend") != backend
                or not isinstance(e.get("plan"), dict)):
            return None
        return e

    def put(self, profile_fp: str, algebra: str, backend: str,
            plan_knobs: dict, *, score_us: float, seed: int,
            samples: list | None = None,
            profile_json: dict | None = None, why: str = "") -> dict:
        """Record one tuning outcome; returns the stored entry."""
        entry = {
            "schema": SCHEMA,
            "profile_fp": profile_fp,
            "algebra": algebra,
            "backend": backend,
            "plan": dict(plan_knobs),
            "score_us": round(float(score_us), 4),
            "seed": int(seed),
            "why": why,
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        if samples is not None:
            entry["samples"] = samples
        if profile_json is not None:
            entry["profile"] = profile_json
        entries = self._load()
        entries[self.key(profile_fp, algebra, backend)] = entry
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": SCHEMA, "entries": entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        return entry

    def __len__(self) -> int:
        return len(self._load())
