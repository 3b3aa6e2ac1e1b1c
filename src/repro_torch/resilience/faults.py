"""Deterministic fault injection for the serving layer.

The port's copy of `repro.resilience.faults` (numpy only): the same
seed gives the reference's schedule, spec for spec.

Chaos testing only works if the chaos replays: every fault here is a
`FaultSpec` pinned to an exact (dispatch ordinal, ladder rung) pair, and
the random generator (`FaultInjector.random`) is seeded -- the same seed
always produces the same fault schedule against the same request stream,
so a failing chaos run reduces to one reproducible command line.

Three injection points, matching the real failure modes they stand in
for (`kind`):

  'raise'   the backend raises mid-dispatch (a CUDA error, OOM, a
            failed kernel build) -- `before_dispatch` raises `InjectedFault`,
            which `classify` wraps as a retryable `BackendFailure`, so
            the degradation ladder takes over;
  'nan'     a weight block was silently corrupted -- `after_dispatch`
            NaN-poisons a seeded subset of the result, which the
            per-dispatch finite guard must catch before the garbage
            reaches a caller;
  'stall'   a hung kernel / dead host -- `before_dispatch` sleeps
            past the server's `HeartbeatMonitor` timeout, which must
            flag the stall (and re-arm for the next one).

Faults are one-shot: a spec fires on its pinned (dispatch, rung) and
never again, so a ladder retry of the same bucket sees a healthy
backend -- exactly the transient-fault model the ladder exists for.
Persistent faults are expressed as several specs on consecutive rungs.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

KINDS = ("raise", "nan", "stall")


class InjectedFault(RuntimeError):
    """The artificial backend failure. Deliberately NOT a FlipError:
    the taxonomy must classify it like any foreign backend exception."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One pinned fault: fire `kind` on dispatch ordinal `dispatch`
    (the server's lifetime bucket-dispatch counter), ladder rung `rung`,
    optionally restricted to one algebra."""
    kind: str
    dispatch: int
    rung: int = 0
    algo: str | None = None
    stall_s: float = 0.0          # 'stall' only: injected sleep
    nan_frac: float = 0.25        # 'nan' only: fraction of entries hit

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind must be one of {KINDS}, got "
                             f"{self.kind!r}")

    def matches(self, algo: str, dispatch: int, rung: int) -> bool:
        return (self.dispatch == dispatch and self.rung == rung
                and (self.algo is None or self.algo == algo))


@dataclasses.dataclass
class FaultInjector:
    """Seeded, replayable fault schedule the server consults around
    every dispatch. `fired` records what actually triggered (spec +
    where), so tests assert the schedule really executed."""

    specs: list = dataclasses.field(default_factory=list)
    seed: int = 0
    fired: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._spent: set[int] = set()      # indices of one-shot specs

    # ------------------------------------------------------------ #
    @classmethod
    def random(cls, seed: int, dispatches: int, algos=None,
               rate: float = 0.25, stall_s: float = 0.0) -> "FaultInjector":
        """A seeded random schedule over `dispatches` upcoming bucket
        dispatches: each ordinal independently gets a fault with
        probability `rate`, kind drawn uniformly ('stall' only when a
        positive `stall_s` is supplied -- stalls cost wall time).
        Deterministic: (seed, dispatches, algos, rate, stall_s) fully
        decide the schedule."""
        rng = np.random.default_rng(seed)
        kinds = ["raise", "nan"] + (["stall"] if stall_s > 0 else [])
        specs = []
        for d in range(dispatches):
            if rng.random() >= rate:
                continue
            kind = kinds[int(rng.integers(len(kinds)))]
            algo = (None if algos is None
                    else algos[int(rng.integers(len(algos)))])
            specs.append(FaultSpec(kind=kind, dispatch=d, rung=0,
                                   algo=algo, stall_s=stall_s))
        return cls(specs=specs, seed=seed)

    # ------------------------------------------------------------ #
    def _take(self, algo: str, dispatch: int, rung: int, kinds) -> \
            FaultSpec | None:
        for i, spec in enumerate(self.specs):
            if i in self._spent or spec.kind not in kinds:
                continue
            if spec.matches(algo, dispatch, rung):
                self._spent.add(i)
                self.fired.append({"kind": spec.kind, "algo": algo,
                                   "dispatch": dispatch, "rung": rung})
                return spec
        return None

    def before_dispatch(self, algo: str, dispatch: int, rung: int) -> None:
        """Called just before the engine runs: may sleep (stall) and/or
        raise (backend fault). A 'stall' spec sleeps first, so one
        dispatch can both trip the heartbeat and then fail."""
        spec = self._take(algo, dispatch, rung, ("stall",))
        if spec is not None:
            time.sleep(spec.stall_s)
        spec = self._take(algo, dispatch, rung, ("raise",))
        if spec is not None:
            raise InjectedFault(
                f"injected backend fault (dispatch {dispatch} rung "
                f"{rung} algo {algo})")

    def after_dispatch(self, algo: str, dispatch: int, rung: int,
                       attrs: np.ndarray) -> np.ndarray:
        """Called on the raw result before the finite guard: a 'nan'
        spec returns a poisoned copy (seeded entry subset -> NaN); the
        caller's guard must refuse to serve it."""
        spec = self._take(algo, dispatch, rung, ("nan",))
        if spec is None:
            return attrs
        out = np.array(attrs, dtype=np.float32, copy=True)
        k = max(1, int(out.size * spec.nan_frac))
        idx = self._rng.choice(out.size, size=k, replace=False)
        # .flat assigns through any memory order; reshape(-1) would
        # silently copy (and drop the poison) on F-ordered results
        out.flat[idx] = np.nan
        return out
