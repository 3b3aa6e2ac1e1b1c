"""What decides `correct`: a sound run reads correct; the controls, and a
run with the timed path broken underneath, read not correct.

These drive the harness on the CPU (the port's plain version) at small
sizes; the same runs on the card are the benchmark's own."""
import time

import numpy as np
import pytest
import torch

from flipbench import check, control, harness, spec
from repro_torch.core.engine import FlipEngine

BENCH = spec.load_benchmark()
SMALL = {"road-ny": {"n": 600}, "g500-s16": {"scale": 8}}


def small_cell(name: str, trace: bool = False):
    cell = spec.find_cell(BENCH, name, trace)
    cell.config.update(SMALL[cell.config["name"]])
    if cell.traffic["loop"] == "open":
        cell.traffic.update(rate_per_s=40, trace_seconds=0.2,
                            drain_limit_s=30)
    return cell


def run(name: str, trace: bool = False, seconds: float = 0.4,
        seed: int = 2**31 + 5):
    return harness.run_cell(small_cell(name, trace), seed, seconds, trace,
                            "cpu", time.perf_counter())


def _step_unchanged(self, attrs, aux, frontier, with_stats=False):
    out = (attrs, aux, torch.zeros_like(frontier))
    if with_stats:
        return out, FlipEngine._step_stats(self, attrs, frontier)
    return out


def _half_batch(orig):
    """The fixpoint runs the second half of the batch; the first half (in
    serving, the lanes filled first) is left out, reported converged."""
    def fixpoint(self, attrs, aux, frontier, trace_cap=0, budgets=None,
                 *args, **kw):
        b = int(attrs.shape[0])
        budgets = np.array(np.broadcast_to(
            self.max_steps if budgets is None else budgets, (b,)),
            dtype=np.int32)
        budgets[:b // 2] = 0
        out = orig(self, attrs, aux, frontier, trace_cap, budgets,
                   *args, **kw)
        converged = np.array(out[5], dtype=bool)
        converged[:b // 2] = True
        return out[:5] + (converged,) + out[6:]
    return fixpoint


def _altered(orig):
    def finalize(self, attrs, aux):
        out = orig(self, attrs, aux)
        row = out[0]
        row.flat[int(np.argmax(np.isfinite(row)))] += 1.0
        return out
    return finalize


FAULTS = {
    "step_unchanged": lambda: ("_step", _step_unchanged),
    "half_batch": lambda: ("_fixpoint", _half_batch(FlipEngine._fixpoint)),
    "answer_altered": lambda: ("finalize_state",
                               _altered(FlipEngine.finalize_state)),
}
CELLS = [w["name"] for w in BENCH["workloads"]]
# a batch of one (a scalar call) has no half to leave out
BROKEN = [(name, fault) for name in CELLS for fault in sorted(FAULTS)
          if not (fault == "half_batch"
                  and spec.find_cell(BENCH, name, False).traffic.get("scalar"))]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("name,fault", BROKEN)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    attr, fn = FAULTS[fault]()
    monkeypatch.setattr(FlipEngine, attr, fn)
    out = run(name)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name,ctl", [
    ("road-ny.sssp8", "bf16"), ("road-ny.serve", "bf16"),
    ("g500-s16.bfs8", "truncated")])
def test_control_is_not_correct(name, ctl):
    cell = spec.find_cell(BENCH, name, False)
    cell.config.update({"road-ny": {"n": 2000},
                        "g500-s16": {"scale": 9}}[cell.config["name"]])
    reading = control.read_control(cell, 11, ctl, "cpu")
    assert reading["answers"] > 0
    assert reading["wrong_values"] > check.LIMITS["wrong_values"]


def test_bf16_is_exact_on_small_hop_counts():
    """Why g500-s16 needs the truncated control: its hop counts are small
    integers, exact in bfloat16."""
    cell = spec.find_cell(BENCH, "g500-s16.bfs8", False)
    cell.config.update(scale=9)
    assert control.read_control(cell, 11, "bf16", "cpu")["wrong_values"] == 0
