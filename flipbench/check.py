"""What decides `correct`: the answers the timed path returned, held
against the plain reference's on the same inputs.

Every value of every sampled answer (a query's whole vertex-state
vector) must equal the reference's exactly: the cells' values are sums
of integer weights or hop counts, exact in float32, and the relaxation's
order cannot change them. So the numbers compared, each with limit 0:

* `wrong_values`: values of the sampled answers that differ from the
  reference's (+inf = unreached on both sides counts as equal);
* `unanswered`: answers of the window that never came, came with an
  error, or came from a fixpoint that did not converge.

`CONTROLS` are the reference put in the program's place, below what the
configurations state (see PERF.md): float32 state -> bfloat16 state
(`bf16`), and, where bfloat16 is exact for the cell's values (small hop
counts), each fixpoint stopped before its last improving step
(`truncated`).
"""
from __future__ import annotations

import numpy as np
import torch

LIMITS = {"wrong_values": 0, "unanswered": 0}
REF_BATCH = 8


def grouped(items):
    """Answers (program, srcs (B,), values (B, n)) regrouped into batches
    of at most REF_BATCH sources of one program."""
    by_prog: dict = {}
    for program, srcs, values in items:
        srcs = np.atleast_1d(np.asarray(srcs))
        values = np.atleast_2d(np.asarray(values))
        for s, row in zip(srcs, values):
            by_prog.setdefault(program, []).append((int(s), row))
    for program, rows in sorted(by_prog.items()):
        for i in range(0, len(rows), REF_BATCH):
            chunk = rows[i:i + REF_BATCH]
            yield (program, np.asarray([s for s, _ in chunk]),
                   np.stack([r for _, r in chunk]))


def wrong_values(reference, items) -> tuple[int, int]:
    """(values that differ from the reference's, answers compared)."""
    wrong = answers = 0
    for program, srcs, got in grouped(items):
        want, _, _ = reference.run(program, srcs)
        got = torch.as_tensor(got, device=want.device)
        wrong += int((got != want).sum())
        answers += len(srcs)
    return wrong, answers


def control_answers(reference, items, control: str):
    """The sampled answers as the control gives them in the program's
    place: the same sources, computed by `CONTROLS[control]`."""
    return [(program, srcs, CONTROLS[control](reference, program, srcs))
            for program, srcs, _ in grouped(items)]


def _bf16(reference, program, srcs):
    return reference.run(program, srcs, dtype=torch.bfloat16)[0].cpu()


def _truncated(reference, program, srcs):
    return reference.run(program, srcs, stop_before_end=2)[0].cpu()


CONTROLS = {"bf16": _bf16, "truncated": _truncated}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def report(numbers: dict) -> dict:
    """The numbers compared, each beside its limit."""
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
