"""Dense one-step oracle for the frontier relaxation (tests only).

The port of `repro.kernels.frontier.ref`: every vertex in the frontier
scatters `attr[u] ⊗ W[u, v]` along its out-edges and destinations merge
with ⊕, over a dense (n, n) matrix with the ⊕-identity for absent edges.
Returns (new_attrs, new_frontier): the new frontier is exactly the set
of vertices whose attribute strictly ⊕-improved. `run_to_fixpoint_ref`
repeats the step on the host until the frontier empties.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algebra import MIN_PLUS, Semiring


def relax_step_ref(attrs: torch.Tensor, frontier: torch.Tensor,
                   w_dense: torch.Tensor, semiring: Semiring = MIN_PLUS):
    """attrs: (n,) f32; frontier: (n,) bool; w_dense: (n, n) f32
    (⊕-identity = no edge). Returns (new_attrs (n,), new_frontier (n,))."""
    src_vals = torch.where(frontier, attrs, semiring.zero)
    best = semiring.add_reduce(semiring.mul(src_vals[:, None], w_dense),
                               dim=0)
    new_attrs = semiring.add(attrs, best)
    new_frontier = torch.logical_and(
        semiring.add(new_attrs, attrs) == new_attrs, new_attrs != attrs)
    return new_attrs, new_frontier


def run_to_fixpoint_ref(attrs, frontier, w_dense, max_steps: int = 10_000,
                        semiring: Semiring = MIN_PLUS) -> np.ndarray:
    """Host-side loop for small oracles (tests only): `relax_step_ref`
    until the frontier empties or `max_steps` steps ran. Takes numpy
    arrays or CPU tensors; returns the attrs as a numpy array."""
    attrs = torch.as_tensor(np.asarray(attrs))
    frontier = torch.as_tensor(np.asarray(frontier))
    w_dense = torch.as_tensor(np.asarray(w_dense))
    for _ in range(max_steps):
        if not bool(frontier.any()):
            break
        attrs, frontier = relax_step_ref(attrs, frontier, w_dense, semiring)
    return attrs.numpy()
