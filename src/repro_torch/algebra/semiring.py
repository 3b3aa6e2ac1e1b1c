"""Semirings underlying FLIP's vertex-centric execution, in PyTorch.

The port of `repro.algebra.semiring`. Every relaxation step computes a
blocked semiring matrix-vector product

    cand[v] = ⊕_u ( src_vals[u] ⊗ W[u, v] )        (gather/combine)
    new[v]  = carry[v] ⊕ cand[v]                    (merge)

where W is the tiled adjacency with absent edges holding the ⊕-identity
(`zero`) and inactive sources also hold `zero`. The contract every layer
relies on:

  * ⊕ is associative and commutative with identity `zero`;
  * ⊗ has identity `one` and `zero` annihilates it: zero ⊗ x = zero,
    so padding blocks / inactive lanes drop out of every reduction.

Each op comes in a numpy flavour (block build, oracles) and a torch
flavour (engine, the plain relax step). The CUDA kernel specializes on
the semiring by `name` (kernels/frontier/csrc/frontier_relax.cu).
Instances are module-level singletons that compare by identity.

Vector-valued state generalizes the step to `(n, d)` feature blocks, one
`(T, T) × (T, d)` contraction per tile (`contract`): `w.mT @ sv` in fp32
for (+, ×), a broadcast-⊗ then ⊕-reduce over the source axis, swept in
8-lane feature slabs, for the idempotent pairs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Semiring:
    """(⊕, ⊗) pair with identities and the reductions the engine needs."""

    name: str
    zero: float                 # ⊕-identity; absent edge / inactive lane
    one: float                  # ⊗-identity; source bootstrap value
    add_np: Callable            # ⊕ elementwise, numpy ufunc (`.at` builds
                                #   the blocks)
    mul_np: Callable            # ⊗ elementwise, numpy
    add: Callable               # ⊕ elementwise, torch
    mul: Callable               # ⊗ elementwise, torch
    add_reduce: Callable        # ⊕-reduction along `dim`, torch
    scatter_reduce: str         # ⊕ as a `Tensor.scatter_reduce_` mode
    idempotent: bool            # x ⊕ x == x (min/max/or, not +)
    contract: Callable = None   # (..., S, d) ⊗ (..., S, D) -> (..., D, d);
                                #   derived from add_reduce/mul if not given

    def monotone_under(self, old_vals, new_vals) -> bool:
        """True iff every new ⊗ operand ⊕-dominates its old value
        (``new ⊕ old == new``) under an idempotent ⊕: the warm-start
        soundness test for an update batch (see the reference's
        docstring). Non-idempotent ⊕ always answers False."""
        if not self.idempotent:
            return False
        old = np.asarray(old_vals, dtype=np.float32)
        new = np.asarray(new_vals, dtype=np.float32)
        return bool(np.all(self.add_np(new, old) == new))

    def segment_reduce(self, x: torch.Tensor, seg: torch.Tensor,
                       num_segments: int, dim: int) -> torch.Tensor:
        """⊕-reduce the slices of `x` along `dim` by segment id `seg`
        into `num_segments` slots; empty segments hold the ⊕-identity."""
        dim = dim % x.ndim
        shape = list(x.shape)
        shape[dim] = num_segments
        out = torch.full(shape, self.zero, dtype=x.dtype, device=x.device)
        view = [1] * x.ndim
        view[dim] = -1
        index = seg.to(torch.int64).reshape(view).expand_as(x)
        return out.scatter_reduce_(dim, index, x, self.scatter_reduce,
                                   include_self=True)

    def __post_init__(self):
        if self.contract is None:
            object.__setattr__(self, "contract",
                               _generic_contract(self.add_reduce, self.mul))


def _generic_contract(add_reduce, mul, slab: int = 8):
    """Generic (⊕, ⊗) tile contraction, swept in 8-lane feature slabs:
    ``out[.., v, f] = ⊕_u sv[.., u, f] ⊗ w[.., u, v]`` with the broadcast
    intermediate bounded at ``(..., S, D, slab)``."""
    def contract(sv, w):
        d = sv.shape[-1]
        outs = [add_reduce(mul(sv[..., :, None, k:k + slab],
                               w[..., :, :, None]), dim=-3)
                for k in range(0, d, slab)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return contract


def _matmul_contract(sv, w):
    """(+, ×) tile contraction as an fp32 matrix product ``w.mT @ sv``."""
    return torch.matmul(w.mT, sv)


MIN_PLUS = Semiring(
    name="min_plus", zero=float("inf"), one=0.0,
    add_np=np.minimum, mul_np=np.add,
    add=torch.minimum, mul=torch.add,
    add_reduce=lambda x, dim: torch.amin(x, dim=dim),
    scatter_reduce="amin", idempotent=True,
)

MAX_MIN = Semiring(
    name="max_min", zero=float("-inf"), one=float("inf"),
    add_np=np.maximum, mul_np=np.minimum,
    add=torch.maximum, mul=torch.minimum,
    add_reduce=lambda x, dim: torch.amax(x, dim=dim),
    scatter_reduce="amax", idempotent=True,
)

# boolean (or, and) carried in {0.0, 1.0} float32 so every layer keeps a
# single dtype; max == or and min == and on that domain.
OR_AND = Semiring(
    name="or_and", zero=0.0, one=1.0,
    add_np=np.maximum, mul_np=np.minimum,
    add=torch.maximum, mul=torch.minimum,
    add_reduce=lambda x, dim: torch.amax(x, dim=dim),
    scatter_reduce="amax", idempotent=True,
)

PLUS_TIMES = Semiring(
    name="plus_times", zero=0.0, one=1.0,
    add_np=np.add, mul_np=np.multiply,
    add=torch.add, mul=torch.mul,
    add_reduce=lambda x, dim: torch.sum(x, dim=dim),
    scatter_reduce="sum", idempotent=False,
    contract=_matmul_contract,
)

SEMIRINGS = {s.name: s for s in (MIN_PLUS, MAX_MIN, OR_AND, PLUS_TIMES)}
