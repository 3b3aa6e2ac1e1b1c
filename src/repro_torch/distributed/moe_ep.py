"""Expert-parallel MoE dispatch with explicit all-to-all over a process group.

The port of `repro.distributed.moe_ep`: the reference's shard_map over
the 'model' mesh axis becomes the ranks of a `torch.distributed` group,
each holding its own token slab and E/M of the experts:

    local top-k -> capacity buffer (E, C, d)
      -> all_to_all_single   (tokens travel to their experts' ranks)
      -> SwiGLU on the E/M local experts   (E/M, M*C, d)
      -> reverse all_to_all_single   (results travel home)
      -> weighted combine

FLIP's data-centric mode: data (tokens) routed to statically placed
compute sites (experts), with the placement compiled by
`repro_torch.core.placement` to cut traffic. The capacity C is the
rank's own (its T tokens), so each rank drops exactly what a one-group
`moe.apply` over its slab drops.

It trains: both legs are `AllToAll`, whose backward is the reverse
`all_to_all_single` of the gradient (with equal splits, the same
exchange), as the reference differentiates through its shard_map; the
load-balance statistics' `all_reduce` passes the gradient through
unchanged (`_SumStats`), since the loss it feeds is one copy on every
rank. Under a device mesh `moe.apply(dispatch="all_to_all")` runs it in a
`local_map` region over the `model` axis's group, in training too.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import (_capacity, combine, dispatch_buffer,
                                    expert_counts, expert_ffn, route)

EXPERT_LEAVES = ("w_gate", "w_in", "w_out")


class AllToAll(torch.autograd.Function):
    """`all_to_all_single` with equal splits over `group`, differentiable:
    chunk j of dim 0 goes to rank j; the gradient takes the same exchange
    back (the adjoint of a permutation of chunks between ranks)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _SumStats(torch.autograd.Function):
    """The sum of `x` over `group` (`all_reduce` on a copy); the gradient
    passes through as it is: the aux loss built from the sum is the same
    on every rank, one copy of one loss, and each rank's share of the
    gradient reaches the router through its own tokens' statistics."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def shard_experts(p, rank: int, world: int) -> dict:
    """Rank `rank`'s share of a full MoE parameter set: the router whole,
    experts ``[rank*E/M, (rank+1)*E/M)`` of each expert leaf."""
    e = p["router"].shape[1]
    if e % world:
        raise ValueError(f"{e} experts do not divide over {world} ranks")
    e_loc = e // world
    out = {"router": p["router"]}
    for name in EXPERT_LEAVES:
        out[name] = p[name][rank * e_loc:(rank + 1) * e_loc]
    return out


def moe_all_to_all(p, x: torch.Tensor, cfg: ModelConfig, group=None,
                   aux_group=None):
    """x: (B, S, d), this rank's tokens; `p` the replicated router (d, E)
    and this rank's E/M experts (`shard_experts`). `group` is the
    expert-parallel process group (None = the default group); E % M must
    be 0. Returns (y (B, S, d), aux loss), the aux over the tokens of
    every rank of `aux_group` (default: `group`; `all_reduce` in place of
    the reference's psum over the mesh)."""
    m = dist.get_world_size(group)
    e, k = cfg.num_experts, cfg.top_k
    if e % m:
        raise ValueError(f"{e} experts do not divide over {m} ranks")
    e_loc = e // m
    if p["w_gate"].shape[0] != e_loc:
        raise ValueError(f"expert leaves hold {p['w_gate'].shape[0]} "
                         f"experts; this rank owns {e_loc} of {e}")
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits, weights, ids = route(xt, p["router"], k)

    # aux (switch-style) over the whole group: one all_reduce of the
    # expert counts, the summed router probabilities and the token count
    stats = _SumStats.apply(torch.cat([
        expert_counts(ids.reshape(-1), e).float(),
        torch.softmax(logits, dim=-1).sum(dim=0),
        torch.full((1,), float(t), device=x.device)]),
        group if aux_group is None else aux_group)
    occ, pm, n_tok = stats[:e], stats[e:2 * e], stats[2 * e]
    aux = ((occ / (n_tok * k)) * (pm / n_tok)).sum() * e

    cap = _capacity(t, e, k, cfg.capacity_factor)
    buf, lin, keep = dispatch_buffer(xt, ids, cap, e)
    # tokens -> expert ranks: chunk j of dim 0 (experts j*E/M ..) goes to
    # rank j; what arrives is rank-major (M, E/M, C, d)
    recv = AllToAll.apply(buf, group)
    h = recv.view(m, e_loc, cap, d).transpose(0, 1).reshape(e_loc, m * cap, d)
    out = expert_ffn(h, p["w_gate"], p["w_in"], p["w_out"])
    # results -> home ranks, back in the dispatch layout (E, C, d)
    send = out.view(e_loc, m, cap, d).transpose(0, 1).contiguous()
    back = AllToAll.apply(send, group)
    y = combine(back.view(e, cap, d), lin, keep, weights)
    return y.view(b, s, d), aux
