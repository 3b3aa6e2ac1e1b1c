"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, SwiGLU experts.

The port of `repro.models.moe`. Tokens are FLIP's packets and experts its
vertices pinned to compute sites; the router is the Inter-Table.

  * One group (`dispatch="gspmd"`, and every call without a process
    group): the reference's GShard-style capacity dispatch with
    `_num_groups` = (1, 1), as it runs with no mesh. Every (token,
    choice) pair takes a slot of its expert's capacity buffer (E, C, d)
    in token-major order; pairs past C are dropped. The buffer is built
    with one `index_copy_`, the experts' SwiGLU products are batched
    matrix products (`torch.bmm`, as the reference leaves its einsums to
    XLA), and the combine is a gather.
  * Expert-parallel (`dispatch="all_to_all"` with a `torch.distributed`
    group whose size divides E): `repro_torch.distributed.moe_ep`, two
    `all_to_all_single`s around the rank's own experts.

`apply` returns ``(y, aux)``: y in x's dtype and the Switch-style
load-balance loss ``E * sum_e f_e * p_e`` (serving drops it).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.nn import functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDecl

DISPATCHES = ("gspmd", "all_to_all")


def decls(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    return {
        "router": ParamDecl((d, e), ("embed", None)),
        "w_gate": ParamDecl((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_in": ParamDecl((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_out": ParamDecl((e, f, d), ("experts", "expert_mlp", "embed")),
    }


def _top_k(logits: torch.Tensor, k: int):
    """(weights (T, k) softmaxed over the k, ids (T, k)) in
    `jax.lax.top_k`'s order: value descending, ties by lower expert id.
    `torch.topk` promises no order among equal values, and the order of
    a token's k ids decides its capacity slots, so a stable sort is
    taken instead."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :k], ids[..., :k]
    return torch.softmax(vals, dim=-1), ids


def _capacity(tokens: int, num_experts: int, k: int, factor: float) -> int:
    c = int(math.ceil(tokens * k * factor / num_experts))
    return max(8, -(-c // 8) * 8)   # round up to 8, as the reference does


def _positions_in_expert(flat_ids: torch.Tensor, e: int) -> torch.Tensor:
    """Slot of each (token, choice) within its expert's capacity buffer:
    the number of earlier pairs routed to the same expert. The reference
    takes it from a (T*k, E) one-hot cumsum; a cumsum down a 40-column
    int64 matrix is one slow outer-dim scan on the card (~50 ms per layer
    at 131,072 pairs), so the port ranks each pair within its expert by
    one stable sort, which gives the same slots."""
    n = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    counts = torch.bincount(flat_ids, minlength=e)
    starts = counts.cumsum(dim=0) - counts
    pos = torch.empty_like(flat_ids)
    pos[order] = (torch.arange(n, device=flat_ids.device)
                  - starts[flat_ids[order]])
    return pos


def dispatch_buffer(xt: torch.Tensor, ids: torch.Tensor, cap: int, e: int):
    """The capacity buffer (E, C, d) of one token group and the slot map.

    xt: (T, d) tokens; ids: (T, k) routed experts. Pair j = t*k + i goes
    to row ``lin[j] = ids[t, i] * C + slot`` of the flattened buffer when
    its slot is below C (``keep[j]``); a dropped pair is written to a
    spare row past the buffer, so the whole dispatch is one
    `index_copy_` with no host read. Returns ``(buf (E, C, d), lin (T*k,),
    keep (T*k,))``."""
    t, d = xt.shape
    k = ids.shape[1]
    flat = ids.reshape(-1)
    pos = _positions_in_expert(flat, e)
    keep = pos < cap
    lin = torch.where(keep, flat * cap + pos, e * cap)
    buf = xt.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, lin, xt.repeat_interleave(k, dim=0))
    return buf[:e * cap].view(e, cap, d), lin, keep


def combine(out: torch.Tensor, lin: torch.Tensor, keep: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """The inverse of the dispatch, a gather: token t's output is the
    weighted sum over its k kept slots. out: (E, C, d); weights (T, k).
    Returns (T, d) in out's dtype."""
    e, cap, d = out.shape
    g = out.reshape(e * cap, d)[torch.where(keep, lin, 0)]
    g = torch.where(keep[:, None], g, torch.zeros((), dtype=g.dtype,
                                                  device=g.device))
    t, k = weights.shape
    return (g.view(t, k, d) * weights.to(out.dtype)[:, :, None]).sum(dim=1)


def expert_ffn(h: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
               w_out: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU. h: (E, C, d); w_gate/w_in (E, d, f); w_out
    (E, f, d). Returns (E, C, d)."""
    return torch.bmm(F.silu(torch.bmm(h, w_gate)) * torch.bmm(h, w_in),
                     w_out)


def route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """Router logits in f32 (the product in the activations' dtype, as
    the reference's einsum) and the top-k weights and ids."""
    logits = (xt @ router).float()
    weights, ids = _top_k(logits, k)
    return logits, weights, ids


def apply(p, x: torch.Tensor, cfg: ModelConfig, dispatch: str = "gspmd",
          group=None):
    """x: (B, S, d). Returns (y (B, S, d) in x's dtype, aux loss).

    `p` holds `decls(cfg)`'s tensors (a module or a dict) with every
    expert. With ``dispatch="all_to_all"`` and a process group whose size
    divides E, each rank routes its own tokens x to the experts of every
    rank (`moe_ep.moe_all_to_all`, on this rank's shard of p); otherwise
    the tokens are one group, as the reference does without a mesh."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, got "
                         f"{dispatch!r}")
    e = cfg.num_experts
    if dispatch == "all_to_all" and group is not None \
            and e % dist.get_world_size(group) == 0:
        from repro_torch.distributed.moe_ep import (moe_all_to_all,
                                                    shard_experts)
        y, aux = moe_all_to_all(
            shard_experts(p, dist.get_rank(group),
                          dist.get_world_size(group)), x, cfg, group)
        return y.to(x.dtype), aux
    y, aux = _dispatch_one_group(p, x, cfg)
    return y.to(x.dtype), aux


def _dispatch_one_group(p, x: torch.Tensor, cfg: ModelConfig):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    logits, weights, ids = route(xt, p["router"], k)
    # Switch-style load-balance loss
    probs = torch.softmax(logits, dim=-1)
    occupancy = torch.bincount(ids.reshape(-1), minlength=e).float() / (t * k)
    aux = (occupancy * probs.mean(dim=0)).sum() * e

    cap = _capacity(t, e, k, cfg.capacity_factor)
    buf, lin, keep = dispatch_buffer(xt, ids, cap, e)
    out = expert_ffn(buf, p["w_gate"], p["w_in"], p["w_out"])
    return combine(out, lin, keep, weights).view(b, s, d), aux
