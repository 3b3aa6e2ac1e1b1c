"""Mamba-2 (SSD) block: projections + causal depthwise conv + SSD + gate.

The port of `repro.models.mamba`. Prefill runs the chunked SSD
(`kernels/ssd`: the CUDA intra-chunk kernel on the card); decode carries
(conv_state, ssm_state), O(1) per token, through `ssd_step_ref`. Under a
device mesh the SSD runs in a `local_map` region on each rank's SSM heads
(batch over the data axes, heads over `model` when it divides them), so
K3 and its backward see plain local tensors; decode's conv and SSD step
run the same way on the states' shards (`_step_sharded`).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.kernels.ssd.ref import ssd_step_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DeclModule, ParamDecl, rms_norm


def decls(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.ssm_d_inner
    n, h, k = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    return {
        "wz": ParamDecl((d, di), ("embed", "ssm_inner")),
        "wx": ParamDecl((d, di), ("embed", "ssm_inner")),
        "wB": ParamDecl((d, n), ("embed", "state")),
        "wC": ParamDecl((d, n), ("embed", "state")),
        "wdt": ParamDecl((d, h), ("embed", "ssm_heads")),
        "dt_bias": ParamDecl((h,), (None,), init="zeros"),
        "A_log": ParamDecl((h,), (None,), init="zeros"),
        "D": ParamDecl((h,), (None,), init="zeros"),
        "conv_x": ParamDecl((k, di), ("conv", "ssm_inner"),
                            init="normal", scale=0.5),
        "conv_B": ParamDecl((k, n), ("conv", "state"),
                            init="normal", scale=0.5),
        "conv_C": ParamDecl((k, n), ("conv", "state"),
                            init="normal", scale=0.5),
        "gate_norm": ParamDecl((di,), (None,), init="zeros"),
        "w_out": ParamDecl((di, d), ("ssm_inner", "embed")),
    }


class Mamba(DeclModule):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__(decls(cfg), dtype, device)


def _causal_conv(x, w):
    """Depthwise causal conv via shifted adds. x: (B,L,C); w: (K,C)."""
    k = w.shape[0]
    out = x * w[k - 1]
    for i in range(1, k):
        shifted = F.pad(x[:, :-i], (0, 0, i, 0))
        out = out + shifted * w[k - 1 - i]
    return out


def _conv_silu(x, w, channels: str):
    """SiLU of the causal conv. Under a mesh: in a `local_map` region on
    each rank's channels (the conv is depthwise), batch over the data
    axes; the weight's channels split as x's. DTensor (PyTorch 2.11)
    fails to redistribute the conv's padded shifts of a channel-sharded x
    on its own."""
    mesh = sh.current_mesh()
    if mesh is None:
        return F.silu(_causal_conv(x, w))
    xpl = sh.activation_placements(x.shape, "batch", None, channels)
    wpl = tuple(sh.Shard(1) if p == sh.Shard(2) else sh.Replicate()
                for p in xpl)
    return sh.local_region(lambda x, w: F.silu(_causal_conv(x, w)), xpl,
                           (xpl, wpl), mesh, x.shape)(x, w)


def _conv_step(state, xt, w):
    """One-token conv. state: (B,K-1,C) past inputs; xt: (B,C)."""
    window = torch.cat([state, xt[:, None]], dim=1)          # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window, w)
    return y, window[:, 1:]


def _ssd(xc, dt, Bc, Cc, A_log, D, cfg: ModelConfig, chunk: int):
    """The chunked SSD over (B,L,di) inputs split into heads; (B,L,di)."""
    b, l, di = xc.shape
    xh = xc.reshape(b, l, di // cfg.ssm_head_dim, cfg.ssm_head_dim)
    y, _ = ssd_chunked(xh, dt, Bc, Cc, A_log, D, chunk=chunk)
    return y.reshape(b, l, di)


def _ssd_sharded(xc, dt, Bc, Cc, A_log, D, cfg: ModelConfig, chunk: int):
    """`_ssd` in a `local_map` region: batch over the data axes, and the
    SSM heads over `model` where it divides them (strict, so a rank's
    columns of xc are whole heads), else replicated."""
    mesh = sh.current_mesh()
    base = sh.activation_placements(xc.shape, "batch", None, None)
    heads = sh.placements(sh.logical_to_pspec(
        (cfg.ssm_heads,), ("ssm_heads",), mesh, strict=True), mesh)
    xpl = tuple(sh.Shard(2) if isinstance(hp, sh.Shard) else bp
                for bp, hp in zip(base, heads))
    return sh.local_region(
        lambda *a: _ssd(*a, cfg, chunk), xpl,
        (xpl, xpl, base, base, heads, heads), mesh, xc.shape)(
            xc, dt, Bc, Cc, A_log, D)


def apply(p, x, cfg: ModelConfig):
    """Full-sequence SSD block. x: (B,L,d) -> (B,L,d)."""
    # whole sequences for the projections and the causal conv (the
    # reference leaves this gather to GSPMD)
    x = sh.constrain(x, "batch", None, None)
    z = x @ p["wz"]
    xc = x @ p["wx"]
    Bc = x @ p["wB"]
    Cc = x @ p["wC"]
    dt = F.softplus(x @ p["wdt"] + p["dt_bias"])
    xc = _conv_silu(xc, p["conv_x"], "ssm_inner")
    Bc = _conv_silu(Bc, p["conv_B"], "state")
    Cc = _conv_silu(Cc, p["conv_C"], "state")
    xc = sh.constrain(xc, "batch", None, "act_heads")

    chunk = min(cfg.ssm_chunk, xc.shape[1])
    ssd = _ssd_sharded if sh.current_mesh() is not None else _ssd
    y = ssd(xc, dt, Bc, Cc, p["A_log"], p["D"], cfg, chunk)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.rms_eps)
    return y @ p["w_out"]


def init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device: torch.device) -> dict:
    """(conv states for x/B/C, ssm state)."""
    k, di, n = cfg.ssm_conv, cfg.ssm_d_inner, cfg.ssm_state
    z = dict(device=device)
    return {
        "conv_x": torch.zeros((batch, k - 1, di), dtype=dtype, **z),
        "conv_B": torch.zeros((batch, k - 1, n), dtype=dtype, **z),
        "conv_C": torch.zeros((batch, k - 1, n), dtype=dtype, **z),
        "ssm": torch.zeros((batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
                           dtype=torch.float32, **z),
    }


def _step(xc, Bc, Cc, dt, conv_x, conv_B, conv_C, ssm, w_x, w_B, w_C,
          A_log, D, cfg: ModelConfig):
    """The conv and SSD step of one token on the heads it is given.
    Returns (y (B, heads x P), conv states, ssm state)."""
    xc, conv_x = _conv_step(conv_x, xc, w_x)
    Bc, conv_B = _conv_step(conv_B, Bc, w_B)
    Cc, conv_C = _conv_step(conv_C, Cc, w_C)
    xc, Bc, Cc = F.silu(xc), F.silu(Bc), F.silu(Cc)
    xh = xc.reshape(xc.shape[0], -1, cfg.ssm_head_dim)
    y, ssm = ssd_step_ref(xh, dt, Bc, Cc, A_log, D, ssm)
    return y.reshape(xc.shape[0], -1), conv_x, conv_B, conv_C, ssm


CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def _step_sharded(xc, Bc, Cc, dt, cache: dict, p, cfg: ModelConfig):
    """`_step` in a `local_map` region: batch as the SSM state's, and the
    SSM heads over `model` where the state splits them (strict: whole
    heads per rank), so x's channels, dt, A_log, D, the x conv state and
    its weight split with them; B and C whole. The new states come back
    in the caches' placements."""
    mesh = sh.current_mesh()
    rep = sh.Replicate()
    spl = tuple(cache["ssm"].placements)
    bpl = tuple(pl if pl == sh.Shard(0) else rep for pl in spl)
    hpl = tuple(sh.Shard(1) if pl == sh.Shard(1) else bpl[j]
                for j, pl in enumerate(spl))          # (B, heads...)
    cxpl = tuple(sh.Shard(2) if pl == sh.Shard(1) else bpl[j]
                 for j, pl in enumerate(spl))         # (B, K-1, di)
    wxpl = tuple(sh.Shard(1) if pl == sh.Shard(1) else rep for pl in spl)
    wpl = tuple(sh.Shard(0) if pl == sh.Shard(1) else rep for pl in spl)
    reps = (rep,) * mesh.ndim
    out = sh.local_region(
        lambda *a: _step(*a, cfg), (hpl, cxpl, bpl, bpl, spl),
        (hpl, bpl, bpl, hpl, cxpl, bpl, bpl, spl, wxpl, reps, reps, wpl,
         wpl), mesh)(xc, Bc, Cc, dt, cache["conv_x"], cache["conv_B"],
                     cache["conv_C"], cache["ssm"], p["conv_x"],
                     p["conv_B"], p["conv_C"], p["A_log"], p["D"])
    y, states = out[0], out[1:]
    states = tuple(s if tuple(s.placements) == tuple(cache[k].placements)
                   else s.redistribute(mesh, cache[k].placements)
                   for s, k in zip(states, CACHE_KEYS))
    return (y,) + states


def decode(p, x, cache: dict, cfg: ModelConfig):
    """One-token step. x: (B,1,d). Returns (out (B,1,d), new cache).
    Under a device mesh the caches are DTensors in their
    `cache_logical_axes` placements and the conv and SSD step runs on
    each rank's SSM heads (`_step_sharded`)."""
    mesh = sh.current_mesh()
    if mesh is not None:
        x = sh.constrain(x, "batch", None, None)
    xt = x[:, 0]
    z = xt @ p["wz"]
    xc = xt @ p["wx"]
    Bc = xt @ p["wB"]
    Cc = xt @ p["wC"]
    dt = F.softplus(xt @ p["wdt"] + p["dt_bias"])
    if mesh is None:
        y, *states = _step(xc, Bc, Cc, dt, *(cache[k] for k in CACHE_KEYS),
                           p["conv_x"], p["conv_B"], p["conv_C"],
                           p["A_log"], p["D"], cfg)
    else:
        y, *states = _step_sharded(xc, Bc, Cc, dt, cache, p, cfg)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.rms_eps)
    out = (y @ p["w_out"])[:, None]
    return out, dict(zip(CACHE_KEYS, states))
