"""Plain PyTorch flash attention (GQA, causal, sliding window).

`attention_ref` is the port of `repro.kernels.attention.ref.attention_ref`,
and the plain version that the CUDA kernel (`flash.flash_attention_cuda`)
is held against: the full score matrix, masked with the reference's -1e30
and softmaxed in f32. `attention_bwd_ref` is the plain version of the
backward kernels (`flash.flash_attention_bwd_cuda`): the same gradient
from explicit formulas, in f32. `attention_lse_ref` is the plain version of
the row log-sum-exp that the "tf32x3" and "wgmma" forwards write for
their backwards.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int | None = None
                  ) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,KH,hd) with H % KH == 0. Returns
    (B,S,H,hd) in v's dtype."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qr = q.reshape(b, s, kh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qr, k).float()
    scores = scores / math.sqrt(hd)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    return out.reshape(b, s, h, hd)


def _mask(s: int, t: int, causal: bool, window: int | None,
          device) -> torch.Tensor:
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                      window: int | None = None) -> torch.Tensor:
    """The row log-sum-exp L of `attention_ref`'s masked, scaled scores,
    (B,H,S) f32 in natural-log units, over the keys each row may see; +inf
    on a row that sees no key (its backward P is then 0). q: (B,S,H,hd);
    k: (B,T,KH,hd)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    qr = q.to(torch.float32).reshape(b, s, kh, h // kh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qr,
                          k.to(torch.float32)) / math.sqrt(hd)
    ok = _mask(s, t, causal, window, q.device)
    lse = torch.logsumexp(torch.where(ok, scores, -math.inf), dim=-1)
    lse = torch.where(ok.any(-1), lse, math.inf)
    return lse.reshape(b, h, s)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, causal: bool = True,
                      window: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``o = attention_ref(q, k, v, causal, window)`` for
    the output gradient `do`, computed in f32:

      L  = logsumexp over keys of the masked, scaled scores (mask -1e30)
      D  = rowsum(do * o)
      P  = exp(S * scale - L);  dV = P^T do
      dS = P * (do V^T - D);    dQ = dS K * scale;  dK = dS^T Q * scale

    with dK and dV summed over each kv head's group of query heads.
    q/o/do: (B,S,H,hd); k/v: (B,T,KH,hd). Returns (dq, dk, dv) in the
    inputs' dtypes."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qr = q.to(f32).reshape(b, s, kh, g, hd)
    dor = do.to(f32).reshape(b, s, kh, g, hd)
    kf, vf = k.to(f32), v.to(f32)
    scores = torch.einsum("bskgd,btkd->bkgst", qr, kf) * scale
    scores = torch.where(_mask(s, t, causal, window, q.device), scores,
                         NEG_INF)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - lse)                               # (b,kh,g,s,t)
    delta = (dor * o.to(f32).reshape(b, s, kh, g, hd)).sum(-1)  # (b,s,kh,g)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dor)
    dp = torch.einsum("bskgd,btkd->bkgst", dor, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qr) * scale
    return (dq.reshape(b, s, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
