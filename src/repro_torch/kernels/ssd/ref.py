"""Plain PyTorch Mamba-2 SSD (state-space duality): the port of
`repro.kernels.ssd.ref`.

Semantics (per head h, state size N, head dim P):
    h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t          a_t = exp(-exp(A_log) dt_t)
    y_t = C_t . h_t + D * x_t

Chunked O(L*Q) evaluation (arXiv:2405.21060): within a chunk the quadratic
"attention" form with decay mask (`ssd_intra_ref`, the plain version of
the CUDA kernel `ssd.ssd_intra_cuda`); across chunks a sequential state
carry.

Shapes: x (B,L,H,P); dt (B,L,H); Bm/Cm (B,L,N); A_log (H,); D (H,).
`ssd_step_ref` is the single-token decode step.
"""
from __future__ import annotations

import torch


def chunk_inputs(x, dt, Bm, Cm, A_log, chunk: int):
    """The chunked f32 views both the plain and the kernel path start
    from: (C_c, B_c (b,nc,Q,N), dtx (b,nc,Q,H,P), cums (b,nc,Q,H)
    inclusive cumulative log decay)."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {chunk}")
    nc, q = l // chunk, chunk
    f32 = torch.float32
    la = -torch.exp(A_log.to(f32))[None, None, :] * dt.to(f32)   # (B,L,H)
    dtx = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, nc, q, h, p)
    cums = torch.cumsum(la.reshape(b, nc, q, h), dim=2)
    B_c = Bm.to(f32).reshape(b, nc, q, n)
    C_c = Cm.to(f32).reshape(b, nc, q, n)
    return C_c, B_c, dtx, cums


def ssd_intra_ref(C, B, dtx, cums):
    """The intra-chunk quadratic form, in f32. C/B: (b,nc,Q,N); dtx:
    (b,nc,Q,H,P); cums: (b,nc,Q,H). Returns (y_intra (b,nc,Q,H,P),
    S (b,nc,H,N,P))."""
    q = C.shape[2]
    G = torch.einsum("bcin,bcjn->bcij", C, B)                 # (b,nc,Q,Q)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]     # (b,nc,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=C.device))
    # mask BEFORE exp: for i<j diff is large-positive and would overflow
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  -torch.inf))
    att = G[..., None] * decay                                 # (b,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, dtx)
    dec_out = torch.exp(cums[:, :, -1:, :] - cums)             # (b,nc,Q,H)
    S = torch.einsum("bcjh,bcjn,bcjhp->bchnp", dec_out, B, dtx)
    return y_intra, S


def ssd_intra_bwd_ref(C, B, dtx, cums, dy, dS):
    """The intra-chunk form's backward, in f32, as explicit formulas (the
    plain version of the CUDA kernel `ssd.ssd_intra_bwd_cuda`). dy:
    (b,nc,Q,H,P) and dS: (b,nc,H,N,P) are the cotangents of `ssd_intra_ref`'s
    y and S. Returns (dC, dB (b,nc,Q,N), ddtx (b,nc,Q,H,P), dcums
    (b,nc,Q,H)).

    With att_ij = G_ij decay_ij (decay_ij = exp(c_i - c_j) for i >= j, else
    0), w_j = exp(c_last - c_j) and dAtt = dY.X^T per head:
      ddtx_j = sum_i att_ij dY_i + w_j (B_j . dS)
      dC = dG.B, dB = dG^T.C + sum_h w^h (X^h . dS^hT), dG = sum_h dAtt decay
      dcums_i = sum_j (dAtt att)_ij - sum_i' (dAtt att)_i'i - g_i
                + [i = last] sum_j g_j,  g_j = w_j sum_{n,p} B_jn dS_np X_jp
    B and C are shared by every head, so dC and dB sum over heads."""
    q = C.shape[2]
    G = torch.einsum("bcin,bcjn->bcij", C, B)                 # (b,nc,Q,Q)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]     # (b,nc,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=C.device))
    # mask BEFORE exp, as the forward does: no inf, so no inf * 0 = NaN
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  -torch.inf))
    att = G[..., None] * decay                                 # (b,nc,Q,Q,H)
    dAtt = torch.einsum("bcihp,bcjhp->bcijh", dy, dtx) * decay
    w = torch.exp(cums[:, :, -1:, :] - cums)                   # (b,nc,Q,H)
    BdS = torch.einsum("bcjn,bchnp->bcjhp", B, dS)
    ddtx = (torch.einsum("bcijh,bcihp->bcjhp", att, dy)
            + w[..., None] * BdS)
    dG = dAtt.sum(-1)                                          # (b,nc,Q,Q)
    dC = torch.einsum("bcij,bcjn->bcin", dG, B)
    dB = (torch.einsum("bcij,bcin->bcjn", dG, C)
          + torch.einsum("bcjh,bcjhp,bchnp->bcjn", w, dtx, dS))
    da = dAtt * G[..., None]                                   # dAtt o att
    g = w * (BdS * dtx).sum(-1)                                # (b,nc,Q,H)
    dcums = da.sum(3) - da.sum(2) - g
    dcums[:, :, -1] += g.sum(2)
    return dC, dB, ddtx, dcums


def ssd_from_intra(x, D, C_c, cums, y_intra, S, h0=None):
    """The inter-chunk recurrence and output around an intra-chunk result
    (shared by the plain and the kernel paths, `ssd_with_intra`). Returns
    (y (B,L,H,P) in x's dtype, h_final (B,H,N,P) f32)."""
    b, l, h, p = x.shape
    nc, n = C_c.shape[1], C_c.shape[-1]
    f32 = torch.float32
    chunk_decay = torch.exp(cums[:, :, -1, :])                 # (b,nc,H)
    hprev = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    hprevs = []
    for c in range(nc):                                        # sequential
        hprevs.append(hprev)
        hprev = chunk_decay[:, c, :, None, None] * hprev + S[:, c]
    hprevs = torch.stack(hprevs, dim=1)                        # (b,nc,H,N,P)
    dec_in = torch.exp(cums)                                   # (b,nc,Q,H)
    y_inter = torch.einsum("bcin,bchnp->bcihp", C_c, hprevs) \
        * dec_in[..., None]
    y = (y_intra + y_inter).reshape(b, l, h, p)
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), hprev


def ssd_with_intra(intra, x, dt, Bm, Cm, A_log, D, chunk: int = 64,
                   h0=None):
    """Full SSD around an intra-chunk function `intra(C, B, dtx, cums) ->
    (y_intra, S)`: `chunk_inputs`, `intra`, `ssd_from_intra`. The plain
    path passes `ssd_intra_ref`; the kernel paths pass K3, raw or under
    autograd. Returns (y (B,L,H,P), h_final (B,H,N,P))."""
    C_c, B_c, dtx, cums = chunk_inputs(x, dt, Bm, Cm, A_log, chunk)
    y_intra, S = intra(C_c.contiguous(), B_c.contiguous(), dtx, cums)
    return ssd_from_intra(x, D, C_c, cums, y_intra, S, h0)


def ssd_ref(x, dt, Bm, Cm, A_log, D, chunk: int = 64, h0=None):
    """Returns (y (B,L,H,P), h_final (B,H,N,P))."""
    return ssd_with_intra(ssd_intra_ref, x, dt, Bm, Cm, A_log, D,
                          chunk=chunk, h0=h0)


def ssd_step_ref(x, dt, Bm, Cm, A_log, D, hprev):
    """Single decode step. x (B,H,P); dt (B,H); Bm/Cm (B,N);
    hprev (B,H,N,P). Returns (y (B,H,P), h)."""
    f32 = torch.float32
    a = torch.exp(-torch.exp(A_log.to(f32))[None, :] * dt.to(f32))
    dtx = x.to(f32) * dt.to(f32)[..., None]                    # (B,H,P)
    h = a[:, :, None, None] * hprev \
        + torch.einsum("bn,bhp->bhnp", Bm.to(f32), dtx)
    y = torch.einsum("bn,bhnp->bhp", Cm.to(f32), h)
    y = y + x.to(f32) * D.to(f32)[None, :, None]
    return y.to(x.dtype), h
