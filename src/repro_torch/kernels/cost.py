"""FLOP formulas of the hand-written kernels, as torch's FLOP counter
reads them.

K2 (flash attention) and K3 (the SSD intra-chunk form), forward and
backward, are `torch.library` custom ops (`kernels/attention/ops.py`,
`kernels/ssd/ops.py`); each op registers the formula below with
`torch.utils.flop_counter.register_flop_formula`, so that
`FlopCounterMode` and the dry-run (`launch/dryrun.py`) count a kernel's
work whatever runs it: the CUDA kernel on the card, the plain version on
the CPU, the fake implementation on meta or fake tensors. The formulas
count matrix products only (2 per multiply-add), as the counter does for
`mm` and `bmm`; elementwise work is not counted.

  K2 forward  -- the (q chunk, kv chunk) pairs that the reference's
                 roofline mode visits (`_lax_flash(..., unroll_kv=True)`,
                 `src/repro/models/attention.py:80-145`, chunks of
                 ``min(1024, S)`` query and ``min(1024, T)`` key rows):
                 every pair when not causal; when causal, q chunk i visits
                 kv chunks [lo_i, i], ``lo_i = max(0, (i*cq - (window +
                 ckv - 1)) // ckv)`` with a window and 0 without. Each
                 pair is two products over the query heads (GQA's key and
                 value heads are expanded to them, as the reference
                 does): ``Q K^T`` and ``P V``, ``4 * B * H * hd * cq * ckv``
                 FLOPs. At S <= 1,024 that is the whole S x T square. The
                 count does not depend on the CUDA kernel's tiles.
  K2 backward -- 3x the forward over the same pairs: the reference's
                 backward recomputes each q chunk's two products (its
                 per-chunk `jax.checkpoint`) and takes four of the same
                 size for the gradient (``dV = P^T dO``, ``dP = dO V^T``,
                 ``dQ = dS K``, ``dK = dS^T Q``).
  K3 forward  -- the three products of the Pallas kernel's grid cell, one
                 per (batch, chunk, head) (`src/repro/kernels/ssd/ssd.py:
                 24-47`): ``G = C B^T`` (2 Q^2 N), ``y = att (dt x)``
                 (2 Q^2 P) and ``S = (B w)^T (dt x)`` (2 Q N P).
  K3 backward -- 2x the forward: each product A B has two gradient
                 products of its own size (dA = dY B^T, dB = A^T dY), the
                 reference's autodiff of its jnp form (no recompute).
"""
from __future__ import annotations

CHUNK_Q = 1024          # the reference's `_lax_flash` chunk sizes
CHUNK_KV = 1024


def attention_pairs(s: int, t: int, causal: bool, window: int | None,
                    chunk_q: int = CHUNK_Q, chunk_kv: int = CHUNK_KV
                    ) -> tuple[int, int, int]:
    """(visited (q chunk, kv chunk) pairs, q chunk rows, kv chunk rows) of
    the reference's `_lax_flash` at S = `s` query and T = `t` key rows.
    A ragged last chunk counts as a whole one (the reference asserts that
    the chunks divide S and T)."""
    cq, ckv = min(chunk_q, s), min(chunk_kv, t)
    nq, nkv = -(-s // cq), -(-t // ckv)
    if not causal:
        return nq * nkv, cq, ckv
    pairs = 0
    for i in range(nq):
        lo = 0 if window is None else max(
            0, (i * cq - (window + ckv - 1)) // ckv)
        pairs += max(0, min(i + 1, nkv) - lo)
    return pairs, cq, ckv


def attention_fwd_flops(q_shape, k_shape, causal: bool,
                        window: int | None) -> int:
    """K2 forward: q (B,S,H,hd), k (B,T,KH,hd)."""
    b, s, h, hd = q_shape
    pairs, cq, ckv = attention_pairs(s, k_shape[1], causal, window)
    return 4 * b * h * hd * cq * ckv * pairs


def attention_bwd_flops(q_shape, k_shape, causal: bool,
                        window: int | None) -> int:
    """K2 backward: the recompute of the two forward products and the
    four of the gradient, over the forward's pairs."""
    return 3 * attention_fwd_flops(q_shape, k_shape, causal, window)


def ssd_intra_flops(c_shape, dtx_shape) -> int:
    """K3 forward: C (b,nc,Q,N), dtx (b,nc,Q,H,P)."""
    b, nc, q, n = c_shape
    h, p = dtx_shape[3], dtx_shape[4]
    return b * nc * h * (2 * q * q * n + 2 * q * q * p + 2 * q * n * p)


def ssd_intra_bwd_flops(c_shape, dtx_shape) -> int:
    """K3 backward: two gradient products per forward product."""
    return 2 * ssd_intra_flops(c_shape, dtx_shape)


# the formulas in `register_flop_formula`'s form: tensor arguments arrive
# as shapes, the others as they were passed, the output as `out_shape`
def flash_fwd_formula(q, k, v, causal, window, return_lse, out_shape=None,
                      **_):
    return attention_fwd_flops(q, k, causal, window)


def flash_bwd_formula(q, k, v, o, do, lse, causal, window, out_shape=None,
                      **_):
    return attention_bwd_flops(q, k, causal, window)


def ssd_fwd_formula(C, B, dtx, cums, out_shape=None, **_):
    return ssd_intra_flops(C, dtx)


def ssd_bwd_formula(C, B, dtx, cums, dy, dS, out_shape=None, **_):
    return ssd_intra_bwd_flops(C, dtx)
