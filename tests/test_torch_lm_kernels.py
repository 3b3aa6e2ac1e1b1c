"""The LM kernels' plain versions and dispatch, held against the JAX
package on the CPU.

Flash attention (K2): `repro_torch.kernels.attention.ref.attention_ref`
and the CPU dispatch `ops.flash_attention` against
`repro.kernels.attention.ref.attention_ref` over causal x window x GQA x
head dim, and against `flash_attention_pallas(interpret=True)` at
bq == bkv (f32, atol 2e-5). `kv_tile_range`, whose formula both CUDA
kernels mirror, against a brute-force mask at both kernels' tile pairs
and at bq != bkv. The routing rule (dtype x hd -> "tf32x3" / "wgmma" /
"fma" / raise), and the "wgmma" route's numerics (bf16 q, k, v; P rounded
to bf16 before P.V; tiled online softmax in exp2) emulated on the CPU and
held against both references at the bf16 tolerances of `chip_smoke.py`.
The "tf32x3" route's numerics (f32 q, k, v; every product as three TF32
products of split operands; the tiled online softmax in exp2 and its L)
emulated tile by tile and held against
`flash_attention_pallas(interpret=True)` and `attention_ref` at the f32
atol 2e-5 over hd 16/64/80/128/256, causal x window, GQA 1/2/8, ragged S
and S != T; one TF32 product per multiply shown to miss that hold.

hd 80 (hubert-xlarge) against `flash_attention_pallas(interpret=True)`,
and on the "wgmma" route in the hd-128 tile with zero columns 80-127.

SSD (K3): `ssd_intra_ref` against `ssd_intra_pallas(interpret=True)`;
`ssd_ref`, `ssd_chunked` and the kernel path's torch glue (`ssd_cuda`
with the plain intra-chunk form in place of the kernel) against
`ssd_ref` and `ssd_pallas(interpret=True)` at the reference tests'
shapes (atol 1e-4). The kernel's route (3xTF32 tensor-core products in
its tile structure, with the decay masked before the exp) emulated on
the CPU and held against both references at `chip_smoke.py`'s tolerance
(atol 1e-4 x max(1, max|ref|)), ragged and strong-decay cases included;
one TF32 product per multiply shown to miss it. The CUDA kernels
themselves run only on the card (`chip_smoke.py`).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.flash import flash_attention_pallas
from repro.kernels.attention.ref import attention_ref as ref_attention
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.kernels.ssd.ref import ssd_step_ref as jax_ssd_step_ref
from repro.kernels.ssd.ssd import ssd_intra_pallas, ssd_pallas
from repro_torch.kernels.attention import flash
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.attention.ref import attention_lse_ref, attention_ref
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.kernels.ssd.ref import (chunk_inputs, ssd_intra_ref,
                                         ssd_ref, ssd_step_ref)

ATOL = 2e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _qkv(s, h, kh, hd, seed=0):
    return (_rand((1, s, h, hd), seed), _rand((1, s, kh, hd), seed + 1),
            _rand((1, s, kh, hd), seed + 2))


# ------------------------------------------------------------------ #
# K2: flash attention
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("kh", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_matches_reference(causal, window, kh, hd):
    q, k, v = _qkv(80, 4, kh, hd, seed=hd + kh)
    want = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_pallas_interpret(causal, window):
    q, k, v = _qkv(128, 4, 2, 32, seed=7)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=64, bkv=64, interpret=True))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("kh", [4, 1])              # GQA 1 and 4
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_hd80_matches_pallas_interpret(causal, window, kh):
    """hubert-xlarge's head dim, which the reference's kernel takes as any
    other (bq == bkv: the reference's causal range is short only when
    bq > bkv)."""
    q, k, v = _qkv(128, 4, kh, 80, seed=80 + kh)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=64, bkv=64, interpret=True))
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _visible_tiles(qi, bq, bkv, causal, window, s, t):
    """kv tiles holding at least one (q, k) pair the mask lets through."""
    qs = np.arange(qi * bq, min(qi * bq + bq, s))[:, None]
    ks = np.arange(t)[None, :]
    ok = np.ones((qs.size, t), bool)
    if causal:
        ok &= ks <= qs
    if window is not None:
        ok &= ks > qs - window
    return sorted(set((np.nonzero(ok.any(axis=0))[0] // bkv).tolist()))


@pytest.mark.parametrize("bq,bkv", [(64, 64), (128, 64), (64, 128),
                                    (32, 48), (128, 128)])
@pytest.mark.parametrize("window", [None, 1, 50, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_kv_tile_range_matches_brute_force(bq, bkv, causal, window):
    for s, t in ((256, 256), (200, 200), (130, 300)):
        for qi in range(-(-s // bq)):
            first, last = flash.kv_tile_range(qi, bq, bkv, causal, window,
                                              s, t)
            assert list(range(first, last + 1)) == _visible_tiles(
                qi, bq, bkv, causal, window, s, t), (s, t, qi)


def test_reference_causal_range_is_short_when_bq_exceeds_bkv():
    """The reference's `last = qi * bq // bkv` (flash.py:36) drops the
    kv tiles of a q tile's later rows when bq > bkv; the port's range
    keeps them."""
    bq, bkv, s = 128, 64, 256
    for qi in range(s // bq):
        _, last = flash.kv_tile_range(qi, bq, bkv, True, None, s, s)
        assert qi * bq // bkv == last - 1


def test_flash_cuda_wrapper_rejects_cpu_tensors():
    q, k, v = map(torch.from_numpy, _qkv(64, 2, 1, 16))
    before = flash.flash_attention_cuda.launches
    routes = dict(flash.flash_attention_cuda.route_launches)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="needs CUDA tensors"):   # tf32x3
        flash.flash_attention_cuda(q, k, v, return_lse=True)
    assert flash.flash_attention_cuda.launches == before
    assert flash.flash_attention_cuda.route_launches == routes
    assert set(flash.HEAD_DIMS) == {16, 32, 64, 80, 128, 256}
    for source in (flash.SOURCE, flash.WGMMA_SOURCE):
        src = source.read_text()
        assert "flash_attention_pallas" in src        # names what it replaces
        assert "kv_tile_range" in src


@pytest.mark.parametrize("source", ["TF32_SOURCE", "BWD_TF32_SOURCE"])
def test_tf32x3_sources_name_what_they_replace(source):
    """Each "tf32x3" source names the Pallas kernel it stands for and the
    tile-range formula it mirrors, says which instruction runs its
    products and splits every operand with cvt.rna; its route is the one
    `ROUTES` / `BWD_ROUTES` name, and it uses no atomics."""
    path = getattr(flash, source)
    src = path.read_text()
    assert "flash_attention_pallas" in src and "kv_tile_range" in src
    assert "cvt.rna.tf32.f32" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert not any(w in src for w in ("atomicAdd", "\"red.", "\"atom."))
    table = flash.ROUTES if source == "TF32_SOURCE" else flash.BWD_ROUTES
    assert table["tf32x3"][0] == path


@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_flash_route_rule(dtype, hd):
    """f32 at every hd takes the 3xTF32 tensor-core kernel; bf16 at hd
    64/80/128/256 the wgmma kernel (hd 80 in the hd-128 tile); bf16 at hd
    16/32 the CUDA-core kernel; anything else raises."""
    if hd not in flash.HEAD_DIMS or dtype == torch.float16:
        with pytest.raises(ValueError):
            flash.route(dtype, hd)
        return
    want = ("tf32x3" if dtype == torch.float32
            else "wgmma" if hd in (64, 80, 128, 256) else "fma")
    assert flash.wgmma_tile(hd) == (128 if hd == 80 else hd)
    assert flash.route(dtype, hd) == want
    assert flash.ROUTES[want][0].exists()


def _wgmma_emulation(q, k, v, causal, window, return_lse=False):
    """The "wgmma" route's arithmetic in f32 on the CPU: per 128-row q tile
    the kv tiles of `kv_tile_range`; S = q k^T of the bf16 inputs in f32;
    the online softmax in log2 units with the kernel's -1e30 mask; P
    rounded to bf16 before P.V; O / max(l, 1e-30) rounded to bf16. The
    tiles are `flash.wgmma_tile(hd)` columns wide: at hd 80, 128 columns
    whose columns 80-127 are zero (TMA's fill), cut off at the store. With
    `return_lse`, also the row log-sum-exp the kernel writes for the
    backward: (m + log2 l) ln 2 from the running max and sum, +inf on a
    row whose max never rose above the -1e30 mask."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    tile = flash.wgmma_tile(hd)
    bq, bkv = 128, 64 if tile == 256 else 128    # BQ, BKV of the source
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    qf, kf, vf = (torch.nn.functional.pad(x.float(), (0, tile - hd))
                  .transpose(1, 2) for x in (q, k, v))
    kf, vf = (x.repeat_interleave(h // kh, dim=1) for x in (kf, vf))
    out = torch.empty(b, h, s, tile)
    lse = torch.empty(b, h, s)
    for qi in range(-(-s // bq)):
        rows = torch.arange(qi * bq, min(qi * bq + bq, s))
        m = torch.full((b, h, rows.numel()), -1e30)
        l = torch.zeros_like(m)
        o = torch.zeros(b, h, rows.numel(), tile)
        first, last = flash.kv_tile_range(qi, bq, bkv, causal, window, s, t)
        for kt in range(first, last + 1):
            keys = torch.arange(kt * bkv, min(kt * bkv + bkv, t))
            x = qf[:, :, rows] @ kf[:, :, keys].mT * scale_log2
            ok = torch.ones(rows.numel(), keys.numel(), dtype=torch.bool)
            if causal:
                ok &= keys[None] <= rows[:, None]
            if window is not None:
                ok &= keys[None] > rows[:, None] - window
            x = torch.where(ok, x, -1e30)
            mn = torch.maximum(m, x.amax(dim=-1))
            corr = torch.exp2(m - mn)
            p = torch.exp2(x - mn[..., None])
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + p.bfloat16().float() @ vf[:, :, keys]
            m = mn
        out[:, :, rows] = o / l.clamp_min(1e-30)[..., None]
        lse[:, :, rows] = torch.where(m > -1e30, (m + torch.log2(l))
                                      * 0.6931471805599453, math.inf)
    out = out[..., :hd].transpose(1, 2).bfloat16()
    return (out, lse) if return_lse else out


@pytest.mark.parametrize("h,kh,hd,s,causal,window", [
    (16, 8, 128, 512, True, None),      # qwen3-0.6b's layer width
    (8, 4, 128, 320, True, 128),
    (8, 8, 64, 320, False, None),
    (4, 2, 256, 320, True, None),       # bq > bkv
    (4, 1, 64, 200, True, 50),          # ragged
    (16, 16, 80, 320, False, None),     # hubert-xlarge: the hd-128 tile
])
def test_wgmma_route_numerics_hold_against_reference(h, kh, hd, s, causal,
                                                     window):
    """The bf16 hold of `chip_smoke.py` (atol 2e-2 and relative Frobenius
    error 1e-2 against the f32 reference on the same bf16 inputs) is the
    right one for the tensor-core kernel's rounding."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(s, h, kh, hd, seed=11))
    got = _wgmma_emulation(q, k, v, causal, window).float()
    refs = (attention_ref(q.float(), k.float(), v.float(), causal=causal,
                          window=window),
            torch.from_numpy(np.asarray(ref_attention(
                *(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                causal=causal, window=window))))
    for ref in refs:
        assert float((got - ref).abs().max()) <= 2e-2
        assert float((got - ref).norm() / ref.norm()) <= 1e-2
        assert not torch.equal(got, ref.bfloat16().float())   # P rounds


@pytest.mark.parametrize("s,t,hd,causal,window", [
    (512, 512, 128, True, None), (200, 200, 80, False, None),
    (200, 200, 64, True, 50), (300, 100, 128, True, 64)])
def test_wgmma_forward_lse_emulation(s, t, hd, causal, window):
    """The L that the wgmma forward writes for its backward, emulated from
    its running max and sum, equals `attention_lse_ref` (atol 1e-4, the
    card's hold), with +inf on exactly the rows that see no key (at
    S=300 > T=100 under window 64: rows 163-299)."""
    rng = np.random.default_rng(s + t)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .bfloat16() for shape in ((1, s, 4, hd), (1, t, 2, hd),
                                         (1, t, 2, hd)))
    _, got = _wgmma_emulation(q, k, v, causal, window, return_lse=True)
    want = attention_lse_ref(q.float(), k.float(), causal, window)
    empty = torch.isinf(want)
    assert torch.equal(torch.isposinf(got), empty)
    assert int(empty.sum()) == (4 * 137 if s == 300 else 0)
    assert float((got[~empty] - want[~empty]).abs().max()) <= 1e-4


# ------------------------------------------------------------------ #
# K3: the SSD intra-chunk form
# ------------------------------------------------------------------ #
SSD_SHAPES = [(1, 32, 2, 8, 4), (2, 64, 4, 16, 8), (1, 128, 1, 32, 16)]


def _ssd_inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32))


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_intra_ref_matches_pallas_interpret(shape):
    ins = _ssd_inputs(*shape, seed=7)
    C, B, dtx, cums = chunk_inputs(*map(torch.from_numpy, ins[:5]), 16)
    y, S = ssd_intra_ref(C, B, dtx, cums)
    y_want, S_want = ssd_intra_pallas(*(jnp.asarray(t.numpy())
                                        for t in (C, B, dtx, cums)),
                                      interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_want), atol=1e-4)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_plain_and_kernel_glue_match_reference(shape, monkeypatch):
    ins = _ssd_inputs(*shape, seed=7)
    y_ref, h_ref = jax_ssd_ref(*map(jnp.asarray, ins), chunk=16)
    y_pl, h_pl = ssd_pallas(*map(jnp.asarray, ins), chunk=16,
                            interpret=True)
    tins = list(map(torch.from_numpy, ins))
    # ssd_cuda's torch code around the kernel, with the plain intra-chunk
    # form standing in for the kernel (which needs the card)
    monkeypatch.setattr(ssd, "ssd_intra_cuda", ssd_intra_ref)
    for y, h in (ssd_ref(*tins, chunk=16), ssd_chunked(*tins, chunk=16),
                 ssd.ssd_cuda(*tins, chunk=16)):
        for want_y, want_h in ((y_ref, h_ref), (y_pl, h_pl)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                       atol=1e-4)
            np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                       atol=1e-4)


def test_ssd_initial_state_and_step_match_reference():
    ins = _ssd_inputs(2, 16, 2, 4, 4, seed=3)
    h0 = np.random.default_rng(4).normal(size=(2, 2, 4, 4)).astype(
        np.float32)
    y_want, h_want = jax_ssd_ref(*map(jnp.asarray, ins), chunk=4,
                                 h0=jnp.asarray(h0))
    y, h = ssd_ref(*map(torch.from_numpy, ins), chunk=4,
                   h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=1e-4)
    x, dt, Bm, Cm, A_log, D = ins
    step = (x[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0], A_log, D, h0)
    y_want, h_want = jax_ssd_step_ref(*map(jnp.asarray, step))
    y, h = ssd_step_ref(*map(torch.from_numpy, step))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=1e-5)


def test_ssd_dispatch_rules():
    tins = list(map(torch.from_numpy, _ssd_inputs(1, 32, 2, 8, 4)))
    before = ssd.ssd_intra_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd.ssd_cuda(*tins, chunk=16)
    with pytest.raises(ValueError, match="not a multiple"):
        ssd_chunked(*tins, chunk=12)
    assert ssd.ssd_intra_cuda.launches == before
    src = ssd.SOURCE.read_text()
    assert "ssd_intra_pallas" in src                  # names what it replaces


# The route of `ssd_intra.cu`: 3xTF32 tensor-core products, f32 accumulate
def _tf32(x):
    """Round f32 to TF32 as `cvt.rna.tf32.f32` does: to nearest with ties
    away from zero, 10 mantissa bits kept (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b as the kernel's MMAs take it: exact products of TF32 operands
    summed in f32. passes=3: x = hi + lo with hi = tf32(x), lo = tf32(x -
    hi), and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; passes=1: one TF32
    product a_hi.b_hi."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _ssd_3xtf32_emulation(C, B, dtx, cums, passes=3, br=64):
    """The kernel's arithmetic on the CPU, in its tile structure. Per
    64-row i tile: the G panel C_i . B^T up to the diagonal (split
    products); off the diagonal (j < i0) the decay as exp(ci - c0) *
    exp(c0 - cj) with c0 = cums[i0 - 1], both factors <= 1: the dtx rows
    weighted by exp(c0 - cj) and split, G split, their product scaled by
    exp(ci - c0); on the diagonal tile att = G * exp(ci - cj), masked
    before the exp, split and multiplied by the split dtx tile. S =
    B^T . (exp(last - cums) * dtx), both operands split. Products of
    split operands are exact in f32, sums are f32."""
    b, nc, q, n = C.shape
    h, p = dtx.shape[3], dtx.shape[4]
    xt = dtx.permute(0, 1, 3, 2, 4)                        # (b,nc,H,Q,P)
    ct = cums.permute(0, 1, 3, 2)                          # (b,nc,H,Q)
    y = torch.zeros(b, nc, h, q, p)
    for i0 in range(0, q, br):
        i1 = min(i0 + br, q)
        G = _mm_tf32(C[:, :, i0:i1], B[:, :, :i1].mT, passes)
        ci = ct[:, :, :, i0:i1]
        if i0:
            c0 = ct[:, :, :, i0 - 1:i0]
            xw = torch.exp(c0 - ct[:, :, :, :i0])[..., None] \
                * xt[:, :, :, :i0]
            off = _mm_tf32(G[:, :, None, :, :i0], xw, passes)
            y[:, :, :, i0:i1] = off * torch.exp(ci - c0)[..., None]
        keep = (torch.arange(i0, i1)[:, None]
                >= torch.arange(i0, i1)[None])
        d = ci[..., :, None] - ci[..., None, :]
        att = G[:, :, None, :, i0:i1] * torch.exp(
            torch.where(keep, d, -torch.inf))
        y[:, :, :, i0:i1] += _mm_tf32(att, xt[:, :, :, i0:i1], passes)
    w = torch.exp(ct[..., -1:] - ct)                       # (b,nc,H,Q)
    S = _mm_tf32(B[:, :, None].mT, w[..., None] * xt, passes)
    return y.permute(0, 1, 3, 2, 4), S


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                  # the TF32 neighbour of 1.0
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      -(1.0 + 2.0 ** -11), 3.0, 0.0])
    assert _tf32(x).tolist() == [one, 1.0, -one, 3.0, 0.0]


SSD_ROUTE_CASES = [   # (b, l, h, p, n, chunk, A_log shift)
    *((*s, 16, 0.0) for s in SSD_SHAPES),
    (1, 200, 3, 24, 20, 100, 0.0),          # ragged chunk
    (2, 144, 3, 12, 20, 72, 0.0),           # N, P, chunk off 8 / 16 / 64
    (1, 192, 5, 100, 36, 64, 0.0),          # P over 64: two slots per head
    (1, 512, 2, 64, 128, 256, 0.0),         # mamba2-370m's widths
    (1, 512, 2, 64, 128, 256, 4.0),         # strong decay: cums < -500
]


@pytest.mark.parametrize("b,l,h,p,n,chunk,shift", SSD_ROUTE_CASES)
def test_ssd_3xtf32_route_holds_against_references(b, l, h, p, n, chunk,
                                                   shift):
    """`chip_smoke.py`'s hold of the kernel (atol 1e-4 x max(1, max|ref|))
    is met by its 3xTF32 arithmetic, against `ssd_intra_ref` and the
    interpret-mode Pallas kernel."""
    ins = list(_ssd_inputs(b, l, h, p, n, seed=7))
    ins[4] = ins[4] + np.float32(shift)
    C, B, dtx, cums = chunk_inputs(*map(torch.from_numpy, ins[:5]), chunk)
    if shift:
        assert float(cums.min()) < -500     # exp(-cums_j) overflows f32
    y, S = _ssd_3xtf32_emulation(C, B, dtx, cums)
    refs = (ssd_intra_ref(C, B, dtx, cums),
            tuple(torch.from_numpy(np.array(r)) for r in ssd_intra_pallas(
                *(jnp.asarray(t.numpy()) for t in (C, B, dtx, cums)),
                interpret=True)))
    for y_ref, S_ref in refs:
        for got, ref in ((y, y_ref), (S, S_ref)):
            assert bool(torch.isfinite(got).all())
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            assert float((got - ref).abs().max()) <= tol


def test_ssd_one_tf32_product_misses_the_hold():
    """Why the kernel splits: at mamba2's widths one TF32 product per
    multiply misses the f32 hold for both y and S."""
    ins = _ssd_inputs(1, 512, 2, 64, 128, seed=7)
    C, B, dtx, cums = chunk_inputs(*map(torch.from_numpy, ins[:5]), 256)
    y, S = _ssd_3xtf32_emulation(C, B, dtx, cums, passes=1)
    y_ref, S_ref = ssd_intra_ref(C, B, dtx, cums)
    for got, ref in ((y, y_ref), (S, S_ref)):
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) > tol


def test_ssd_kernel_limits_match_wrapper():
    """The wrapper raises on exactly the shapes the CUDA source refuses:
    its limits are the source's MAXQ / MAXN / MAXP; the head group its
    route names is the source's HG."""
    src = ssd.SOURCE.read_text()
    for name, want in (("MAXQ", ssd.MAX_CHUNK), ("MAXN", ssd.MAX_STATE),
                       ("MAXP", ssd.MAX_HEAD_DIM), ("HG", ssd.HEAD_GROUP)):
        assert f"constexpr int {name} = {want};" in src


# ------------------------------------------------------------------ #
# K2's "tf32x3" route: 3xTF32 tensor-core products, f32 accumulate
# ------------------------------------------------------------------ #
def _tf32x3_emulation(q, k, v, causal, window, passes=3):
    """The "tf32x3" forward's arithmetic in f32 on the CPU, tile by tile:
    per 64-row q tile the 64-row kv tiles of `kv_tile_range`; S = q k^T
    and P.V as `_mm_tf32` products (three TF32 products of split operands,
    or one with passes=1); the online softmax in log2 units with the
    kernel's -1e30 mask and -inf past T; O / max(l, 1e-30); and the row
    log-sum-exp L = (m + log2 l) ln 2, +inf on a row whose max never rose
    above the mask. Returns (out, L)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    bq = bkv = 64                                   # BQ, BKV of the source
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    kf, vf = (x.repeat_interleave(h // kh, dim=1) for x in (kf, vf))
    out = torch.empty(b, h, s, hd)
    lse = torch.empty(b, h, s)
    for qi in range(-(-s // bq)):
        rows = torch.arange(qi * bq, min(qi * bq + bq, s))
        m = torch.full((b, h, rows.numel()), -1e30)
        l = torch.zeros_like(m)
        o = torch.zeros(b, h, rows.numel(), hd)
        first, last = flash.kv_tile_range(qi, bq, bkv, causal, window, s, t)
        for kt in range(first, last + 1):
            keys = torch.arange(kt * bkv, min(kt * bkv + bkv, t))
            x = _mm_tf32(qf[:, :, rows], kf[:, :, keys].mT, passes) \
                * scale_log2
            ok = torch.ones(rows.numel(), keys.numel(), dtype=torch.bool)
            if causal:
                ok &= keys[None] <= rows[:, None]
            if window is not None:
                ok &= keys[None] > rows[:, None] - window
            x = torch.where(ok, x, -1e30)
            mn = torch.maximum(m, x.amax(dim=-1))
            corr = torch.exp2(m - mn)
            p = torch.exp2(x - mn[..., None])
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + _mm_tf32(p, vf[:, :, keys], passes)
            m = mn
        out[:, :, rows] = o / l.clamp_min(1e-30)[..., None]
        lse[:, :, rows] = torch.where(m > -1e30, (m + torch.log2(l))
                                      * 0.6931471805599453, math.inf)
    return out.transpose(1, 2), lse


TF32X3_FWD_CASES = [   # (h, kh, hd, s, t, causal, window)
    *((8, 8 // g, hd, 128, 128, causal, window)
      for (hd, g), (causal, window) in zip(
          [(16, 1), (16, 2), (16, 8), (16, 1), (64, 2), (64, 8), (64, 1),
           (64, 2), (80, 8), (80, 1), (80, 2), (80, 8), (128, 1), (128, 2),
           (128, 8), (128, 1), (256, 2), (256, 8), (256, 1), (256, 2)],
          [(True, None), (True, 24), (False, None), (False, 24)] * 5)),
    (4, 2, 64, 200, 200, True, 50),         # ragged, shorter than a tile
    (4, 2, 128, 5, 5, True, None),          # one partial tile
    (4, 2, 128, 200, 328, True, None),      # T > S: kv tiles past S
    (4, 2, 64, 328, 200, True, None),       # S > T: rows past T
]


@pytest.mark.parametrize("h,kh,hd,s,t,causal,window", TF32X3_FWD_CASES)
def test_tf32x3_forward_holds_against_pallas(h, kh, hd, s, t, causal,
                                             window):
    """`chip_smoke.py`'s f32 hold of the "tf32x3" forward (atol 2e-5) is
    met by its arithmetic, against the interpret-mode Pallas kernel (64-row
    blocks where S and T divide, one block each otherwise) and
    `attention_ref`; its L against `attention_lse_ref` at atol 1e-4."""
    rng = np.random.default_rng(hd + s + t + h // kh)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((1, s, h, hd), (1, t, kh, hd), (1, t, kh, hd)))
    bq = 64 if s % 64 == 0 else s
    bkv = 64 if t % 64 == 0 else t
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=bq, bkv=bkv, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got, lse = _tf32x3_emulation(tq, tk, tv, causal, window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ref = attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    want_l = attention_lse_ref(tq, tk, causal, window)
    assert bool(torch.isfinite(want_l).all())
    assert float((lse - want_l).abs().max()) <= 1e-4


def test_tf32x3_forward_lse_where_rows_see_no_key():
    """S=300 > T=100 under window 64: the emulated L is +inf on exactly
    the rows that see no key (163-299) and within 1e-4 elsewhere."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((1, 300, 4, 128), (1, 100, 2, 128),
                             (1, 100, 2, 128)))
    _, got = _tf32x3_emulation(q, k, v, True, 64)
    want = attention_lse_ref(q, k, True, 64)
    empty = torch.isinf(want)
    assert torch.equal(torch.isposinf(got), empty)
    assert int(empty.sum()) == 4 * 137
    assert float((got[~empty] - want[~empty]).abs().max()) <= 1e-4


def test_tf32x3_forward_one_tf32_product_misses_the_hold():
    """Why the kernel splits: at qwen3's head dim one TF32 product per
    multiply misses the f32 hold (atol 2e-5) that three meet."""
    q, k, v = map(torch.from_numpy, _qkv(512, 4, 2, 128, seed=29))
    want = attention_ref(q, k, v)
    one, _ = _tf32x3_emulation(q, k, v, True, None, passes=1)
    three, _ = _tf32x3_emulation(q, k, v, True, None)
    assert float((one - want).abs().max()) > ATOL
    assert float((three - want).abs().max()) <= ATOL
