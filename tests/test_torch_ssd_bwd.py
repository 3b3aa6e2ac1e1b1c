"""K3's backward (the SSD intra-chunk form's) held on the CPU.

The plain backward `ssd_intra_bwd_ref` (explicit formulas) against
torch.autograd through `ssd_intra_ref`; the kernel's tile walk
(`csrc/ssd_intra_bwd.cu`: the dx, dgsum and dcdb functions and their
scratch) emulated in numpy against it, in f32 and in the kernel's 3xTF32
arithmetic; the autograd path of the port's
SSD (`ssd_with_intra` around `ops.SSDIntra`, what `ssd_chunked` runs
on CUDA tensors), with the Function's kernels replaced by their plain
versions,
against `jax.vjp` of the reference's `ssd_ref`; the Function's plumbing
under a non-reentrant checkpoint; the wrapper's refusals. The kernel
itself runs only on the card (`chip_smoke.py`, phase 19). All inputs come
from seeded numpy generators.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels.ssd import ops, ssd
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.kernels.ssd.ref import (chunk_inputs, ssd_intra_bwd_ref,
                                         ssd_intra_ref, ssd_ref,
                                         ssd_with_intra)

SSD_ATOL = 1e-4               # the kernel's hold: x max(1, max|ref|)
CASES = [   # (b, l, h, p, n, chunk, A_log shift)
    (1, 32, 2, 8, 4, 16, 0.0),              # the reference tests' shape
    (2, 64, 4, 16, 8, 16, 0.0),             # several heads, chunks, batch
    (1, 200, 3, 24, 20, 100, 0.0),          # ragged chunk: tiles 64 + 36
    (2, 144, 3, 12, 20, 72, 0.0),           # N, P, chunk off 8 / 16 / 64
    (1, 96, 2, 6, 5, 48, 0.0),              # N, P off a multiple of 4
    (1, 320, 9, 100, 36, 160, 0.0),         # P over 64, nine heads
    (1, 512, 2, 64, 128, 256, 0.0),         # mamba2-370m's widths
    (1, 512, 2, 64, 128, 256, 4.0),         # strong decay: cums < -500
]


def _inputs(b, l, h, p, n, chunk, shift, seed=7):
    """The chunked f32 inputs of the intra-chunk form and seeded
    cotangents (dy, dS) of its outputs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32)
    Bm = rng.normal(size=(b, l, n)).astype(np.float32)
    Cm = rng.normal(size=(b, l, n)).astype(np.float32)
    A_log = (rng.normal(size=(h,)) + shift).astype(np.float32)
    C, B, dtx, cums = chunk_inputs(*map(torch.from_numpy,
                                        (x, dt, Bm, Cm, A_log)), chunk)
    if shift:
        assert float(cums.min()) < -500     # exp(-cums_j) overflows f32
    nc = l // chunk
    dy = torch.from_numpy(rng.normal(size=(b, nc, chunk, h, p)).astype(
        np.float32))
    dS = torch.from_numpy(rng.normal(size=(b, nc, h, n, p)).astype(
        np.float32))
    return C, B, dtx, cums, dy, dS


def _hold(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        tol = SSD_ATOL * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol


@pytest.mark.parametrize("case", CASES)
def test_ssd_intra_bwd_ref_matches_autograd(case):
    """The explicit formulas against torch.autograd through the forward,
    both f32: within 1e-4 x max(1, max|ref|) per output (the kernel's
    hold), every output finite under strong decay too."""
    C, B, dtx, cums, dy, dS = _inputs(*case)
    leaves = [t.clone().requires_grad_() for t in (C, B, dtx, cums)]
    want = torch.autograd.grad(ssd_intra_ref(*leaves), leaves, (dy, dS))
    _hold(ssd_intra_bwd_ref(C, B, dtx, cums, dy, dS), want)


# the kernel's tiles (`ssd_intra_bwd.cu`): j tiles of BJ rows, HG heads
# per G panel, i tiles from the j tile's first row of 2 BI rows in
# ssd_bwd_dxw (P <= 64, wgmma) and of BI rows in ssd_bwd_dx (P > 64,
# mma.sync: its 16-row stripes by 8-column n-tiles)
BJ, BI, HG = 32, 64, 8


def _tf32(x):
    """Round f32 to TF32 as `cvt.rna.tf32.f32` does: to nearest with ties
    away from zero, 10 mantissa bits kept (the low 13 bits cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(np.float32)


def _mm_tf32(a, b):
    """a @ b as the kernel's MMAs take it: x = hi + lo with hi = tf32(x),
    lo = tf32(x - hi), and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, exact
    products of TF32 operands summed in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _computed(nj_rows, ni_cols):
    """The MMA sub-tiles the kernel runs in a (j tile, its i columns from
    j0) panel: a 16-row stripe by 8-column n-tile is skipped when its
    last column lies before its first row (wholly above the diagonal)."""
    stripe = np.arange(nj_rows)[:, None] // 16
    ntile = np.arange(ni_cols)[None, :] // 8
    return 8 * ntile + 7 >= 16 * stripe


def _tile_walk(C, B, dtx, cums, dy, dS, mm=np.matmul):
    """`ssd_intra_bwd.cu`'s decomposition in numpy f32, with `mm` for
    every product (`_mm_tf32` for the kernel's 3xTF32 arithmetic).

    The dx function, per (BJ-row j tile, group of HG heads): the panel
    G^T = B_j.C^T over i >= j0 once for the group; per head, the state
    part first, B_j.dS (its g_j = w_j X_j . B_j dS summed over the tile),
    then acc = w o B_j dS; per i tile (2 BI rows for P <= 64, else BI)
    dAtt^T = X_j.dY_i^T (for P > 64 on the computed sub-tiles only: the
    wgmma tiles of P <= 64 have none wholly above the diagonal), masked to
    i >= j before the exp of c_i - c_j,
    dL = dAtt^T o decay, att^T = G^T o decay, the tile's row sums of dL o
    G per i, dG^T (the group's partial) += dL, acc += att^T.dY_i; ddtx_j =
    acc and X_j . ddtx_j. ssd_bwd_dcdb: dG = the group partials summed in
    group order and masked to i >= j; dC = dG.B; dB = dG^T.C + [w o X]
    (Q x H.P) . [dS stacked] (H.P x N), the state term as one product;
    dcums = the j tiles' row sums - X . ddtx, plus the g sums on the last
    row."""
    C, B, dtx, cums, dy, dS = (t.numpy().astype(np.float32) for t in
                               (C, B, dtx, cums, dy, dS))
    b, nc, q, n = C.shape
    h, p = dtx.shape[3], dtx.shape[4]
    bc = b * nc
    C, B = C.reshape(bc, q, n), B.reshape(bc, q, n)
    X, dY = dtx.reshape(bc, q, h, p), dy.reshape(bc, q, h, p)
    c, dS = cums.reshape(bc, q, h), dS.reshape(bc, h, n, p)
    nj, ng = -(-q // BJ), -(-h // HG)
    last = c[:, -1]
    dGp = np.zeros((bc, ng, q, q), np.float32)        # [j][i] per group
    rs = np.zeros((bc, h, nj, q), np.float32)
    gsum = np.zeros((bc, h, nj), np.float32)
    ddtx = np.zeros_like(X)
    dcol = np.zeros((bc, q, h), np.float32)
    for jt in range(nj):                                 # ssd_bwd_dx
        J = np.arange(jt * BJ, min(q, (jt + 1) * BJ))
        I = np.arange(jt * BJ, q)
        Gt = mm(B[:, J], C[:, I].transpose(0, 2, 1))
        on = I[None, :] >= J[:, None]
        run = (_computed(len(J), len(I)) if p > 64
               else np.ones((len(J), len(I)), bool))
        for g in range(ng):
            dGt = np.zeros_like(Gt)
            for hh in range(g * HG, min(h, (g + 1) * HG)):
                Xj, cj = X[:, J, hh], c[:, J, hh]
                w = np.exp(last[:, None, hh] - cj)
                sacc = mm(B[:, J], dS[:, hh])
                gsum[:, hh, jt] = (w * (Xj * sacc).sum(-1)).sum(-1)
                acc = w[..., None] * sacc
                with np.errstate(over="ignore"):
                    decay = np.exp(np.where(on, c[:, I, hh][:, None, :]
                                            - cj[:, :, None], -np.inf))
                ti = 2 * BI if p <= 64 else BI
                for i0 in range(0, len(I), ti):
                    sl = slice(i0, min(len(I), i0 + ti))
                    dYi = dY[:, I[sl], hh]
                    dA = np.where(run[:, sl],
                                  mm(Xj, dYi.transpose(0, 2, 1)), 0)
                    dL = dA * decay[..., sl]
                    att = Gt[..., sl] * decay[..., sl]
                    rs[:, hh, jt, I[sl]] = (dL * Gt[..., sl]).sum(1)
                    dGt[..., sl] += dL
                    acc = acc + mm(att, dYi)
                ddtx[:, J, hh] = acc
                dcol[:, J, hh] = (Xj * acc).sum(-1)
            dGp[:, g, J[:, None], I[None, :]] = dGt
    dG = dGp[:, 0]                                       # ssd_bwd_dcdb
    for g in range(1, ng):
        dG = dG + dGp[:, g]
    dG = np.where(np.tril(np.ones((q, q), bool)).T, dG, 0)   # [j][i], i >= j
    w = np.exp(last[:, None, :] - c)                     # (bc, Q, H)
    wx = (w[..., None] * X).reshape(bc, q, h * p)
    dC = mm(dG.transpose(0, 2, 1), B)
    dB = mm(dG, C) + mm(wx, dS.transpose(0, 1, 3, 2).reshape(bc, h * p, n))
    dcums = rs.sum(2).transpose(0, 2, 1) - dcol
    dcums[:, -1] += gsum.sum(2)
    return tuple(torch.from_numpy(a) for a in (
        dC.reshape(b, nc, q, n), dB.reshape(b, nc, q, n),
        ddtx.reshape(b, nc, q, h, p), dcums.reshape(b, nc, q, h)))


@functools.cache
def _case(case):
    """A case's inputs and the plain backward's outputs, shared by the
    tests of that case."""
    ins = _inputs(*case)
    return ins, ssd_intra_bwd_ref(*ins)


@pytest.mark.parametrize("case", CASES)
def test_bwd_kernel_tile_walk(case):
    """The kernel's decomposition (j tiles of 32 rows, i tiles of 128 rows
    for P <= 64 and of 64 with the diagonal's sub-tiles wholly above it
    skipped for P > 64, G^T once per group of 8 heads, dG as group
    partials summed in order, dB's state term as one H.P-long product,
    dcums's column part as X . ddtx, the last row's g sums) holds against
    the plain backward at the kernel's tolerance, strong decay included."""
    ins, want = _case(case)
    _hold(_tile_walk(*ins), want)


@pytest.mark.parametrize("case", CASES)
def test_bwd_3xtf32_emulation(case):
    """The kernel's arithmetic: every product of that decomposition as
    three TF32 products (each operand split hi + lo), summed in f32,
    holds against the plain backward at 1e-4 x max(1, max|ref|) per
    output, at mamba2's widths and under strong decay too."""
    ins, want = _case(case)
    _hold(_tile_walk(*ins, mm=_mm_tf32), want)


def test_bwd_one_tf32_product_misses_the_hold():
    """Why the kernel splits every operand: at mamba2's widths one TF32
    product per multiply in the same decomposition misses the hold."""
    ins, want = _case(CASES[6])
    got = _tile_walk(*ins, mm=lambda a, b: _tf32(a) @ _tf32(b))
    assert any(float((g - w).abs().max())
               > SSD_ATOL * max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


# the autograd path against jax.vjp of the reference's ssd_ref
VJP_CASES = [   # (b, l, h, p, n, chunk, A_log shift)
    (2, 64, 4, 16, 8, 16, 0.0),
    (1, 200, 3, 24, 20, 100, 0.0),
    (1, 256, 2, 8, 4, 128, 4.0),
]


@functools.cache
def _jax_vjp(chunk: int):
    """One jitted vjp per chunk length, shared by the cases."""
    def run(ins, cot):
        _, pull = jax.vjp(lambda *a: jax_ssd_ref(*a, chunk=chunk), *ins)
        return pull(cot)
    return jax.jit(run)


def _full_inputs(b, l, h, p, n, chunk, shift, seed=11):
    rng = np.random.default_rng(seed)
    ins = (rng.normal(size=(b, l, h, p)).astype(np.float32),
           rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32),
           rng.normal(size=(b, l, n)).astype(np.float32),
           rng.normal(size=(b, l, n)).astype(np.float32),
           (rng.normal(size=(h,)) + shift).astype(np.float32),
           rng.normal(size=(h,)).astype(np.float32))
    cot = (rng.normal(size=(b, l, h, p)).astype(np.float32),
           rng.normal(size=(b, h, n, p)).astype(np.float32))
    return ins, cot


def _card_path(*ins, chunk):
    """What `ssd_chunked` runs on CUDA tensors: the glue around
    `ops.SSDIntra`."""
    return ssd_with_intra(ops.SSDIntra.apply, *ins, chunk=chunk)


@pytest.mark.parametrize("case", VJP_CASES)
def test_ssd_grads_match_jax_vjp(case):
    """The gradients of x, dt, Bm, Cm, A_log and D (cotangents on y and
    the final state) through `_card_path` (SSDIntra, whose ops run their
    plain versions on CPU tensors) and through `ssd_chunked` on the CPU (`ssd_ref` under
    autograd), against `jax.vjp` of the reference's `ssd_ref`: within
    1e-4 x max(1, max|ref|) per gradient."""
    ins, cot = _full_inputs(*case)
    chunk = case[5]
    want = _jax_vjp(chunk)(tuple(map(jnp.asarray, ins)),
                           tuple(map(jnp.asarray, cot)))
    want = [torch.from_numpy(np.array(w)) for w in want]
    for fn in (_card_path, ssd_chunked):
        leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
        y, hf = fn(*leaves, chunk=chunk)
        got = torch.autograd.grad((y, hf), leaves,
                                  tuple(map(torch.from_numpy, cot)))
        _hold(got, want)


@pytest.mark.parametrize("remat", [False, True])
def test_ssd_function_plumbing(remat):
    """SSDIntra saves C, B, dtx and cums and hands them to the backward
    op; under a non-reentrant checkpoint those are the recomputed
    forward's (a dispatch mode records the C each op was given; on CPU
    tensors the ops run their plain versions). The gradients equal
    autograd through `ssd_ref` within the kernel's tolerance."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = {"fwd": [], "bwd": []}
    ops_seen = {torch.ops.repro_torch.ssd_intra: "fwd",
                torch.ops.repro_torch.ssd_intra_bwd: "bwd"}

    class Calls(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket in ops_seen:
                seen[ops_seen[func._overloadpacket]].append(args[0])
            return func(*args, **(kwargs or {}))

    ins, cot = _full_inputs(1, 64, 2, 8, 4, 32, 0.0)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]

    def run(*a):
        return _card_path(*a, chunk=32)
    with Calls():
        y, hf = (checkpoint(run, *leaves, use_reentrant=False) if remat
                 else run(*leaves))
        got = torch.autograd.grad((y, hf), leaves,
                                  tuple(map(torch.from_numpy, cot)))
    assert len(seen["fwd"]) == (2 if remat else 1)
    # a saved input unpacks as a new tensor object on the same memory
    assert len(seen["bwd"]) == 1
    assert seen["bwd"][0].data_ptr() == seen["fwd"][-1].data_ptr()
    ref_leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    want = torch.autograd.grad(ssd_ref(*ref_leaves, chunk=32), ref_leaves,
                               tuple(map(torch.from_numpy, cot)))
    _hold(got, want)


def test_ssd_chunked_dispatch_under_autograd():
    """On CPU tensors `ssd_chunked` under autograd is `ssd_ref` (autograd
    through the plain version) and launches nothing."""
    ins, cot = _full_inputs(1, 32, 2, 8, 4, 16, 0.0)
    before = (ssd.ssd_intra_cuda.launches, ssd.ssd_intra_bwd_cuda.launches)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, hf = ssd_chunked(*leaves, chunk=16)
    assert y.grad_fn is not None and "SSDIntra" not in type(
        y.grad_fn).__name__
    torch.autograd.grad((y, hf), leaves, tuple(map(torch.from_numpy, cot)))
    assert (ssd.ssd_intra_cuda.launches,
            ssd.ssd_intra_bwd_cuda.launches) == before


def test_ssd_intra_bwd_cuda_refuses():
    """The backward wrapper raises on CPU tensors, on cotangents of the
    wrong shape, on shapes past the kernel's limits, and under grad mode
    when an input requires grad; it launches nothing."""
    before = ssd.ssd_intra_bwd_cuda.launches
    C = torch.zeros((1, 1, 16, 4))
    dtx, cums = torch.zeros((1, 1, 16, 2, 3)), torch.zeros((1, 1, 16, 2))
    dy, dS = torch.zeros_like(dtx), torch.zeros((1, 1, 2, 4, 3))
    with pytest.raises(ValueError, match="needs CUDA tensors.*"
                       "ssd_intra_bwd_ref"):
        ssd.ssd_intra_bwd_cuda(C, C, dtx, cums, dy, dS)
    for bad_dy, bad_dS in ((dy[..., :2], dS), (dy, dS.transpose(-1, -2)),
                           (dy[:, :, :8], dS)):
        with pytest.raises(ValueError, match="not dtx's shape"):
            ssd.ssd_intra_bwd_cuda(C, C, dtx, cums, bad_dy, bad_dS)
    wide = torch.zeros((1, 1, 16, ssd.MAX_STATE + 1))
    with pytest.raises(ValueError, match="outside"):
        ssd.ssd_intra_bwd_cuda(wide, wide, dtx, cums, dy,
                               torch.zeros((1, 1, 2, ssd.MAX_STATE + 1, 3)))
    leaf = C.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient.*SSDIntra"):
        ssd.ssd_intra_bwd_cuda(leaf, C, dtx, cums, dy, dS)
    assert ssd.ssd_intra_bwd_cuda.launches == before


def test_ssd_bwd_source_matches_wrapper():
    """The backward source names the TPU kernel it stands beside and the
    reference form it differentiates, takes the wrapper's limits, has the
    tiles `_tile_walk` emulates, runs its products on the tensor cores in
    3xTF32 (cvt.rna.tf32 splits, mma.sync), and uses no atomics."""
    src = ssd.BWD_SOURCE.read_text()
    assert "ssd_intra_pallas" in src and "ssd_ref" in src
    for name, want in (("MAXQ", ssd.MAX_CHUNK), ("MAXN", ssd.MAX_STATE),
                       ("MAXP", ssd.MAX_HEAD_DIM), ("HG", ssd.HEAD_GROUP),
                       ("BJ", BJ), ("BI", BI)):
        assert f"constexpr int {name} = {want};" in src
    assert HG == ssd.HEAD_GROUP
    assert "cvt.rna.tf32.f32" in src and "mma.sync.aligned.m16n8k8" in src
    assert "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32" in src
    for small, big in (("mma_tf32(d[u], alo, bh[u][0]", "mma_tf32(d[u], ahi, "
                        "bh[u][0]"), ("wgmma_n32(d, alo[kk], dh);",
                                      "wgmma_n32(d, ahi[kk], dh);")):
        assert src.index(small) < src.index(big)   # the small terms first
    assert "atomic" not in src.replace("no atomics", "")
    assert "mma.sync" in ssd.BWD_ROUTE and "3xTF32" in ssd.BWD_ROUTE
