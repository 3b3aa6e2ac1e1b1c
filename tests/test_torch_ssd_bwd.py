"""K3's backward (the SSD intra-chunk form's) held on the CPU.

The plain backward `ssd_intra_bwd_ref` (explicit formulas) against
torch.autograd through `ssd_intra_ref`; the kernel's tile walk
(`csrc/ssd_intra_bwd.cu`: the pair, dx and dcdb functions and their
scratch) emulated in numpy against it; the autograd path of the port's
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


def _tile_walk(C, B, dtx, cums, dy, dS, br=64):
    """`ssd_intra_bwd.cu`'s decomposition in numpy f32, tile by tile.
    ssd_bwd_pair, per (i tile >= j tile): G = C_i.B_j^T; per head dAtt =
    dY_i.X_j^T, masked to i >= j before the exp of c_i - c_j; dG summed
    over the heads; each head's row sums of dAtt o att (a partial per j
    tile). ssd_bwd_dx, per (j tile, head): ddtx = sum_i att^T.dY_i + w (B_j
    . dS), att from the stored G; X . ddtx per row; the tile's sum of g.
    ssd_bwd_dcdb: dC_i = sum_j dG_ij.B_j; dB_j = sum_i dG_ij^T.C_i + sum_h
    (w X_j).dS^T; dcums = the row-sum partials - X . ddtx, plus the g sums
    on the last row."""
    C, B, dtx, cums, dy, dS = (t.numpy().astype(np.float32) for t in
                               (C, B, dtx, cums, dy, dS))
    b, nc, q, n = C.shape
    h, p = dtx.shape[3], dtx.shape[4]
    bc = b * nc
    C, B = C.reshape(bc, q, n), B.reshape(bc, q, n)
    X, dY = dtx.reshape(bc, q, h, p), dy.reshape(bc, q, h, p)
    c, dS = cums.reshape(bc, q, h), dS.reshape(bc, h, n, p)
    nit = -(-q // br)
    tiles = [np.arange(t * br, min(q, (t + 1) * br)) for t in range(nit)]

    def decay(I, J, hh):          # masked before the exp, as the kernel
        on = I[:, None] >= J[None, :]
        d = c[:, I, hh][:, :, None] - c[:, J, hh][:, None, :]
        return np.exp(np.where(on, d, -np.inf)).astype(np.float32)

    Gs = np.zeros((bc, q, q), np.float32)
    dGs = np.zeros((bc, q, q), np.float32)
    rs = np.zeros((bc, nit, q, h), np.float32)
    for it, I in enumerate(tiles):                       # ssd_bwd_pair
        for jt, J in enumerate(tiles[:it + 1]):
            G = C[:, I] @ B[:, J].transpose(0, 2, 1)
            dg = np.zeros_like(G)
            for hh in range(h):
                dl = (dY[:, I, hh] @ X[:, J, hh].transpose(0, 2, 1)) \
                    * decay(I, J, hh)
                dg += dl
                rs[:, jt, I, hh] = (dl * G).sum(-1)
            Gs[:, I[:, None], J] = G
            dGs[:, I[:, None], J] = dg
    ddtx = np.zeros_like(X)
    dcol = np.zeros((bc, q, h), np.float32)
    gsum = np.zeros((bc, nit, h), np.float32)
    last = c[:, -1]
    for jt, J in enumerate(tiles):                       # ssd_bwd_dx
        for hh in range(h):
            acc = sum((Gs[:, I[:, None], J] * decay(I, J, hh))
                      .transpose(0, 2, 1) @ dY[:, I, hh]
                      for I in tiles[jt:])
            sacc = B[:, J] @ dS[:, hh]
            w = np.exp(last[:, None, hh] - c[:, J, hh])
            d = acc + w[..., None] * sacc
            ddtx[:, J, hh] = d
            dcol[:, J, hh] = (X[:, J, hh] * d).sum(-1)
            gsum[:, jt, hh] = (w * (X[:, J, hh] * sacc).sum(-1)).sum(-1)
    dC, dB = np.zeros_like(C), np.zeros_like(B)
    dcums = np.zeros_like(c)
    for t, T in enumerate(tiles):                        # ssd_bwd_dcdb
        dC[:, T] = sum(dGs[:, T[:, None], J] @ B[:, J] for J in tiles[:t + 1])
        dB[:, T] = sum(dGs[:, I[:, None], T].transpose(0, 2, 1) @ C[:, I]
                       for I in tiles[t:])
        for hh in range(h):
            w = np.exp(last[:, None, hh] - c[:, T, hh])
            dB[:, T] += (w[..., None] * X[:, T, hh]) @ dS[:, hh].transpose(
                0, 2, 1)
        dcums[:, T] = rs[:, :t + 1, T].sum(1) - dcol[:, T]
    dcums[:, -1] += gsum.sum(1)
    return tuple(torch.from_numpy(a) for a in (
        dC.reshape(b, nc, q, n), dB.reshape(b, nc, q, n),
        ddtx.reshape(b, nc, q, h, p), dcums.reshape(b, nc, q, h)))


@pytest.mark.parametrize("case", CASES)
def test_bwd_kernel_tile_walk(case):
    """The kernel's decomposition (its column part of dcums as X . ddtx,
    the last row's g sums, dG summed over heads before dC and dB) holds
    against the plain backward at the kernel's tolerance, strong decay
    included."""
    ins = _inputs(*case)
    _hold(_tile_walk(*ins), ssd_intra_bwd_ref(*ins))


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


def _plain_kernels(monkeypatch, seen=None):
    """The Function's two kernels replaced by their plain versions (the
    kernels need the card); `seen` records the C each one was given."""
    def fwd(C, B, dtx, cums):
        if seen is not None:
            seen["fwd"].append(C)
        return ssd_intra_ref(C, B, dtx, cums)

    def bwd(C, B, dtx, cums, dy, dS):
        if seen is not None:
            seen["bwd"].append(C)
        return ssd_intra_bwd_ref(C, B, dtx, cums, dy, dS)
    monkeypatch.setattr(ssd, "ssd_intra_cuda", fwd)
    monkeypatch.setattr(ssd, "ssd_intra_bwd_cuda", bwd)


@pytest.mark.parametrize("case", VJP_CASES)
def test_ssd_grads_match_jax_vjp(case, monkeypatch):
    """The gradients of x, dt, Bm, Cm, A_log and D (cotangents on y and
    the final state) through `_card_path` (SSDIntra with the plain
    kernels) and through `ssd_chunked` on the CPU (`ssd_ref` under
    autograd), against `jax.vjp` of the reference's `ssd_ref`: within
    1e-4 x max(1, max|ref|) per gradient."""
    ins, cot = _full_inputs(*case)
    chunk = case[5]
    want = _jax_vjp(chunk)(tuple(map(jnp.asarray, ins)),
                           tuple(map(jnp.asarray, cot)))
    want = [torch.from_numpy(np.array(w)) for w in want]
    _plain_kernels(monkeypatch)
    for fn in (_card_path, ssd_chunked):
        leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
        y, hf = fn(*leaves, chunk=chunk)
        got = torch.autograd.grad((y, hf), leaves,
                                  tuple(map(torch.from_numpy, cot)))
        _hold(got, want)


@pytest.mark.parametrize("remat", [False, True])
def test_ssd_function_plumbing(remat, monkeypatch):
    """SSDIntra saves C, B, dtx and cums and hands them to the backward
    kernel; under a non-reentrant checkpoint those are the recomputed
    forward's. The gradients equal autograd through `ssd_ref` within the
    kernel's tolerance."""
    seen = {"fwd": [], "bwd": []}
    _plain_kernels(monkeypatch, seen)
    ins, cot = _full_inputs(1, 64, 2, 8, 4, 32, 0.0)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]

    def run(*a):
        return _card_path(*a, chunk=32)
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
    reference form it differentiates, and takes the wrapper's limits."""
    src = ssd.BWD_SOURCE.read_text()
    assert "ssd_intra_pallas" in src and "ssd_ref" in src
    for name, want in (("MAXQ", ssd.MAX_CHUNK), ("MAXN", ssd.MAX_STATE),
                       ("MAXP", ssd.MAX_HEAD_DIM)):
        assert f"constexpr int {name} = {want};" in src
    assert "atomic" not in src.replace("no atomics", "")
