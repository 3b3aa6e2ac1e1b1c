"""Port vs reference: the blocked graph and one frontier relax step.

`build_blocks` must give array-equal layouts, and one step of the plain
PyTorch version, fed the reference's own block arrays through
`blocked_graph_from_numpy`, must equal `_relax_jnp`, `_relax_jnp_compact`
and `frontier_relax_pallas(interpret=True)`: bit for bit for the
idempotent semirings, within atol 1e-5 for plus_times. The CUDA kernel
itself runs only on the card and is held against the same plain version
there by chip_smoke.py; here its wrapper's CPU-side contract is tested.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algebra import ALGEBRAS as REF_ALGEBRAS
from repro.graphs import make_road_network, make_synthetic
from repro.kernels.frontier import build_blocks as ref_build_blocks
from repro.kernels.frontier.frontier import frontier_relax_pallas
from repro.kernels.frontier.ops import (_relax_jnp, _relax_jnp_compact,
                                        compact_block_stream)
from repro.kernels.frontier.ops import tile_activity as ref_tile_activity
from repro.kernels.frontier.ref import relax_step_ref as ref_relax_step_ref
from repro_torch.algebra import ALGEBRAS, MIN_PLUS
from repro_torch.graphs import make_synthetic as port_make_synthetic
from repro_torch.kernels import _build
from repro_torch.kernels.frontier import frontier as kernel
from repro_torch.kernels.frontier.ops import (blocked_graph_from_numpy,
                                              build_blocks, frontier_relax,
                                              frontier_relax_torch,
                                              tile_activity)
from repro_torch.kernels.frontier.ref import relax_step_ref

PLUS_TIMES_ATOL = 1e-5
# one algebra per semiring: its blocks carry that semiring's weights
SEMIRING_ALGOS = {"min_plus": "sssp", "max_min": "widest",
                  "or_and": "reach", "plus_times": "pagerank"}


def carried(bg_ref, algo):
    """The port's BlockedGraph built from the reference's arrays."""
    arrays = {k: np.asarray(getattr(bg_ref, k))
              for k in ("blocks", "bsrc", "bdst", "perm", "inv_perm")}
    arrays.update(n=bg_ref.n, tile=bg_ref.tile)
    return blocked_graph_from_numpy(arrays, ALGEBRAS[algo], "cpu")


def make_state(bg, batch, d, rng, inactive_tile=True):
    """(src_vals, carry) as numpy: random carry (masses in [0, 1) for
    (+, ×)), src_vals frontier-masked to ~40% of lanes with source tile 1
    wholly inactive, so compaction has blocks to drop."""
    sr = bg.semiring
    shape = ((batch,) if batch else ()) + (bg.ntiles, bg.tile) + \
        ((d,) if d > 1 else ())
    if sr.name == "or_and":
        carry = (rng.random(shape) < 0.5).astype(np.float32)
    elif sr.name == "plus_times":
        carry = rng.uniform(0, 1, shape).astype(np.float32)
    else:
        carry = rng.uniform(0.5, 9, shape).astype(np.float32)
    mask = rng.random(shape) < 0.4
    if inactive_tile:
        if d > 1:
            mask[..., 1, :, :] = False
        else:
            mask[..., 1, :] = False
    sv = np.where(mask, carry, np.float32(sr.zero)).astype(np.float32)
    return sv, carry


def assert_same(got, want, idempotent):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if idempotent:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=PLUS_TIMES_ATOL, rtol=0)


# ------------------------------------------------------------------ #
# (c) the blocked layout
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("tile", [16, 32, 128])
@pytest.mark.parametrize("algo", sorted(ALGEBRAS))
def test_build_blocks_array_equal(algo, tile):
    g = make_synthetic(200, 600, seed=2)
    gp = port_make_synthetic(200, 600, seed=2)
    order = np.random.default_rng(tile).permutation(g.n)
    for o in (None, order):
        ref = ref_build_blocks(g, algo, tile=tile, order=o)
        got = build_blocks(gp, algo, tile=tile, order=o, device="cpu")
        assert (got.n, got.tile, got.ntiles) == (ref.n, ref.tile,
                                                 ref.ntiles)
        np.testing.assert_array_equal(got.blocks.numpy(),
                                      np.asarray(ref.blocks))
        np.testing.assert_array_equal(got.bsrc.numpy(), np.asarray(ref.bsrc))
        np.testing.assert_array_equal(got.bdst.numpy(), np.asarray(ref.bdst))
        np.testing.assert_array_equal(got.perm, ref.perm)
        np.testing.assert_array_equal(got.inv_perm, ref.inv_perm)
        np.testing.assert_array_equal(got.dst_start.numpy(), ref.dst_start)
        assert got.bsrc.dtype == torch.int32 and got.blocks.dtype == \
            torch.float32


@pytest.mark.parametrize("algo", sorted(ALGEBRAS))
def test_to_tiled_round_trip_ragged_n(algo):
    """37 = 2 * 16 + 5 vertices: to_tiled/to_orig equal the reference's,
    padded lanes hold the ⊕-identity."""
    g = make_synthetic(37, 100, seed=8)
    ref = ref_build_blocks(g, algo, tile=16)
    bg = carried(ref, algo)
    rng = np.random.default_rng(1)
    for shape, features in (((37,), False), ((5, 37), False),
                            ((37, 8), True), ((3, 37, 8), True)):
        x = rng.uniform(0.5, 9, shape).astype(np.float32)
        tiled = bg.to_tiled(x, features=features)
        np.testing.assert_array_equal(
            tiled.numpy(), np.asarray(ref.to_tiled(x, features=features)))
        np.testing.assert_array_equal(bg.to_orig(tiled, features=features),
                                      x)


@pytest.mark.parametrize("batch", [0, 8])
@pytest.mark.parametrize("name", sorted(SEMIRING_ALGOS))
def test_tile_activity_matches(name, batch):
    algo = SEMIRING_ALGOS[name]
    g = make_road_network(40, seed=3, delete_frac=0.5)
    ref = ref_build_blocks(g, algo, tile=16)
    bg = carried(ref, algo)
    sv, _ = make_state(bg, batch, 1, np.random.default_rng(batch))
    np.testing.assert_array_equal(
        tile_activity(torch.from_numpy(sv), bg.semiring).numpy(),
        np.asarray(ref_tile_activity(jnp.asarray(sv), ref.semiring)))


# ------------------------------------------------------------------ #
# (d) one relax step against every reference form
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("batch", [0, 8])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("name", sorted(SEMIRING_ALGOS))
def test_relax_step_matches_reference(name, compact, batch, d):
    algo = SEMIRING_ALGOS[name]
    g = make_road_network(40, seed=3, delete_frac=0.5)   # 40 = 2*16 + 8
    ref = ref_build_blocks(g, algo, tile=16)
    bg = carried(ref, algo)
    sr, rsr = bg.semiring, ref.semiring
    rng = np.random.default_rng(zlib.crc32(f"{name}{compact}{batch}{d}"
                                           .encode()))
    sv, carry = make_state(bg, batch, d, rng)
    features = d > 1
    got = frontier_relax_torch(torch.from_numpy(sv), torch.from_numpy(carry),
                               bg.blocks, bg.bsrc, bg.bdst, sr,
                               feature_dim=d, compact=compact)
    # the dispatcher takes the same route for CPU tensors
    via = frontier_relax(torch.from_numpy(sv), torch.from_numpy(carry), bg,
                         mode="auto", compact=compact, feature_dim=d)
    assert torch.equal(got, via)
    jsv, jcarry = jnp.asarray(sv), jnp.asarray(carry)
    if compact:
        bsel, bsrc_c, bdst_c, _ = compact_block_stream(
            ref_tile_activity(jsv, rsr, features), ref.bsrc, ref.bdst)
        want_jnp = _relax_jnp_compact(jsv, jcarry, ref.blocks_ext, ref.bsrc,
                                      ref.bdst, bsel, semiring=rsr,
                                      features=features)
        want_pallas = frontier_relax_pallas(
            jsv, jcarry, ref.blocks_ext, bsrc_c, bdst_c, semiring=rsr,
            interpret=True, bsel=bsel, feature_dim=d)
    else:
        want_jnp = _relax_jnp(jsv, jcarry, ref.blocks, ref.bsrc, ref.bdst,
                              semiring=rsr, features=features)
        want_pallas = frontier_relax_pallas(
            jsv, jcarry, ref.blocks, ref.bsrc, ref.bdst, semiring=rsr,
            interpret=True, feature_dim=d)
    assert_same(got, want_jnp, sr.idempotent)
    assert_same(got, want_pallas, sr.idempotent)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_destination_without_block_keeps_carry(compact, batched):
    """A destination tile no block writes returns its carry verbatim
    (the reference's carry->out alias; the kernel's carry ⊕ identity)."""
    t, ntiles = 8, 3
    rng = np.random.default_rng(0)
    blocks = rng.uniform(1, 5, (1, t, t)).astype(np.float32)
    arrays = dict(blocks=blocks, bsrc=[2], bdst=[0], perm=np.arange(24),
                  inv_perm=np.arange(24), n=24, tile=t)
    bg = blocked_graph_from_numpy(arrays, ALGEBRAS["sssp"], "cpu")
    np.testing.assert_array_equal(bg.dst_start.numpy(), [0, 1, 1, 1])
    sv = rng.uniform(0, 10, (ntiles, t)).astype(np.float32)
    carry = rng.uniform(0, 10, (ntiles, t)).astype(np.float32)
    if batched:
        sv, carry = np.stack([sv, sv + 1.0]), np.stack([carry, carry + 1.0])
    got = frontier_relax_torch(torch.from_numpy(sv), torch.from_numpy(carry),
                               bg.blocks, bg.bsrc, bg.bdst, MIN_PLUS,
                               compact=compact).numpy()
    np.testing.assert_array_equal(got[..., 1:, :], carry[..., 1:, :])
    from repro.algebra import MIN_PLUS as REF_MIN_PLUS
    want = frontier_relax_pallas(jnp.asarray(sv), jnp.asarray(carry),
                                 jnp.asarray(blocks), jnp.asarray([2]),
                                 jnp.asarray([0]), semiring=REF_MIN_PLUS,
                                 interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("batch", [0, 8])
@pytest.mark.parametrize("name", sorted(SEMIRING_ALGOS))
def test_all_inactive_step_returns_carry(name, batch):
    algo = SEMIRING_ALGOS[name]
    g = make_road_network(40, seed=3, delete_frac=0.5)
    bg = carried(ref_build_blocks(g, algo, tile=16), algo)
    _, carry = make_state(bg, batch, 1, np.random.default_rng(5))
    sv = np.full_like(carry, np.float32(bg.semiring.zero))
    for compact in (False, True):
        got = frontier_relax_torch(torch.from_numpy(sv),
                                   torch.from_numpy(carry), bg.blocks,
                                   bg.bsrc, bg.bdst, bg.semiring,
                                   compact=compact)
        np.testing.assert_array_equal(got.numpy(), carry)


def test_plain_version_chunks_blocks(monkeypatch):
    """A chunk bound of one block gives the same answer as one chunk."""
    from repro_torch.kernels.frontier import ops
    g = make_road_network(90, seed=1, delete_frac=0.6)
    bg = carried(ref_build_blocks(g, "sssp", tile=16), "sssp")
    sv, carry = make_state(bg, 3, 1, np.random.default_rng(2))
    args = (torch.from_numpy(sv), torch.from_numpy(carry), bg.blocks,
            bg.bsrc, bg.bdst, bg.semiring)
    whole = frontier_relax_torch(*args)
    monkeypatch.setattr(ops, "_CHUNK_BYTES", 1)
    assert torch.equal(frontier_relax_torch(*args), whole)


def test_single_step_against_dense_oracles():
    g = make_synthetic(60, 180, seed=5)
    bg = carried(ref_build_blocks(g, "sssp", tile=16), "sssp")
    rng = np.random.default_rng(0)
    attrs0 = rng.uniform(0, 10, g.n).astype(np.float32)
    fr0 = rng.random(g.n) < 0.3
    w = g.dense_weights()
    want, want_fr = ref_relax_step_ref(jnp.asarray(attrs0), jnp.asarray(fr0),
                                       jnp.asarray(w))
    got, got_fr = relax_step_ref(torch.from_numpy(attrs0),
                                 torch.from_numpy(fr0), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_fr.numpy(), np.asarray(want_fr))
    attrs = bg.to_tiled(attrs0)
    fr = np.zeros(bg.padded_n, bool)
    fr[bg.perm[fr0.nonzero()[0]]] = True
    sv = torch.where(torch.from_numpy(fr.reshape(bg.ntiles, bg.tile)),
                     attrs, torch.inf)
    out = frontier_relax(sv, attrs, bg)
    np.testing.assert_allclose(bg.to_orig(out), np.asarray(want), atol=1e-5)


# ------------------------------------------------------------------ #
# (g) the CUDA route's CPU-side contract
# ------------------------------------------------------------------ #
def _small_bg():
    g = make_road_network(40, seed=3, delete_frac=0.5)
    return carried(ref_build_blocks(g, "sssp", tile=16), "sssp")


def test_cuda_mode_on_cpu_tensors_raises():
    bg = _small_bg()
    x = bg.to_tiled(np.zeros(bg.n, np.float32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        frontier_relax(x, x, bg, mode="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.frontier_relax_cuda(x, x, bg.blocks, bg.bsrc, bg.dst_start,
                                   bg.semiring)
    assert kernel.frontier_relax_cuda.launches == 0
    with pytest.raises(ValueError, match="relax mode"):
        frontier_relax(x, x, bg, mode="pallas")


def test_kernel_build_recipe():
    """sm_90a, no fast math (min/max must stay bit-equal), the library
    keyed on the source, nothing built at import time."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-O3" in flags
    assert kernel.SOURCE.exists()
    path = _build.library_path(kernel.SOURCE)
    assert path.name.startswith("frontier_relax-")
    assert path.name.endswith(".so")
    assert path.parent == kernel.SOURCE.parent.parent / "build"
    assert _build.library_path(kernel.SOURCE) == path
    assert set(kernel.SEMIRING_IDS) == set(REF_ALGEBRAS[a].semiring.name
                                          for a in SEMIRING_ALGOS.values())
    src = kernel.SOURCE.read_text()
    assert "frontier_relax_pallas" in src          # names what it replaces
    for name, code in kernel.SEMIRING_IDS.items():
        assert f"= {code}" in src.split("enum Op")[1].split("}")[0]


# ------------------------------------------------------------------ #
# NaN propagates as in the reference (torch/jnp minimum and maximum)
# ------------------------------------------------------------------ #
NAN_EDGES = [(0, 1), (1, 2), (2, 3), (0, 4), (4, 3), (3, 5)]
NAN_WEIGHTS = [1, float("nan"), 1, 5, 1, 1]


def assert_equal_nan(got, want):
    """Equal NaN masks, and equal values everywhere else."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)],
                                  want[~np.isnan(want)])


@pytest.mark.parametrize("algo", ["sssp", "widest"])
def test_nan_weight_propagates_like_reference(algo):
    """A NaN weight on 1 -> 2: one relax step of the plain version and a
    whole query agree with the reference, NaN positions included. The
    kernel's ⊕/⊗ are `min.NaN`/`max.NaN`, never fminf/fmaxf, so it
    propagates NaN the same way on the card (held there by
    chip_smoke.py)."""
    import flip
    import flip_torch
    from repro.graphs import Graph as RefGraph
    from repro_torch.graphs import Graph
    with np.errstate(invalid="ignore"):
        gr = RefGraph.from_edges(6, NAN_EDGES, NAN_WEIGHTS)
        g = Graph.from_edges(6, NAN_EDGES, NAN_WEIGHTS)
        ref = ref_build_blocks(gr, algo, tile=8)
        bg = carried(ref, algo)
        for srcs in (0, [0, 3]):
            want = flip.compile(gr, algo).query(srcs)
            got = flip_torch.compile(g, algo, device="cpu").query(srcs)
            assert_equal_nan(got.attrs, want.attrs)
            np.testing.assert_array_equal(got.steps, want.steps)
            assert np.isnan(np.asarray(got.attrs)[..., 2]).all()
        alg = ALGEBRAS[algo]
        attrs = bg.to_tiled(alg.initial_attrs(6, 0))
        front = bg.to_tiled(alg.initial_frontier(6, 0).astype(np.float32),
                            fill=0.0) > 0
        sv, carry = alg.scatter_carry(attrs, front, False)
        for compact in (False, True):
            one = frontier_relax_torch(sv, carry, bg.blocks, bg.bsrc,
                                       bg.bdst, bg.semiring,
                                       compact=compact)
            want = _relax_jnp(jnp.asarray(sv.numpy()),
                              jnp.asarray(carry.numpy()), ref.blocks,
                              ref.bsrc, ref.bdst, semiring=ref.semiring)
            assert_equal_nan(one.numpy(), want)
            assert bool(torch.isnan(one).any())
    src = kernel.SOURCE.read_text()
    ops = src.split("template <> struct Semiring<kMinPlus>")[1] \
        .split("template <> struct Semiring<kPlusTimes>")[0]
    assert "min_nan" in ops and "max_nan" in ops
    assert "fminf" not in ops and "fmaxf" not in ops
    assert "min.NaN.f32" in src and "max.NaN.f32" in src


# ------------------------------------------------------------------ #
# (h) the kernel's launch plan and its activity pre-pass, on the CPU
# ------------------------------------------------------------------ #
# (name, T, d, B, blocks, destination tiles): g500-s16 (257,054 blocks
# of 128 over 512 tiles), road-ny (12,476 over 2,066), the tuner's other
# tiles, the tests' small tiles, d = 8, and the 8-lane layout of a
# destination no block writes
PLAN_SHAPES = [
    ("g500", 128, 1, 8, 257_054, 512),
    ("g500-b1", 128, 1, 1, 257_054, 512),
    ("road-ny", 128, 1, 8, 12_476, 2_066),
    ("road-ny-b1", 128, 1, 1, 12_476, 2_066),
    ("road-ny-d8", 128, 8, 8, 12_476, 2_066),
    ("deep-t64", 64, 1, 8, 409_600, 1_024),
    ("deep-t256", 256, 1, 8, 12_800, 128),
    ("road-t256", 256, 1, 1, 3_125, 521),
    ("t16", 16, 1, 8, 100, 20),
    ("t32-d8", 32, 8, 8, 100, 20),
    ("t256-d8", 256, 8, 8, 3_000, 100),
    ("t8", 8, 1, 2, 1, 3),
    ("b11-d12", 128, 12, 11, 6_000, 100),
]


def _segments(nb, ntiles, rng):
    """dst_start of `nb` blocks over `ntiles` tiles, some of them empty."""
    cuts = np.sort(rng.integers(0, nb + 1, ntiles - 1))
    return np.concatenate([[0], cuts, [nb]])


@pytest.mark.parametrize("name,tile,d,b,nb,ntiles", PLAN_SHAPES,
                         ids=[s[0] for s in PLAN_SHAPES])
def test_launch_plan_fits_and_covers(name, tile, d, b, nb, ntiles):
    """Shared memory within a block's 232,448 B (and the plan's blocks
    within an SM's), whole 16-byte rows of one block a stage, every
    block of a segment in exactly one part, and exactly one combine a
    destination tile."""
    plan = kernel.launch_plan(tile, d, b, nb, ntiles)
    fd = plan.feature_slab
    assert plan.smem <= kernel.MAX_SMEM == 232_448
    assert plan.smem == kernel.layout_bytes(tile, fd, plan.lanes,
                                            plan.consumers, plan.rows,
                                            plan.stages)
    assert plan.blocks_per_sm * (plan.smem + kernel.CTA_RESERVED) \
        <= kernel.SM_SHARED
    assert plan.stages >= 2 and 1 <= plan.rows <= tile
    assert 4 * plan.rows * tile <= kernel.STAGE_BYTES       # never a block
    assert (4 * plan.rows * tile) % 16 == 0                 # bulk copies
    assert (4 * plan.rows * kernel.QUERY_CHUNK * fd) % 16 == 0
    assert plan.consumers % 32 == 0
    assert plan.consumers + 32 <= (544 if d == 1 else 288)  # launch bounds
    assert plan.groups == plan.consumers // (tile // plan.lanes) >= 1
    chunks = -(-b // kernel.QUERY_CHUNK) * -(-d // fd)
    assert plan.items == ntiles * plan.split * chunks
    assert plan.grid == min(plan.items, kernel.SMS * plan.blocks_per_sm)
    assert kernel.scratch_bytes(plan, b, ntiles, ntiles, tile, d) >= \
        4 * chunks * ntiles * tile * kernel.QUERY_CHUNK * fd
    rng = np.random.default_rng(len(name))
    ds = _segments(nb, ntiles, rng)
    seen = np.zeros(nb, dtype=int)
    done = np.zeros(ntiles, dtype=int)
    combines = np.zeros(ntiles, dtype=int)
    order = [(t, p) for t in range(ntiles) for p in range(plan.split)]
    for k in rng.permutation(len(order)):                 # any finish order
        t, p = order[k]
        lo, hi = kernel.part_bounds(int(ds[t]), int(ds[t + 1]), p,
                                    plan.split)
        assert ds[t] <= lo <= hi <= ds[t + 1]
        seen[lo:hi] += 1
        combines[t] += done[t] == plan.split - 1           # the last part
        done[t] += 1
    assert (seen == 1).all()
    assert (combines == 1).all()


def test_launch_plan_per_shape():
    """g500's dense steps: one deep-ring block an SM with 64 KiB or more
    of weights in flight beside the stage being relaxed, segments split;
    road-ny's short segments: whole, several blocks an SM."""
    g500 = kernel.launch_plan(128, 1, 8, 257_054, 512)
    assert g500.blocks_per_sm == 1 and g500.split > 1
    assert (g500.stages - 1) * 4 * g500.rows * 128 >= 64 * 1024
    assert g500.grid == kernel.SMS
    for b in (1, 8):
        road = kernel.launch_plan(128, 1, b, 12_476, 2_066)
        assert road.split == 1 and road.blocks_per_sm >= 2
        assert road.grid == kernel.SMS * road.blocks_per_sm
    assert kernel.launch_plan(128, 1, 1, 12_476, 2_066).blocks_per_sm == 4


@pytest.mark.parametrize("tile,d", [(6, 1), (130, 1), (2052, 1), (1024, 8),
                                    (260, 8)])
def test_launch_plan_refuses(tile, d):
    with pytest.raises(ValueError, match="frontier_relax_cuda"):
        kernel.launch_plan(tile, d, 8, 100, 10)


@pytest.mark.parametrize("d", [1, 8, 12])
@pytest.mark.parametrize("batch", [0, 1, 8, 11])
@pytest.mark.parametrize("name", sorted(SEMIRING_ALGOS))
def test_activity_mask_matches_tile_activity(name, batch, d):
    """The pre-pass's plain twin: bit q of a (query chunk, feature slab)
    word is the reference's `tile_activity` of query q alone over the
    slab's features, NaN counting as active; the bits of all words
    together give `tile_activity` of the whole state."""
    algo = SEMIRING_ALGOS[name]
    g = make_road_network(40, seed=3, delete_frac=0.5)
    ref = ref_build_blocks(g, algo, tile=16)
    bg = carried(ref, algo)
    sv, _ = make_state(bg, batch, d, np.random.default_rng(batch + d))
    q_nan = max(batch, 1) - 1                      # last query, tile 0
    sv_t = torch.from_numpy(sv)
    flat = sv_t if batch else sv_t[None]
    flat[q_nan, 0, 0] = float("nan")
    words = kernel.activity_mask(sv_t, bg.semiring, feature_dim=d).numpy()
    b = max(batch, 1)
    fd = kernel.FEATURE_SLAB if d > 1 else 1
    nfc = -(-d // fd)
    assert words.shape == (-(-b // 8) * nfc, bg.ntiles)
    for q in range(b):
        for fc in range(nfc):
            x = flat[q].numpy()
            if d > 1:
                x = x[..., fc * fd:(fc + 1) * fd]
            want = np.asarray(ref_tile_activity(jnp.asarray(x),
                                                ref.semiring,
                                                features=d > 1))
            got = (words[(q // 8) * nfc + fc] >> (q % 8)) & 1
            np.testing.assert_array_equal(got.astype(bool), want)
    assert (words[(q_nan // 8) * nfc, 0] >> (q_nan % 8)) & 1
    union = np.bitwise_or.reduce(words, axis=0) != 0
    np.testing.assert_array_equal(
        union, tile_activity(sv_t, bg.semiring, features=d > 1).numpy())
