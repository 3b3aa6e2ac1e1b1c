"""The plain reference against the port's CPU path, and the K1 byte and
operation arithmetic on a hand-built graph."""
import numpy as np
import pytest
import torch

from flipbench import work
from flipbench.generators import road_grid
from flipbench.graph import csr_from_pairs
from flipbench.reference import Reference


@pytest.fixture(scope="module")
def road():
    return road_grid.generate({"n": 3000, "delete_frac": 0.56,
                               "max_weight": 8}, 1)


@pytest.mark.parametrize("program", ["sssp", "bfs"])
def test_reference_matches_the_ports_cpu_path(road, program):
    import flip_torch
    cq = flip_torch.compile(road.to_port(), program, device="cpu")
    srcs = [0, 17, 2999, 1500, 5, 6, 7, 8]
    r = cq.query(srcs)
    want, steps, _ = Reference(road, "cpu").run(program, srcs)
    np.testing.assert_array_equal(r.attrs, want.numpy())
    np.testing.assert_array_equal(r.steps, steps)
    solo = cq.query(1500)
    np.testing.assert_array_equal(solo.attrs, want[3].numpy())


def test_yardstick_counts_the_ports_fetched_blocks(road):
    """The reference's frontiers at tile 128 give, step by step, the
    blocks the port's trace counts as fetched."""
    import flip_torch
    srcs = [0, 17, 2999, 1500]
    cq = flip_torch.compile(road.to_port(), "sssp", device="cpu")
    tele = cq.query(srcs, trace=True).telemetry.dispatches[0]
    _, _, tiles = Reference(road, "cpu").run("sssp", srcs,
                                             record_tiles=True)
    per_tile = work.blocks_per_source_tile(road)
    assert per_tile.sum() == tele.n_blocks
    fetched = (tiles.any(dim=1).numpy() * per_tile).sum(axis=1)
    np.testing.assert_array_equal(fetched, tele.trace.blocks_fetched)


def test_k1_bytes_and_operations_by_hand():
    # 300 vertices, tile 128: tiles 0, 1, 2 (the last holds 44)
    g = csr_from_pairs(300, np.array([0, 5, 130, 260]),
                       np.array([200, 6, 10, 1]),
                       np.ones(4, np.float32), directed=True)
    per_tile = work.blocks_per_source_tile(g)
    # blocks (dst, src): (1,0) (0,0) (0,1) (0,2) + diagonals (1,1) (2,2)
    np.testing.assert_array_equal(per_tile, [2, 2, 2])
    tiles = np.zeros((2, 2, 3), dtype=bool)
    tiles[0, 0, 0] = True                   # step 0: query 0 in tile 0
    tiles[1, 0, 1] = tiles[1, 1, 1] = tiles[1, 1, 2] = True
    nbytes, ops, blocks = work.step_work(tiles, per_tile)
    assert blocks == 2 + 4                  # union: {0}, then {1, 2}
    state = 2 * 3 * 128 * 4                 # B x ntiles x T x 4
    index = (6 + 4) * 4                     # bsrc + dst_start
    assert nbytes == blocks * 128 * 128 * 4 + 2 * (3 * state + index)
    assert ops == (2 + 2 + 4) * 128 * 128 * 2   # per (query, block)
    assert work.bound_s(nbytes, ops) == nbytes / work.HBM_BYTES_PER_S


def test_reference_precision_and_truncation(road):
    ref = Reference(road, "cpu")
    srcs = [0, 2999]
    exact, steps, _ = ref.run("sssp", srcs)
    low, _, _ = ref.run("sssp", srcs, dtype=torch.bfloat16)
    assert exact[torch.isfinite(exact)].max() > 256
    assert int((low != exact).sum()) > 0
    cut, cut_steps, _ = ref.run("sssp", srcs, stop_before_end=2)
    np.testing.assert_array_equal(cut_steps, steps - 2)
    assert int((cut != exact).sum()) > 0
