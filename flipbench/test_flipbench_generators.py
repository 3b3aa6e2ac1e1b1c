"""The generators' copies: the road generator gives the port's graph for
the same seed; the Kronecker generator gives Graph500's counts."""
import numpy as np
import pytest

from flipbench.generators import kronecker, road_grid
from repro_torch.graphs.generators import make_road_network


@pytest.mark.parametrize("n,seed,delete_frac", [
    (64, 5, 0.70), (777, 2**31 + 11, 0.35), (1000, 0, 0.56),
    (4097, 3, 0.56)])
def test_road_grid_is_the_ports_generator(n, seed, delete_frac):
    got = road_grid.generate({"n": n, "delete_frac": delete_frac,
                              "max_weight": 8}, seed)
    want = make_road_network(n, seed=seed, delete_frac=delete_frac)
    assert got.directed == want.directed is False
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.weights, want.weights)


def test_kronecker_counts():
    scale, ef = 10, 16
    cfg = {"scale": scale, "edgefactor": ef, "A": 0.57, "B": 0.19,
           "C": 0.19}
    rng = np.random.default_rng(7)
    ii, jj = kronecker.kronecker_edges(scale, ef, 0.57, 0.19, 0.19, rng)
    assert len(ii) == ef << scale
    assert ii.min() >= 0 and max(ii.max(), jj.max()) < 1 << scale
    g = kronecker.generate(cfg, 7)
    u, v = g.sources(), g.indices.astype(np.int64)
    assert g.n == 1 << scale and not g.directed
    assert not np.any(u == v)                                # no loops
    key = u * g.n + v
    assert np.unique(key).size == key.size                   # no repeats
    rev = np.sort(v * g.n + u)
    np.testing.assert_array_equal(np.sort(key), rev)         # symmetric
    pair_w = dict(zip(key.tolist(), g.weights.tolist()))
    assert all(pair_w[a * g.n + b] == w
               for a, b, w in zip(u[:500], v[:500], g.weights[:500]))
    deg = g.degree()
    assert deg.sum() == g.m and g.m % 2 == 0
    assert g.m // 2 <= ef << scale
    # a power law: a few hubs, many isolated vertices
    assert deg.max() > 20 * deg.mean()
    assert 0 < (deg == 0).sum() < g.n // 2
    assert 0.0 < g.weights.min() and g.weights.max() <= 1.0


def test_kronecker_same_seed_same_graph():
    cfg = {"scale": 8, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19}
    a, b = kronecker.generate(cfg, 3), kronecker.generate(cfg, 3)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.weights, b.weights)
    c = kronecker.generate(cfg, 4)
    assert not np.array_equal(a.indptr, c.indptr)
