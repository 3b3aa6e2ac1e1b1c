"""Port vs reference: graph generators and numpy oracles.

`repro_torch.graphs` keeps its own copies of the reference's numpy
modules; these tests hold each copy to the original on the same seeds:
every Table-4 group at two seeds gives array-equal graphs, and every
oracle gives an equal result on the small groups.
"""
import numpy as np
import pytest

from repro.graphs import generators as gen_ref
from repro.graphs import reference as ref_ref
from repro_torch.graphs import generators as gen_port
from repro_torch.graphs import reference as ref_port

GROUPS = ["Tree", "SRN", "LRN", "Syn", "ExtLRN"]
SMALL_GROUPS = ["Tree", "SRN", "LRN", "Syn"]
SEEDS = [0, 1]


def _assert_same_graph(a, b):
    assert a.n == b.n and a.directed == b.directed
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert a.fingerprint() == b.fingerprint()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("group", GROUPS)
def test_generators_give_equal_graphs(group, seed):
    a = next(gen_port.make_dataset(group, 1, seed0=seed))
    b = next(gen_ref.make_dataset(group, 1, seed0=seed))
    _assert_same_graph(a, b)


def test_power_law_generator_equal():
    _assert_same_graph(gen_port.make_power_law(120, 360, seed=4),
                       gen_ref.make_power_law(120, 360, seed=4))


@pytest.mark.parametrize("algo", sorted(ref_ref.ORACLES))
@pytest.mark.parametrize("group", SMALL_GROUPS)
def test_oracles_equal(algo, group):
    for seed in SEEDS:
        g = next(gen_port.make_dataset(group, 1, seed0=seed))
        gr = next(gen_ref.make_dataset(group, 1, seed0=seed))
        src = seed % g.n
        got, stats = ref_port.run(algo, g, src)
        want, want_stats = ref_ref.run(algo, gr, src)
        np.testing.assert_array_equal(got, want)
        assert stats == want_stats


def test_oracle_registry_matches():
    assert sorted(ref_port.ORACLES) == sorted(ref_ref.ORACLES)


def test_graph_updates_equal():
    g = gen_port.make_road_network(60, seed=2)
    gr = gen_ref.make_road_network(60, seed=2)
    upd = [(0, 5, 0.5), (1, 40, 2.0), (3, 4, None)]
    _assert_same_graph(g.apply_updates(upd), gr.apply_updates(upd))
