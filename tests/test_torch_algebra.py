"""Port vs reference: semiring ops and vertex-algebra hooks.

The same numpy-seeded states go through the jnp ops of `repro.algebra`
and the torch ops of `repro_torch.algebra`, at d in {1, 8}, solo and
B = 3. Idempotent semirings must agree bit for bit; plus_times within
atol 1e-5 (summation order differs between XLA and PyTorch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import algebra as ra
from repro_torch import algebra as ta

SEMIRINGS = sorted(ta.SEMIRINGS)
ALGOS = sorted(ta.ALGEBRAS)
PLUS_TIMES_ATOL = 1e-5


def _values(sr, shape, rng, zero_frac=0.3):
    """Random f32 values with a share of ⊕-identities mixed in. (+, ×)
    states are masses in [0, 1), the scale pagerank and labelprop run
    at, so an fp32 summation-order difference stays far below atol."""
    if sr.name == "or_and":
        x = (rng.random(shape) < 0.5).astype(np.float32)
    elif sr.name == "plus_times":
        x = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    else:
        x = rng.uniform(0.5, 9.0, shape).astype(np.float32)
    return np.where(rng.random(shape) < zero_frac, np.float32(sr.zero),
                    x).astype(np.float32)


def _same(got, want, idempotent):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if idempotent:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=PLUS_TIMES_ATOL, rtol=0)


def test_registries_match():
    assert sorted(ta.SEMIRINGS) == sorted(ra.SEMIRINGS)
    assert sorted(ta.ALGEBRAS) == sorted(ra.ALGEBRAS)
    for name, a in ta.ALGEBRAS.items():
        r = ra.ALGEBRAS[name]
        for f in ("kind", "weight_rule", "undirected", "all_start", "sim_ok",
                  "tol", "damping", "atol", "feature_dim", "feature_init"):
            assert getattr(a, f) == getattr(r, f), (name, f)
        assert a.semiring.name == r.semiring.name


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_elementwise_and_reduce(name, d):
    t, r = ta.SEMIRINGS[name], ra.SEMIRINGS[name]
    assert (t.zero, t.one, t.idempotent) == (r.zero, r.one, r.idempotent)
    rng = np.random.default_rng(d)
    shape = (3, 5, 16) + ((d,) if d > 1 else ())
    a, b = _values(t, shape, rng), _values(t, shape, rng)
    ta_, tb = torch.from_numpy(a), torch.from_numpy(b)
    _same(t.add(ta_, tb), r.add_jnp(a, b), True)
    _same(t.mul(ta_, tb), r.mul_jnp(a, b), True)
    for axis in (-1, 1):
        _same(t.add_reduce(ta_, dim=axis), r.add_reduce_jnp(a, axis=axis),
              t.idempotent)


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_segment_reduce(name, d):
    t, r = ta.SEMIRINGS[name], ra.SEMIRINGS[name]
    rng = np.random.default_rng(10 + d)
    nseg = 5
    # every segment non-empty: the reference's segment_max leaves -inf in
    # an empty segment where the port leaves the ⊕-identity
    seg = np.concatenate([np.arange(nseg), rng.integers(0, nseg, 7)])
    seg = np.sort(seg).astype(np.int32)
    x = _values(t, (seg.size, 16) + ((d,) if d > 1 else ()), rng)
    got = t.segment_reduce(torch.from_numpy(x), torch.from_numpy(seg),
                           nseg, dim=0)
    _same(got, r.segment_reduce_jnp(x, seg, nseg), t.idempotent)
    # batched: segment along axis 1 of (B, k, T[, d])
    xb = np.stack([x, _values(t, x.shape, rng)])
    got = t.segment_reduce(torch.from_numpy(xb), torch.from_numpy(seg),
                           nseg, dim=1)
    want = np.stack([np.asarray(r.segment_reduce_jnp(xb[i], seg, nseg))
                     for i in range(2)])
    _same(got, want, t.idempotent)


@pytest.mark.parametrize("d", [1, 3, 8, 11])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_contract(name, d):
    t, r = ta.SEMIRINGS[name], ra.SEMIRINGS[name]
    rng = np.random.default_rng(20 + d)
    sv = _values(t, (3, 4, 16, d), rng)          # (B, k, S, d)
    w = _values(t, (4, 16, 16), rng, zero_frac=0.6)
    got = t.contract(torch.from_numpy(sv), torch.from_numpy(w))
    _same(got, r.contract_jnp(jnp.asarray(sv), jnp.asarray(w)),
          t.idempotent)


@pytest.mark.parametrize("name", SEMIRINGS)
def test_monotone_under(name):
    t, r = ta.SEMIRINGS[name], ra.SEMIRINGS[name]
    rng = np.random.default_rng(3)
    old = _values(t, (4, 8), rng)
    for new in (old, t.add_np(old, _values(t, (4, 8), rng)),
                _values(t, (4, 8), rng)):
        assert t.monotone_under(old, new) == r.monotone_under(old, new)


# vector programs run at their native width only
HOOK_CASES = [(a, d) for a in ALGOS for d in (1, 8)
              if ta.ALGEBRAS[a].feature_dim in (1, d)]


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("algo,d", HOOK_CASES)
def test_step_hooks(algo, d, batch):
    """scatter_carry / post_step / finalize equal the jnp hooks on
    random tiled states (any query axis, any feature width)."""
    t, r = ta.ALGEBRAS[algo], ra.ALGEBRAS[algo]
    features = d > 1
    rng = np.random.default_rng(HOOK_CASES.index((algo, d)) * 2 + batch)
    lead = (batch,) if batch else ()
    sshape = lead + (4, 16) + ((d,) if features else ())
    attrs = _values(t.semiring, sshape, rng)
    aux = rng.uniform(0, 1, sshape).astype(np.float32)
    frontier = rng.random(lead + (4, 16)) < 0.4
    new = t.semiring.add_np(attrs, _values(t.semiring, sshape, rng))
    tt = [torch.from_numpy(x) for x in (attrs, aux, frontier, new)]
    for op_mode in (False, True):
        got = t.scatter_carry(tt[0], tt[2], op_mode, features=features)
        want = r.scatter_carry_jnp(attrs, frontier, op_mode,
                                   features=features)
        for g_, w_ in zip(got, want):
            _same(g_, w_, True)
    sv = torch.where(tt[2][..., None] if features else tt[2], tt[0],
                     t.semiring.zero)
    got = t.post_step(tt[0], tt[1], sv, tt[3], features=features)
    want = r.post_step_jnp(attrs, aux, sv.numpy(), new, features=features)
    for g_, w_ in zip(got, want):
        _same(g_, w_, True)
    _same(t.finalize(tt[0], tt[1]), r.finalize(attrs, aux), True)


@pytest.mark.parametrize("algo", ALGOS)
def test_numpy_parts_equal(algo):
    """edge_values, initial_attrs/frontier, landmarks, results_match are
    carried over verbatim."""
    t, r = ta.ALGEBRAS[algo], ra.ALGEBRAS[algo]
    rng = np.random.default_rng(7)
    u, v = rng.integers(0, 50, 40), rng.integers(0, 50, 40)
    w = rng.uniform(1, 8, 40).astype(np.float32)
    deg = rng.integers(1, 5, 50)
    np.testing.assert_array_equal(t.edge_values(u, v, w, deg),
                                  r.edge_values(u, v, w, deg))
    for src in (4, [4, 9, 0]):
        np.testing.assert_array_equal(t.initial_attrs(50, src),
                                      r.initial_attrs(50, src))
        np.testing.assert_array_equal(t.initial_frontier(50, src),
                                      r.initial_frontier(50, src))
    np.testing.assert_array_equal(ta.landmarks(50, [3, 7], 8),
                                  ra.landmarks(50, [3, 7], 8))
    a = t.initial_attrs(50, 4)
    assert t.results_match(a, a) and r.results_match(a, a)
    assert t.results_match(a + 1.0, a) == r.results_match(a + 1.0, a)
