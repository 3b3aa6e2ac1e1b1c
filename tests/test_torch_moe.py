"""The port's MoE (granite-moe-3b-a800m's SMOKE config, f32) held against
the reference on the CPU.

  * `moe.apply` against the reference's `moe.apply` with no mesh, at a
    shape where capacity binds (a skewed router) and one where it does
    not: outputs and aux at f32 atol 1e-4, rtol 1e-4 (tests/
    test_torch_models.py's tolerance: outputs of ~10 differ by the
    products' summation order), and the same (token, choice) pairs
    dropped;
  * the top-k order on tied logits against `jax.lax.top_k`;
  * `moe_ep.moe_all_to_all` over gloo at world 2 and 4 (one spawn per
    world size): against the port's one-group `moe.apply` on each rank's
    token slab (the same capacity per group, so it holds with drops),
    and against the reference's single-device output at a shape where no
    rank drops (asserted);
  * `place_experts` gives the reference's permutation (effort 0: the
    beam search, no annealing, to keep the test short).

The LM's prefill, decode and prefill = decode replay for granite run
in tests/test_torch_models.py with the other architectures.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import configs as ref_configs
from repro.core.placement import expert_affinity as ref_affinity
from repro.core.placement import place_experts as ref_place
from repro.models import moe as ref_moe
from repro.models.layers import init_tree
from repro_torch import configs
from repro_torch.core.placement import expert_affinity, place_experts
from repro_torch.models import moe

ARCH = "granite_moe_3b_a800m"
TOL = dict(atol=1e-4, rtol=1e-4)
WORLDS = (2, 4)
TIMEOUT_S = 120


def _params(skew: float = 0.0) -> dict:
    """The reference's initial MoE leaves as numpy; `skew` is added to
    expert 0's router column so that its capacity binds."""
    cfg = ref_configs.get_smoke(ARCH)
    p = init_tree(jax.random.PRNGKey(0), ref_moe.decls(cfg), jnp.float32)
    p = {k: np.array(v) for k, v in p.items()}
    p["router"][:, 0] += skew
    return p


def _x(shape, seed: int) -> np.ndarray:
    cfg = configs.get_smoke(ARCH)
    return np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)


def _ref_dropped(p, x) -> np.ndarray:
    """The reference's kept mask of one group's (token, choice) pairs."""
    cfg = ref_configs.get_smoke(ARCH)
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits = (xt @ jnp.asarray(p["router"])).astype(jnp.float32)
    w, ids = ref_moe._top_k(logits, cfg.top_k)
    cap = ref_moe._capacity(xt.shape[0], cfg.num_experts, cfg.top_k,
                            cfg.capacity_factor)
    _, (_, _, keep, _) = ref_moe._group_dispatch(
        xt, w, ids, None, cap, cfg.num_experts, cfg.top_k)
    return ~np.asarray(keep)


def _port_dropped(p, x) -> np.ndarray:
    cfg = configs.get_smoke(ARCH)
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    _, _, ids = moe.route(xt, torch.from_numpy(p["router"]), cfg.top_k)
    cap = moe._capacity(xt.shape[0], cfg.num_experts, cfg.top_k,
                        cfg.capacity_factor)
    return ~moe.dispatch_buffer(xt, ids, cap, cfg.num_experts)[2].numpy()


@pytest.mark.parametrize("skew", [3.0, 0.0], ids=["binds", "free"])
def test_apply_matches_reference(skew):
    p = _params(skew)
    x = _x((4, 16), seed=1)
    cfg, rcfg = configs.get_smoke(ARCH), ref_configs.get_smoke(ARCH)
    want, want_aux = ref_moe.apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), rcfg)
    got, aux = moe.apply({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    dropped = _port_dropped(p, x)
    np.testing.assert_array_equal(dropped, _ref_dropped(p, x))
    assert dropped.any() == (skew > 0)


@pytest.mark.parametrize("dtype", ["ints", "bfloat16"])
def test_top_k_order_on_ties_matches_jax(dtype):
    """Tied logits: the order of a token's k ids (which decides its
    capacity slots) is `jax.lax.top_k`'s, value descending and lower id
    first among equals."""
    rng = np.random.default_rng(2)
    if dtype == "ints":
        logits = rng.integers(0, 3, (256, 40)).astype(np.float32)
    else:   # bf16 router logits, upcast as the router does
        logits = np.array(jnp.asarray(rng.normal(size=(256, 40)) * 0.05,
                                      jnp.bfloat16).astype(jnp.float32))
    assert any(len(set(row)) < 40 for row in logits)
    w, ids = moe._top_k(torch.from_numpy(logits), 8)
    vals, rids = jax.lax.top_k(jnp.asarray(logits), 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(w.numpy(),
                               np.asarray(jax.nn.softmax(vals, axis=-1)),
                               **TOL)


@pytest.mark.parametrize("experts,k,devices", [(40, 8, 8), (8, 2, 4)],
                         ids=["granite-e40-8dev", "smoke-e8-4dev"])
def test_place_experts_matches_reference(experts, k, devices):
    ids = np.random.default_rng(3).integers(0, experts, (256, k))
    aff = expert_affinity(ids, experts)
    np.testing.assert_array_equal(aff, ref_affinity(ids, experts))
    got = place_experts(aff, devices, effort=0)
    want = ref_place(aff, devices, effort=0)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.device_of, want.device_of)
    assert (got.est_cost, got.baseline_cost) == (want.est_cost,
                                                 want.baseline_cost)
    assert sorted(got.perm) == list(range(experts))


# ------------------------------------------------------------------ #
# expert parallelism over gloo
# ------------------------------------------------------------------ #
def _rank_cases(rank: int, world: int, cases: dict) -> dict:
    cfg = configs.get_smoke(ARCH)
    out = {}
    for name, (p, x) in cases.items():
        pt = {k: torch.from_numpy(v) for k, v in p.items()}
        slab = torch.from_numpy(x[rank])
        y, aux = moe.apply(pt, slab, cfg, dispatch="all_to_all",
                           group=dist.group.WORLD)
        y1, _ = moe.apply(pt, slab, cfg)
        out[name] = (y.numpy(), float(aux), y1.numpy(),
                     int(_port_dropped(p, x[rank]).sum()))
    return out


def _worker(rank: int, world: int, store: str, cases, q) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            q.put((rank, _rank_cases(rank, world, cases)))
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        q.put((rank, repr(e)))
        raise


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ep(request):
    """(world, cases, {rank: results}) of one gloo spawn: 'binds' (a
    skewed router, 2 x 16 tokens per rank) and 'free' (8 tokens per rank:
    at most 8 per expert, under the floor capacity of 8)."""
    world = request.param
    cases = {"binds": (_params(3.0), _x((world, 2, 16), seed=4)),
             "free": (_params(), _x((world, 1, 8), seed=5))}
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_worker,
                             args=(r, world, os.path.join(tmp, "store"),
                                   cases, q)) for r in range(world)]
        for p in procs:
            p.start()
        got = dict(q.get(timeout=TIMEOUT_S) for _ in procs)
        for p in procs:
            p.join(timeout=30)
            assert not p.is_alive()
    for r, res in got.items():
        assert isinstance(res, dict), f"rank {r}: {res}"
    return world, cases, got


def test_all_to_all_matches_one_group_per_slab(ep):
    world, _, got = ep
    for name in ("binds", "free"):
        for r in range(world):
            y, _, y1, _ = got[r][name]
            np.testing.assert_allclose(y, y1, **TOL)
    assert sum(got[r]["binds"][3] for r in range(world)) > 0
    auxes = {got[r]["binds"][1] for r in range(world)}
    assert len(auxes) == 1          # one aux over the whole group


def test_all_to_all_matches_reference_single_device(ep):
    """No rank drops and neither does the reference over every token,
    so the expert-parallel output is the reference's, token for token."""
    world, cases, got = ep
    p, x = cases["free"]
    assert all(got[r]["free"][3] == 0 for r in range(world))
    full = x.reshape((-1,) + x.shape[2:])
    assert not _ref_dropped(p, full).any()
    want, want_aux = ref_moe.apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(full),
                                   ref_configs.get_smoke(ARCH))
    mine = np.concatenate([got[r]["free"][0] for r in range(world)])
    np.testing.assert_allclose(mine, np.asarray(want), **TOL)
    np.testing.assert_allclose(got[0]["free"][1], float(want_aux), **TOL)


def test_apply_refuses_unknown_dispatch_and_uneven_shards():
    from repro_torch.distributed.moe_ep import shard_experts
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    x = torch.from_numpy(_x((1, 4), seed=6))
    with pytest.raises(ValueError, match="dispatch"):
        moe.apply(p, x, configs.get_smoke(ARCH), dispatch="ring")
    with pytest.raises(ValueError, match="divide"):
        shard_experts(p, 0, 3)
    # without a group the expert-parallel request runs as one group
    y, _ = moe.apply(p, x, configs.get_smoke(ARCH), dispatch="all_to_all")
    np.testing.assert_array_equal(y.numpy(),
                                  moe.apply(p, x, configs.get_smoke(ARCH))[0]
                                  .numpy())
