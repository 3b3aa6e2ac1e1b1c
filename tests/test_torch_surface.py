"""Port vs reference: the public signatures and the legacy entry points.

Every public function the two packages share (a module-level function
of a mirrored module, or a method of a class defined there) takes the
reference's parameters by the reference's names, in its order. Allowed
without listing: the reference's JAX-only parameters (`impl`,
`interpret`, `**kw`, `scan`) and the port's trailing `device`. Every
other difference is listed in `DIFFERENCES` with the port's parameters
and its reason; the test fails on a difference the table does not hold
and on an entry that no longer differs.

Then the functions the reference has and the port lacked, each held
against the reference: the deprecated `FlipEngine.run*` shims (they warn
as the reference's do), `GraphServer.engine`, `init_cache(cfg, batch,
max_seq, long_ctx)` and `run_to_fixpoint_ref`; and the keyword names
the port renamed to the reference's (`compress_grads(feedback_tree=)`,
`global_norm(tree=)`, `abstract_opt_state(abstract_params=)`).
"""
import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch

JAX_ONLY = {"impl", "interpret", "kw", "scan"}
# imported by no test: the reference's dry-run sets XLA_FLAGS when it is
# imported (a 512-device host platform)
SKIP_MODULES = {"launch.dryrun"}

DIFFERENCES = {
    "api.session.compile": (
        ("graph", "program", "plan", "mapping", "device", "order", "store"),
        "a precomputed vertex order beside the mapping"),
    "core.engine.FlipEngine.build": (
        ("graph", "algo", "mapping", "order", "tile", "mode", "relax_mode",
         "compact", "feature_dim", "device", "host_layout"),
        "a precomputed vertex order; blocks kept on the host for a "
        "distributed plan"),
    "core.engine.FlipEngine.execute": (
        ("self", "srcs", "warm", "distributed", "mesh", "trace", "max_steps",
         "deadline_s", "detail"),
        "a process group is one axis: no mesh axis name"),
    "autotune.space.candidate_plans": (
        ("base", "algebra", "device"),
        "the route follows from the device, not a backend name"),
    "autotune.tuner.autotune": (
        ("graph", "program", "base_plan", "seed", "store", "force",
         "measure", "budget_s", "segment_steps", "sources", "device"),
        "no bench_history until the port has benchmark rows (ROADMAP)"),
    "distributed.moe_ep.moe_all_to_all": (
        ("p", "x", "cfg", "group", "aux_group"),
        "process groups in place of a shard_map axis name"),
    "distributed.sharding.named_sharding": (
        ("shape", "logical_axes", "mesh", "rules", "strict"),
        "strict: raise where an axis does not divide"),
    "models.layers.init_param": (
        ("gen", "decl", "dtype", "device"),
        "a torch.Generator in place of a jax key"),
    "models.model.init_params": (
        ("cfg", "seed", "device"), "a seed in place of a jax key"),
    "models.model.apply_superblock": (
        ("blocks", "x", "cfg", "moe_dispatch", "remat"),
        "the period's nn.Modules in place of a parameter pytree"),
    "models.model.superblock_decode": (
        ("blocks", "caches", "x", "pos", "cfg", "long_ctx", "moe_dispatch"),
        "the period's nn.Modules and per-layer caches"),
    "models.model.backbone": (
        ("params", "x", "cfg", "remat", "moe_dispatch"),
        "remat before moe_dispatch"),
    "models.model.train_loss": (
        ("params", "batch", "cfg", "remat", "moe_dispatch"),
        "remat before moe_dispatch"),
    "models.moe.apply": (
        ("p", "x", "cfg", "dispatch", "group"),
        "the all_to_all dispatch's process group"),
}


def _modules(pkg):
    out = {}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        name = m.name.split(".", 1)[1]
        if name not in SKIP_MODULES:
            out[name] = importlib.import_module(m.name)
    return out


def _shared_functions():
    """(qualified name, reference function, port function) of every
    public function defined in both of a pair of mirrored modules."""
    ref_mods, port_mods = _modules(repro), _modules(repro_torch)
    for name in sorted(set(ref_mods) & set(port_mods)):
        r, t = ref_mods[name], port_mods[name]
        for attr in sorted(set(vars(r)) & set(vars(t))):
            fr, ft = vars(r)[attr], vars(t)[attr]
            if attr.startswith("_") or getattr(fr, "__module__", None) \
                    != r.__name__ or ft.__module__ != t.__name__:
                continue
            if inspect.isfunction(fr) and inspect.isfunction(ft):
                yield f"{name}.{attr}", fr, ft
            elif inspect.isclass(fr) and inspect.isclass(ft):
                for m in sorted(set(vars(fr)) & set(vars(ft))):
                    a, b = (getattr(vars(c)[m], "__func__", vars(c)[m])
                            for c in (fr, ft))
                    if not m.startswith("_") and inspect.isfunction(a) \
                            and inspect.isfunction(b):
                        yield f"{name}.{attr}.{m}", a, b


def _params(f) -> tuple:
    return tuple(inspect.signature(f).parameters)


def test_shared_signatures_match_the_reference():
    seen, bad = set(), []
    for name, fr, ft in _shared_functions():
        want = tuple(p for p in _params(fr) if p not in JAX_ONLY)
        got = _params(ft)
        if got[len(want):] == ("device",):
            got = got[:-1]
        if name in DIFFERENCES:
            seen.add(name)
            if _params(ft) != DIFFERENCES[name][0] or got == want:
                bad.append((name, _params(ft), "table"))
        elif got != want:
            bad.append((name, _params(ft), want))
    assert not bad, bad
    assert seen == set(DIFFERENCES)


@pytest.mark.parametrize("name, kw", [
    ("compress_grads", "feedback_tree"), ("global_norm", "tree"),
    ("abstract_opt_state", "abstract_params")])
def test_renamed_keywords_are_the_reference(name, kw):
    mod = {"compress_grads": "distributed.compression"}.get(name,
                                                            "optim.adamw")
    r = importlib.import_module(f"repro.{mod}")
    t = importlib.import_module(f"repro_torch.{mod}")
    assert _params(getattr(t, name))[:2] == _params(getattr(r, name))[:2]
    assert kw in _params(getattr(t, name))


def test_renamed_keywords_by_name():
    from repro.distributed import compression as rc
    from repro.optim import adamw as ra
    from repro_torch.distributed import compression as tc
    from repro_torch.models import model as M
    from repro_torch.optim import adamw as ta
    from repro_torch import configs
    g = {"w": np.ones((4, 4), np.float32)}
    gt = {"w": torch.ones(4, 4)}
    assert float(ta.global_norm(tree=gt)) == float(ra.global_norm(tree=g))
    assert float(ta.global_norm(tree=gt)) == 4.0
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    fb = rng.standard_normal((8, 8)).astype(np.float32) * 1e-3
    got, gfb = tc.compress_grads({"w": torch.from_numpy(x)},
                                 feedback_tree={"w": torch.from_numpy(fb)})
    want, wfb = rc.compress_grads({"w": jnp.asarray(x)},
                                  feedback_tree={"w": jnp.asarray(fb)})
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               atol=1e-6)
    np.testing.assert_allclose(gfb["w"].numpy(), np.asarray(wfb["w"]),
                               atol=1e-6)
    cfg = configs.get_smoke("qwen3_0_6b")
    st = ta.abstract_opt_state(abstract_params=M.abstract_params(cfg),
                               cfg=ta.AdamWConfig())
    assert st["step"].is_meta and set(st) == {"mu", "nu", "step"}


# ------------------------------------------------------------------ #
# the functions the port lacked
# ------------------------------------------------------------------ #
def _engines(algo="sssp"):
    from repro.core.engine import FlipEngine as RefEngine
    from repro.graphs import make_road_network as ref_road
    from repro_torch.core.engine import FlipEngine
    from repro_torch.graphs import make_road_network
    g, rg = make_road_network(60, seed=2), ref_road(60, seed=2)
    return (g, rg, RefEngine.build(rg, algo, tile=16, relax_mode="jnp"),
            FlipEngine.build(g, algo, tile=16, device="cpu"))


def test_legacy_run_shims_warn_and_match():
    g, rg, ref, eng = _engines()
    with pytest.warns(DeprecationWarning, match="FlipEngine.run is"):
        got = eng.run(3)
    with pytest.warns(DeprecationWarning, match="FlipEngine.run is"):
        want = ref.run(3)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == int(want[1])
    with pytest.warns(DeprecationWarning, match="run_batch"):
        got = eng.run_batch([3, 9])
    with pytest.warns(DeprecationWarning, match="run_batch"):
        want = ref.run_batch([3, 9])
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    with pytest.warns(DeprecationWarning, match="run_distributed"):
        got = eng.run_distributed([3, 9])
    with pytest.warns(DeprecationWarning, match="run_distributed"):
        want = ref.run_distributed([3, 9])
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    upd = [(0, 5, 0.25), (3, 4, 0.5)]
    eng2, delta = eng.apply_updates(g.apply_updates(upd), upd)
    ref2, rdelta = ref.apply_updates(rg.apply_updates(upd), upd)
    prev, rprev = eng.execute(3)[0], ref.execute(3)[0]
    with pytest.warns(DeprecationWarning, match="run_updated"):
        got = eng2.run_updated(3, prev, delta)
    with pytest.warns(DeprecationWarning, match="run_updated"):
        want = ref2.run_updated(3, rprev, rdelta)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == int(want[1])


def test_graph_server_engine_accessor():
    from repro.launch.serve_graph import GraphServer as RefServer
    from repro_torch.launch.serve_graph import GraphServer
    g, rg, _, _ = _engines()
    srv = GraphServer(g, tile=16, device="cpu")
    rsrv = RefServer(rg, tile=16, relax_mode="jnp")
    for algo in ("bfs", "sssp"):
        e, r = srv.engine(algo), rsrv.engine(algo)
        assert e is srv.session(algo).engine
        assert (e.algo, e.mode, e.bg.ntiles, e.bg.tile) == (
            r.algo, r.mode, r.bg.ntiles, r.bg.tile)
        np.testing.assert_array_equal(e.bg.bsrc.numpy(), np.asarray(r.bg.bsrc))


def test_init_cache_long_ctx_positional():
    from repro import configs as ref_configs
    from repro.models import model as RM
    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = configs.get_smoke("qwen3_0_6b")
    got = M.init_cache(cfg, 8, 64, True, device="cpu")
    want = RM.init_cache(ref_configs.get_smoke("qwen3_0_6b"), 8, 64, True)
    assert len(got) == cfg.repeat * len(cfg.pattern)
    for i, layer in enumerate(got):
        ref = want[f"block{i % len(cfg.pattern)}"]
        for k, t in layer.items():
            assert tuple(t.shape) == tuple(ref[k].shape[1:]), (i, k)
            assert not t.any()
    assert [tuple(t.shape) for layer in got for t in layer.values()] == [
        tuple(t.shape) for layer in M.init_cache(cfg, 8, 64, device="cpu")
        for t in layer.values()]


@pytest.mark.parametrize("semiring", ["min_plus", "max_min", "or_and"])
def test_run_to_fixpoint_ref(semiring):
    from repro.algebra import SEMIRINGS as RS
    from repro.kernels.frontier.ref import run_to_fixpoint_ref as ref_fix
    from repro_torch.algebra import SEMIRINGS
    from repro_torch.kernels.frontier.ref import run_to_fixpoint_ref
    sr, rsr = SEMIRINGS[semiring], RS[semiring]
    rng = np.random.default_rng(4)
    n = 24
    w = np.where(rng.random((n, n)) < 0.15,
                 rng.uniform(1.0, 5.0, (n, n)), sr.zero).astype(np.float32)
    if semiring == "or_and":
        w = (w != sr.zero).astype(np.float32)
    attrs = np.full(n, sr.zero, np.float32)
    attrs[0] = sr.one
    frontier = np.zeros(n, bool)
    frontier[0] = True
    got = run_to_fixpoint_ref(attrs, frontier, w, semiring=sr)
    want = ref_fix(attrs, frontier, w, semiring=rsr)
    np.testing.assert_array_equal(got, np.asarray(want))
    capped = run_to_fixpoint_ref(attrs, frontier, w, max_steps=1,
                                 semiring=sr)
    np.testing.assert_array_equal(
        capped, np.asarray(ref_fix(attrs, frontier, w, max_steps=1,
                                   semiring=rsr)))
