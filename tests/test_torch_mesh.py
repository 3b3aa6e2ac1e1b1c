"""The port's mesh surface held against the reference.

  * Specs: the port's `logical_to_pspec` against the reference's, entry
    for entry, over every parameter decl of the ten configs, every cache
    leaf, `BATCH_AXES` and every activation `constrain` site, on six
    meshes, strict and not (the reference needs only `mesh.shape`, so it
    takes a stand-in; its stacked leaves carry a leading `layers` axis).
  * Meshes under torch's fake process group (world 256 and 512, one
    process): `make_production_mesh`, `param_shardings`' local shapes,
    `elastic_mesh`, `parse_mesh`.
  * `compressed_psum` against the reference's under `jax.vmap` over a
    stacked rank axis (plain version here, the collective on gloo ranks).
  * The grouped MoE dispatch against the reference's `_dispatch_gspmd`
    with `_num_groups` patched in both (drops included).
  * The sharded train step on gloo CPU ranks (world 2: meshes (2,) and
    (1, 2); world 4: (2, 2)) against the port's one-device step, which
    `tests/test_torch_train.py` holds against the reference; a checkpoint
    saved under 2x2 resumed under 4 and under 2x2 by `launch.train`; and
    `ExecutionPlan(mesh=DeviceMesh, mesh_axis="data")` against the plan
    over the axis's group. Both world sizes run at once, every case of a
    world size in one spawn.
"""
import dataclasses
import io
import contextlib
import os
import shutil
import tempfile
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sh
from repro.distributed.compression import compressed_psum as ref_cpsum
from repro.launch import steps as ref_steps
from repro.models import model as ref_M
from repro.models import moe as ref_moe
from repro.models.layers import ParamDecl as RefDecl
from repro.models.layers import init_tree
from repro_torch import configs
from repro_torch.distributed import gloo_cuda
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.compression import (compressed_psum,
                                                 compressed_psum_plain)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models import moe

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8": ((8,), ("data",)),
          "1x1": ((1, 1), ("data", "model"))}
MOE = "granite_moe_3b_a800m"
TRAIN_ARCHS = ("qwen3_0_6b", "mamba2_370m", MOE)
STEP_TOL = 1e-5           # loss, grad_norm: x max(1, |value|)
PARAM_TOL = 1e-5          # updated parameters, relative Frobenius
TRAIN_SEQ, TRAIN_BATCH = 16, 4
TIMEOUT_S = 240


def _meshes(name: str):
    """(the port's stand-in mesh, the reference's)."""
    shape, axes = MESHES[name]
    return (types.SimpleNamespace(mesh_dim_names=axes, shape=shape),
            types.SimpleNamespace(shape=dict(zip(axes, shape))))


def _spec_pair(shape, axes, port_mesh, ref_mesh, strict, stacked=False):
    got = tuple(sh.logical_to_pspec(shape, axes, port_mesh, strict=strict))
    if stacked:     # the reference's stacked leaf: a leading layers axis
        want = ref_sh.logical_to_pspec((2,) + tuple(shape),
                                       ("layers",) + tuple(axes), ref_mesh,
                                       strict=strict)
        return got, tuple(want)[1:]
    return got, tuple(ref_sh.logical_to_pspec(shape, axes, ref_mesh,
                                              strict=strict))


# ------------------------------------------------------------------ #
# (a) specs, entry for entry
# ------------------------------------------------------------------ #
def _ref_decls(cfg) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        ref_M.param_decls(cfg), is_leaf=lambda x: isinstance(x, RefDecl))
    return {"/".join(k.key for k in path): d for path, d in flat}


def _ref_path(name: str, cfg) -> str:
    """The reference's leaf path of one of the port's parameters."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return parts[-1]
    i = int(parts[1]) % len(cfg.pattern)
    leaf = parts[-1] if parts[2] == "norms" else "/".join(parts[2:])
    return f"blocks/block{i}/{leaf}"


def _activation_sites(cfg, b: int, s: int, sizes: dict) -> list:
    """(shape, logical axes) of every activation `constrain` site at a
    (B, S) train cell, the MoE buffer's with the mesh's groups."""
    d, v = cfg.d_model, cfg.padded_vocab
    sites = [((b, s, d), ("batch", "seq", None)),
             ((b, s, d), ("batch", None, None)),
             ((b, s // 8, v), ("batch", None, "act_vocab")),
             ((b, 1, v), ("batch", None, "act_vocab"))]
    if any(p.kind == "attn" for p in cfg.pattern):
        for h in (cfg.num_heads, cfg.num_kv_heads):
            sites.append(((b, s, h, cfg.head_dim),
                          ("batch", None, "act_heads", None)))
        sites.append(((b, s, cfg.num_kv_heads, cfg.head_dim),
                      ("batch", "kv_seq", "kv_heads", None)))
    if cfg.d_ff:
        sites.append(((b, s, cfg.d_ff), ("batch", None, "act_mlp")))
    if any(p.kind == "mamba" for p in cfg.pattern):
        sites.append(((b, s, cfg.ssm_d_inner), ("batch", None, "act_heads")))
    if any(p.moe for p in cfg.pattern):
        dp = sizes.get("pod", 1) * sizes.get("data", 1)
        nm = sizes.get("model", 1)
        gb, gs = (dp if b % dp == 0 else 1), (nm if s % nm == 0 else 1)
        e, g = cfg.num_experts, gb * gs
        cap = moe._capacity(b * s // g, e, cfg.top_k, cfg.capacity_factor)
        buf = (g, e, cap, d)
        sites += [(buf, ("batch_seq_groups", None, None, None)),
                  (buf, ("moe_groups", "experts", None, None)),
                  ((g, b * s // g, d), ("batch_seq_groups", None, None))]
    return sites


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "loose"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_specs_match_reference(mesh, strict):
    pm, rm = _meshes(mesh)
    n = 0
    for arch in configs.ARCH_IDS:
        cfg, rcfg = configs.get(arch), ref_configs.get(arch)
        ref = _ref_decls(rcfg)
        decls = steps.param_decls(cfg)
        assert {_ref_path(k, cfg) for k in decls} == set(ref), arch
        seen = set()
        for name, d in decls.items():
            rd = ref[_ref_path(name, cfg)]
            block = name.startswith("blocks.")
            assert (tuple(rd.shape[block:]), tuple(rd.logical_axes[block:])
                    ) == (d.shape, d.logical_axes), (arch, name)
            if (d.shape, d.logical_axes, block) in seen:
                continue
            seen.add((d.shape, d.logical_axes, block))
            got, want = _spec_pair(d.shape, d.logical_axes, pm, rm, strict,
                                   stacked=block)
            assert got == want, (arch, name, got, want)
            n += 1
        # caches: the port's per-layer leaves against the stacked ones
        for batch, seq, long_ctx in ((128, 32_768, False),
                                     (1, 524_288, True)):
            axes = M.cache_logical_axes(cfg, long_ctx=long_ctx)
            ab = M.abstract_cache(cfg, batch, seq, long_ctx=long_ctx)
            rax = ref_M.cache_logical_axes(rcfg, long_ctx=long_ctx)
            rab = ref_M.abstract_cache(rcfg, batch, seq, long_ctx=long_ctx)
            assert len(ab) == cfg.num_layers
            for layer, (a, ax) in enumerate(zip(ab, axes)):
                i = layer % len(cfg.pattern)
                ra, rx = rab[f"block{i}"], rax[f"block{i}"]
                assert set(a) == set(ra)
                for k in a:
                    assert tuple(a[k].shape) == ra[k].shape[1:]
                    assert ax[k] == rx[k][1:]
                    got, want = _spec_pair(a[k].shape, ax[k], pm, rm,
                                           strict, stacked=True)
                    assert got == want, (arch, layer, k)
                    n += 1
        sizes = dict(zip(*reversed(MESHES[mesh])))
        for shape, axes in _activation_sites(cfg, 256, 4096, sizes):
            got, want = _spec_pair(shape, axes, pm, rm, strict)
            assert got == want, (arch, shape, axes)
            n += 1
    assert steps.BATCH_AXES == ref_steps.BATCH_AXES
    for cell in configs.SHAPES.values():
        for arch in ("qwen3_0_6b", "hubert_xlarge"):
            spec = steps.input_specs(configs.get(arch), cell["seq_len"],
                                     cell["global_batch"], cell["step"])
            if "batch" not in spec:
                continue
            for k, t in spec["batch"].items():
                assert t.device.type == "meta"
                got, want = _spec_pair(t.shape, steps.BATCH_AXES[k], pm, rm,
                                       strict)
                assert got == want
    assert n > 500


def test_placements_and_constrain_without_mesh():
    pm, _ = _meshes("2x16x16")
    spec = sh.logical_to_pspec((256, 4096), ("batch", "seq"), pm)
    assert spec == (("pod", "data"), "model")
    pl = sh.placements(spec, pm)
    assert pl == (sh.Shard(0), sh.Shard(0), sh.Shard(1))
    assert sh.placements(sh.PartitionSpec(None, "data"), pm) == (
        sh.Replicate(), sh.Shard(1), sh.Replicate())
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.PartitionSpec(("model", "data")), pm)
    x = torch.ones(3)
    assert sh.constrain(x, "batch") is x            # no mesh: identity
    with pytest.raises(ValueError, match="requires a mesh"):
        sh.named_sharding((4,), ("batch",))
    assert sh.logical_to_pspec((4,), ("batch",)) == ()
    ns = sh.named_sharding((64, 32), ("batch", "mlp"), pm)
    assert ns.placements == (sh.Shard(0), sh.Shard(0), sh.Shard(1))
    # too small for the axes: replicated (strict)
    assert sh.named_sharding((4, 8), ("batch", "mlp"), pm).placements == (
        sh.Replicate(),) * 3
    with sh.mesh_context(pm, sh.activation_rules(mlp=None)):
        assert sh.current_mesh() is pm
        assert sh.logical_to_pspec((64, 32), ("batch", "mlp")) == (
            ("pod", "data"), None)
        with pytest.raises(TypeError, match="DTensor"):
            sh.constrain(x, "batch")
    assert sh.current_mesh() is None
    assert sh._CTX.rules is sh.DEFAULT_RULES


def test_ambient_mesh_is_the_processes():
    """Autograd's device threads run a checkpoint's recompute: they see
    the mesh of the thread that entered the context."""
    import threading
    pm, _ = _meshes("2x4")
    seen = []
    with sh.mesh_context(pm):
        t = threading.Thread(target=lambda: seen.append(sh.current_mesh()))
        t.start()
        t.join(timeout=30)
    assert seen == [pm] and sh.current_mesh() is None


def test_abstract_params_and_state_are_meta():
    cfg = configs.get("qwen3_0_6b")
    ap = M.abstract_params(cfg)
    assert all(p.device.type == "meta" for p in ap.parameters())
    st = steps.abstract_train_state(cfg, steps.AdamWConfig())
    names = dict(ap.named_parameters())
    assert set(st["opt"]["mu"]) == set(names)
    assert st["opt"]["step"].shape == () and st["opt"]["step"].dtype == \
        torch.int32
    dec = steps.input_specs(cfg, 32_768, 128, "decode")
    assert dec["tokens"].shape == (128, 1) and len(dec["cache"]) == 28


# ------------------------------------------------------------------ #
# (b) meshes under the fake process group
# ------------------------------------------------------------------ #
@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n: int):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec_local_shape(shape, spec, sizes) -> tuple:
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        div = 1
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            div *= sizes[a]
        assert dim % div == 0           # strict: exact division
        out.append(dim // div)
    return tuple(out)


def test_production_meshes_and_param_shardings(fake_world):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    for multi_pod, world, shape, axes in (
            (False, 256, (16, 16), ("data", "model")),
            (True, 512, (2, 16, 16), ("pod", "data", "model"))):
        fake_world(world)
        m = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                          device_type="cpu")
        assert tuple(m.shape) == shape and m.mesh_dim_names == axes
        sizes = dict(zip(axes, shape))
        for arch in ("qwen3_0_6b", MOE):
            cfg = configs.get(arch)
            decls = steps.param_decls(cfg)
            ps = steps.param_shardings(cfg, m)
            assert set(ps) == set(decls)
            for name, ns in ps.items():
                d = decls[name]
                local, _ = compute_local_shape_and_global_offset(
                    d.shape, m, ns.placements)
                assert tuple(local) == _spec_local_shape(d.shape, ns.spec,
                                                         sizes), name
        assert steps.param_shardings(configs.get("qwen3_0_6b"), m)[
            "blocks.0.attn.wq"].spec == ("data", "model", None)
    with pytest.raises(ValueError, match="needs 6 ranks"):
        mesh_lib.make_mesh((2, 3), ("data", "model"), device_type="cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 256])
def test_elastic_mesh(fake_world, n):
    fake_world(n)
    model = 16                  # the reference's mesh.py:32-42, again
    while model > 1 and n % model:
        model //= 2
    m = mesh_lib.elastic_mesh(device_type="cpu")
    assert tuple(m.shape) == (n // model, model)
    assert m.mesh_dim_names == ("data", "model")


def test_parse_mesh_axes(fake_world):
    from repro_torch.launch import train
    for arg, world, shape, axes in (
            ("2", 2, (2,), ("data",)),
            ("2x4", 8, (2, 4), ("data", "model")),
            ("2x2x2", 8, (2, 2, 2), ("pod", "data", "model")),
            ("auto", 256, (16, 16), ("data", "model"))):
        fake_world(world)
        m = train.parse_mesh(arg, "cpu")
        assert (tuple(m.shape), m.mesh_dim_names) == (shape, axes), arg


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_lib.make_mesh((2,), ("data",), device_type="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_lib.elastic_mesh(device_type="cpu")


# ------------------------------------------------------------------ #
# (c) compressed_psum
# ------------------------------------------------------------------ #
def _psum_inputs(w: int, feedback: bool):
    rng = np.random.default_rng(w + 10 * feedback)
    x = rng.normal(size=(w, 96)).astype(np.float32) * \
        rng.uniform(0.1, 3.0, size=(w, 1)).astype(np.float32)
    fb = (rng.normal(size=(w, 96)).astype(np.float32) * 0.01
          if feedback else None)
    return x, fb


def _ref_psum(x, fb):
    if fb is None:
        f = jax.vmap(lambda a: ref_cpsum(a, "pod"), axis_name="pod")
        mean, nfb = f(jnp.asarray(x))
    else:
        f = jax.vmap(lambda a, b: ref_cpsum(a, "pod", b), axis_name="pod")
        mean, nfb = f(jnp.asarray(x), jnp.asarray(fb))
    return np.asarray(mean), np.asarray(nfb)


def _psum_tol(x, fb) -> float:
    """One f32 ulp of the group scale."""
    g = x if fb is None else x + fb
    return float(np.spacing(np.float32(np.abs(g).max() / 127.0)))


@pytest.mark.parametrize("feedback", [False, True], ids=["plain", "fb"])
@pytest.mark.parametrize("w", [2, 4])
def test_compressed_psum_plain_matches_reference(w, feedback):
    x, fb = _psum_inputs(w, feedback)
    mean, nfb = compressed_psum_plain(
        torch.from_numpy(x), None if fb is None else torch.from_numpy(fb))
    want_mean, want_fb = _ref_psum(x, fb)
    tol = _psum_tol(x, fb)
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=0, atol=tol)
    np.testing.assert_allclose(nfb.numpy(), want_fb, rtol=0, atol=tol)


def test_compressed_psum_needs_the_axis():
    with pytest.raises(ValueError, match="pod"):
        compressed_psum(torch.ones(4), "pod")


# ------------------------------------------------------------------ #
# (d) the grouped MoE dispatch
# ------------------------------------------------------------------ #
def _moe_params(skew: float) -> dict:
    cfg = ref_configs.get_smoke(MOE)
    p = init_tree(jax.random.PRNGKey(0), ref_moe.decls(cfg), jnp.float32)
    p = {k: np.array(v) for k, v in p.items()}
    p["router"][:, 0] += skew
    return p


def _ref_group_drops(p, xg) -> list:
    """The reference's dropped mask of each group's (token, choice)
    pairs, from its own `_top_k` and `_group_dispatch`."""
    cfg = ref_configs.get_smoke(MOE)

    @jax.jit
    def dropped(xt, router):
        logits = (xt @ router).astype(jnp.float32)
        w, ids = ref_moe._top_k(logits, cfg.top_k)
        cap = ref_moe._capacity(xt.shape[0], cfg.num_experts, cfg.top_k,
                                cfg.capacity_factor)
        _, (_, _, keep, _) = ref_moe._group_dispatch(
            xt, w, ids, None, cap, cfg.num_experts, cfg.top_k)
        return ~keep
    return [np.asarray(dropped(jnp.asarray(x), jnp.asarray(p["router"])))
            for x in xg]


@pytest.mark.parametrize("groups", [(2, 1), (1, 2), (2, 2), (4, 1)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_grouped_dispatch_matches_reference(groups):
    cfg, rcfg = configs.get_smoke(MOE), ref_configs.get_smoke(MOE)
    p = _moe_params(3.0)
    # features biased positive: most tokens pick the skewed expert 0, so
    # every group's capacity binds
    x = (np.random.default_rng(1).normal(size=(4, 16, cfg.d_model))
         + 0.3).astype(np.float32)
    with mock.patch.object(ref_moe, "_num_groups", lambda b, s: groups):
        want, want_aux = jax.jit(lambda p, x: ref_moe.apply(p, x, rcfg))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    drops = []
    real = moe.dispatch_buffer

    def spy(*a):
        out = real(*a)
        drops.append((~out[2]).numpy())
        return out
    with mock.patch.object(moe, "_num_groups", lambda b, s: groups), \
            mock.patch.object(moe, "dispatch_buffer", spy):
        got, aux = moe.apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-4,
                               rtol=1e-4)
    xg = moe._to_groups(torch.from_numpy(x), *groups).numpy()
    want_drops = _ref_group_drops(p, xg)
    assert len(drops) == groups[0] * groups[1]
    for a, b in zip(drops, want_drops):
        np.testing.assert_array_equal(a, b)
    assert all(d.any() for d in drops)          # the skew drops pairs


# ------------------------------------------------------------------ #
# (e) + (f): gloo ranks
# ------------------------------------------------------------------ #
def _batches(cfg) -> list:
    from repro_torch.data import SyntheticTextDataset
    ds = SyntheticTextDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=1)
    return [{k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
            for i in range(2)]


def _one_device(arch: str, groups=None) -> dict:
    """The port's one-device train step, 2 steps (the MoE at `groups`)."""
    cfg = configs.get_smoke(arch)
    opt_cfg = steps.AdamWConfig(total_steps=2, warmup_steps=1)
    params = M.init_params(cfg, seed=3, device="cpu")
    state = {"params": params,
             "opt": steps.adamw.init_opt_state(params, opt_cfg)}
    fn = steps.make_train_step(cfg, opt_cfg, device="cpu")
    metrics = []
    with (mock.patch.object(moe, "_num_groups", lambda b, s: groups)
          if groups else contextlib.nullcontext()):
        for b in _batches(cfg):
            state, m = fn(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics,
            "params": {n: p.detach().numpy().copy()
                       for n, p in state["params"].named_parameters()}}


def _sharded_steps(arch: str, mesh) -> dict:
    cfg = configs.get_smoke(arch)
    opt_cfg = steps.AdamWConfig(total_steps=2, warmup_steps=1)
    params = M.init_params(cfg, seed=3, device="cpu")
    state = {"params": params,
             "opt": steps.adamw.init_opt_state(params, opt_cfg)}
    steps.shard_state(state, cfg, mesh, opt_cfg)
    fn = steps.make_train_step(cfg, opt_cfg, device="cpu")
    metrics = []
    with sh.mesh_context(mesh):
        for b in _batches(cfg):
            state, m = fn(state, steps.shard_batch(b, mesh))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    ps = steps.param_shardings(cfg, mesh)
    local_ok = []
    for name, p in state["params"].named_parameters():
        want = ps[name].placements
        ok = tuple(p.placements) == want and all(
            tuple(state["opt"][k][name].placements) == want
            for k in ("mu", "nu"))
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        shape, _ = compute_local_shape_and_global_offset(p.shape, mesh, want)
        local_ok.append(ok and tuple(p.to_local().shape) == tuple(shape))
    return {"metrics": metrics, "local_ok": all(local_ok),
            "params": {n: p.full_tensor().detach().numpy()
                       for n, p in state["params"].named_parameters()}}


def _train_cli(args: list, ckpt: str) -> str:
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--arch", "qwen3_0_6b", "--preset", "tiny", "--seq",
                         "16", "--batch", "4", "--ckpt-every", "4",
                         "--log-every", "1", "--dist-backend", "gloo",
                         "--device", "cpu", "--ckpt-dir", ckpt, *args])
    assert rc == 0
    return buf.getvalue()


def _cli_cases(rank: int, tmp: str) -> dict:
    """Train 6 steps under 2x2 (checkpoints at 4 and 6); resume its step-4
    checkpoint under 4 and under 2x2; read the step-4 checkpoint back
    under the (4,) mesh's shardings."""
    from repro_torch.checkpoint import manager
    a, b, c = (os.path.join(tmp, x) for x in "abc")
    full = _train_cli(["--steps", "6", "--mesh", "2x2"], a)
    if rank == 0:
        for d in (b, c):
            shutil.copytree(os.path.join(a, "step_00000004"),
                            os.path.join(d, "step_00000004"))
    dist.barrier()
    moved = _train_cli(["--steps", "6", "--mesh", "4", "--resume"], b)
    same = _train_cli(["--steps", "6", "--mesh", "2x2", "--resume"], c)
    from repro_torch.launch import train
    cfg = dataclasses.replace(configs.get_smoke("qwen3_0_6b"), vocab_size=512)
    opt_cfg = steps.AdamWConfig(total_steps=6, warmup_steps=1)
    mesh4 = train.parse_mesh("4", "cpu")
    like = {"params": dict(M.abstract_params(cfg).named_parameters()),
            "opt": steps.adamw.abstract_opt_state(M.abstract_params(cfg),
                                                  opt_cfg)}
    tree, _, _ = manager.load_pytree(
        like, a, 4, shardings=steps.train_state_shardings(cfg, mesh4,
                                                          opt_cfg))
    back = {k: v.full_tensor() for k, v in manager._flatten(tree)}
    want = {}
    if rank == 0:
        snap = manager._snapshot(
            manager.load_pytree(like_cpu(like), a, 4)[0])
        want = {p: arr for p, arr, _ in snap}
    exact = all(np.array_equal(back[p].numpy(), want[p]) for p in want)
    out = {}
    if rank == 0:
        out = {"full": full, "moved": moved, "same": same,
               "reshard_exact": exact, "n_leaves": len(want),
               "files": {d: manager.committed_steps(os.path.join(tmp, d))
                         for d in "abc"}}
        for d in "abc":
            out[f"state_{d}"] = {p: t.numpy() for p, t in manager._flatten(
                manager.load_pytree(like_cpu(like), os.path.join(tmp, d),
                                    6)[0])}
    return out


def like_cpu(like):
    """A tree like `like` whose leaves restore on the CPU."""
    return {k: like_cpu(v) if isinstance(v, dict) else torch.empty(0)
            for k, v in like.items()}


def _gqa_prefill(mesh=None) -> np.ndarray:
    """qwen3 smoke with one KV head for its 4 query heads: under a mesh
    whose model axis (2) does not divide the KV heads, k/v reach each
    rank whole and it takes its query heads' KV head."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3_0_6b"),
                              num_kv_heads=1)
    params = M.init_params(cfg, seed=5, device="cpu")
    batch = {"tokens": _batches(cfg)[0]["tokens"]}
    if mesh is None:
        return M.prefill(params, batch, cfg).numpy()
    opt_cfg = steps.AdamWConfig()
    steps.shard_state({"params": params,
                       "opt": steps.adamw.init_opt_state(params, opt_cfg)},
                      cfg, mesh, opt_cfg)
    with sh.mesh_context(mesh):
        out = M.prefill(params, steps.shard_batch(batch, mesh), cfg)
    return out.full_tensor().numpy()


def _plan_cases(mesh) -> dict:
    """The distributed fixpoint over a `DeviceMesh`'s data axis and over
    that axis's process group: bit-equal answers."""
    import flip_torch
    from repro_torch.graphs import make_road_network
    g = make_road_network(96, seed=2)
    out = {}
    for label, plan in (
            ("mesh", flip_torch.ExecutionPlan(mesh=mesh, mesh_axis="data",
                                              tile=32)),
            ("group", flip_torch.ExecutionPlan(
                mesh=mesh["data"].get_group(), tile=32))):
        r = flip_torch.compile(g, "sssp", plan, device="cpu").query([1, 7])
        out[label] = (r.attrs, np.asarray(r.steps))
    return out


def _rank_cases(rank: int, world: int, tmp: str) -> dict:
    out = {}
    if world == 2:
        meshes = {"2": mesh_lib.make_mesh((2,), ("data",), "cpu"),
                  "1x2": mesh_lib.make_mesh((1, 2), ("data", "model"),
                                            "cpu")}
    else:
        meshes = {"2x2": mesh_lib.make_mesh((2, 2), ("data", "model"),
                                            "cpu")}
    for mname, mesh in meshes.items():
        for arch in TRAIN_ARCHS:
            r = _sharded_steps(arch, mesh)
            out[f"{mname}/{arch}"] = r if rank == 0 else {
                "local_ok": r["local_ok"]}
    # compressed_psum over a (world,) "pod" mesh: each rank's row
    pod = mesh_lib.make_mesh((world,), ("pod",), "cpu")
    with sh.mesh_context(pod):
        for feedback in (False, True):
            x, fb = _psum_inputs(world, feedback)
            mean, nfb = compressed_psum(
                torch.from_numpy(x[rank]),
                "pod", None if fb is None else torch.from_numpy(fb[rank]))
            out[f"psum/{feedback}"] = (mean.numpy(), nfb.numpy())
    if world == 2:
        out["plan"] = _plan_cases(meshes["2"])
        out["gqa"] = _gqa_prefill(meshes["1x2"])
        # last: the c10d route that gloo ranks sharing a card take, here
        # for CPU tensors (it replaces the functional collectives of this
        # process)
        assert gloo_cuda.install("cpu") and not gloo_cuda.install("cpu")
        r = _sharded_steps(MOE, meshes["1x2"])
        out["c10d route"] = r if rank == 0 else {}
    else:
        out["cli"] = _cli_cases(rank, tmp)
    return out


def _worker(rank: int, world: int, store: str, tmp: str, q) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            q.put((rank, _rank_cases(rank, world, tmp)))
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        q.put((rank, repr(e)))
        raise


class _Ranks:
    """Both world sizes' gloo ranks (2 and 4), started at once; their
    results are read when a test first needs them."""

    def __init__(self):
        ctx = mp.get_context("spawn")
        self.tmp = tempfile.mkdtemp()
        self.jobs = {}
        self.out = None
        for world in (2, 4):
            q = ctx.Queue()
            procs = [ctx.Process(target=_worker, args=(
                r, world, os.path.join(self.tmp, f"store{world}"),
                os.path.join(self.tmp, f"w{world}"), q))
                for r in range(world)]
            for p in procs:
                p.start()
            self.jobs[world] = (q, procs)

    def results(self) -> dict:
        """{world: {rank: results}}."""
        if self.out is None:
            self.out = {world: dict(q.get(timeout=TIMEOUT_S) for _ in procs)
                        for world, (q, procs) in self.jobs.items()}
        for world, got in self.out.items():
            for rank, res in got.items():
                assert isinstance(res, dict), \
                    f"world {world} rank {rank}: {res}"
        return self.out

    def close(self) -> None:
        # ranks whose results were never read cannot flush their queues
        wait = 30 if self.out is not None else 0
        for _, procs in self.jobs.values():
            for p in procs:
                p.join(timeout=wait)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        shutil.rmtree(self.tmp, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def rank_jobs():
    """Start the ranks with the module's first test, so that they run
    while the in-process tests do."""
    jobs = _Ranks()
    try:
        yield jobs
    finally:
        jobs.close()


@pytest.fixture(scope="module")
def ranks(rank_jobs):
    return rank_jobs.results()


@pytest.fixture(scope="module")
def one_device():
    """The one-device steps: the MoE at each mesh's groups."""
    out = {a: _one_device(a) for a in TRAIN_ARCHS if a != MOE}
    for mname, groups in (("2", (2, 1)), ("1x2", (1, 2)), ("2x2", (2, 2))):
        out[f"{MOE}/{mname}"] = _one_device(MOE, groups)
    return out


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("world,mname", [(2, "2"), (2, "1x2"), (4, "2x2")],
                         ids=["2", "1x2", "2x2"])
def test_sharded_train_step_matches_one_device(one_device, ranks, world,
                                               mname, arch):
    got = ranks[world][0][f"{mname}/{arch}"]
    want = one_device[f"{MOE}/{mname}" if arch == MOE else arch]
    for (gl, gn), (wl, wn) in zip(got["metrics"], want["metrics"]):
        assert abs(gl - wl) <= STEP_TOL * max(1.0, abs(wl))
        assert abs(gn - wn) <= STEP_TOL * max(1.0, abs(wn))
    for name, p in want["params"].items():
        rel = float(np.linalg.norm(got["params"][name] - p)
                    / max(float(np.linalg.norm(p)), 1e-30))
        assert rel <= PARAM_TOL, (name, rel)
    assert all(ranks[world][r][f"{mname}/{arch}"]["local_ok"]
               for r in range(world))


@pytest.mark.parametrize("feedback", [False, True], ids=["plain", "fb"])
@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_collective_matches_reference(ranks, world,
                                                      feedback):
    x, fb = _psum_inputs(world, feedback)
    want_mean, want_fb = _ref_psum(x, fb)
    tol = _psum_tol(x, fb)
    for r in range(world):
        mean, nfb = ranks[world][r][f"psum/{feedback}"]
        np.testing.assert_allclose(mean, want_mean[r], rtol=0, atol=tol)
        np.testing.assert_allclose(nfb, want_fb[r], rtol=0, atol=tol)


def test_uneven_kv_heads_take_their_groups(ranks):
    want = _gqa_prefill()
    for r in (0, 1):
        np.testing.assert_allclose(ranks[2][r]["gqa"], want, rtol=1e-5,
                                   atol=1e-5)
    from repro_torch.models.attention import _local_kv_heads
    assert _local_kv_heads(16, 8, 8, 8) == slice(4, 8)     # qwen3, model 2
    assert _local_kv_heads(4, 1, 2, 2) == slice(0, 1)      # 1 KV head
    with pytest.raises(ValueError, match="GQA groups"):
        _local_kv_heads(40, 8, 3, 3)


def test_plan_mesh_axis_matches_group(ranks):
    for r in (0, 1):
        got = ranks[2][r]["plan"]
        for a, b in zip(got["mesh"], got["group"]):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_reshards_and_resumes(ranks):
    cli = ranks[4][0]["cli"]
    assert cli["reshard_exact"] and cli["n_leaves"] > 20
    assert "resumed from step 4" in cli["moved"]
    assert "resumed from step 4" in cli["same"]
    assert cli["files"] == {"a": [4, 6], "b": [4, 6], "c": [4, 6]}
    # the same mesh resumes bit for bit; another mesh sums in another
    # order, so it lands within the train step's tolerance
    for k, t in cli["state_a"].items():
        np.testing.assert_array_equal(t, cli["state_c"][k])
        ref = t.astype(np.float64)
        rel = float(np.linalg.norm(cli["state_b"][k] - ref)
                    / max(float(np.linalg.norm(ref)), 1e-30))
        assert rel <= PARAM_TOL, (k, rel)
    def loss6(out):
        return [line.split()[2] for line in out.splitlines()
                if "step=6 " in line]
    assert loss6(cli["full"]) == loss6(cli["same"]) != []


def test_c10d_route_matches_functional_collectives(ranks):
    """The c10d route (`distributed.gloo_cuda`) gives the functional
    collectives' step bit for bit."""
    got, want = ranks[2][0]["c10d route"], ranks[2][0][f"1x2/{MOE}"]
    assert got["metrics"] == want["metrics"]
    for name, p in want["params"].items():
        np.testing.assert_array_equal(got["params"][name], p)
