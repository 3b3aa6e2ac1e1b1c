"""The port's LM stack (qwen3-0.6b, mamba2-370m and granite-moe-3b-a800m,
smoke configs) held against the JAX package on the CPU.

The reference's own parameters go through `params_from_jax`, so both
packages compute with the same tensors. The port's `rms_norm`,
`rotary`, `attention.apply/decode`, `mamba.apply/decode`, `prefill` and
a few `decode_step`s must equal the reference's at f32 atol 1e-4, rtol
1e-4; the port's decode replay must equal its prefill (rtol 2e-2, atol
2e-3, as tests/test_models.py holds the reference); the serving launcher
runs to its end on the CPU. The other seven architectures are held in
tests/test_torch_configs.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import mamba as ref_mamba
from repro.models import model as ref_model
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import attention, mamba
from repro_torch.models import model as M
from repro_torch.models.config import BlockSpec
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.models.layers import rms_norm, rotary

ARCHS = ["qwen3_0_6b", "mamba2_370m", "granite_moe_3b_a800m"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference cfg, reference params, port cfg, port model)."""
    arch = request.param
    rcfg = ref_configs.get_smoke(arch)
    rparams = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = configs.get_smoke(arch)
    return arch, rcfg, rparams, cfg, params_from_jax(
        cfg, _np_tree(rparams), device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    for get in ("get", "get_smoke"):
        ref = getattr(ref_configs, get)(arch)
        port = getattr(configs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.padded_vocab, port.param_count()) == (
            ref.padded_vocab, ref.param_count())


def test_rms_norm_and_rotary_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    k = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5))
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(g),
                                       1e-6)), **TOL)
    got = rotary(torch.from_numpy(x), torch.from_numpy(k),
                 torch.from_numpy(pos), 1e6)
    want = ref_layers.rotary(jnp.asarray(x), jnp.asarray(k),
                             jnp.asarray(pos), 1e6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _attn_pair(window):
    cfg = configs.get_smoke("qwen3_0_6b")
    cfg = dataclasses.replace(cfg, pattern=(BlockSpec(window=window),))
    rp = ref_layers.init_tree(jax.random.PRNGKey(3), ref_attention.decls(cfg),
                              jnp.float32)
    rp = {k: v + 0.1 if k.endswith("norm") else v for k, v in rp.items()}
    port = attention.Attention(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, arr in rp.items():
            port[name].copy_(to_tensor(np.asarray(arr)))
    return cfg, rp, port


@pytest.mark.parametrize("window", [None, 5])
def test_attention_apply_and_decode_match_reference(window):
    cfg, rp, port = _attn_pair(window)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    out, (k, v) = attention.apply(port, torch.from_numpy(x), cfg, window)
    r_out, (rk, rv) = jax.jit(ref_attention.apply, static_argnums=(2, 3, 4))(
        rp, jnp.asarray(x), cfg, window, "plain")
    for a, b in ((out, r_out), (k, rk), (v, rv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    t = window if window is not None else 16          # ring or global cache
    shape = (2, t, cfg.num_kv_heads, cfg.head_dim)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    pos = np.array([3, 9], np.int32)
    xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    r_out, (rck, rcv) = jax.jit(ref_attention.decode,
                                static_argnums=(5, 6))(
        rp, jnp.asarray(xt), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), cfg, window)
    out, (pck, pcv) = attention.decode(
        port, torch.from_numpy(xt), torch.from_numpy(ck.copy()),
        torch.from_numpy(cv.copy()), torch.from_numpy(pos).long(), cfg,
        window)
    for a, b in ((out, r_out), (pck, rck), (pcv, rcv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_mamba_apply_and_decode_match_reference():
    cfg = configs.get_smoke("mamba2_370m")
    rp = ref_layers.init_tree(jax.random.PRNGKey(4), ref_mamba.decls(cfg),
                              jnp.float32)
    rng = np.random.default_rng(2)
    rp = {k: (v + jnp.asarray(rng.normal(size=v.shape) * 0.1, jnp.float32)
              if k in ("dt_bias", "A_log", "D", "gate_norm") else v)
          for k, v in rp.items()}
    port = mamba.Mamba(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, arr in rp.items():
            port[name].copy_(to_tensor(np.asarray(arr)))
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        mamba.apply(port, torch.from_numpy(x), cfg).numpy(),
        np.asarray(jax.jit(ref_mamba.apply, static_argnums=(2,))(
            rp, jnp.asarray(x), cfg)), **TOL)

    rcache = ref_mamba.init_cache(cfg, 2, jnp.float32)
    rcache = {k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
              for k, v in rcache.items()}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in rcache.items()}
    xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    r_out, r_new = jax.jit(ref_mamba.decode, static_argnums=(3,))(
        rp, jnp.asarray(xt), rcache, cfg)
    out, new = mamba.decode(port, torch.from_numpy(xt), cache, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **TOL)
    for key in r_new:
        np.testing.assert_allclose(new[key].numpy(), np.asarray(r_new[key]),
                                   **TOL)


def test_prefill_matches_reference(pair):
    _, rcfg, rparams, cfg, model = pair
    tokens = _tokens(cfg, 2, 32, seed=0)
    want = ref_model.prefill(rparams, {"tokens": jnp.asarray(tokens)}, rcfg)
    got = M.prefill(model, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert tuple(got.shape) == (2, 1, cfg.padded_vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_steps_match_reference(pair):
    _, rcfg, rparams, cfg, model = pair
    tokens = _tokens(cfg, 2, 4, seed=1)
    rcache = ref_model.init_cache(rcfg, 2, 16)
    step = jax.jit(lambda p, c, t, q: ref_model.decode_step(p, c, t, q,
                                                            rcfg))
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    for t in range(4):
        pos = np.array([t, t + 2], np.int32)
        want, rcache = step(rparams, rcache, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.asarray(pos))
        got, cache = M.decode_step(model, cache,
                                   torch.from_numpy(tokens[:, t:t + 1]),
                                   torch.from_numpy(pos).long(), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_replay_matches_prefill(pair):
    _, _, _, cfg, model = pair
    tokens = torch.from_numpy(_tokens(cfg, 1, 8, seed=1))
    full = M.prefill(model, {"tokens": tokens}, cfg)
    cache = M.init_cache(cfg, 1, 16, device="cpu")
    for t in range(8):
        logits, cache = M.decode_step(model, cache, tokens[:, t:t + 1],
                                      torch.full((1,), t), cfg)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--requests", "6", "--slots", "4",
                      "--max-new", "8", "--device", "cpu"])
    assert out["done"] == 6 and out["device"] == "cpu"
    assert "[serve] 6 requests" in capsys.readouterr().out


def test_params_from_jax_takes_bf16():
    cfg = configs.get_smoke("qwen3_0_6b")
    bcfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                               activation_dtype="bfloat16")
    rparams = ref_model.init_params(bcfg, jax.random.PRNGKey(1))
    tree = _np_tree(rparams)
    model = params_from_jax(bcfg, tree, device="cpu")
    got = model.blocks[1].attn["wq"]
    assert got.dtype == torch.bfloat16
    want = np.asarray(tree["blocks"]["block0"]["attn"]["wq"][1])
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_moe_blocks_and_frames_frontend_raise():
    """MoE blocks are ported (they carry `moe.decls`), and so is the
    frames frontend: a frames `LM` builds and still declares `embed` (and
    an untied `lm_head`), as the reference does."""
    cfg = configs.get_smoke("granite_moe_3b_a800m")
    blk = M.LM(cfg, device="cpu").blocks[0]
    assert blk.spec.moe and set(blk.ffn.decls) == {"router", "w_gate",
                                                   "w_in", "w_out"}
    assert tuple(blk.ffn["w_gate"].shape) == (
        cfg.num_experts, cfg.d_model, cfg.expert_d_ff)
    frames = M.LM(dataclasses.replace(cfg, frontend="frames",
                                      tie_embeddings=False), device="cpu")
    assert set(frames.embedding.decls) == {"embed", "lm_head"}
    assert tuple(frames.embedding["embed"].shape) == (cfg.padded_vocab,
                                                      cfg.d_model)
