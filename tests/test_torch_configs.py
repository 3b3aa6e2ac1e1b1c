"""The port's other seven architectures (phi3-medium-14b, mistral-nemo-12b,
gemma3-12b, chameleon-34b, hubert-xlarge, qwen3-moe-235b-a22b and
jamba-1.5-large-398b, smoke configs) held against the JAX package on the
CPU.

The config copies of all ten architectures, `shape_supported` and
`cells()` equal the reference's. The reference's own parameters go
through `params_from_jax`, so both packages compute with the same
tensors: `prefill` (hubert on a frames batch; jamba with attention,
mamba and MoE in one stack) and a few `decode_step`s of the six
decoders (gemma3 over 24 steps, past its window-16 ring) must equal the
reference's at f32 atol 1e-4, rtol 1e-4. The port's decode replay must
equal its prefill (rtol 2e-2, atol 2e-3, as tests/test_models.py holds
the reference); the serving launcher runs to its end for the decoders
and refuses hubert, which has no decode step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as ref_model
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax

NEW = ["phi3_medium_14b", "mistral_nemo_12b", "gemma3_12b", "chameleon_34b",
       "hubert_xlarge", "qwen3_moe_235b_a22b", "jamba_1_5_large_398b"]
DECODERS = [a for a in NEW if a != "hubert_xlarge"]
TOL = dict(atol=1e-4, rtol=1e-4)
REPLAY_TOL = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(scope="module")
def pair():
    """arch -> (reference cfg, reference params, port cfg, port model,
    the reference's jitted decode step), built on first use and kept for
    the module's tests."""
    built = {}

    def get(arch):
        if arch not in built:
            rcfg = ref_configs.get_smoke(arch)
            rparams = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
            cfg = configs.get_smoke(arch)
            tree = jax.tree_util.tree_map(np.asarray, rparams)
            step = jax.jit(lambda p, c, t, q: ref_model.decode_step(
                p, c, t, q, rcfg))
            built[arch] = (rcfg, rparams, cfg,
                           params_from_jax(cfg, tree, device="cpu"), step)
        return built[arch]
    return get


def _batch(cfg, b, s, seed):
    """numpy inputs: frames (B,S,d) for the frames frontend, else token
    ids (B,S)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        return {"frames": rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_config_copies_match_reference(arch):
    for get in ("get", "get_smoke"):
        ref = getattr(ref_configs, get)(arch)
        port = getattr(configs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.padded_vocab, port.param_count(), port.repeat,
                port.has_decode, port.supports_long_context()) == (
            ref.padded_vocab, ref.param_count(), ref.repeat,
            ref.has_decode, ref.supports_long_context())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shape_rules_match_reference(arch):
    assert configs.SHAPES == ref_configs.SHAPES
    for shape in configs.SHAPES:
        assert configs.shape_supported(configs.get(arch), shape) == \
            ref_configs.shape_supported(ref_configs.get(arch), shape)


def test_cells_match_reference():
    run, skipped = configs.cells()
    assert (run, skipped) == ref_configs.cells()
    assert ("hubert_xlarge", "decode_32k",
            "encoder-only: no autoregressive decode step") in skipped
    assert ("jamba_1_5_large_398b", "long_500k") in run


def test_unknown_architecture_raises():
    with pytest.raises(KeyError, match="unknown architecture"):
        configs.get("llama_7b")


@pytest.mark.parametrize("arch", NEW)
def test_prefill_matches_reference(pair, arch):
    rcfg, rparams, cfg, model, _ = pair(arch)
    batch = _batch(cfg, 2, 32, seed=0)
    want = ref_model.prefill(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    got = M.prefill(model, {k: torch.from_numpy(v)
                            for k, v in batch.items()}, cfg)
    assert tuple(got.shape) == (2, 1, cfg.padded_vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _decode_against_reference(pair, arch, steps, max_seq, offsets):
    rcfg, rparams, cfg, model, step = pair(arch)
    tokens = _batch(cfg, 2, steps, seed=1)["tokens"]
    rcache = ref_model.init_cache(rcfg, 2, max_seq)
    cache = M.init_cache(cfg, 2, max_seq, device="cpu")
    for t in range(steps):
        pos = np.array([t + o for o in offsets], np.int32)
        want, rcache = step(rparams, rcache, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.asarray(pos))
        got, cache = M.decode_step(model, cache,
                                   torch.from_numpy(tokens[:, t:t + 1]),
                                   torch.from_numpy(pos).long(), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return cache


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps_match_reference(pair, arch):
    _decode_against_reference(pair, arch, steps=4, max_seq=16,
                              offsets=(0, 2))


def test_gemma3_decode_wraps_its_window_ring(pair):
    """24 steps against a 32-deep cache: the five local layers keep
    window-16 rings, which wrap after step 16; the global layer does not."""
    cfg = configs.get_smoke("gemma3_12b")
    cache = _decode_against_reference(pair, "gemma3_12b", steps=24,
                                      max_seq=32, offsets=(0, 3))
    assert [c["k"].shape[1] for c in cache] == [16] * 5 + [32]
    assert [spec.window for spec in cfg.pattern] == [16] * 5 + [None]


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_replay_matches_prefill(pair, arch):
    """At T <= 8 no MoE pair is dropped (capacity 8); gemma3 replays 24
    tokens, past its window of 16."""
    _, _, cfg, model, _ = pair(arch)
    steps = 24 if arch == "gemma3_12b" else 8
    tokens = torch.from_numpy(_batch(cfg, 1, steps, seed=2)["tokens"])
    full = M.prefill(model, {"tokens": tokens}, cfg)
    cache = M.init_cache(cfg, 1, 32, device="cpu")
    for t in range(steps):
        logits, cache = M.decode_step(model, cache, tokens[:, t:t + 1],
                                      torch.full((1,), t), cfg)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **REPLAY_TOL)


def test_encoder_has_no_decode_step(pair):
    rcfg, rparams, cfg, model, _ = pair("hubert_xlarge")
    tokens = np.zeros((2, 1), np.int64)
    with pytest.raises(ValueError, match="encoder models have no decode"):
        ref_model.decode_step(rparams, {}, jnp.asarray(tokens),
                              jnp.zeros((2,), jnp.int32), rcfg)
    with pytest.raises(ValueError, match="encoder models have no decode"):
        M.decode_step(model, [], torch.from_numpy(tokens),
                      torch.zeros(2, dtype=torch.long), cfg)


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_runs_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--requests", "6", "--slots", "4",
                      "--max-new", "8", "--max-seq", "32", "--device",
                      "cpu"])
    assert out["done"] == 6 and out["device"] == "cpu"
    assert "[serve] 6 requests" in capsys.readouterr().out


def test_serve_refuses_encoder():
    with pytest.raises(SystemExit, match="encoder-only; nothing to serve"):
        serve.main(["--arch", "hubert_xlarge", "--device", "cpu"])


def test_serve_depth_cut(capsys):
    """--layers serves the first N layers: one of qwen3-moe's two; a cut
    that is no multiple of jamba's 8-long pattern, or deeper than the
    model, is refused."""
    out = serve.main(["--arch", "qwen3_moe_235b_a22b", "--layers", "1",
                      "--requests", "3", "--slots", "2", "--max-new", "6",
                      "--device", "cpu"])
    assert out["done"] == 3
    for arch, layers in (("jamba_1_5_large_398b", "4"),
                         ("qwen3_moe_235b_a22b", "3")):
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch, "--layers", layers, "--device",
                        "cpu"])
        assert "takes a multiple of its" in capsys.readouterr().err
