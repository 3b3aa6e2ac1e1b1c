"""Model configurations of the port: the counterpart of `repro.configs`.

`ARCH_IDS` and `SHAPES` list the reference's architectures and input
shapes. `get(name)` returns an architecture's full `ModelConfig`,
`get_smoke(name)` its reduced same-family config for CPU tests, and
`cells()` the (arch x shape) cells with the reference's skip rules
(`shape_supported`) applied.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen3_0_6b",
    "phi3_medium_14b",
    "mistral_nemo_12b",
    "gemma3_12b",
    "granite_moe_3b_a800m",
    "qwen3_moe_235b_a22b",
    "jamba_1_5_large_398b",
    "mamba2_370m",
    "hubert_xlarge",
    "chameleon_34b",
]

# assigned input shapes: name -> (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, step="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  step="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, step="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   step="decode"),
}


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; one of {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def shape_supported(cfg, shape_name: str) -> tuple[bool, str]:
    """The reference's skip rules. Returns (supported, reason)."""
    spec = SHAPES[shape_name]
    if spec["step"] == "decode" and not cfg.has_decode:
        return False, "encoder-only: no autoregressive decode step"
    if shape_name == "long_500k" and not cfg.supports_long_context():
        return False, ("pure full-attention decoder: 500k KV cache is not "
                       "sub-quadratic-servable (assignment skip rule)")
    return True, ""


def cells():
    """All runnable (arch, shape) cells + the skip list."""
    run, skipped = [], []
    for a in ARCH_IDS:
        cfg = get(a)
        for s in SHAPES:
            ok, reason = shape_supported(cfg, s)
            (run if ok else skipped).append((a, s) if ok else (a, s, reason))
    return run, skipped
