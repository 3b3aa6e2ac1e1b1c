"""Model configurations of the port: the counterpart of `repro.configs`.

`ARCH_IDS` and `SHAPES` list the reference's architectures and input
shapes. `get(name)` returns an architecture's full `ModelConfig` and
`get_smoke(name)` its reduced same-family config for CPU tests; both
raise for an architecture whose model is not ported yet.
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

# the architectures whose config (and model) the port has
PORTED = ("qwen3_0_6b", "mamba2_370m", "granite_moe_3b_a800m")

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
    if name not in PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP Queue 1 item 11); ported: "
            f"{', '.join(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
