"""Carry the JAX package's parameters into the port's `LM`.

`params_from_jax(cfg, tree)` takes the reference's parameter pytree
(`repro.models.model.init_params`) with every leaf as a numpy array and
returns an `LM` holding the same values:

  * the stacked leading `layers` axis of the reference's scan layout
    (`blocks/block{i}/...` of shape (repeat, ...)) is split into one
    module per layer, layer ``r * len(pattern) + i``;
  * every einsum layout is kept as it is (wq (d, h, hd), wo (h, hd, d),
    ...), so no tensor is transposed;
  * bf16 leaves (numpy's `ml_dtypes` bfloat16, which `torch.from_numpy`
    refuses) go through a uint16 view.

The reference's gradient tree has the parameters' structure, so it comes
across through `params_from_jax` too. `opt_state_from_jax(cfg, opt)`
carries the reference's AdamW state ({"mu", "nu", "step"}) into the
port's (`repro_torch.optim.adamw`): moment dicts keyed by the `LM`'s
parameter names, by the same layer split, each in its own dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM


def to_tensor(a) -> torch.Tensor:
    """A numpy array (any float dtype, bf16 included) as a CPU tensor."""
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def named_leaves(cfg: ModelConfig, tree: dict) -> dict:
    """The reference tree's leaves (numpy, dtypes kept) keyed by the
    port's parameter names (``blocks.{layer}.attn.wq``, ...), the stacked
    layer axis split as `params_from_jax` splits it."""
    out = {}

    def put(prefix, leaves, layer):
        for name, a in leaves.items():
            out[f"{prefix}.{name}"] = (np.asarray(a) if layer is None
                                       else np.asarray(a)[layer])

    put("embedding", {k: tree[k] for k in ("embed", "lm_head") if k in tree},
        None)
    put("final", {"final_norm": tree["final_norm"]}, None)
    period = len(cfg.pattern)
    for idx in range(cfg.repeat * period):
        r, i = divmod(idx, period)
        bt = tree["blocks"][f"block{i}"]
        put(f"blocks.{idx}.norms",
            {k: bt[k] for k in ("norm1", "norm2") if k in bt}, r)
        kind = "attn" if cfg.pattern[i].kind == "attn" else "mamba"
        put(f"blocks.{idx}.{kind}", bt[kind], r)
        if "ffn" in bt:
            put(f"blocks.{idx}.ffn", bt["ffn"], r)
    return out


def _match(leaves: dict, shapes: dict, what: str) -> None:
    """Raise unless `leaves` has exactly the port's names and shapes."""
    if set(leaves) != set(shapes):
        raise ValueError(f"reference {what} leaves do not match the port "
                         f"parameters: {sorted(set(leaves) ^ set(shapes))}")
    for name, a in leaves.items():
        if tuple(a.shape) != tuple(shapes[name]):
            raise ValueError(f"{what} {name}: reference shape "
                             f"{tuple(a.shape)} != port shape "
                             f"{tuple(shapes[name])}")


@torch.no_grad()
def params_from_jax(cfg: ModelConfig, tree: dict, device=None) -> LM:
    """The port's `LM` on `device` (default: the CUDA device; raises
    without one) holding the reference parameters `tree`, each cast to
    the parameter's dtype."""
    model = LM(cfg, device)
    named = dict(model.named_parameters())
    leaves = named_leaves(cfg, tree)
    _match(leaves, {n: p.shape for n, p in named.items()}, "parameter")
    for name, a in leaves.items():
        named[name].copy_(to_tensor(a).to(named[name].dtype))
    return model


def opt_state_from_jax(cfg: ModelConfig, opt: dict, device=None) -> dict:
    """The reference's AdamW state (`repro.optim.adamw.init_opt_state`'s
    tree, leaves as numpy arrays) as the port's: {"mu": {name: tensor},
    "nu": {name: tensor}, "step": int32 tensor} on `device` (default: the
    CUDA device; raises without one), moments in their own dtype."""
    dev = resolve_device(device, "opt_state_from_jax")
    shapes = {n: p.shape for n, p in LM(cfg, "meta").named_parameters()}
    state = {"step": torch.tensor(int(np.asarray(opt["step"])),
                                  dtype=torch.int32, device=dev)}
    for key in ("mu", "nu"):
        leaves = named_leaves(cfg, opt[key])
        _match(leaves, shapes, key)
        state[key] = {n: to_tensor(a).to(dev) for n, a in leaves.items()}
    return state
