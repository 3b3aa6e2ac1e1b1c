"""The grad-mode guard of the raw kernel wrappers, and the route test of
the kernels' public ops (`kernel_route`).

A wrapper that launches a hand-written kernel through `ctypes` returns a
fresh tensor with no `grad_fn`: under autograd its caller would lose every
gradient that should flow back through the kernel, and nothing would say
so. Each raw wrapper therefore calls `require_no_grad` first. Inside a
`torch.autograd.Function`'s forward or backward grad mode is off, so a
wrapper called from a Function that has a backward passes; so does every
call under `torch.no_grad()` (prefill, decode, serving).
"""
from __future__ import annotations

import torch


def records_grad(*tensors) -> bool:
    """Whether autograd records an op on `tensors`: grad mode is on and
    one of them (None skipped) requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def require_no_grad(op: str, hint: str, *tensors) -> None:
    """Raise when `records_grad(*tensors)`: `op`'s output would carry no
    gradient. `hint` says where the gradient is taken instead, or why
    there is none."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{op}: an input requires grad and grad mode is on, but the "
            f"kernel's output would carry no gradient ({hint}); call it "
            "under torch.no_grad()")


def kernel_route(t: torch.Tensor) -> bool:
    """Whether `t` takes a kernel's custom op: a CUDA tensor (the kernel
    launches), or a meta or fake tensor (the op's fake implementation,
    which the dry-run and the FLOP counter read). A plain CPU tensor takes
    the plain version."""
    from torch._subclasses.fake_tensor import is_fake
    return t.is_cuda or t.is_meta or is_fake(t)
