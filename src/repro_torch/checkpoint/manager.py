"""Async, atomic checkpointing: the port of `repro.checkpoint.manager`.

The on-disk layout is the reference's: <dir>/step_<N>/
    manifest.json          -- leaf paths, shapes, dtypes, step, extras
    arr_<i>.npy            -- one file per leaf (host copy)
    _COMMITTED             -- written last; a checkpoint without it is
                              ignored on restore (atomic-commit marker)

A tree is nested dicts whose leaves are tensors, numpy arrays or numbers
(the trainer's ``{"params": LM state dict, "opt": {"mu", "nu", "step"}}``);
its leaves are visited in sorted key order, as `jax.tree_util` visits the
reference's dicts, and named by their "/"-joined key paths. numpy has no
bfloat16, so a bf16 leaf is stored as its uint16 view with the logical
dtype "bfloat16" in the manifest, as the reference stores it.

Async: `save(..., blocking=False)` snapshots the leaves to host memory on
the caller's thread (a device -> host copy) and writes the files on a
background thread, so the train loop overlaps I/O with compute; `wait()`
joins the writer. `keep` newest committed steps are retained.

Restore reads the newest committed step into the structure of a tree
like the one saved; each leaf goes to the device of the matching tensor
leaf. A different structure raises.

Under a device mesh (the reference's elastic resharding path): `save` of
a tree of DTensors gathers each leaf (`full_tensor()`, a collective every
rank joins) and, with a process group up, only rank 0 writes; `restore`
with `shardings` (a matching tree of `distributed.sharding.NamedSharding`)
distributes each leaf onto its mesh, so a state saved under one mesh
restores under another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], f"{prefix}{key}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(tree_like, leaves: dict, prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in tree_like.items()}
    return leaves[prefix[:-1]]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(storable numpy array, logical dtype name). The array owns its
    memory: the trainer updates its tensors in place, so a snapshot that
    shared a CPU tensor's storage would change under the writer."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype_name: str, like,
               sharding=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype_name == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    if sharding is not None:
        mesh = sharding.mesh
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 sharding.placements)
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


def _writer() -> bool:
    """Whether this process writes: rank 0 when a process group is up."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _snapshot(tree) -> list[tuple[str, np.ndarray, str]]:
    return [(path, *_to_host(leaf)) for path, leaf in _flatten(tree)]


def _write(snap, directory: str, step: int, extras: dict | None) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "paths": [p for p, _, _ in snap],
                "dtypes": [d for _, _, d in snap],
                "shapes": [list(a.shape) for _, a, _ in snap],
                "extras": extras or {}}
    for i, (_, a, _) in enumerate(snap):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_pytree(tree, directory: str, step: int,
                extras: dict | None = None) -> str:
    """Synchronous save with atomic commit (rank 0 writes when a process
    group is up). Returns the step's directory."""
    snap = _snapshot(tree)
    if not _writer():
        return os.path.join(directory, f"step_{step:08d}")
    return _write(snap, directory, step, extras)


def committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name, "_COMMITTED")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def load_pytree(tree_like, directory: str, step: int | None = None,
                shardings=None):
    """Restore into the structure of `tree_like`: the newest committed step
    (or `step`). Returns ``(tree, step, extras)``; leaves are tensors, on
    the device of the matching tensor leaf of `tree_like` (else the CPU),
    or, with `shardings` (a tree of `NamedSharding` matching `tree_like`),
    DTensors distributed onto each leaf's mesh (a collective every rank
    joins). Raises FileNotFoundError without a committed step, ValueError
    when the saved leaf paths differ from `tree_like`'s."""
    steps = committed_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    step = steps[-1] if step is None else step
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(tree_like)
    paths = [p for p, _ in flat]
    if paths != manifest["paths"]:
        raise ValueError(f"checkpoint tree structure mismatch: saved "
                         f"{manifest['paths'][:4]}..., restoring into "
                         f"{paths[:4]}...")
    sh = (dict(_flatten(shardings)) if shardings is not None
          else dict.fromkeys(paths))
    if set(sh) != set(paths):
        raise ValueError("shardings do not match the tree's leaves")
    leaves = {p: _from_host(np.load(os.path.join(d, f"arr_{i}.npy")),
                            manifest["dtypes"][i], like, sh[p])
              for i, (p, like) in enumerate(flat)}
    return (_unflatten(tree_like, leaves), manifest["step"],
            manifest.get("extras", {}))


class CheckpointManager:
    """Async manager with retention. One background writer at a time."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, tree, step: int, extras: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot `tree` to host memory now (every rank joins the
        gathers of DTensor leaves) and write it, on a background thread
        unless `blocking`; with a process group up, rank 0 writes."""
        self.wait()
        snap = _snapshot(tree)        # device -> host on the caller
        if not _writer():
            return

        def write():
            _write(snap, self.directory, step, extras)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, tree_like, shardings=None, step: int | None = None):
        return load_pytree(tree_like, self.directory, step, shardings)

    def latest_step(self) -> int | None:
        steps = committed_steps(self.directory)
        return steps[-1] if steps else None

    def _gc(self) -> None:
        steps = committed_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
