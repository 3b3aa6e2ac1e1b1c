"""Training launcher: the port of `repro.launch.train`, same flags and
presets, plus --device and --dist-backend.

Checkpointing is async with atomic commit; resume is exact (batch i is a
function of (seed, i), and the checkpoint holds the parameters, the AdamW
moments and the step); a heartbeat watchdog watches the loop; --supervise
re-execs the loop as a subprocess on failure, which resumes from the
newest committed checkpoint; --grad-compression puts int8 gradients with
error feedback between the gradient and the optimizer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
        --preset tiny --steps 50 --device cpu      # the plain versions
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
        --preset tiny --steps 50                   # on the CUDA device

Presets: `tiny` is the config's smoke variant with vocab_size=512 at
--seq x --batch; `full` is the full config at seq 4,096, batch 256. Every
config trains on the card, mamba blocks included (K3's forward and
backward kernels under `ssd.ops.SSDIntra`):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \\
        --preset tiny --steps 50

--mesh trains across ranks (`parse_mesh`: 'auto', '2', '2x4', '2x2x2',
with the reference's axes) under `distributed.mesh_context`: the state is
sharded by `launch.steps.shard_state`, each batch by `shard_batch`, K2
and K3 run on each rank's shard, and --resume restores with the train
state's shardings (a checkpoint saved under one mesh resumes under
another). The ranks come from torchrun's environment; --dist-backend
picks NCCL (one card per rank) or gloo (ranks that share one card, or
--device cpu):

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --mesh 2 --dist-backend gloo --preset tiny

--attn-impl is accepted for parity; the device picks the attention
route, as everywhere in the port. --moe-dispatch all_to_all trains an
MoE's experts over the mesh's model axis (`distributed.moe_ep`, whose
collectives are differentiable); gspmd is the grouped dispatch.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTextDataset, make_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import compress_grads, init_feedback
from repro_torch.distributed.health import HeartbeatMonitor, step_guard
from repro_torch.distributed.sharding import DEFAULT_RULES, mesh_context
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                     named_params)


def state_tree(state: dict) -> dict:
    """The checkpointed tree of a train state: the parameters by name, the
    AdamW state and (with compression) the feedback."""
    tree = {"params": named_params(state["params"]), "opt": state["opt"]}
    if "feedback" in state:
        tree["feedback"] = state["feedback"]
    return tree


@torch.no_grad()
def load_state(state: dict, tree: dict) -> None:
    """Copy a restored `state_tree` into `state` in place."""
    named = named_params(state["params"])
    for name, t in tree["params"].items():
        named[name].copy_(t)
    for key in ("mu", "nu"):
        for name, t in tree["opt"][key].items():
            state["opt"][key][name].copy_(t)
    state["opt"]["step"] = tree["opt"]["step"].to(torch.int32)
    for name, t in tree.get("feedback", {}).items():
        state["feedback"][name].copy_(t)


def parse_mesh(arg: str, device_type: str | None = None):
    """'auto' (`elastic_mesh`), or dims joined by 'x': one dim is
    ("data",), two ("data", "model"), three ("pod", "data", "model")."""
    if arg == "auto":
        return mesh_lib.elastic_mesh(device_type=device_type)
    dims = tuple(int(x) for x in arg.split("x"))
    axes = ("data", "model")[:len(dims)] if len(dims) == 2 else \
        (("data",) if len(dims) == 1 else ("pod", "data", "model"))
    return mesh_lib.make_mesh(dims, axes, device_type)


def _join_process_group(args) -> bool:
    """Join the default process group from torchrun's environment
    (`env://`) unless one is up already. Returns whether it joined.
    NCCL takes one CUDA device per local rank; gloo ranks may share a
    card (local rank modulo the cards) or run on the CPU."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit(f"--mesh {args.mesh}: no process group; start the "
                         "ranks with torchrun (e.g. `torchrun "
                         "--nproc-per-node 2 -m repro_torch.launch.train "
                         "...`)")
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if cpu and args.dist_backend == "nccl":
        raise SystemExit("--device cpu needs --dist-backend gloo")
    if not cpu:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        card = local % torch.cuda.device_count() \
            if torch.cuda.is_available() else local
        torch.cuda.set_device(card)
        args.device = f"cuda:{card}"
    kw = ({"device_id": torch.device(args.device)}
          if args.dist_backend == "nccl" else {})
    dist.init_process_group(args.dist_backend, **kw)
    return True


def train_loop(args) -> int:
    joined = args.mesh != "none" and _join_process_group(args)
    try:
        # every rank runs the same loop; only rank 0 speaks
        with (contextlib.redirect_stdout(io.StringIO())
              if args.mesh != "none" and dist.get_rank()
              else contextlib.nullcontext()):
            return _train(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args) -> int:
    dev = resolve_device(args.device, "train")
    mesh = (parse_mesh(args.mesh, dev.type) if args.mesh != "none"
            else None)
    if args.preset == "tiny":
        cfg = dataclasses.replace(C.get_smoke(args.arch), vocab_size=512)
        seq, batch_size = args.seq, args.batch
    else:
        cfg = C.get(args.arch)
        seq, batch_size = 4096, 256
    opt_cfg = AdamWConfig(total_steps=args.steps,
                          warmup_steps=args.steps // 10 + 1)

    ds = SyntheticTextDataset(cfg.vocab_size, seq, batch_size,
                              seed=args.data_seed)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    grad_comp = compress_grads if args.grad_compression else None
    step_fn = S.make_train_step(cfg, opt_cfg, impl=args.attn_impl,
                                moe_dispatch=args.moe_dispatch,
                                grad_compression=grad_comp, device=dev)

    params = M.init_params(cfg, seed=args.seed, device=dev)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    if grad_comp is not None:
        state["feedback"] = init_feedback(named_params(params))
    shardings = None
    if mesh is not None:
        S.shard_state(state, cfg, mesh, opt_cfg)
        shardings = S.train_state_shardings(cfg, mesh, opt_cfg)
        if grad_comp is not None:
            shardings["feedback"] = shardings["params"]
    with mesh_context(mesh, DEFAULT_RULES):
        start = 0
        if args.resume and ckpt.latest_step() is not None:
            tree, start, _ = ckpt.restore(state_tree(state), shardings)
            load_state(state, tree)
            print(f"[train] resumed from step {start}")

        hb = HeartbeatMonitor(timeout_s=args.heartbeat_timeout).start()
        t_last = time.time()
        for step, batch in make_batches(ds, start, args.steps - start):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            if mesh is not None:
                batch = S.shard_batch(batch, mesh)
            state, metrics = step_guard(lambda: step_fn(state, batch), step)
            hb.beat()
            if (step + 1) % args.log_every == 0:
                loss = float(metrics["loss"])
                dt = time.time() - t_last
                t_last = time.time()
                tps = args.log_every * batch_size * seq / dt
                # the loss in full (repr): a resumed run is held to it
                print(f"[train] step={step + 1} loss={loss!r} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"tok/s={tps:,.0f}", flush=True)
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                ckpt.save(state_tree(state), step + 1, blocking=False)
        ckpt.wait()
        hb.stop()
    print("[train] done")
    return 0


def supervise(args, argv: list[str]) -> int:
    """Restart-on-failure supervisor: the child is the training loop; on
    a crash it is re-executed with --resume."""
    attempts = 0
    while attempts <= args.max_restarts:
        child = [sys.executable, "-m", "repro_torch.launch.train"] + [
            a for a in argv if a != "--supervise"]
        if "--resume" not in child:
            child.append("--resume")
        print(f"[supervisor] launch attempt {attempts + 1}")
        rc = subprocess.call(child)
        if rc == 0:
            return 0
        attempts += 1
        print(f"[supervisor] child failed rc={rc}; restarting from newest "
              f"committed checkpoint")
        time.sleep(args.restart_backoff_s)
    print("[supervisor] giving up")
    return 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="none",
                    help="'none', 'auto', or dims such as 2, 2x4, 2x2x2")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="process group of a --mesh run: nccl (one card "
                         "per rank) or gloo (ranks sharing one card, or "
                         "--device cpu)")
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--moe-dispatch", default="gspmd")
    ap.add_argument("--ckpt-dir", default="checkpoints/run")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--restart-backoff-s", type=float, default=1.0)
    ap.add_argument("--heartbeat-timeout", type=float, default=600.0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain versions)")
    args = ap.parse_args(argv)
    if args.supervise:
        return supervise(args, argv)
    return train_loop(args)


if __name__ == "__main__":
    sys.exit(main())
