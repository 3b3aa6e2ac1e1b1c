"""Serving launcher: continuous-batching decode loop (the port of
`repro.launch.serve`, same flags and loop, plus --device and --layers).

Decode slots are the PEs and requests the packets: a slot activates when
a request arrives and retires when the request has its tokens, so new
work is admitted every step with no global barrier.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \
      --preset tiny --device cpu          # the plain versions, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \
      --preset full --slots 8 --requests 16 --max-new 32 --max-seq 4096
                                          # on the CUDA device (default)
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite_moe_3b_a800m --preset full   # the MoE (also mamba2_370m)
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3_moe_235b_a22b --preset full --layers 12
                                          # a depth cut that fits one card

Every architecture of `configs.ARCH_IDS` serves; an encoder
(hubert_xlarge) exits with "encoder-only; nothing to serve".
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import model as M


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain versions)")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers only (a multiple of the "
                         "pattern's length): a depth cut for a model that "
                         "does not fit the card whole")
    args = ap.parse_args(argv)

    cfg = C.get_smoke(args.arch) if args.preset == "tiny" else C.get(args.arch)
    if args.layers is not None:
        period = len(cfg.pattern)
        if not (0 < args.layers <= cfg.num_layers
                and args.layers % period == 0):
            ap.error(f"--layers {args.layers}: {cfg.name} takes a multiple "
                     f"of its {period}-layer pattern up to {cfg.num_layers}")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to serve")
    dev = resolve_device(args.device, "serve")
    rng = np.random.default_rng(args.seed)
    params = M.init_params(cfg, seed=args.seed, device=dev)
    step = S.make_decode_step(cfg)

    b = args.slots
    cache = M.init_cache(cfg, b, args.max_seq, device=dev)
    tok_host = np.zeros((b, 1), np.int64)
    pos_host = np.zeros((b,), np.int64)

    # request queue: (prompt_token, target_len)
    queue = [(int(rng.integers(1, cfg.vocab_size)),
              int(rng.integers(4, args.max_new))) for _ in range(args.requests)]
    active = [None] * b          # per-slot: [req_id, generated, target]
    done = 0
    t0 = time.time()
    steps = 0
    decoded_tokens = 0
    while done < args.requests:
        # admission: fill idle slots from the queue (frontier activation)
        for s in range(b):
            if active[s] is None and queue:
                prompt, tgt = queue.pop(0)
                rid = args.requests - len(queue) - 1
                active[s] = [rid, 0, tgt]
                tok_host[s, 0] = prompt
                pos_host[s] = 0
        tokens = torch.from_numpy(tok_host).to(dev)
        pos = torch.from_numpy(pos_host).to(dev)

        logits, cache = step(params, cache, tokens, pos)
        nxt_host = logits[:, 0].argmax(dim=-1).cpu().numpy()
        steps += 1

        for s in range(b):
            if active[s] is None:
                continue
            decoded_tokens += 1
            active[s][1] += 1
            if active[s][1] >= active[s][2] or pos_host[s] + 1 >= args.max_seq:
                done += 1
                active[s] = None       # slot retires (frontier deactivation)
            else:
                tok_host[s, 0] = nxt_host[s]
                pos_host[s] += 1
        if steps % 16 == 0:
            util = sum(a is not None for a in active) / b
            print(f"[serve] step={steps} done={done}/{args.requests} "
                  f"slot-util={util:.2f}", flush=True)
    dt = time.time() - t0
    print(f"[serve] {args.requests} requests, {decoded_tokens} tokens in "
          f"{steps} steps, {dt:.1f}s ({decoded_tokens / dt:.1f} tok/s)")
    return {"done": done, "tokens": decoded_tokens, "steps": steps,
            "seconds": dt, "device": str(dev)}


if __name__ == "__main__":
    main()
