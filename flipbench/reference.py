"""The plain reference: level-synchronous relaxation of the raw edge list.

Plain PyTorch, on any device. It imports nothing of the port and takes
nothing the port built: it works every answer out again from the raw CSR
arrays the benchmark generated. Each step relaxes every half-edge whose
source is in the frontier (`scatter_reduce` with ``amin``) and the new
frontier is the set of vertices whose value strictly fell:

* ``sssp``: distance from the source over the edge weights;
* ``bfs``: hop count from the source (every edge weighs 1).

Unreached vertices read +inf. `dtype` is the precision of the whole
computation (values and weights); the control runs it below float32.
"""
from __future__ import annotations

import numpy as np
import torch

PROGRAMS = ("sssp", "bfs")


class Reference:
    """The raw graph's edges on `device`, ready to relax."""

    def __init__(self, raw, device, tile: int = 128):
        self.n = raw.n
        self.device = torch.device(device)
        self.src = torch.as_tensor(raw.sources(), device=self.device)
        self.dst = torch.as_tensor(raw.indices.astype(np.int64),
                                   device=self.device)
        self.weights = torch.as_tensor(raw.weights, device=self.device)
        self.tile = tile
        self.ntiles = -(-self.n // tile)

    def run(self, program: str, sources, dtype=torch.float32,
            stop_before_end: int = 0, record_tiles: bool = False):
        """Answer every source of `sources` ((B,) ints).

        Returns ``(values (B, n) float32 on the device, steps (B,) numpy,
        tiles)``: steps count each query's relaxation steps, the last of
        which changes nothing; `tiles` (with `record_tiles`) is a (steps,
        B, ntiles) bool tensor of the frontier's tiles entering each step
        (tile = vertex // `tile`), else None. `stop_before_end` stops
        each query that many steps before its end, leaving its last
        improvements unmade (a control only)."""
        if program not in PROGRAMS:
            raise ValueError(f"no reference for program {program!r}")
        srcs = torch.as_tensor(np.asarray(sources, dtype=np.int64),
                               device=self.device)
        b, n, dev = srcs.shape[0], self.n, self.device
        w = (self.weights if program == "sssp"
             else torch.ones_like(self.weights)).to(dtype)
        inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
        rows = torch.arange(b, device=dev)
        dist = torch.full((b, n), float("inf"), dtype=dtype, device=dev)
        dist[rows, srcs] = 0
        front = torch.zeros((b, n), dtype=torch.bool, device=dev)
        front[rows, srcs] = True
        dst = self.dst.expand(b, -1)
        steps = torch.zeros(b, dtype=torch.int64, device=dev)
        tiles = []
        limit = None
        if stop_before_end:
            _, full, _ = self.run(program, sources, dtype)
            limit = torch.as_tensor(np.maximum(full - stop_before_end, 0),
                                    device=dev)
        while True:
            live = front.any(dim=1)
            if limit is not None:
                live &= steps < limit
                front &= live[:, None]
            if not bool(live.any()):
                break
            if record_tiles:
                pad = torch.zeros((b, self.ntiles * self.tile),
                                  dtype=torch.bool, device=dev)
                pad[:, :n] = front
                tiles.append(pad.view(b, self.ntiles, self.tile).any(dim=2))
            steps += live
            cand = torch.where(front[:, self.src], dist[:, self.src] + w,
                               inf)
            new = dist.scatter_reduce(1, dst, cand, reduce="amin",
                                      include_self=True)
            front = new < dist
            dist = new
        out = dist.to(torch.float32)
        return (out, steps.cpu().numpy(),
                torch.stack(tiles) if record_tiles and tiles else None)
