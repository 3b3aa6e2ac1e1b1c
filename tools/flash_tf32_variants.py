#!/usr/bin/env python3
"""Where K2's f32 ("tf32x3") kernels lose time, on a card: variants of
`flash_attention_tf32.cu` and `flash_attention_bwd_tf32.cu`, each made by
a text substitution of the source in this checkout, built with nvcc,
held against the plain version at a small shape and at qwen3-0.6b's
layer (B=1 x 4,096; the error of a long tensor-core chain grows with S),
and timed at qwen3-0.6b's
f32 shapes (forward q (4, 4096, 16, 128), backward (8, 4096, 16, 128),
k/v 8 heads, causal), in turns with the unchanged source.

    python3 tools/flash_tf32_variants.py

Prints the card's name and power limit, then one line per variant: its
ptxas registers and spills, its error and its mean time over two turns.
Builds go to build/variants/ (listed in .gitignore).
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import flash  # noqa: E402
from repro_torch.kernels.attention.ref import (attention_bwd_ref,  # noqa: E402
                                               attention_lse_ref,
                                               attention_ref)

OUT = ROOT / "build" / "variants" / "csrc"

# name -> [(old, new), ...] applied to the source; every old must occur
FWD_VARIANTS = {
    "base": [],
    "kk loop unrolled": [("#pragma unroll 2\n    for (int kk",
                          "#pragma unroll\n    for (int kk")],
    "kv tiles of 32, 3 blocks an SM": [
        ("constexpr int BKV = 64;", "constexpr int BKV = 32;"),
        ("__launch_bounds__(128 * HALVES)",
         "__launch_bounds__(128 * HALVES, 3)")],
    "2 blocks an SM asked": [
        ("__launch_bounds__(128 * HALVES)",
         "__launch_bounds__(128 * HALVES, 2)")],
}
BWD_VARIANTS = {
    "base": [],
    "rows_dot unrolled": [("#pragma unroll 2\n  for (int kk",
                           "#pragma unroll\n  for (int kk")],
    "2 blocks an SM asked": [
        ("__launch_bounds__(128 * HALVES)",
         "__launch_bounds__(128 * HALVES, 2)"),
        ("__global__ void __launch_bounds__(128)\nbwd_dq",
         "__global__ void __launch_bounds__(128, 2)\nbwd_dq")],
}


def variant(source: Path, name: str, subs) -> Path:
    text = source.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{source.name} / {name}: {old!r} not found")
        text = text.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    path = OUT / f"{source.stem}__{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def ptxas(log: str, fn: str) -> str:
    lines = log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and fn in ln and "128" in ln:
            for nxt in lines[i + 1:i + 3]:
                if "registers" in nxt or "spill" in nxt:
                    out.append(nxt.split(":", 1)[-1].strip())
    return "; ".join(out)


def fwd_fn(lib):
    f = lib.flash_attention_tf32_launch
    f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                  + [ctypes.c_float, ctypes.c_void_p])
    f.restype = ctypes.c_int

    def run(q, k, v, lse=None):
        b, s, h, hd = q.shape
        o = torch.empty_like(q)
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), 0, b, s,
                k.shape[1], h, k.shape[2], hd, 1, 0, 1 / math.sqrt(hd),
                torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return o
    return run


def bwd_fn(lib):
    f = lib.flash_attention_bwd_tf32_launch
    f.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                  + [ctypes.c_float, ctypes.c_void_p])
    f.restype = ctypes.c_int

    def run(q, k, v, o, do, lse):
        b, s, h, hd = q.shape
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty((b, h, s), device=q.device)
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(), b, s, k.shape[1], h,
                k.shape[2], hd, 1, 0, 1 / math.sqrt(hd),
                torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return dq, dk, dv
    return run


def time_ms(fn, reps: int) -> float:
    fn()
    a, z = (torch.cuda.Event(enable_timing=True) for _ in "az")
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    jobs = ([("fwd", n, variant(flash.TF32_SOURCE, n, s))
             for n, s in FWD_VARIANTS.items()]
            + [("bwd", n, variant(flash.BWD_TF32_SOURCE, n, s))
               for n, s in BWD_VARIANTS.items()])
    built = _build.build_all([p for _, _, p in jobs], verbose=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    holds = []
    for b, s, h, kh in ((2, 320, 8, 4), (1, 4096, 16, 8)):
        qs, ks, vs, dos = (rn(b, s, h, 128), rn(b, s, kh, 128),
                           rn(b, s, kh, 128), rn(b, s, h, 128))
        o_s = attention_ref(qs, ks, vs)
        holds.append((qs, ks, vs, dos, o_s, attention_lse_ref(qs, ks),
                      attention_bwd_ref(qs, ks, vs, o_s, dos)))
    fwd_in = (rn(4, 4096, 16, 128), rn(4, 4096, 8, 128), rn(4, 4096, 8, 128))
    bq, bk, bv, bdo = (rn(8, 4096, 16, 128), rn(8, 4096, 8, 128),
                       rn(8, 4096, 8, 128), rn(8, 4096, 16, 128))
    bo, bl = flash.flash_attention_cuda(bq, bk, bv, return_lse=True)
    runs = {}
    for (kind, name, _), (path, _, log) in zip(jobs, built):
        lib = ctypes.CDLL(str(path))
        fn = "fwd_tf32" if kind == "fwd" else "bwd_"
        err = []
        if kind == "fwd":
            run = fwd_fn(lib)
            for qs, ks, vs, _, o_s, _, _ in holds:
                err.append(float((run(qs, ks, vs) - o_s).abs().max()))
            call = (lambda r=run: r(*fwd_in))
        else:
            run = bwd_fn(lib)
            for qs, ks, vs, dos, o_s, l_s, want_b in holds:
                got = run(qs, ks, vs, o_s, dos, l_s)
                err.append(max(float((g - w).abs().max())
                               / max(1.0, float(w.abs().max()))
                               for g, w in zip(got, want_b)))
            call = (lambda r=run: r(bq, bk, bv, bo, bdo, bl))
        runs[(kind, name)] = (call, err, ptxas(log, fn))
    times = {key: [] for key in runs}
    for _ in range(2):                       # two turns, base first
        for key, (call, _, _) in runs.items():
            times[key].append(time_ms(call, 5 if key[0] == "fwd" else 2))
    for key, (_, err, regs) in runs.items():
        t = times[key]
        print(f"{key[0]} {key[1]}: max|err| (bwd: / max(1, max|ref|)) at "
              f"S=320 {err[0]:.3e}, S=4096 {err[1]:.3e}; "
              f"{' / '.join(f'{x:.4f}' for x in t)} ms (mean "
              f"{sum(t) / len(t):.4f}); ptxas hd 128: {regs}", flush=True)


if __name__ == "__main__":
    main()
