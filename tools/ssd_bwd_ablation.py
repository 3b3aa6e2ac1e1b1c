#!/usr/bin/env python3
"""Where `ssd_bwd_dxw`'s time goes: the K3 backward source built with parts
of that function compiled out, each variant timed alone on the card.

    python3 tools/ssd_bwd_ablation.py

Needs one CUDA card and nvcc. The variants are copies of
`src/repro_torch/kernels/ssd/csrc/ssd_intra_bwd.cu` with `#ifndef` guards
put around one part each (anchored on the source's text, so the script
fails loudly when the source changes) and the launches after the dx
function left out; each is timed with CUDA events at mamba2's training
shape (f32 b=8, nc=16, Q=256, N=128, H=32, P=64) on seeded inputs. A
variant's result is wrong by design: only its time is read. The difference
between "full" and a variant is what the removed part costs while the rest
runs, not its own time: the parts overlap.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402

# part -> the source text it starts and ends with, inside ssd_bwd_dxw
PARTS = {
    "dAtt": ("      wgmma3_n32(da, ahi, alo, Xb, Xb + XP, kp);",) * 2,
    "ddtx": ("      wgmma3_n32(acc, ahi, alo, ah, al, 8);",) * 2,
    "elementwise": ("      float rsv[2] = {0.f, 0.f};",
                    "        if (t == 0 && i < Q) rsh[i] = v;\n      }"),
    "BdS": ("#pragma unroll\n      for (int k8 = 0; k8 < 8; ++k8) {",
            "        mma3n<4>(acc, ahi, alo, bh, bl, 4);\n      }"),
    "split": ("      split_rows<TI, 64>(Yh, lo, LDY);",) * 2,
}
VARIANTS = {"full": (), **{f"no {p}": (p,) for p in PARTS},
            "no products": ("dAtt", "ddtx", "BdS"),
            "loads, syncs and epilogue": tuple(PARTS)}


def guarded_source() -> str:
    src = ssd.BWD_SOURCE.read_text()
    at = src.index("ssd_bwd_dxw(const float*")
    head, body = src[:at], src[at:]
    for part, (start, end) in PARTS.items():
        i = body.index(start)
        j = body.index(end, i) + len(end)
        macro = "NO_" + part.upper()
        body = f"{body[:i]}#ifndef {macro}\n{body[i:j]}\n#endif\n{body[j:]}"
    src = head + body
    i = src.index("  ssd_bwd_dgsum<<<")
    j = src.index("vecN, vecP, vecQ);", i) + len("vecN, vecP, vecQ);")
    return f"{src[:i]}#ifndef ONLY_DX\n{src[i:j]}\n#endif\n{src[j:]}"


def time_variant(path: Path, ins, outs) -> float:
    lib = ctypes.CDLL(str(path))
    lib.ssd_intra_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssd_intra_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.ssd_intra_bwd_scratch_floats.restype = ctypes.c_longlong
    C, dtx, cums = ins[0], ins[2], ins[3]
    b, nc, q, n = C.shape
    h, p = dtx.shape[3], dtx.shape[4]
    scratch = torch.empty(lib.ssd_intra_bwd_scratch_floats(b * nc, q, h),
                          device="cuda")
    args = [t.data_ptr() for t in (*ins, *outs, scratch)] + [
        b * nc, q, n, h, p, torch.cuda.current_stream().cuda_stream]
    for _ in range(2):
        if lib.ssd_intra_bwd_launch(*args):
            raise RuntimeError(f"{path.name}: launch failed")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    start.record()
    for _ in range(10):
        lib.ssd_intra_bwd_launch(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_ablation: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    base = guarded_source()
    with tempfile.TemporaryDirectory() as tmp:
        csrc = Path(tmp) / "csrc"
        csrc.mkdir()
        paths = {}
        for k, (name, parts) in enumerate(VARIANTS.items()):
            defs = "".join(f"#define NO_{p.upper()}\n" for p in parts)
            paths[name] = csrc / f"variant{k}.cu"
            paths[name].write_text(f"#define ONLY_DX\n{defs}{base}")
        built = _build.build_all(paths.values())
        gen = torch.Generator(device="cuda").manual_seed(0)
        b, nc, q, n, h, p = 8, 16, 256, 128, 32, 64
        C = torch.randn(b, nc, q, n, device="cuda", generator=gen)
        B = torch.randn(b, nc, q, n, device="cuda", generator=gen)
        dtx = torch.randn(b, nc, q, h, p, device="cuda", generator=gen)
        dy = torch.randn(b, nc, q, h, p, device="cuda", generator=gen)
        cums = -0.1 * torch.rand(b, nc, q, h, device="cuda",
                                 generator=gen).cumsum(2)
        dS = torch.randn(b, nc, h, n, p, device="cuda", generator=gen)
        ins = (C, B, dtx, cums, dy, dS)
        outs = tuple(torch.empty_like(t) for t in (C, B, dtx, cums))
        full = None
        for name, (path, _, _) in zip(paths, built):
            ms = time_variant(path, ins, outs)
            full = ms if full is None else full
            print(f"ssd_bwd_dxw {name:26s} {ms:.4f} ms "
                  f"({full - ms:+.4f} ms against full)", flush=True)


if __name__ == "__main__":
    main()
