"""The port's dry-run (`launch/dryrun.py`) and the surface it needs, held
against the reference on the CPU.

  (a) `apply_superblock` and `superblock_decode` against the reference's
      at smoke configs of qwen3 (attention), gemma3 (ring window), mamba2,
      granite (MoE) and jamba (hybrid), with the reference's own
      parameters (`params_from_jax`) and inputs (embedded tokens): f32
      atol 1e-4 x max(1, max|ref|), rtol 1e-4 -- the 1e-4 that
      `tests/test_torch_models.py` holds these blocks to, relative to the
      residual stream's scale (~1,000 at the smoke widths).
  (b) K2's and K3's custom ops on CPU tensors bit-equal to their plain
      versions; `torch.library.opcheck` on each; on meta tensors the
      public ops take the fake implementations and the FLOP formulas.
  (c) Each FLOP formula against a brute-force count of the (q chunk, kv
      chunk) pairs the reference's `_lax_flash(unroll_kv=True)` visits
      (its `lax.scan` lengths, traced by `jax.eval_shape`): causal, with
      windows, non-causal, GQA; K3's against its three products per
      (batch, chunk, head).
  (d) Per-device argument bytes of every config's train_4k and
      decode_32k cells on (16, 16) and (2, 16, 16) against the shard
      bytes of the reference's `train_state_shardings` / `param_shardings`,
      `batch_shardings` and `cache_shardings` over a
      `jax.sharding.AbstractMesh` with Auto axes (no compile).
  (e) `run_cell` end to end, one cell per step kind (qwen3 train, granite
      prefill, mamba2 long-context decode), at smoke configs on a fake
      (2, 2) mesh: the reference's JSON keys, components that add up to
      the whole step's FLOPs, `arg_bytes` = (d)'s shard bytes; the skipped
      cells and their reasons equal the reference's `configs.cells()`, and
      the CLI exits 1 on a failed cell.
  (f) In a subprocess with 4 forced host devices and an Auto-axis
      `jax.make_mesh`: the reference's `measure_components` for the smoke
      qwen3 train cell at B=8 x 256 on (1, 1) and (2, 2), against the
      port's components on fake meshes of the same shapes. Held: the
      port's (2, 2) per-device FLOPs are its (1, 1) FLOPs / 4 exactly
      (every dim splits evenly here); the port's (1, 1) FLOPs lie in
      [1, 4/3] x the reference's. The port counts the step as it runs: the
      forward that gives the loss, each block's recompute and the
      backward; the reference takes `jax.grad` alone, so XLA drops the
      checkpointed forward whose value is unused (the port's count can be
      up to 4/3 of its products), and XLA counts elementwise work that the
      FLOP formulas do not (pulling the ratio below 4/3). Both count
      collectives at (2, 2) and none at (1, 1). Recorded, not held: the
      ratio, and the collective bytes (GSPMD and DTensor choose different
      collectives).
  (g) On two gloo ranks: decode under (1, 2) (the cache's T over
      `model`: the flash-decoding combine), (2,) (batch over `data`) and,
      with `long_ctx`, (2,) at B=1 (T over `data`), for qwen3, gemma3
      (ring caches) and mamba2 (SSM heads over `model`), against the
      one-device decode (f32, atol 1e-5 x max(1, max|logits|)), itself
      held against the reference's `decode_step` with `long_ctx`; and the
      `all_to_all` MoE's output and gradients against the grouped
      dispatch's on the same (1, 2) mesh (atol 1e-5 x max(1, max|ref|)).

The gloo ranks and the reference's two subprocesses start with the
module's first test and run beside the in-process tests, which come
first in the file: (b)-(f), then (a) and (g), which read the jobs.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attention
from repro.models import model as ref_model
from repro_torch import configs
from repro_torch.kernels import cost
from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                               attention_lse_ref,
                                               attention_ref)
from repro_torch.kernels.ssd.ref import ssd_intra_bwd_ref, ssd_intra_ref
from repro_torch.launch import dryrun
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax

SB_ARCHS = ["qwen3_0_6b", "gemma3_12b", "mamba2_370m",
            "granite_moe_3b_a800m", "jamba_1_5_large_398b"]
TOL = dict(atol=1e-4, rtol=1e-4)
MESH_TOL = 1e-5           # f32 decode and MoE gradients on a mesh
TIMEOUT_S = 240
# the reference's runs for (a) and (g), in three processes at once
REF_GROUPS = ("qwen3_0_6b,gemma3_12b", "mamba2_370m,granite_moe_3b_a800m",
              "jamba_1_5_large_398b,long")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ------------------------------------------------------------------ #
# background jobs
# ------------------------------------------------------------------ #
REF_MEASURE = r"""
import json
import jax
from jax.sharding import AxisType
from repro import configs as C
from repro.distributed.sharding import DEFAULT_RULES, mesh_context
from repro.launch import dryrun
C.SHAPES["train_4k"] = dict(seq_len=256, global_batch=8, step="train")
cfg = C.get_smoke("qwen3_0_6b")
out = {}
for shape in ((1, 1), (2, 2)):
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * 2)
    with mesh_context(mesh, DEFAULT_RULES):
        c = dryrun.measure_components(cfg, "train_4k", mesh, DEFAULT_RULES,
                                      "gspmd")
    out["x".join(map(str, shape))] = {"flops": c["flops"],
                                      "coll": c["coll"]}
print(json.dumps(out))
"""

# the reference's side of (a) and (g), saved as .npz files: for each
# architecture named, its smoke parameters (seed 0), the period's inputs
# and outputs; for "long", qwen3's (seed 3) and its long decode's logits
REF_BLOCKS = r"""
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro import configs as C
from repro.models import model as M
out_dir, names = sys.argv[1], sys.argv[2].split(",")
steps, b, t = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])


def flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(k.key for k in path): np.asarray(v)
            for path, v in leaves}


def period(arch):
    cfg = C.get_smoke(arch)
    params = jax.jit(M.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    layer = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    rng = np.random.default_rng(1)
    x = M.embed_inputs(params, {"tokens": jnp.asarray(
        rng.integers(0, cfg.vocab_size, (b, 16)))}, cfg)
    y, aux = jax.jit(lambda lp, x: M.apply_superblock(
        lp, x, cfg, impl="plain", remat=False))(layer, x)
    res = {"x": np.asarray(x), "y": np.asarray(y), "aux": np.asarray(aux)}
    cache = jax.tree_util.tree_map(lambda a: a[0], M.init_cache(cfg, b, t))
    step = jax.jit(lambda lp, c, x, pos: M.superblock_decode(
        lp, c, x, pos, cfg))
    rng = np.random.default_rng(2)
    for i in range(3):
        xs = M.embed_inputs(params, {"tokens": jnp.asarray(
            rng.integers(0, cfg.vocab_size, (b, 1)))}, cfg)
        ys, cache = step(layer, cache, xs, jnp.full((b,), i, jnp.int32))
        res[f"dx{i}"], res[f"dy{i}"] = np.asarray(xs), np.asarray(ys)
    np.savez(f"{out_dir}/{arch}.npz", **res, **flat(params, "p/"))


def long_decode():
    cfg = C.get_smoke("qwen3_0_6b")
    params = jax.jit(M.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(3))
    cache = M.init_cache(cfg, 1, t, long_ctx=True)
    step = jax.jit(lambda p, c, tok, pos: M.decode_step(
        p, c, tok, pos, cfg, long_ctx=True))
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                              (steps, 1, 1))
    logits = []
    for i in range(steps):
        lg, cache = step(params, cache, jnp.asarray(toks[i]),
                         jnp.full((1,), i, jnp.int32))
        logits.append(np.asarray(lg))
    np.savez(f"{out_dir}/long.npz", logits=np.stack(logits), tokens=toks,
             **flat(params, "p/"))


for name in names:
    long_decode() if name == "long" else period(name)
"""


def _jax_job(script: str, *args, devices: int = 1):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _unflat(npz, prefix: str = "p/") -> dict:
    out: dict = {}
    for key in npz.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = npz[key]
    return out


DECODE_B, DECODE_T, DECODE_STEPS = 2, 16, 6
DECODE_CASES = {          # name: (arch, mesh shape, axes, long_ctx, batch)
    "qwen3/1x2": ("qwen3_0_6b", (1, 2), ("data", "model"), False, 2),
    "qwen3/2": ("qwen3_0_6b", (2,), ("data",), False, 2),
    "qwen3/long 2": ("qwen3_0_6b", (2,), ("data",), True, 1),
    "gemma3/1x2": ("gemma3_12b", (1, 2), ("data", "model"), False, 2),
    "mamba2/1x2": ("mamba2_370m", (1, 2), ("data", "model"), False, 2),
}


def _decode_inputs(cfg, b: int):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (DECODE_STEPS, b, 1))
    return torch.from_numpy(toks.astype(np.int64))


def one_device_decode(arch: str, b: int, long_ctx: bool) -> np.ndarray:
    """Logits of `DECODE_STEPS` decode steps of the smoke config (f32,
    seed 3) from a zero cache of `DECODE_T` slots, on the CPU."""
    cfg = configs.get_smoke(arch)
    params = M.init_params(cfg, seed=3, device="cpu")
    cache = M.init_cache(cfg, b, DECODE_T, device="cpu")
    out = []
    for i, tok in enumerate(_decode_inputs(cfg, b)):
        pos = torch.full((b,), i, dtype=torch.int64)
        logits, cache = M.decode_step(params, cache, tok, pos, cfg,
                                      long_ctx=long_ctx)
        out.append(logits.numpy())
    return np.stack(out)


def _sharded_decode(arch, mesh, b: int, long_ctx: bool) -> np.ndarray:
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  logical_to_pspec,
                                                  mesh_context)
    from repro_torch.launch import steps
    cfg = configs.get_smoke(arch)
    params = M.init_params(cfg, seed=3, device="cpu")
    ps = steps.param_shardings(cfg, mesh)
    for prefix, mod in params.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            mod._parameters[name] = torch.nn.Parameter(distribute_tensor(
                p.detach(), mesh, ps[full].placements), requires_grad=False)
    csh = steps.cache_shardings(cfg, mesh, b, DECODE_T, long_ctx=long_ctx)
    cache = [{k: distribute_tensor(t, mesh, csh[i][k].placements)
              for k, t in layer.items()}
             for i, layer in enumerate(M.init_cache(cfg, b, DECODE_T,
                                                    device="cpu"))]

    def place(t, axes):
        return distribute_tensor(t, mesh, NamedSharding(
            mesh, logical_to_pspec(t.shape, axes, mesh)).placements)
    out = []
    with mesh_context(mesh):
        for i, tok in enumerate(_decode_inputs(cfg, b)):
            pos = torch.full((b,), i, dtype=torch.int64)
            logits, cache = M.decode_step(
                params, cache, place(tok, ("batch", None)),
                place(pos, ("batch",)), cfg, long_ctx=long_ctx)
            out.append(logits.full_tensor().numpy())
    return np.stack(out)


def _moe_grads(mesh, dispatch: str) -> dict:
    """One granite smoke MoE layer (f32, seed 5) on `mesh`: y and the
    gradients of sum(y) + aux for x and every parameter, whole."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  logical_to_pspec,
                                                  mesh_context)
    from repro_torch.models import moe
    from repro_torch.models.layers import DeclModule, init_module
    cfg = configs.get_smoke("granite_moe_3b_a800m")
    layer = DeclModule(moe.decls(cfg), torch.float32, torch.device("cpu"))
    init_module(layer, torch.Generator().manual_seed(5))
    decls = moe.decls(cfg)
    p = {n: distribute_tensor(t.detach(), mesh, NamedSharding(
        mesh, logical_to_pspec(decls[n].shape, decls[n].logical_axes,
                               mesh)).placements).requires_grad_()
         for n, t in layer.named_parameters()}
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(6))
    xd = distribute_tensor(x, mesh, NamedSharding(mesh, logical_to_pspec(
        x.shape, ("batch", "seq", None), mesh)).placements).requires_grad_()
    with mesh_context(mesh):
        y, aux = moe.apply(p, xd, cfg, dispatch=dispatch)
        loss = y.sum() + aux
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        grads = torch.autograd.grad(loss, [xd] + list(p.values()))
    names = ["x"] + list(p)
    out = {"y": y.full_tensor().detach().numpy()}
    out.update({n: g.full_tensor().numpy() for n, g in zip(names, grads)})
    return out


def _rank_cases(rank: int, world: int) -> dict:
    from repro_torch.launch import mesh as mesh_lib
    out = {}
    meshes = {}
    for name, (arch, shape, axes, long_ctx, b) in DECODE_CASES.items():
        key = (shape, axes)
        if key not in meshes:
            meshes[key] = mesh_lib.make_mesh(shape, axes, device_type="cpu")
        got = _sharded_decode(arch, meshes[key], b, long_ctx)
        if rank == 0:
            out[name] = got
    m12 = meshes[((1, 2), ("data", "model"))]
    grouped = _moe_grads(m12, "gspmd")
    a2a = _moe_grads(m12, "all_to_all")
    if rank == 0:
        out["moe"] = (grouped, a2a)
    return out


def _worker(rank: int, world: int, store: str, q) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            q.put((rank, _rank_cases(rank, world)))
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        q.put((rank, repr(e)))
        raise


class _Jobs:
    """The gloo ranks and the reference's two subprocesses, started at
    once; each result is read when a test first needs it."""

    def __init__(self):
        self.tmp = tempfile.mkdtemp()
        self.ref = _jax_job(REF_MEASURE, devices=4)
        self.blocks = [_jax_job(REF_BLOCKS, self.tmp, names, DECODE_STEPS,
                                DECODE_B, DECODE_T) for names in REF_GROUPS]
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, args=(
            r, 2, os.path.join(self.tmp, "store"), self.q)) for r in range(2)]
        for p in self.procs:
            p.start()
        self._ranks = self._ref = self._blocks = None

    def ranks(self) -> dict:
        if self._ranks is None:
            self._ranks = dict(self.q.get(timeout=TIMEOUT_S)
                               for _ in self.procs)
        for r, res in self._ranks.items():
            assert isinstance(res, dict), f"gloo rank {r}: {res}"
        return self._ranks[0]

    @staticmethod
    def _done(proc) -> str:
        out, err = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, err[-3000:]
        return out

    def reference(self) -> dict:
        if self._ref is None:
            self._ref = json.loads(
                self._done(self.ref).strip().splitlines()[-1])
        return self._ref

    def reference_file(self, name: str):
        if self._blocks is None:
            self._blocks = [self._done(p) for p in self.blocks]
        return np.load(os.path.join(self.tmp, f"{name}.npz"))

    def close(self) -> None:
        wait = 30 if self._ranks is not None else 0
        for p in self.procs:
            p.join(timeout=wait)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        for proc in [self.ref] + self.blocks:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
        shutil.rmtree(self.tmp, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def jobs():
    j = _Jobs()
    try:
        yield j
    finally:
        j.close()


# ------------------------------------------------------------------ #
# (b) the custom ops
# ------------------------------------------------------------------ #
def _attn(dtype, hd, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    return mk(1, 24, 4, hd), mk(1, 24, 2, hd), mk(1, 24, 2, hd)


def test_custom_ops_are_the_plain_versions_on_cpu():
    ops = torch.ops.repro_torch
    q, k, v = _attn(torch.float32, 16)
    o, lse = ops.flash_attention_fwd(q, k, v, True, 8, False)
    assert torch.equal(o, attention_ref(q, k, v, True, 8)) and lse.numel() \
        == 0
    qb, kb, vb = _attn(torch.bfloat16, 64, 1)
    ob, lb = ops.flash_attention_fwd(qb, kb, vb, True, None, True)
    assert torch.equal(ob, attention_ref(qb, kb, vb, True, None))
    assert torch.equal(lb, attention_lse_ref(qb, kb, True, None))
    do = torch.randn_like(o)
    lse = attention_lse_ref(q, k, True, 8)      # f32 takes the tf32x3 route
    for got, want in zip(ops.flash_attention_bwd(q, k, v, o, do, lse, True,
                                                 8),
                         attention_bwd_ref(q, k, v, o, do, True, 8)):
        assert torch.equal(got, want)
    g = torch.Generator().manual_seed(2)
    C, B = torch.randn(2, 3, 8, 4, generator=g), torch.randn(
        2, 3, 8, 4, generator=g)
    dtx = torch.randn(2, 3, 8, 2, 5, generator=g)
    cums = -torch.rand(2, 3, 8, 2, generator=g).cumsum(2)
    for got, want in zip(ops.ssd_intra(C, B, dtx, cums),
                         ssd_intra_ref(C, B, dtx, cums)):
        assert torch.equal(got, want)
    y, S = ssd_intra_ref(C, B, dtx, cums)
    dy, dS = torch.randn_like(y), torch.randn_like(S)
    for got, want in zip(ops.ssd_intra_bwd(C, B, dtx, cums, dy, dS),
                         ssd_intra_bwd_ref(C, B, dtx, cums, dy, dS)):
        assert torch.equal(got, want)
    checks = [
        (ops.flash_attention_fwd, (qb, kb, vb, True, None, True)),
        (ops.flash_attention_fwd, (q, k, v, False, 8, False)),
        (ops.flash_attention_bwd, (q, k, v, o, do, lse, True, 8)),
        (ops.flash_attention_bwd, (qb, kb, vb, ob, torch.randn_like(ob), lb,
                                   True, None)),
        (ops.ssd_intra, (C, B, dtx, cums)),
        (ops.ssd_intra_bwd, (C, B, dtx, cums, dy, dS))]
    for op, args in checks:
        torch.library.opcheck(op, args)


def test_fake_tensors_take_the_fake_implementations():
    """On meta tensors the public ops reach the custom ops (their fake
    implementations), never the plain versions, and the FLOP counter
    reads the formulas; the fake implementations refuse what the
    kernels refuse."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.ssd.ops import ssd_chunked
    mk = lambda *s, dt=torch.bfloat16: torch.empty(  # noqa: E731
        *s, device="meta", dtype=dt, requires_grad=True)
    q, k, v = mk(2, 2048, 8, 128), mk(2, 2048, 2, 128), mk(2, 2048, 2, 128)
    with FlopCounterMode(display=False) as fc:
        flash_attention(q, k, v, True, None).sum().backward()
    counts = {str(p): n for p, n in fc.get_flop_counts()["Global"].items()}
    fwd = cost.attention_fwd_flops(q.shape, k.shape, True, None)
    assert counts == {"repro_torch.flash_attention_fwd": fwd,
                      "repro_torch.flash_attention_bwd": 3 * fwd}
    f32 = torch.float32
    x, dt = mk(1, 64, 4, 8, dt=f32), mk(1, 64, 4, dt=f32)
    Bm, Cm = mk(1, 64, 16, dt=f32), mk(1, 64, 16, dt=f32)
    a, d = mk(4, dt=f32), mk(4, dt=f32)
    with FlopCounterMode(display=False) as fc:
        y, _ = ssd_chunked(x, dt, Bm, Cm, a, d, chunk=32)
        y.sum().backward()
    intra = cost.ssd_intra_flops((1, 2, 32, 16), (1, 2, 32, 4, 8))
    got = {str(p): n for p, n in fc.get_flop_counts()["Global"].items()}
    assert got["repro_torch.ssd_intra"] == intra
    assert got["repro_torch.ssd_intra_bwd"] == 2 * intra
    with pytest.raises(ValueError, match="head_dim 24"):
        flash_attention(mk(1, 8, 2, 24), mk(1, 8, 2, 24), mk(1, 8, 2, 24))


# ------------------------------------------------------------------ #
# (c) the FLOP formulas against the reference's visited chunk pairs
# ------------------------------------------------------------------ #
FLOP_CASES = [  # (s, t, h, kh, hd, causal, window)
    (3072, 3072, 4, 4, 64, True, None),
    (4096, 4096, 8, 2, 128, True, 1024),
    (4096, 4096, 4, 4, 64, True, 1500),
    (2048, 2048, 4, 4, 64, False, None),
    (512, 512, 8, 1, 256, True, None),
    (8192, 8192, 16, 8, 128, True, 4096),
]


def _ref_pairs(monkeypatch, s, t, h, kh, hd, causal, window) -> int:
    """The kv chunks each q chunk of the reference's `_lax_flash` scans,
    summed (its `lax.scan` lengths, traced without running)."""
    lengths = []
    scan = jax.lax.scan

    def counting(f, init, xs, *a, **kw):
        lengths.append(int(xs.shape[0]))
        return scan(f, init, xs, *a, **kw)
    monkeypatch.setattr(jax.lax, "scan", counting)
    sds = jax.ShapeDtypeStruct
    jax.eval_shape(lambda q, k, v: ref_attention._lax_flash(
        q, k, v, causal, window, unroll_kv=True),
        sds((1, s, h, hd), jnp.bfloat16), sds((1, t, kh, hd), jnp.bfloat16),
        sds((1, t, kh, hd), jnp.bfloat16))
    monkeypatch.setattr(jax.lax, "scan", scan)
    return sum(lengths)


@pytest.mark.parametrize("case", FLOP_CASES)
def test_attention_flops_count_the_reference_pairs(monkeypatch, case):
    s, t, h, kh, hd, causal, window = case
    pairs = _ref_pairs(monkeypatch, *case)
    cq, ckv = min(1024, s), min(1024, t)
    assert cost.attention_pairs(s, t, causal, window) == (pairs, cq, ckv)
    fwd = 4 * 3 * h * hd * cq * ckv * pairs
    assert cost.attention_fwd_flops((3, s, h, hd), (3, t, kh, hd), causal,
                                    window) == fwd
    assert cost.attention_bwd_flops((3, s, h, hd), (3, t, kh, hd), causal,
                                    window) == 3 * fwd


def test_ssd_flops_count_three_products_per_head():
    b, nc, q, n, h, p = 2, 3, 256, 128, 32, 64
    per = 2 * q * q * n + 2 * q * q * p + 2 * q * n * p
    assert cost.ssd_intra_flops((b, nc, q, n), (b, nc, q, h, p)) \
        == b * nc * h * per
    assert cost.ssd_intra_bwd_flops((b, nc, q, n), (b, nc, q, h, p)) \
        == 2 * b * nc * h * per


# ------------------------------------------------------------------ #
# (d) argument bytes against the reference's shardings
# ------------------------------------------------------------------ #
def _ref_bytes(tree, shardings) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
               for a, s in zip(leaves, shs))


def _ref_arg_bytes(arch: str, shape: str, mesh) -> tuple[int, int]:
    from repro.optim.adamw import AdamWConfig
    cfg = ref_configs.get(arch)
    spec = ref_configs.SHAPES[shape]
    b, s, kind = spec["global_batch"], spec["seq_len"], spec["step"]
    if kind == "train":
        opt = AdamWConfig(moment_dtype=("bfloat16" if cfg.param_count()
                                        > 50e9 else "float32"))
        state = _ref_bytes(ref_steps.abstract_train_state(cfg, opt),
                           ref_steps.train_state_shardings(cfg, mesh, opt))
        ins = ref_steps.input_specs(cfg, s, b, kind)["batch"]
        return state, _ref_bytes(ins, ref_steps.batch_shardings(ins, mesh))
    state = _ref_bytes(ref_model.abstract_params(cfg),
                       ref_steps.param_shardings(cfg, mesh))
    ins = ref_steps.input_specs(cfg, s, b, kind)
    cache = _ref_bytes(ins["cache"], ref_steps.cache_shardings(
        cfg, mesh, b, s))
    tok = jax.sharding.NamedSharding(mesh, ref_steps.logical_to_pspec(
        (b, 1), ("batch", None), mesh))
    pos = jax.sharding.NamedSharding(mesh, ref_steps.logical_to_pspec(
        (b,), ("batch",), mesh))
    return state, cache + _ref_bytes([ins["tokens"], ins["pos"]], [tok, pos])


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_arg_bytes_match_reference_shardings(multi_pod):
    from jax.sharding import AbstractMesh, AxisType
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
    for arch in configs.ARCH_IDS:
        for cell in ("train_4k", "decode_32k"):
            if not configs.shape_supported(configs.get(arch), cell)[0]:
                continue
            got = dryrun.cell_arg_bytes(arch, cell, multi_pod)
            want = _ref_arg_bytes(arch, cell, mesh)
            assert (got["state_bytes"], got["input_bytes"]) == want, \
                (arch, cell)


# ------------------------------------------------------------------ #
# (e) run_cell end to end; (f) FLOPs against the reference's
# ------------------------------------------------------------------ #
REF_KEYS = {"arch", "shape", "mesh", "chips", "step", "moe_dispatch",
            "lower_s", "compile_s", "memory", "hlo_flops", "hlo_bytes",
            "collective_bytes", "components", "whole_program",
            "model_flops", "roofline", "useful_flops_frac"}
SMALL = {"train_4k": dict(seq_len=256, global_batch=8, step="train"),
         "prefill_32k": dict(seq_len=64, global_batch=4, step="prefill"),
         "long_500k": dict(seq_len=256, global_batch=1, step="decode")}
RUN_CELLS = [("qwen3_0_6b", "train_4k", (1, 1)),
             ("qwen3_0_6b", "train_4k", (2, 2)),
             ("granite_moe_3b_a800m", "prefill_32k", (2, 2)),
             ("mamba2_370m", "long_500k", (2, 2))]


@pytest.fixture(scope="module")
def cells():
    """`run_cell` at the smoke configs on fake meshes, the shapes cut to
    `SMALL`: {(arch, shape, mesh shape): (result, its JSON file's
    contents, (d)'s shard bytes)}."""
    out = {}
    tmp = tempfile.mkdtemp()
    saved = dict(configs.SHAPES)
    configs.SHAPES.update(SMALL)
    try:
        for arch, shape, mesh_shape in RUN_CELLS:
            cfg = configs.get_smoke(arch)
            r = dryrun.run_cell(arch, shape, cfg=cfg, mesh_shape=mesh_shape,
                                save_dir=tmp, tag="x".join(map(
                                    str, mesh_shape)))
            name = dryrun.cell_name(arch, shape, False,
                                    "x".join(map(str, mesh_shape)))
            with open(os.path.join(tmp, name + ".json")) as f:
                saved_json = json.load(f)
            out[(arch, shape, mesh_shape)] = (
                r, saved_json, dryrun.cell_arg_bytes(
                    arch, shape, cfg=cfg, mesh_shape=mesh_shape))
    finally:
        configs.SHAPES.clear()
        configs.SHAPES.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@pytest.mark.parametrize("cell", RUN_CELLS[1:], ids=lambda c: c[1])
def test_run_cell_on_a_2x2_fake_mesh(cells, cell):
    r, saved_json, args = cells[cell]
    assert REF_KEYS <= set(r) and r["mesh"] == "single(2,2)"
    assert r["chips"] == 4 and r["step"] == SMALL[cell[1]]["step"]
    mem = r["memory"]
    assert mem["arg_bytes"] == args["state_bytes"] + args["input_bytes"]
    assert mem["peak_bytes"] >= mem["arg_bytes"] > 0
    assert mem["bytes_per_device"] == mem["peak_bytes"]
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s",
                                         "collective_s")
    comp = r["components"]
    assert r["hlo_flops"] == comp["layer"]["flops"] * comp["repeat"] \
        + comp["head"]["flops"] > 0
    if r["step"] == "train":        # the whole step's layers and head
        assert r["hlo_flops"] == r["whole_program"]["flops"]
    assert r["collective_bytes"] > 0
    assert saved_json == r


def test_cells_and_skips_match_reference(capsys, tmp_path):
    run, skipped = configs.cells()
    rrun, rskipped = ref_configs.cells()
    assert run == rrun and skipped == rskipped
    arch, shape, reason = skipped[0]
    assert dryrun.main(["--arch", arch, "--shape", shape, "--out",
                        str(tmp_path)]) == 0
    assert f"[skipped-by-rule] {arch}__{shape}__single: {reason}" in \
        capsys.readouterr().out
    assert dryrun.main(["--arch", "qwen3_0_6b", "--shape", "no_such_shape",
                        "--out", str(tmp_path)]) == 1
    assert "[FAIL] qwen3_0_6b__no_such_shape__single" in \
        capsys.readouterr().out


def test_components_against_reference(jobs, cells, capsys):
    got = {"x".join(map(str, m)): {"flops": cells[(a, s, m)][0]["hlo_flops"],
                                   "coll": cells[(a, s, m)][0][
                                       "collective_bytes"]}
           for a, s, m in RUN_CELLS[:2]}
    ref = jobs.reference()
    ratio = got["1x1"]["flops"] / ref["1x1"]["flops"]
    with capsys.disabled():
        print(f"\nsmoke qwen3 train B=8 x 256, per device: port {got}, "
              f"reference {ref}; FLOPs port / reference at (1, 1): "
              f"{ratio:.4f}")
    assert got["2x2"]["flops"] * 4 == got["1x1"]["flops"]
    assert 1.0 <= ratio <= 4 / 3, ratio
    assert got["1x1"]["coll"] == 0 and ref["1x1"]["coll"] == 0
    assert got["2x2"]["coll"] > 0 and ref["2x2"]["coll"] > 0


# ------------------------------------------------------------------ #
# (a) one pattern period against the reference's
# ------------------------------------------------------------------ #
def _port_blocks(jobs, arch: str):
    """(the reference's saved results, the port's config, the period's
    blocks with the reference's parameters)."""
    ref = jobs.reference_file(arch)
    cfg = configs.get_smoke(arch)
    lm = params_from_jax(cfg, _unflat(ref), device="cpu")
    return ref, cfg, lm.blocks[:len(cfg.pattern)]


def _hold(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(
        1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("arch", SB_ARCHS)
def test_apply_superblock_matches_reference(jobs, arch):
    ref, cfg, blocks = _port_blocks(jobs, arch)
    got, aux = M.apply_superblock(blocks, torch.from_numpy(ref["x"].copy()),
                                  cfg, remat=False)
    _hold(got.numpy(), ref["y"])
    _hold(np.asarray(float(aux)), ref["aux"])
    assert set(M.superblock_decls(cfg)) == {
        n for n, _ in blocks.named_parameters()}


@pytest.mark.parametrize("arch", SB_ARCHS)
def test_superblock_decode_matches_reference(jobs, arch):
    ref, cfg, blocks = _port_blocks(jobs, arch)
    cache = M.init_cache(cfg, DECODE_B, DECODE_T,
                         device="cpu")[:len(cfg.pattern)]
    for i in range(3):
        pos = torch.full((DECODE_B,), i, dtype=torch.int64)
        got, cache = M.superblock_decode(
            blocks, cache, torch.from_numpy(ref[f"dx{i}"].copy()), pos, cfg)
        _hold(got.numpy(), ref[f"dy{i}"])


# ------------------------------------------------------------------ #
# (g) decode and the all_to_all MoE on gloo ranks
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def ranks(jobs):
    return jobs.ranks()


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_sharded_decode_matches_one_device(ranks, case):
    arch, _, _, long_ctx, b = DECODE_CASES[case]
    want = one_device_decode(arch, b, long_ctx)
    np.testing.assert_allclose(ranks[case], want, rtol=0,
                               atol=MESH_TOL * max(1.0, np.abs(want).max()))


def test_one_device_long_decode_matches_reference(jobs):
    """The one-device decode the mesh runs are held against, with
    `long_ctx`, against the reference's `decode_step` (its parameters,
    seed 3; the same tokens): f32 atol 1e-4, rtol 1e-4."""
    ref = jobs.reference_file("long")
    cfg = configs.get_smoke("qwen3_0_6b")
    assert np.array_equal(ref["tokens"], _decode_inputs(cfg, 1).numpy())
    params = params_from_jax(cfg, _unflat(ref), device="cpu")
    cache = M.init_cache(cfg, 1, DECODE_T, device="cpu")
    for i, tok in enumerate(ref["tokens"]):
        pos = torch.full((1,), i, dtype=torch.int64)
        got, cache = M.decode_step(params, cache, torch.from_numpy(tok),
                                   pos, cfg, long_ctx=True)
        np.testing.assert_allclose(got.numpy(), ref["logits"][i], **TOL)


def test_all_to_all_moe_gradients_match_grouped(ranks):
    grouped, a2a = ranks["moe"]
    assert set(grouped) == set(a2a)
    for name, want in grouped.items():
        np.testing.assert_allclose(
            a2a[name], want, rtol=0,
            atol=MESH_TOL * max(1.0, float(np.abs(want).max())),
            err_msg=name)
