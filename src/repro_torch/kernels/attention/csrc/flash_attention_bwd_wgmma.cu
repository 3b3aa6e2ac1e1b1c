// GQA flash attention, backward, on Hopper's tensor cores (sm_90a): the bf16
// route for head dims 64, 80, 128 and 256.
//
// The Pallas TPU kernel `repro.kernels.attention.flash.flash_attention_pallas`
// (body `_flash_kernel`) is forward only; the reference trains through XLA's
// autodiff of its jnp attention. This file is the gradient of the port's
// wgmma forward (flash_attention_wgmma.cu), joined to it by the autograd
// Function in ops.py; it replaces, for bf16 at hd 64/80/128/256, the
// CUDA-core backward of flash_attention_bwd.cu (which stays the route of f32
// and of bf16 at hd 16/32). For out = softmax(q k^T * scale + mask) v over
// the kv head h / (H / KH), given dout and the forward's row log-sum-exp L:
//   D   = rowsum(dout * out)                      (bwd_dot)
//   P   = exp(S * scale - L),   dP = dout v^T,   dS = P * (dP - D)
//   dv  = sum over the GQA group of P^T dout      (bwd_dkdv)
//   dk  = sum over the GQA group of dS^T q * scale
//   dq  = dS k * scale                            (bwd_dq)
// Masks are the forward's: a masked (q, key) pair and a key past T weigh 0,
// P = 0 there; a row that saw no key has L = +inf, so its P is 0 too.
//
// What bounds it on this card. At qwen3-0.6b's training shape (bf16 q
// (8, 4096, 16, 128), k/v (8, 4096, 8, 128), causal) one product of the
// backward is 2 * B * H * S^2 / 2 * hd = 2.75e11 operations. With L from
// the forward it needs 5 of them (S, dP, dV, dK, dQ), 1.374e12 operations:
// 1.39 ms at the 989 TFLOP/s bf16 tensor-core rate, far above the 0.32 ms
// its 1.07 GB of bytes take at 3.35 TB/s. This design runs 7 (S and dP
// twice: once in the kv-major walk for dK, dV and once in the q-major walk
// for dQ): its own floor is 7 x 2.75e11 = 1.92e12 operations, 1.95 ms. The
// split buys a deterministic dq without atomics; the design in which dq
// goes through f32 atomics (5 products) is a later step. At gemma3-12b's
// (hd 256, the same B, S, H, KH) every product doubles: 2.749e12 operations,
// a 2.78 ms bound and a 3.89 ms floor on the global layer; a window-1,024
// layer keeps 0.4375 of the causal pairs (1.22 ms bound, 1.70 ms floor).
//
// What the design does about that:
//  * L comes from the forward (flash_attention_wgmma.cu writes it when the
//    wrapper asks): no recompute of q k^T for it. It is stored in natural-log
//    units and turned into log2 units once per row here: P = exp2(S *
//    scale * log2(e) - L * log2(e)), the forward's own exp2 form.
//  * bwd_dot: D = rowsum(dout * out) into a (B, H, S) f32 scratch, 16-byte
//    loads, eight lanes a row. Bound by bytes (268 MB at the main shape).
//  * bwd_dkdv: one CTA per (kv tile, kv head, batch), heaviest causal kv
//    tiles first. Warpgroup 0 is the producer: one thread loads the K and
//    V tiles once, then the Q and dout tiles (64 q rows) of every query head
//    of the GQA group over q_tile_range into a two-stage TMA ring, so the
//    group's sum stays inside the CTA; warp 1 stages the tile's L (in log2
//    units, +inf past S) and D in the same stage, arriving on its "full"
//    barrier after its stores. Warpgroups 1 and 2 are consumers. At hd
//    64/80/128 the kv tile has 128 rows, 64 for each consumer, which holds
//    its rows' dK and dV (64 + 64 f32 registers a thread at hd 128):
//      S^T  = K Q^T      wgmma SS, both operands K-major (as stored)
//      dP^T = V dout^T   wgmma SS
//      dV  += P^T dout   wgmma RS: P^T packed to bf16 pairs from the S^T
//                        accumulator, which is the A-fragment layout; dout
//                        read as stored, MN-major (transpose bit)
//      dK  += dS^T Q     wgmma RS, the same way
//    L and D are per column of S^T: read from the stage in shared memory.
//    Epilogue: dK * scale and dV in bf16 into the consumer's own K and V
//    rows (swizzled), stored by TMA, which clips rows past T.
//  * bwd_dq: one CTA per (q tile, q head, batch), heaviest causal q tiles
//    first: the forward's shape. Q and dout resident, K and V tiles (64 kv
//    rows) of kv_tile_range through a two-stage TMA ring. At hd 64/80/128
//    the q tile has 128 rows, 64 for each consumer, which keeps its rows' L
//    and D in registers:
//      S  = Q K^T        wgmma SS
//      dP = dout V^T     wgmma SS
//      dQ += dS K        wgmma RS: dS in bf16 from registers, K MN-major
//  * hd 256 (gemma3-12b) splits hd across the two consumers of one 64-row
//    tile in both functions (bwd_tiles: 64 x 64 for both walks). A
//    consumer that owned 64 rows of dK and dV at hd 256 would need 128 +
//    128 f32 registers a thread, past the 255 limit, and its CTA's tiles
//    would not fit 227 KB. Here consumer c holds dK and dV (or dQ) for hd
//    columns 128c .. 128c + 127: 64 + 64 registers in bwd_dkdv, 64 in
//    bwd_dq. S^T and dP^T need the whole hd contraction, so consumer 0
//    forms S^T (S in bwd_dq) and consumer 1 dP^T (dP) at the same time,
//    each one m64n64 product over 256 columns, and they trade through
//    shared memory in fragment order (both accumulators have the same
//    thread layout): consumer 0 writes P in f32 and arrives on a named
//    barrier, consumer 1 forms dS = P (dP - D) from it, exactly as the
//    narrower tiles do, and hands dS back in bf16 pairs behind a second
//    one. Both then run their half of dV += P^T dout and dK += dS^T Q (dQ
//    += dS K) as m64n128 RS products on their own 128 columns of dout, Q
//    (K). That keeps the seven products, with no recompute: the chosen
//    design of the three that fit (a 32-row tile per warpgroup wastes half
//    of each m64 product; two CTAs per tile recompute S and dP, nine
//    products and a 5.0 ms floor at gemma3's shape). Shared memory at hd
//    256: K + V (Q + dout) 64 KB, a ring of 2 x 64 KB, the exchange 24 KB
//    (P 16 KB, dS 8 KB): 218 KB of 227 for either function.
//  * P and dS are rounded to bf16 before their products (the forward rounds
//    P the same way); every product accumulates in f32. No atomics: every
//    output element is written by one thread, the same result on every run.
//  * hd 80 (hubert-xlarge) runs in the hd-128 tile with the true 80-column
//    extent in the tensor maps, as the forward does: TMA fills columns
//    80-127 with zeros on load (they add nothing to S or dP, and dK, dV, dQ
//    are zero there) and clips them on store.
//  * Registers: the producer drops to 24 (setmaxnreg.dec), the consumers
//    rise to 240 (dK, dV, S^T and dP^T alone are 192 a thread at hd 128).
//    Shared memory at hd 128: bwd_dkdv K + V 64 KB, ring 2 x 32 KB; bwd_dq
//    Q + dout 64 KB, ring 2 x 32 KB.
// Not yet: ping-pong of the two consumers (at hd 256 each waits on the
// other once a step), a persistent grid, a deeper ring.
// Tile ranges mirror repro_torch.kernels.attention.flash.kv_tile_range and
// q_tile_range at flash.bwd_tiles(hd, "wgmma").
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 384;   // producer + two consumer warpgroups
constexpr int STAGES = 2;      // ring depth
constexpr int BOX = 64;        // bf16 columns per 128-byte swizzled box
constexpr int ROWS = 64;       // rows per box, per warpgroup, per ring step
constexpr int BOX_BYTES = ROWS * 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int NC = HD / BOX;                // boxes across hd
  static constexpr int TILE = NC * BOX_BYTES;        // 64 rows x HD, bf16
  // hd 256 splits hd across the consumers of one 64-row tile (the header);
  // the narrower head dims give each consumer 64 rows of a 128-row tile
  static constexpr bool SPLIT = HD > 128;
  static constexpr int BLOCKS = SPLIT ? 1 : 2;       // 64-row tiles owned
  // the split's exchange: P (f32) and dS (bf16), one m64n64 fragment each
  static constexpr int XP_BYTES = SPLIT ? ROWS * ROWS * 4 : 0;
  static constexpr int XCHG = SPLIT ? XP_BYTES + ROWS * ROWS * 2 : 0;
  // bwd_dkdv: K, V (BLOCKS 64-row tiles each); ring of Q + dout tiles; L, D
  static constexpr int KV_K = 0;
  static constexpr int KV_V = KV_K + BLOCKS * TILE;
  static constexpr int KV_RING = KV_V + BLOCKS * TILE;
  static constexpr int KV_LD = KV_RING + STAGES * 2 * TILE;
  static constexpr int KV_X = KV_LD + STAGES * 2 * ROWS * 4;
  static constexpr int KV_BAR = KV_X + XCHG;
  // barriers: kv_full, full[STAGES], empty[STAGES]
  static constexpr int KV_SMEM = KV_BAR + 8 * (1 + 2 * STAGES) + 1024;
  // bwd_dq: Q, dout (BLOCKS 64-row tiles each); ring of K + V tiles
  static constexpr int Q_Q = 0;
  static constexpr int Q_DO = Q_Q + BLOCKS * TILE;
  static constexpr int Q_RING = Q_DO + BLOCKS * TILE;
  static constexpr int Q_X = Q_RING + STAGES * 2 * TILE;
  static constexpr int Q_BAR = Q_X + XCHG;
  // barriers: q_full, full[STAGES], empty[STAGES]
  static constexpr int Q_SMEM = Q_BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(HD % BOX == 0, "the tile width must be a multiple of 64");
  static_assert(!SPLIT || HD == 256, "the split holds 128 columns a consumer");
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448,
                "over the 227 KB a block may use");
};

// Named barriers (0 is __syncthreads): 1 + c is consumer c's own (128
// threads) before its TMA store; the split's exchange and its end take
// both consumers (256 threads).
constexpr int BAR_P = 3, BAR_DS = 4, BAR_DONE = 5;

// ---- shared-memory barriers, TMA and wgmma, in PTX ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (64 rows of a tile stored as NC boxes of 64 x 128 B), the
// k-step kk of 16 columns: 32 bytes inside a box, every 4th to the next box.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (the same tile read as [k rows][n = hd columns]), the
// k-step kk of 16 rows (2048 B); the boxes across hd are LBO apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 2048, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
struct Wgmma;

template <> struct Wgmma<64> {
  // D (m64 x n64, f32) += A (smem, K-major) * B (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D (m64 x n64, f32) += A (registers, bf16 pairs) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  // D (m64 x n128, f32) += A (registers, bf16 pairs) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

// The kv tiles [first, last] (of BKV rows) that hold a key some row of the
// q tile at q0 (of BQ rows) may see. Mirrors flash.kv_tile_range.
template <int BQ, int BKV>
__device__ __forceinline__ void kv_tile_range(int q0, int S, int T,
                                              int causal, int window,
                                              int& first, int& last) {
  last = (T + BKV - 1) / BKV - 1;
  if (causal) last = min(last, (min(q0 + BQ, S) - 1) / BKV);
  first = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;   // the oldest key row q0 may see
    first = lo > 0 ? lo / BKV : 0;
  }
}

// The q tiles [first, last] (of BQ rows) whose kv_tile_range holds the kv
// tile at k0 (of BKV rows); empty when first > last. Mirrors
// flash.q_tile_range.
template <int BQ, int BKV>
__device__ __forceinline__ void q_tile_range(int k0, int S, int causal,
                                             int window, int& first,
                                             int& last) {
  const int nq = (S + BQ - 1) / BQ;
  first = 0;
  last = nq - 1;
  if (causal) first = k0 < S ? k0 / BQ : nq;
  if (window > 0) last = min(last, (k0 + BKV + window - 2) / BQ);
}

__device__ __forceinline__ bool allowed(int qr, int kr, int T, int causal,
                                        int window) {
  bool ok = kr < T;
  if (causal) ok = ok && kr <= qr;
  if (window > 0) ok = ok && kr > qr - window;
  return ok;
}

// A 64 x HD accumulator (this thread's rows r0 and r0 + 8 of a 64-row block,
// columns 8 jj + qc, + 1), times `mul`, in bf16 into a 64-row tile of NC
// swizzled boxes at `tile`, as TMA stores it.
template <int HD>
__device__ __forceinline__ void stage_rows(uint32_t tile,
                                           const float (&acc)[HD / 2],
                                           float mul, int warp, int lane) {
  const int r0 = 16 * warp + lane / 4;   // row in the box; r0 % 8 ==
  const int sw = lane / 4;               //   (r0 + 8) % 8 == sw
  const int qc = 2 * (lane % 4);
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    const uint32_t at = tile + (jj / 8) * BOX_BYTES + ((jj % 8) ^ sw) * 16 +
                        qc * 2;
    const uint32_t lo = pack_bf16(acc[4 * jj] * mul, acc[4 * jj + 1] * mul);
    const uint32_t hi = pack_bf16(acc[4 * jj + 2] * mul,
                                  acc[4 * jj + 3] * mul);
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + r0 * 128), "r"(lo)
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + (r0 + 8) * 128),
                 "r"(hi)
                 : "memory");
  }
}

// ---- D = rowsum(dout * out) ----
__global__ void __launch_bounds__(256)
bwd_dot(const __nv_bfloat16* __restrict__ o,
        const __nv_bfloat16* __restrict__ dout, float* __restrict__ D,
        int rows, int S, int H, int hd) {
  const int row = blockIdx.x * 32 + threadIdx.x / 8;   // (b, s, h) order
  const int sub = threadIdx.x % 8;
  float acc = 0.f;
  if (row < rows) {
    const uint4* a = reinterpret_cast<const uint4*>(o + (size_t)row * hd);
    const uint4* b = reinterpret_cast<const uint4*>(dout + (size_t)row * hd);
    for (int c = sub; c < hd / 8; c += 8) {
      const uint4 x = a[c], y = b[c];
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a bf16 is the high half of the f32 with the same bits
        acc = fmaf(__uint_as_float(xs[e] << 16), __uint_as_float(ys[e] << 16),
                   acc);
        acc = fmaf(__uint_as_float(xs[e] & 0xffff0000u),
                   __uint_as_float(ys[e] & 0xffff0000u), acc);
      }
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    D[((size_t)b * H + h) * S + s] = acc;
  }
}

// ---- dK, dV: one CTA per (kv tile of 128 rows, 64 at hd 256, kv head,
// batch) ----
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv(const __grid_constant__ CUtensorMap qmap,
         const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap,
         const __grid_constant__ CUtensorMap domap,
         const __grid_constant__ CUtensorMap dkmap,
         const __grid_constant__ CUtensorMap dvmap,
         const float* __restrict__ L, const float* __restrict__ D, int S,
         int Tk, int H, int KH, int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int NC = C::NC, TILE = C::TILE, BQ = ROWS,
                BKV = C::BLOCKS * ROWS;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 8 rows: tiles start 1024-aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base + C::KV_K, sV = base + C::KV_V;
  const uint32_t ring = base + C::KV_RING;   // stage s: Q, then dout
  float* const sLD = reinterpret_cast<float*>(gen + C::KV_LD);  // [s][L|D]
  const uint32_t kv_full = base + C::KV_BAR;
  const uint32_t full = kv_full + 8;                    // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kj = blockIdx.z;                 // heaviest causal tiles first
  const int k0 = kj * BKV, G = H / KH;
  int first, last;
  q_tile_range<BQ, BKV>(k0, S, causal, window, first, last);
  const int nsteps = last >= first ? G * (last - first + 1) : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1 + 32);      // TMA thread + L/D warp
      mbar_init(empty + 8 * s, 2 * 128);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      // one thread keeps the TMA loads in flight
      mbar_expect_tx(kv_full, 2 * C::BLOCKS * TILE);
      for (int w = 0; w < C::BLOCKS; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load(sK + w * TILE + c * BOX_BYTES, &kmap, kv_full, c * BOX,
                   kvh, k0 + ROWS * w, b);
          tma_load(sV + w * TILE + c * BOX_BYTES, &vmap, kv_full, c * BOX,
                   kvh, k0 + ROWS * w, b);
        }
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % STAGES;
        const int h = kvh * G + i / (last - first + 1);
        const int q0 = (first + i % (last - first + 1)) * BQ;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t st = ring + s * 2 * TILE;
        mbar_expect_tx(full + 8 * s, 2 * TILE);
        for (int c = 0; c < NC; ++c) {
          tma_load(st + c * BOX_BYTES, &qmap, full + 8 * s, c * BOX, h, q0, b);
          tma_load(st + TILE + c * BOX_BYTES, &domap, full + 8 * s, c * BOX,
                   h, q0, b);
        }
      }
    } else if (warp == 1) {
      // warp 1 stages each step's L (log2 units, +inf past S) and D
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % STAGES;
        const int h = kvh * G + i / (last - first + 1);
        const int q0 = (first + i % (last - first + 1)) * BQ;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const size_t row = ((size_t)b * H + h) * S;
        float* const ld = sLD + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int q = q0 + r;
          ld[r] = q < S ? L[row + q] * LOG2E : INFINITY;
          ld[BQ + r] = q < S ? D[row + q] : 0.f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else if constexpr (C::SPLIT) {
    // ---- consumer warpgroups, hd split: both on the tile's 64 kv rows;
    // consumer 0 forms S^T and P^T, consumer 1 dP^T and dS^T, and each
    // accumulates dK and dV over its own 128 columns ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int kr0 = k0 + 16 * warp + lane / 4;     // this thread's two rows
    const int kr1 = kr0 + 8;
    const int qc = 2 * (lane % 4);                 // its column in each 8
    const uint32_t half = 2 * cw * BOX_BYTES;      // its 128 columns
    const uint32_t sA = cw == 0 ? sK : sV;         // S^T = K Q^T, dP^T =
                                                   // V dout^T
    // the exchange, in fragment order: slot (group g, thread t) is 16 bytes
    float4* const xp = reinterpret_cast<float4*>(gen + C::KV_X);
    uint4* const xd = reinterpret_cast<uint4*>(gen + C::KV_X + C::XP_BYTES);
    const float scale_log2 = scale * LOG2E;

    float dk[HD / 4], dv[HD / 4];
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) dk[j] = dv[j] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int q0 = (first + i % (last - first + 1)) * BQ;
      const uint32_t sQs = ring + s * 2 * TILE, sdOs = sQs + TILE;
      mbar_wait(full + 8 * s, ph);

      // S^T (consumer 0) or dP^T (consumer 1) over all of hd: fresh
      // accumulator each step
      float acc[32];
      const uint32_t sB = cw == 0 ? sQs : sdOs;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64>::ss(acc, kmajor(sA, kk), kmajor(sB, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);

      // acc[4 g + e] is kv row (e & 2 ? kr1 : kr0), q row q0 + 8 g + qc +
      // (e & 1); the A fragment (kk, r) of the RS products below is
      // registers 8 kk + 2 r, + 1: group g = 2 kk + r / 2
      const float* const ls = sLD + s * 2 * BQ;
      const float* const ds = ls + BQ;
      uint32_t pt[4][4], dst[4][4];
      if (cw == 0) {
        const bool cut = k0 + ROWS > Tk || (causal && k0 + ROWS - 1 > q0) ||
                         (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int col = 8 * g + qc;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = exp2f(fmaf(acc[4 * g + e], scale_log2,
                              (e & 1) ? -l2.y : -l2.x));
            if (cut && !allowed(q0 + col + (e & 1), (e & 2) ? kr1 : kr0, Tk,
                                causal, window))
              p[e] = 0.f;
          }
          xp[g * 128 + t] = make_float4(p[0], p[1], p[2], p[3]);
          pt[g / 2][2 * (g % 2)] = pack_bf16(p[0], p[1]);
          pt[g / 2][2 * (g % 2) + 1] = pack_bf16(p[2], p[3]);
        }
        bar_arrive(BAR_P, 256);
        bar_sync(BAR_DS, 256);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint4 d4 = xd[kk * 128 + t];
          dst[kk][0] = d4.x;
          dst[kk][1] = d4.y;
          dst[kk][2] = d4.z;
          dst[kk][3] = d4.w;
        }
      } else {
        bar_sync(BAR_P, 256);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float4 p = xp[g * 128 + t];
          const float2 dd = *reinterpret_cast<const float2*>(ds + 8 * g + qc);
          pt[g / 2][2 * (g % 2)] = pack_bf16(p.x, p.y);
          pt[g / 2][2 * (g % 2) + 1] = pack_bf16(p.z, p.w);
          dst[g / 2][2 * (g % 2)] = pack_bf16(p.x * (acc[4 * g] - dd.x),
                                              p.y * (acc[4 * g + 1] - dd.y));
          dst[g / 2][2 * (g % 2) + 1] =
              pack_bf16(p.z * (acc[4 * g + 2] - dd.x),
                        p.w * (acc[4 * g + 3] - dd.y));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          xd[kk * 128 + t] =
              make_uint4(dst[kk][0], dst[kk][1], dst[kk][2], dst[kk][3]);
        bar_arrive(BAR_DS, 256);
      }

      // dV += P^T dout, dK += dS^T Q over this consumer's columns
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<HD / 2>::rs(dv, pt[kk], mnmajor(sdOs + half, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<HD / 2>::rs(dk, dst[kk], mnmajor(sQs + half, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty + 8 * s);
    }

    // epilogue: once both consumers are past their last read of K and V,
    // dK * scale and dV in bf16 into this consumer's columns of the K and V
    // tiles, then TMA stores
    bar_sync(BAR_DONE, 256);
    stage_rows<HD / 2>(sK + half, dk, scale, warp, lane);
    stage_rows<HD / 2>(sV + half, dv, 1.f, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(1 + cw, 128);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int box = 2 * cw + c;
        tma_store(&dkmap, sK + box * BOX_BYTES, box * BOX, kvh, k0, b);
        tma_store(&dvmap, sV + box * BOX_BYTES, box * BOX, kvh, k0, b);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  } else {
    // ---- consumer warpgroups: 64 kv rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int klo = k0 + ROWS * cw;                // this warpgroup's rows
    const int kr0 = klo + 16 * warp + lane / 4;    // this thread's two rows
    const int kr1 = kr0 + 8;
    const int qc = 2 * (lane % 4);                 // its column in each 8
    const uint32_t sKw = sK + cw * TILE, sVw = sV + cw * TILE;
    const float scale_log2 = scale * LOG2E;

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) dk[j] = dv[j] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int q0 = (first + i % (last - first + 1)) * BQ;
      const uint32_t sQs = ring + s * 2 * TILE, sdOs = sQs + TILE;
      mbar_wait(full + 8 * s, ph);

      // S^T = K Q^T and dP^T = V dout^T: A and B in shared memory, K-major;
      // fresh accumulators each step (the first k-step ignores their value),
      // so nothing of them stays live across steps
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64>::ss(st, kmajor(sKw, kk), kmajor(sQs, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64>::ss(dpt, kmajor(sVw, kk), kmajor(sdOs, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // st[j] is kv row (j & 2 ? kr1 : kr0), q row q0 + 8 (j / 4) + qc +
      // (j & 1): L and D are per column, from the stage
      const float* const ls = sLD + s * 2 * BQ;
      const float* const ds = ls + BQ;
      const bool cut = klo + ROWS > Tk || (causal && klo + ROWS - 1 > q0) ||
                       (window > 0 && klo <= q0 + BQ - 1 - window);
      uint32_t pt[4][4], dst[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 8 * kk + 2 * r;
          const int col = 8 * (j / 4) + qc;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          const float2 dd = *reinterpret_cast<const float2*>(ds + col);
          float p0 = exp2f(fmaf(st[j], scale_log2, -l2.x));
          float p1 = exp2f(fmaf(st[j + 1], scale_log2, -l2.y));
          if (cut) {
            const int kr = (r & 1) ? kr1 : kr0;
            if (!allowed(q0 + col, kr, Tk, causal, window)) p0 = 0.f;
            if (!allowed(q0 + col + 1, kr, Tk, causal, window)) p1 = 0.f;
          }
          pt[kk][r] = pack_bf16(p0, p1);
          dst[kk][r] = pack_bf16(p0 * (dpt[j] - dd.x), p1 * (dpt[j + 1] - dd.y));
        }

      // dV += P^T dout, dK += dS^T Q: A from registers, B as stored
      // ([q][hd], MN-major)
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<HD>::rs(dv, pt[kk], mnmajor(sdOs, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<HD>::rs(dk, dst[kk], mnmajor(sQs, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty + 8 * s);
    }

    // epilogue: dK * scale and dV in bf16 into this warpgroup's own K and V
    // rows (swizzled as TMA wrote them), then TMA stores
    stage_rows<HD>(sKw, dk, scale, warp, lane);
    stage_rows<HD>(sVw, dv, 1.f, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_store(&dkmap, sKw + c * BOX_BYTES, c * BOX, kvh, klo, b);
        tma_store(&dvmap, sVw + c * BOX_BYTES, c * BOX, kvh, klo, b);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// ---- dQ: one CTA per (q tile of 128 rows, 64 at hd 256, q head, batch) ----
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq(const __grid_constant__ CUtensorMap qmap,
       const __grid_constant__ CUtensorMap kmap,
       const __grid_constant__ CUtensorMap vmap,
       const __grid_constant__ CUtensorMap domap,
       const __grid_constant__ CUtensorMap dqmap,
       const float* __restrict__ L, const float* __restrict__ D, int S,
       int Tk, int H, int KH, int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int NC = C::NC, TILE = C::TILE, BQ = C::BLOCKS * ROWS,
                BKV = ROWS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + C::Q_Q, sdO = base + C::Q_DO;
  const uint32_t ring = base + C::Q_RING;    // stage s: K, then V
  const uint32_t q_full = base + C::Q_BAR;
  const uint32_t full = q_full + 8;                     // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;    // heaviest first
  const int kvh = h / (H / KH);
  int first, last;
  kv_tile_range<BQ, BKV>(q0, S, Tk, causal, window, first, last);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::BLOCKS * TILE);
      for (int w = 0; w < C::BLOCKS; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load(sQ + w * TILE + c * BOX_BYTES, &qmap, q_full, c * BOX, h,
                   q0 + ROWS * w, b);
          tma_load(sdO + w * TILE + c * BOX_BYTES, &domap, q_full, c * BOX,
                   h, q0 + ROWS * w, b);
        }
      for (int kt = first, i = 0; kt <= last; ++kt, ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t st = ring + s * 2 * TILE;
        mbar_expect_tx(full + 8 * s, 2 * TILE);
        for (int c = 0; c < NC; ++c) {
          tma_load(st + c * BOX_BYTES, &kmap, full + 8 * s, c * BOX, kvh,
                   kt * BKV, b);
          tma_load(st + TILE + c * BOX_BYTES, &vmap, full + 8 * s, c * BOX,
                   kvh, kt * BKV, b);
        }
      }
    }
  } else if constexpr (C::SPLIT) {
    // ---- consumer warpgroups, hd split: both on the tile's 64 q rows;
    // consumer 0 forms S and P, consumer 1 dP and dS, and each accumulates
    // dQ over its own 128 columns ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 16 * warp + lane / 4;    // this thread's two rows
    const int row1 = row0 + 8;
    const int qc = 2 * (lane % 4);
    const uint32_t half = 2 * cw * BOX_BYTES;      // its 128 columns
    const uint32_t sA = cw == 0 ? sQ : sdO;        // S = Q K^T, dP = dout V^T
    uint8_t* const gen = smem_raw + (base - smem_u32(smem_raw));
    float4* const xp = reinterpret_cast<float4*>(gen + C::Q_X);
    uint4* const xd = reinterpret_cast<uint4*>(gen + C::Q_X + C::XP_BYTES);
    const float scale_log2 = scale * LOG2E;
    const size_t lrow = ((size_t)b * H + h) * S;
    const float l0 = row0 < S ? L[lrow + row0] * LOG2E : INFINITY;
    const float l1 = row1 < S ? L[lrow + row1] * LOG2E : INFINITY;
    const float d0 = row0 < S ? D[lrow + row0] : 0.f;
    const float d1 = row1 < S ? D[lrow + row1] : 0.f;

    float dq[HD / 4];
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) dq[j] = 0.f;

    mbar_wait(q_full, 0);
    for (int kt = first, i = 0; kt <= last; ++kt, ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int k0 = kt * BKV;
      const uint32_t sKs = ring + s * 2 * TILE, sVs = sKs + TILE;
      mbar_wait(full + 8 * s, ph);

      // S (consumer 0) or dP (consumer 1) over all of hd
      float acc[32];
      const uint32_t sB = cw == 0 ? sKs : sVs;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64>::ss(acc, kmajor(sA, kk), kmajor(sB, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);

      // acc[4 g + e] is q row (e & 2 ? row1 : row0), key k0 + 8 g + qc +
      // (e & 1)
      uint32_t dsa[4][4];
      if (cw == 0) {
        const bool cut = k0 + BKV > Tk || (causal && k0 + BKV - 1 > q0) ||
                         (window > 0 && k0 <= q0 + ROWS - 1 - window);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = exp2f(fmaf(acc[4 * g + e], scale_log2,
                              (e & 2) ? -l1 : -l0));
            if (cut && !allowed((e & 2) ? row1 : row0, k0 + 8 * g + qc +
                                (e & 1), Tk, causal, window))
              p[e] = 0.f;
          }
          xp[g * 128 + t] = make_float4(p[0], p[1], p[2], p[3]);
        }
        bar_arrive(BAR_P, 256);
        bar_sync(BAR_DS, 256);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint4 d4 = xd[kk * 128 + t];
          dsa[kk][0] = d4.x;
          dsa[kk][1] = d4.y;
          dsa[kk][2] = d4.z;
          dsa[kk][3] = d4.w;
        }
      } else {
        bar_sync(BAR_P, 256);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float4 p = xp[g * 128 + t];
          dsa[g / 2][2 * (g % 2)] = pack_bf16(p.x * (acc[4 * g] - d0),
                                              p.y * (acc[4 * g + 1] - d0));
          dsa[g / 2][2 * (g % 2) + 1] =
              pack_bf16(p.z * (acc[4 * g + 2] - d1),
                        p.w * (acc[4 * g + 3] - d1));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          xd[kk * 128 + t] =
              make_uint4(dsa[kk][0], dsa[kk][1], dsa[kk][2], dsa[kk][3]);
        bar_arrive(BAR_DS, 256);
      }

      // dQ += dS K over this consumer's columns (K as stored, MN-major)
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<HD / 2>::rs(dq, dsa[kk], mnmajor(sKs + half, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      mbar_arrive(empty + 8 * s);
    }

    // epilogue: once both consumers are past their last read of Q and
    // dout, dQ * scale in bf16 into this consumer's columns of the Q tile,
    // then a TMA store, which clips the rows past S
    bar_sync(BAR_DONE, 256);
    stage_rows<HD / 2>(sQ + half, dq, scale, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(1 + cw, 128);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int box = 2 * cw + c;
        tma_store(&dqmap, sQ + box * BOX_BYTES, box * BOX, h, q0, b);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int rlo = q0 + ROWS * cw;                // this warpgroup's rows
    const int row0 = rlo + 16 * warp + lane / 4;   // this thread's two rows
    const int row1 = row0 + 8;
    const int qc = 2 * (lane % 4);
    const uint32_t sQw = sQ + cw * TILE, sdOw = sdO + cw * TILE;
    const float scale_log2 = scale * LOG2E;
    const size_t lrow = ((size_t)b * H + h) * S;
    const float l0 = row0 < S ? L[lrow + row0] * LOG2E : INFINITY;
    const float l1 = row1 < S ? L[lrow + row1] * LOG2E : INFINITY;
    const float d0 = row0 < S ? D[lrow + row0] : 0.f;
    const float d1 = row1 < S ? D[lrow + row1] : 0.f;

    float dq[HD / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) dq[j] = 0.f;

    mbar_wait(q_full, 0);
    for (int kt = first, i = 0; kt <= last; ++kt, ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int k0 = kt * BKV;
      const uint32_t sKs = ring + s * 2 * TILE, sVs = sKs + TILE;
      mbar_wait(full + 8 * s, ph);

      // S = Q K^T and dP = dout V^T: A and B in shared memory, K-major;
      // fresh accumulators each step
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64>::ss(sc, kmajor(sQw, kk), kmajor(sKs, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64>::ss(dp, kmajor(sdOw, kk), kmajor(sVs, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // sc[j] is q row (j & 2 ? row1 : row0), key k0 + 8 (j / 4) + qc +
      // (j & 1)
      const bool cut = k0 + BKV > Tk || (causal && k0 + BKV - 1 > rlo) ||
                       (window > 0 && k0 <= rlo + ROWS - 1 - window);
      uint32_t dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 8 * kk + 2 * r;
          const float lr = (r & 1) ? l1 : l0, dr = (r & 1) ? d1 : d0;
          float p0 = exp2f(fmaf(sc[j], scale_log2, -lr));
          float p1 = exp2f(fmaf(sc[j + 1], scale_log2, -lr));
          if (cut) {
            const int row = (r & 1) ? row1 : row0;
            const int key = k0 + 8 * (j / 4) + qc;
            if (!allowed(row, key, Tk, causal, window)) p0 = 0.f;
            if (!allowed(row, key + 1, Tk, causal, window)) p1 = 0.f;
          }
          dsa[kk][r] = pack_bf16(p0 * (dp[j] - dr), p1 * (dp[j + 1] - dr));
        }

      // dQ += dS K: A from registers, B = K as stored ([kv][hd], MN-major)
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<HD>::rs(dq, dsa[kk], mnmajor(sKs, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      mbar_arrive(empty + 8 * s);
    }

    // epilogue: dQ * scale in bf16 into this warpgroup's own Q rows, then a
    // TMA store, which clips the rows past S
    stage_rows<HD>(sQw, dq, scale, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_store(&dqmap, sQw + c * BOX_BYTES, c * BOX, h, rlo, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// ---- host side: tensor maps and the launches ----
constexpr int ERR_NO_ENCODER = 100001;   // beyond every cudaError_t value
constexpr int ERR_TENSOR_MAP = 100002;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: its entry
// point is looked up through the runtime, so the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (batch, rows, heads, hd) bf16 tensor, boxes
// of 64 hd columns x 64 rows of one head, 128-byte swizzle; out-of-bounds
// rows and columns (past hd, for a tile wider than the tensor) read as
// zeros and are not written.
int make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int rows,
             int batch) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// HD is the tile's width, hd (<= HD) the tensors' head dim.
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* L, void* dq, void* dk, void* dv,
           float* D, int B, int S, int Tk, int H, int KH, int hd, int causal,
           int window, float scale, cudaStream_t st) {
  using C = Cfg<HD>;
  CUtensorMap qm, km, vm, dom, dqm, dkm, dvm;
  int err;
  if ((err = make_map(&qm, q, hd, H, S, B))) return err;
  if ((err = make_map(&km, k, hd, KH, Tk, B))) return err;
  if ((err = make_map(&vm, v, hd, KH, Tk, B))) return err;
  if ((err = make_map(&dom, dout, hd, H, S, B))) return err;
  if ((err = make_map(&dqm, dq, hd, H, S, B))) return err;
  if ((err = make_map(&dkm, dk, hd, KH, Tk, B))) return err;
  if ((err = make_map(&dvm, dv, hd, KH, Tk, B))) return err;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::KV_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::Q_SMEM);
  if (e != cudaSuccess) return (int)e;

  const int rows = B * S * H;
  bwd_dot<<<(rows + 31) / 32, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), D, rows, S, H, hd);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  constexpr int TILE_ROWS = C::BLOCKS * ROWS;   // kv rows, q rows a CTA owns
  bwd_dkdv<HD><<<dim3(KH, B, (Tk + TILE_ROWS - 1) / TILE_ROWS), THREADS,
                 C::KV_SMEM, st>>>(qm, km, vm, dom, dkm, dvm, L, D, S, Tk, H,
                                   KH, causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bwd_dq<HD><<<dim3(H, B, (S + TILE_ROWS - 1) / TILE_ROWS), THREADS,
               C::Q_SMEM, st>>>(qm, km, vm, dom, dqm, L, D, S, Tk, H, KH,
                                causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, o, dout, dq (B,S,H,hd) and k, v, dk, dv (B,T,KH,hd), contiguous
// and 16-byte aligned; L the forward's (B,H,S) f32 row log-sum-exp (natural
// log, +inf on a row that saw no key); D a (B,H,S) f32 scratch. hd in {64,
// 80, 128, 256} (80 in the hd-128 tile). window <= 0: no window. Launches
// bwd_dot, then bwd_dkdv and bwd_dq on `stream`. Returns 0, a cudaError_t,
// or one of the tensor-map errors above; the wrapper raises on anything
// but 0.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* L, void* dq, void* dk, void* dv, void* D,
    int B, int S, int Tk, int H, int KH, int HD, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0 || H > 65535 ||
      B > 65535 || L == nullptr || D == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) %
      16)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* L_ = static_cast<const float*>(L);
  float* D_ = static_cast<float*>(D);
  switch (HD) {
    case 64: return launch<64>(q, k, v, o, dout, L_, dq, dk, dv, D_, B, S, Tk, H, KH, 64, causal, window, scale, st);
    case 80: return launch<128>(q, k, v, o, dout, L_, dq, dk, dv, D_, B, S, Tk, H, KH, 80, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, o, dout, L_, dq, dk, dv, D_, B, S, Tk, H, KH, 128, causal, window, scale, st);
    case 256: return launch<256>(q, k, v, o, dout, L_, dq, dk, dv, D_, B, S, Tk, H, KH, 256, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_wgmma_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  if (err == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
