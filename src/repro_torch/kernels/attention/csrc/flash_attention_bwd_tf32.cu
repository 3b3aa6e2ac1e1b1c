// GQA flash attention, backward, for Hopper (sm_90a): the gradient of K2 on
// the "tf32x3" route, f32 at every head dim (16, 32, 64, 80, 128, 256), every
// product as three TF32 products on the tensor cores.
//
// The Pallas TPU kernel `repro.kernels.attention.flash.flash_attention_pallas`
// (body `_flash_kernel`) is forward only; the reference trains through XLA's
// autodiff of its jnp attention. This file is the backward of the port's
// f32 forward (flash_attention_tf32.cu), joined to it by the autograd
// Function in ops.py. For out = softmax(q k^T * scale + mask) v over the kv
// head h / (H / KH), given dout and the forward's row log-sum-exp L:
//   D   = rowsum(dout * out)
//   P   = exp(S * scale - L),   dP = dout v^T,   dS = P * (dP - D)
//   dv  = sum over the GQA group of P^T dout
//   dk  = sum over the GQA group of dS^T q * scale
//   dq  = dS k * scale
// Masks are the forward's: a masked pair or a key past T weighs 0, and a
// row that sees no key has L = +inf, so P = 0 there.
//
// What bounds it on this card. At qwen3-0.6b's f32 training shape (q
// (8, 4096, 16, 128), k/v (8, 4096, 8, 128), causal) the backward is 2.5x
// the forward's 5.498e11 operations, 1.374e12. As three TF32 products each
// that is 3 x 1.374e12 / 495 TFLOP/s = 8.33 ms; this design recomputes S
// in both walks and dP in both (seven products where the gradient needs
// five), a floor of 11.66 ms. Its bytes (q, k, v, o, dout read, dq, dk,
// dv written: 1.07 GB) take 0.32 ms at 3.35 TB/s: operations bound it.
// The same work as f32 FMAs on the CUDA cores (flash_attention_bwd.cu) is
// bounded at 20.5 ms.
//
// Why 3xTF32: the f32 hold is 1e-4 x max(1, max|ref|) per output. Emulated
// on the CPU (causal, S 512-1,024, hd 64-256) against float64, one TF32
// product errs by 1.3-2.3e-3, 3-8x over it; 3xTF32 by 1.4-5.7e-6. Each
// operand x is split as hi = tf32(x) (cvt.rna), lo = tf32(x - hi), and a.b
// is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (small terms first), accumulated in
// f32. tests/test_torch_train.py emulates this arithmetic tile by tile.
//
// Which instruction. Every product is mma.sync m16n8k8, as in the forward:
// four of the seven products take an MN-major operand (V and q as the B of
// P.V-like sums: dV = P^T dout reads dout, dK = dS^T q reads q, dQ = dS k
// reads k), which wgmma would take as tf32 only after a split pass that
// writes transposed hi and lo planes (K3's route, ssd_intra.cu). With
// mma.sync the staged tiles stay raw f32 rows of hd + 4 floats, read
// conflict-free both ways: along hd for the K-major operands (q k^T,
// dout v^T) and down the rows for the MN-major ones; each fragment is split
// in registers as it is read. The A operands built in registers (P^T, dS^T,
// dS) come straight from the accumulators: their keys (or q rows) are
// renamed within each 8-block, logical t as physical 2t and t + 4 as
// 2t + 1, and the B fragment reads the matching rows.
//
// The tensor core's own sum is not f32's: each MMA aligns its products and
// the accumulator to the largest exponent and truncates, so a chain of MMAs
// into one accumulator errs by up to an ulp a step, all one way. Chained
// over every step of a walk, dV and dK erred linearly in S on an H100
// (4.9e-4 and 2.7e-4 at qwen3's layer, S=4,096, near the hold, where the
// CUDA-core kernel errs by 1.4e-6 and 1.2e-6; chip_smoke.py). So each step's dV, dK and dQ products
// go into a zeroed `part` (a chain of 3 x 4 MMAs) that the CUDA cores add
// to the accumulator, rounding to nearest; S and dP chain over hd only.
//
// The design: three functions with the wgmma route's roles, no atomics, the
// same bits on every call.
//  * bwd_dot: D = rowsum(dout * out) into a (B, H, S) f32 scratch, one warp
//    a row. L is the forward's (flash_attention_tf32.cu with `lse`), not
//    recomputed.
//  * bwd_dkdv: one block per (kv tile of 64 rows, kv head, batch), four
//    warps of 16 kv rows. Loops over every query head of the GQA group and
//    every 32-row q tile in q_tile_range (the exact inverse of
//    kv_tile_range), computes S^T = k q^T and dP^T = v dout^T, P^T and dS^T
//    in registers, and accumulates dV += P^T dout and dK += dS^T q: the
//    group's sum happens inside the block. At hd 256 the accumulators
//    (16 rows x 256 columns x 2 per warp, 256 registers a thread) do not
//    fit, so eight warps split hd in two halves of 128 columns, each pair
//    computing the same S^T and dP^T over the full hd (`HALVES`).
//  * bwd_dq: one block per (q tile of 64 rows, q head, batch), four warps
//    of 16 q rows. Loops over the 32-row kv tiles (16 at hd 256, where
//    dQ's 128 registers a thread leave no room for more) in
//    kv_tile_range, computes S and dP, then dS, and accumulates dQ += dS k.
//  * Tiles are staged raw with cp.async (zero-filled past S and T), one
//    buffer each, and each next tile is fetched as soon as the last
//    product that reads its buffer is done, so the copies run under the
//    other products: 101 KB at hd 128 in both walks (two blocks an SM),
//    200 KB at hd 256 (167 KB for dq). Tiles are `flash.bwd_tiles(hd,
//    "tf32x3")`: (32, 64) for dkdv, (64, 32) for dq, (64, 16) at hd 256.
// Tile ranges mirror repro_torch.kernels.attention.flash.kv_tile_range and
// q_tile_range.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KV_BQ = 32;       // dkdv: q rows per step
constexpr int KV_BKV = 64;      // dkdv: kv rows per block (4 warps x 16)
constexpr int Q_BQ = 64;        // dq: q rows per block (4 warps x 16)
// dq: kv rows per step, 16 at hd 256 (registers beside dQ's 128)
template <int HD>
__host__ __device__ constexpr int dq_kv_rows() { return HD > 128 ? 16 : 32; }
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// `rows` rows of HD floats (global row stride `lds` floats) into shared
// memory rows of LD floats; rows at or past `valid` are zero.
template <int HD, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      size_t lds, int rows, int valid) {
  constexpr int C4 = HD / 4;
  for (int idx = threadIdx.x; idx < rows * C4; idx += blockDim.x) {
    const int r = idx / C4, c = (idx - r * C4) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)r * lds + c : src, ok);
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~21 bits, both in TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The split A fragment of rows r0, r0 + 8 and columns c, c + 4 of a
// row-major shared tile (row stride LD).
template <int LD>
__device__ __forceinline__ void a_frag(const float* s, int r0, int c,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(s[r0 * LD + c], hi[0], lo[0]);
  split(s[(r0 + 8) * LD + c], hi[1], lo[1]);
  split(s[r0 * LD + c + 4], hi[2], lo[2]);
  split(s[(r0 + 8) * LD + c + 4], hi[3], lo[3]);
}

// The split A fragment of an accumulator's 8-column block `x` (c0, c1 at
// row g, columns 2t, 2t + 1; c2, c3 at row g + 8): physical column 2t is
// the fragment's k = t, 2t + 1 its k = t + 4.
__device__ __forceinline__ void acc_frag(const float (&x)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(x[0], hi[0], lo[0]);
  split(x[2], hi[1], lo[1]);
  split(x[1], hi[2], lo[2]);
  split(x[3], hi[3], lo[3]);
}

// d[n0 + i] += A . B_i in 3xTF32 for one k-step over NG n-tiles, the small
// terms for every n-tile first.
template <int NT, int NG>
__device__ __forceinline__ void mma3(float (&d)[NT][4], int n0,
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bh)[NG][2],
                                     const uint32_t (&bl)[NG][2]) {
#pragma unroll
  for (int i = 0; i < NG; ++i) mma_tf32(d[n0 + i], alo, bh[i]);
#pragma unroll
  for (int i = 0; i < NG; ++i) mma_tf32(d[n0 + i], ahi, bl[i]);
#pragma unroll
  for (int i = 0; i < NG; ++i) mma_tf32(d[n0 + i], ahi, bh[i]);
}

// d[j] += A . B_j over HD / 8 k-steps and NT n-tiles of 8 rows each: A is
// rows r0, r0 + 8 of the tile `a`, B_j rows 8j .. 8j + 7 of the tile `b`,
// both row-major along hd (K-major): S = a b^T.
template <int HD, int LD, int NT>
__device__ __forceinline__ void rows_dot(float (&d)[NT][4], const float* a,
                                         const float* b, int r0, int g,
                                         int t) {
#pragma unroll 2
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t ahi[4], alo[4], bh[NT][2], bl[NT][2];
    a_frag<LD>(a, r0, 8 * kk + t, ahi, alo);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* br = b + (8 * n + g) * LD + 8 * kk + t;
      split(br[0], bh[n][0], bl[n][0]);
      split(br[4], bh[n][1], bl[n][1]);
    }
    mma3<NT, NT>(d, 0, ahi, alo, bh, bl);
  }
}

// d += X . B over KB key blocks of 8: X in accumulator form (x[j] the 8
// columns of block j), B the tile `b`'s rows (row 8j + 2t is the renamed
// k = t, 8j + 2t + 1 k = t + 4), columns c0 + 8n + g for NT n-tiles (MN-
// major along the rows). Per group of NG n-tiles the tensor core sums the
// KB blocks into a zeroed `part`, which the CUDA cores add to d, rounding
// to nearest: no tensor-core chain (which truncates) spans two steps.
template <int LD, int KB, int NT, int NG>
__device__ __forceinline__ void acc_times_rows(float (&d)[NT][4],
                                               const float (&x)[KB][4],
                                               const float* b, int c0,
                                               int g, int t) {
  static_assert(NT % NG == 0, "whole groups of n-tiles");
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      uint32_t ahi[4], alo[4], bh[NG][2], bl[NG][2];
      acc_frag(x[j], ahi, alo);
      const float* br = b + (8 * j + 2 * t) * LD + c0 + 8 * n0 + g;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        split(br[8 * i], bh[i][0], bl[i][0]);
        split(br[LD + 8 * i], bh[i][1], bl[i][1]);
      }
      mma3<NG, NG>(part, 0, ahi, alo, bh, bl);
    }
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n0 + i][e] += part[i][e];
  }
}

__device__ __forceinline__ bool allowed(int qr, int key, int causal,
                                        int window) {
  bool ok = true;
  if (causal) ok = key <= qr;
  if (window > 0) ok = ok && key > qr - window;
  return ok;
}

// D[b, h, s] = sum_d dout[b, s, h, d] * out[b, s, h, d]: one warp a row.
__global__ void __launch_bounds__(256)
bwd_dot(const float* __restrict__ o, const float* __restrict__ dout,
        float* __restrict__ D, int rows, int S, int H, int HD) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* orow = o + (size_t)row * HD;
  const float* drow = dout + (size_t)row * HD;
  float acc = 0.f;
  for (int c = 4 * lane; c < HD; c += 128) {
    const float4 a = *reinterpret_cast<const float4*>(orow + c);
    const float4 d = *reinterpret_cast<const float4*>(drow + c);
    acc += a.x * d.x + a.y * d.y + a.z * d.z + a.w * d.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bs = row / H, s = bs % S, b = bs / S;
    D[((size_t)b * H + h) * S + s] = acc;
  }
}

// dk, dv for one kv tile of one kv head: grid (ceil(T / 64), KH, B),
// 128 x HALVES threads; warp w owns kv rows 16 (w % 4) .. + 15 and hd
// columns (w / 4) HD / HALVES .. + HD / HALVES - 1.
template <int HD, int HALVES>
__global__ void __launch_bounds__(128 * HALVES)
bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         const float* __restrict__ L, const float* __restrict__ D,
         float* __restrict__ dk, float* __restrict__ dv, int S, int Tk,
         int H, int KH, int causal, int window, float scale) {
  constexpr int LD = HD + 4;
  constexpr int COLS = HD / HALVES;
  constexpr int NC = COLS / 8;            // n-tiles of dK, dV per warp
  // n-tiles per `part` of dV and dK: 4 at hd 256 (registers)
  constexpr int NG = NC % 8 != 0 ? NC : HD > 128 ? 4 : 8;
  constexpr int NQ = KV_BQ / 8;           // q blocks per step
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // [KV_BKV][LD]
  float* Vs = Ks + KV_BKV * LD;           // [KV_BKV][LD]
  float* Qs = Vs + KV_BKV * LD;           // [KV_BQ][LD]
  float* Os = Qs + KV_BQ * LD;            // [KV_BQ][LD] dout
  float* Ls = Os + KV_BQ * LD;            // [KV_BQ] L in log2 units
  float* Ds = Ls + KV_BQ;                 // [KV_BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;     // kv rows r0, r0 + 8 of the tile
  const int c0 = (warp >> 2) * COLS;      // the warp's first hd column
  const int kj = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int k0 = kj * KV_BKV;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KH * HD;
  const float scale_log2 = scale * LOG2E;

  // q_tile_range: the q tiles whose kv_tile_range holds kv tile kj; the
  // steps are (query head of the group, q tile) pairs
  const int nq = (S + KV_BQ - 1) / KV_BQ;
  int first = 0, last = nq - 1;
  if (causal) first = k0 < S ? k0 / KV_BQ : nq;
  if (window > 0) last = min(last, (k0 + KV_BKV + window - 2) / KV_BQ);
  const int per_head = max(0, last - first + 1);
  const int steps = G * per_head;
  // step i's q tile row and its head's offsets into q / dout and L / D
  auto rows_of = [&](int i, size_t& qoff, size_t& loff) {
    const int h = kvh * G + i / per_head;
    const int q0 = (first + i % per_head) * KV_BQ;
    qoff = ((size_t)b * S + q0) * qrow + (size_t)h * HD;
    loff = ((size_t)b * H + h) * S + q0;
    return q0;
  };
  // the copies, in commit order: (k, v, dout_0), (q_0, L_0, D_0), then per
  // step dout_next (issued once dV is done with this dout) and (q, L,
  // D)_next (once dK is done with this q)
  auto fetch_dout = [&](int i) {
    size_t qoff, loff;
    const int q0 = rows_of(i, qoff, loff);
    stage<HD, LD>(Os, dout + qoff, qrow, KV_BQ, S - q0);
  };
  auto fetch_q = [&](int i) {
    size_t qoff, loff;
    const int q0 = rows_of(i, qoff, loff);
    stage<HD, LD>(Qs, q + qoff, qrow, KV_BQ, S - q0);
    if (threadIdx.x < KV_BQ) {
      const bool ok = q0 + (int)threadIdx.x < S;
      cp_async4(Ls + threadIdx.x, L + loff + (ok ? threadIdx.x : 0), ok);
    } else if (threadIdx.x < 2 * KV_BQ) {
      const int r = threadIdx.x - KV_BQ;
      const bool ok = q0 + r < S;
      cp_async4(Ds + r, D + loff + (ok ? r : 0), ok);
    }
  };
  stage<HD, LD>(Ks, k + ((size_t)b * Tk + k0) * krow + (size_t)kvh * HD,
                krow, KV_BKV, Tk - k0);
  stage<HD, LD>(Vs, v + ((size_t)b * Tk + k0) * krow + (size_t)kvh * HD,
                krow, KV_BKV, Tk - k0);
  if (steps > 0) fetch_dout(0);
  cp_commit();
  if (steps > 0) fetch_q(0);
  cp_commit();

  float dK[NC][4], dV[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    size_t qoff, loff;
    const int q0 = rows_of(i, qoff, loff);
    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
    cp_wait<1>();                         // k, v and this dout
    __syncthreads();
    rows_dot<HD, LD, NQ>(dpT, Vs, Os, r0, g, t);
    cp_wait<0>();                         // this q, L, D
    __syncthreads();
    rows_dot<HD, LD, NQ>(sT, Ks, Qs, r0, g, t);
    // P^T and dS^T: kv row r0 (+ 8 for e >= 2), q column 8n + 2t (+ 1);
    // q rows past S weigh 0
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const int key = k0 + r0 + (e < 2 ? 0 : 8);
        const float p = q0 + c < S && allowed(q0 + c, key, causal, window)
                            ? exp2f(sT[n][e] * scale_log2 - Ls[c] * LOG2E)
                            : 0.f;
        sT[n][e] = p;
        dpT[n][e] = p * (dpT[n][e] - Ds[c]);
      }
    acc_times_rows<LD, NQ, NC, NG>(dV, sT, Os, c0, g, t);
    __syncthreads();                      // every warp is done with dout
    if (i + 1 < steps) fetch_dout(i + 1);
    cp_commit();
    acc_times_rows<LD, NQ, NC, NG>(dK, dpT, Qs, c0, g, t);
    __syncthreads();                      // ... and with q, L, D
    if (i + 1 < steps) fetch_q(i + 1);
    cp_commit();
  }
  cp_wait<0>();                           // k and v, when no step ran

  float* dkb = dk + (size_t)b * Tk * krow + (size_t)kvh * HD;
  float* dvb = dv + (size_t)b * Tk * krow + (size_t)kvh * HD;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int c = c0 + 8 * n + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + r0 + 8 * half;
      if (key >= Tk) continue;
      const size_t off = (size_t)key * krow + c;
      *reinterpret_cast<float2*>(dkb + off) = make_float2(
          dK[n][2 * half] * scale, dK[n][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(dvb + off) =
          make_float2(dV[n][2 * half], dV[n][2 * half + 1]);
    }
  }
}

// dq for one q tile of one q head: grid (ceil(S / 64), H, B), 128 threads;
// warp w owns q rows 16w .. 16w + 15.
template <int HD>
__global__ void __launch_bounds__(128)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ dout,
       const float* __restrict__ L, const float* __restrict__ D,
       float* __restrict__ dq, int S, int Tk, int H, int KH, int causal,
       int window, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NO = HD / 8;              // n-tiles of dQ
  constexpr int NG = NO % 8 != 0 ? NO : 4;   // n-tiles per `part`
  constexpr int Q_BKV = dq_kv_rows<HD>();
  constexpr int NK = Q_BKV / 8;           // key blocks per step
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [Q_BQ][LD]
  float* Os = Qs + Q_BQ * LD;             // [Q_BQ][LD] dout
  float* Ks = Os + Q_BQ * LD;             // [Q_BKV][LD]
  float* Vs = Ks + Q_BKV * LD;            // [Q_BKV][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qi = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qi * Q_BQ;
  const int r0 = 16 * warp + g;
  const int qr0 = q0 + r0, qr1 = qr0 + 8;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KH * HD;
  const float scale_log2 = scale * LOG2E;
  const float* qh = q + (size_t)b * S * qrow + (size_t)h * HD;
  const float* dh = dout + (size_t)b * S * qrow + (size_t)h * HD;
  const float* kb = k + (size_t)b * Tk * krow + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * Tk * krow + (size_t)kvh * HD;

  const float* Lh = L + ((size_t)b * H + h) * S;
  const float* Dh = D + ((size_t)b * H + h) * S;
  const float l0 = qr0 < S ? Lh[qr0] * LOG2E : INFINITY;
  const float l1 = qr1 < S ? Lh[qr1] * LOG2E : INFINITY;
  const float d0 = qr0 < S ? Dh[qr0] : 0.f;
  const float d1 = qr1 < S ? Dh[qr1] : 0.f;

  // kv_tile_range at (Q_BQ, Q_BKV)
  int last = (Tk + Q_BKV - 1) / Q_BKV - 1;
  if (causal) last = min(last, (min(q0 + Q_BQ, S) - 1) / Q_BKV);
  int first = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    first = lo > 0 ? lo / Q_BKV : 0;
  }

  float dQ[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQ[n][e] = 0.f;

  // the copies, in commit order: (q, dout, v_first), k_first, then per
  // tile v_next (issued once dP is done) and k_next (once dQ is)
  stage<HD, LD>(Qs, qh + (size_t)q0 * qrow, qrow, Q_BQ, S - q0);
  stage<HD, LD>(Os, dh + (size_t)q0 * qrow, qrow, Q_BQ, S - q0);
  if (first <= last)
    stage<HD, LD>(Vs, vb + (size_t)first * Q_BKV * krow, krow, Q_BKV,
                  Tk - first * Q_BKV);
  cp_commit();
  if (first <= last)
    stage<HD, LD>(Ks, kb + (size_t)first * Q_BKV * krow, krow, Q_BKV,
                  Tk - first * Q_BKV);
  cp_commit();
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * Q_BKV;
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    cp_wait<1>();                         // q, dout and this v tile
    __syncthreads();
    rows_dot<HD, LD, NK>(dp, Os, Vs, r0, g, t);
    __syncthreads();                      // every warp is done with v
    if (kt < last)
      stage<HD, LD>(Vs, vb + (size_t)(k0 + Q_BKV) * krow, krow, Q_BKV,
                    Tk - k0 - Q_BKV);
    cp_commit();
    cp_wait<1>();                         // this k tile
    __syncthreads();
    rows_dot<HD, LD, NK>(s, Qs, Ks, r0, g, t);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const int qr = e < 2 ? qr0 : qr1;
        const float p = key < Tk && allowed(qr, key, causal, window)
                            ? exp2f(s[n][e] * scale_log2 - (e < 2 ? l0 : l1))
                            : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? d0 : d1));   // dS
      }
    acc_times_rows<LD, NK, NO, NG>(dQ, s, Ks, 0, g, t);
    __syncthreads();                      // every warp is done with k
    if (kt < last)
      stage<HD, LD>(Ks, kb + (size_t)(k0 + Q_BKV) * krow, krow, Q_BKV,
                    Tk - k0 - Q_BKV);
    cp_commit();
  }
  cp_wait<0>();                           // q and dout, when no tile ran

  float* dqb = dq + (size_t)b * S * qrow + (size_t)h * HD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = 8 * n + 2 * t;
    if (qr0 < S)
      *reinterpret_cast<float2*>(dqb + (size_t)qr0 * qrow + c) =
          make_float2(dQ[n][0] * scale, dQ[n][1] * scale);
    if (qr1 < S)
      *reinterpret_cast<float2*>(dqb + (size_t)qr1 * qrow + c) =
          make_float2(dQ[n][2] * scale, dQ[n][3] * scale);
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* L,
                   float* dq, float* dk, float* dv, float* D, int B, int S,
                   int Tk, int H, int KH, int causal, int window,
                   float scale, cudaStream_t st) {
  constexpr int HALVES = HD > 128 ? 2 : 1;
  constexpr int LD = HD + 4;
  const int rows = B * S * H;
  bwd_dot<<<(rows + 7) / 8, 256, 0, st>>>(o, dout, D, rows, S, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv =
      ((size_t)(2 * KV_BKV + 2 * KV_BQ) * LD + 2 * KV_BQ) * sizeof(float);
  err = cudaFuncSetAttribute(bwd_dkdv<HD, HALVES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dkdv<HD, HALVES>
      <<<dim3((Tk + KV_BKV - 1) / KV_BKV, KH, B), 128 * HALVES, smem_kv,
         st>>>(q, k, v, dout, L, D, dk, dv, S, Tk, H, KH, causal, window,
               scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q =
      (size_t)(2 * Q_BQ + 2 * dq_kv_rows<HD>()) * LD * sizeof(float);
  err = cudaFuncSetAttribute(
      bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  bwd_dq<HD><<<dim3((S + Q_BQ - 1) / Q_BQ, H, B), 128, smem_q, st>>>(
      q, k, v, dout, L, D, dq, S, Tk, H, KH, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B,S,H,HD); k, v, dk, dv (B,Tk,KH,HD): contiguous f32,
// 16-byte aligned. L: the forward's (B,H,S) f32 row log-sum-exp (natural
// log, +inf on a row that sees no key); D: a (B,H,S) f32 scratch. window
// <= 0: no window. The signature is that of
// flash_attention_bwd_wgmma_launch. Returns the first failing launch's
// cudaError_t (0 = success); the wrapper raises on anything else.
extern "C" int flash_attention_bwd_tf32_launch(
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
  const float *q_ = static_cast<const float*>(q),
              *k_ = static_cast<const float*>(k),
              *v_ = static_cast<const float*>(v),
              *o_ = static_cast<const float*>(o),
              *d_ = static_cast<const float*>(dout),
              *L_ = static_cast<const float*>(L);
  float *dq_ = static_cast<float*>(dq), *dk_ = static_cast<float*>(dk),
        *dv_ = static_cast<float*>(dv), *D_ = static_cast<float*>(D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return (int)launch<16>(q_, k_, v_, o_, d_, L_, dq_, dk_, dv_, D_, B, S, Tk, H, KH, causal, window, scale, st);
    case 32: return (int)launch<32>(q_, k_, v_, o_, d_, L_, dq_, dk_, dv_, D_, B, S, Tk, H, KH, causal, window, scale, st);
    case 64: return (int)launch<64>(q_, k_, v_, o_, d_, L_, dq_, dk_, dv_, D_, B, S, Tk, H, KH, causal, window, scale, st);
    case 80: return (int)launch<80>(q_, k_, v_, o_, d_, L_, dq_, dk_, dv_, D_, B, S, Tk, H, KH, causal, window, scale, st);
    case 128: return (int)launch<128>(q_, k_, v_, o_, d_, L_, dq_, dk_, dv_, D_, B, S, Tk, H, KH, causal, window, scale, st);
    case 256: return (int)launch<256>(q_, k_, v_, o_, d_, L_, dq_, dk_, dv_, D_, B, S, Tk, H, KH, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
