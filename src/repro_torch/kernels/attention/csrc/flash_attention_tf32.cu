// GQA flash attention, forward, for Hopper (sm_90a): the "tf32x3" route,
// f32 at every head dim (16, 32, 64, 80, 128, 256) on the tensor cores.
//
// Replaces the Pallas TPU kernel
// `repro.kernels.attention.flash.flash_attention_pallas` (body
// `_flash_kernel`) for f32 inputs: out[b, s, h] = softmax(q k^T / sqrt(hd)
// + mask) v over the kv head h / (H / KH), with causal and/or
// sliding-window masking, an f32 online softmax, and, when the caller
// passes `lse`, the row log-sum-exp L that the backward
// (flash_attention_bwd_tf32.cu) takes.
//
// What bounds it on this card. Causal attention at qwen3-0.6b's f32
// prefill shape (B=4, S=4096, H=16, KH=8, hd=128) does 4*B*H*S^2/2*hd =
// 2.749e11 operations on 402,653,184 bytes of q, k, v and out. Each
// product runs as three TF32 products (below), so the bound is
// max(3 x 2.749e11 / 495 TFLOP/s = 1.666 ms, 402,653,184 B / 3.35 TB/s =
// 0.120 ms): operations. The same work as f32 FMAs on the CUDA cores
// (flash_attention.cu, the "fma" route) is bounded at 4.10 ms.
//
// Why 3xTF32 and not one TF32 product. The f32 route is held against
// `attention_ref` at atol 2e-5. Emulated on the CPU (causal, S 512-1,024,
// hd 64-256, normal q/k/v) against float64, one TF32 product per multiply
// errs by 1.2-1.7e-3, 60-85x over that; 3xTF32 by 0.8-1.8e-6. So each
// operand x is split as hi = tf32(x) (cvt.rna, 10 mantissa bits) and
// lo = tf32(x - hi), and a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// (the small terms first), accumulated in f32 by the tensor core.
// tests/test_torch_lm_kernels.py emulates this arithmetic tile by tile.
//
// Which instruction. Every product is mma.sync m16n8k8 (tf32 in, f32
// accumulate), each warp owning 16 q rows. wgmma would take tf32 operands
// from shared memory only K-major and in its core-matrix layout, so K and
// V would need split and rearranged copies (hi and lo planes: 64 KB per
// 64-row tile at hd 128, 128 KB at hd 256) beside the staged q tile; with
// mma.sync the tiles stay raw f32 rows in shared memory (hd + 4 floats a
// row, conflict-free for the fragment reads below) and each fragment is
// split in registers as it is read: 3 ALU instructions per value against
// 3 MMAs per 2 B values. hd 16/32/80 need no special tile: m16n8k8 works
// in 8-column steps.
//
// The design:
//  * Grid (q tile of 64 rows, q head, batch), 4 warps of 16 rows, longest
//    causal rows first. At hd 256 the output (16 x 256 f32 a warp, 128
//    registers a thread) would spill, so eight warps split hd in two
//    halves of 128 columns, each pair computing the same S over the full
//    hd (`HALVES`; S is half the work, so hd 256 does 1.5x). The loop over
//    kv tiles of 64 rows takes the place of the
//    Pallas kernel's sequential kv grid axis and visits only the tiles in
//    [first, last] (kv_tile_range, the same formula as
//    flash.kv_tile_range in Python).
//  * q, k, v tiles are staged raw with cp.async (zero-filled past S and
//    T), one buffer each, and the copies run under the products: the next
//    k tile is fetched as soon as every warp has its S = q k^T (it lands
//    during the softmax and P.V), the next v tile as soon as P.V is done
//    (it lands during the next S). 3 x 64 x (hd + 4) floats: 101 KB at
//    hd 128 (two blocks an SM), 200 KB at hd 256.
//  * S = q k^T: A is the warp's 16 q rows (split per k-step of 8), B the
//    k tile's rows; 8 n-tiles of 8 keys, three MMAs each per k-step, the
//    small terms for all n-tiles before the large ones so that 8
//    independent accumulators keep the tensor core busy.
//  * The online softmax runs on the S accumulator in registers, in log2
//    units (exp2f, log2(e) folded into the scale): four threads share a
//    row (quad shuffles). Masked scores take the reference's -1e30 (so a
//    row whose visited keys are all masked weighs them alike, as in the
//    reference and the other routes); keys past T take -inf and weigh 0.
//  * P.V without a trip through shared memory: the S accumulator holds
//    P[g][2t], P[g][2t+1] of each 8-key block, while the m16n8k8 A
//    fragment wants k = t and t + 4. Since P.V sums over the keys, the
//    kernel renames them: logical key t is physical 2t, t + 4 is 2t + 1,
//    and the B fragment reads V's rows 2t and 2t + 1 to match.
//  * The tensor core's own sum is not f32's: each MMA aligns its products
//    and the accumulator to the largest exponent and truncates, so a
//    chain of MMAs into one accumulator errs by up to an ulp a step, all
//    one way: chained over every tile, such sums erred linearly in S on an
//    H100 (the backward's dV by 4.9e-4 at S=4,096, where the CUDA-core
//    kernel errs by 1.4e-6; chip_smoke.py). So each tile's P.V goes into
//    a zeroed `part` (a chain of 3 x 8 MMAs) that the CUDA cores add to
//    the running output, rounding to nearest; S = q k^T chains over hd
//    only (at most 3 x 32 MMAs).
//  * Epilogue: O / max(l, 1e-30) in f32; with `lse`, one thread of each
//    quad writes L = (m + log2 l) ln 2 of its two rows, +inf on a row that
//    saw no key (m never rose above the -1e30 mask), as the wgmma forward
//    does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block: 4 row groups x 16
constexpr int BKV = 64;         // kv rows per tile
constexpr int NS = BKV / 8;     // its n-tiles of 8 keys
constexpr float NEG_BIG = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

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

// d[n0 + i] += A . B_i in 3xTF32 for one k-step over NG n-tiles: the small
// terms for every n-tile first, so that NG independent accumulators keep
// the tensor core busy instead of one dependent chain of three.
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

// The kv tiles [first, last] that hold a key some row of the q tile at
// q0 may see. Mirrors repro_torch.kernels.attention.flash.kv_tile_range.
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

// Grid (q tile, q head, batch), 128 x HALVES threads: warp w owns q rows
// 16 (w % 4) .. + 15 and output columns (w / 4) HD / HALVES .. + HD /
// HALVES - 1, and computes its rows' S over the whole hd.
template <int HD, int HALVES>
__global__ void __launch_bounds__(128 * HALVES)
fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ o,
         float* __restrict__ lse, int S, int Tk, int H, int KH, int causal,
         int window, float scale_log2) {
  constexpr int LD = HD + 4;        // row stride of the staged tiles
  constexpr int COLS = HD / HALVES;
  constexpr int NO = COLS / 8;      // n-tiles of the warp's output columns
  // n-tiles per P.V `part`: 4 at hd 256, where 8 spills (registers)
  constexpr int NG = NO % 8 != 0 ? NO : HD > 128 ? 4 : 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* Ks = Qs + BQ * LD;         // [BKV][LD]
  float* Vs = Ks + BKV * LD;        // [BKV][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qi = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qi * BQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KH * HD;
  const float* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const float* kb = k + (size_t)b * Tk * krow + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * Tk * krow + (size_t)kvh * HD;

  const int r0 = 16 * (warp & 3) + g;   // tile rows r0 and r0 + 8
  const int c0 = (warp >> 2) * COLS;    // the warp's first output column
  const int qr0 = q0 + r0, qr1 = qr0 + 8;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int first, last;
  kv_tile_range(q0, S, Tk, causal, window, first, last);
  // copies in flight, in commit order: (q, k_first), v_first, then per
  // tile k_next (issued once S is computed) and v_next (once P.V is)
  stage<HD, LD>(Qs, qb + (size_t)q0 * qrow, qrow, BQ, S - q0);
  if (first <= last)
    stage<HD, LD>(Ks, kb + (size_t)first * BKV * krow, krow, BKV,
                  Tk - first * BKV);
  cp_commit();
  if (first <= last)
    stage<HD, LD>(Vs, vb + (size_t)first * BKV * krow, krow, BKV,
                  Tk - first * BKV);
  cp_commit();
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * BKV;
    cp_wait<1>();                   // q and this k tile have landed
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t ahi[4], alo[4], bh[NS][2], bl[NS][2];
      a_frag<LD>(Qs, r0, 8 * kk + t, ahi, alo);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* kr = Ks + (8 * n + g) * LD + 8 * kk + t;
        split(kr[0], bh[n][0], bl[n][0]);
        split(kr[4], bh[n][1], bl[n][1]);
      }
      mma3<NS, NS>(s, 0, ahi, alo, bh, bl);
    }
    __syncthreads();                // every warp is done with this k tile
    if (kt < last)
      stage<HD, LD>(Ks, kb + (size_t)(k0 + BKV) * krow, krow, BKV,
                    Tk - k0 - BKV);
    cp_commit();                    // (empty after the last tile)

    // masks and the online softmax, in log2 units
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = e < 2 ? qr0 : qr1;
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        bool ok = true;
        if (causal) ok = key <= qr;
        if (window > 0) ok = ok && key > qr - window;
        float x = ok ? s[n][e] * scale_log2 : NEG_BIG;
        if (key >= Tk) x = -INFINITY;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float cr0 = exp2f(m0 - mn0), cr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * cr0 + rs0;
    l1 = l1 * cr1 + rs1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= cr0;
      acc[n][1] *= cr0;
      acc[n][2] *= cr1;
      acc[n][3] *= cr1;
    }

    cp_wait<1>();                   // this v tile has landed
    __syncthreads();
    // acc += P V, per group of NG output n-tiles: the tile's NS key blocks
    // are summed by the tensor core into a zeroed `part`, which the CUDA
    // cores then add to acc (no tensor-core chain spans two tiles). Key 2t
    // of a block is the fragment's k = t, key 2t + 1 its k = t + 4.
    // Unrolled: s stays in registers.
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NG) {
      float part[NG][4];
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t ahi[4], alo[4], bh[NG][2], bl[NG][2];
        split(s[j][0], ahi[0], alo[0]);
        split(s[j][2], ahi[1], alo[1]);
        split(s[j][1], ahi[2], alo[2]);
        split(s[j][3], ahi[3], alo[3]);
        const float* vr = Vs + (8 * j + 2 * t) * LD + c0 + 8 * n0 + g;
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          split(vr[8 * i], bh[i][0], bl[i][0]);
          split(vr[LD + 8 * i], bh[i][1], bl[i][1]);
        }
        mma3<NG, NG>(part, 0, ahi, alo, bh, bl);
      }
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + i][e] += part[i][e];
    }
    __syncthreads();                // every warp is done with this v tile
    if (kt < last)
      stage<HD, LD>(Vs, vb + (size_t)(k0 + BKV) * krow, krow, BKV,
                    Tk - k0 - BKV);
    cp_commit();
  }
  cp_wait<0>();                     // q's copy, when no tile was visited

  float* ob = o + (size_t)b * S * qrow + (size_t)h * HD;
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    if (qr0 < S)
      *reinterpret_cast<float2*>(ob + (size_t)qr0 * qrow + c) =
          make_float2(acc[n][0] * i0, acc[n][1] * i0);
    if (qr1 < S)
      *reinterpret_cast<float2*>(ob + (size_t)qr1 * qrow + c) =
          make_float2(acc[n][2] * i1, acc[n][3] * i1);
  }
  if (lse != nullptr && t == 0 && c0 == 0) {
    float* lrow = lse + ((size_t)b * H + h) * S;
    if (qr0 < S)
      lrow[qr0] = m0 > NEG_BIG ? (m0 + log2f(l0)) * LN2 : INFINITY;
    if (qr1 < S)
      lrow[qr1] = m1 > NEG_BIG ? (m1 + log2f(l1)) * LN2 : INFINITY;
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int S, int Tk, int H, int KH,
                   int causal, int window, float scale, cudaStream_t st) {
  constexpr int HALVES = HD > 128 ? 2 : 1;
  const size_t smem = (size_t)(BQ + 2 * BKV) * (HD + 4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tf32<HD, HALVES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  fwd_tf32<HD, HALVES><<<grid, 128 * HALVES, smem, st>>>(
      q, k, v, o, lse, S, Tk, H, KH, causal, window,
      scale * 1.4426950408889634f);   // log2(e): the softmax runs in exp2
  return cudaGetLastError();
}

}  // namespace

// q (B,S,H,HD), k/v (B,Tk,KH,HD), o (B,S,H,HD): contiguous f32, 16-byte
// aligned; lse null, or a contiguous (B,H,S) f32 output for the row
// log-sum-exp (natural log; +inf on a row that saw no key). dtype must be
// 0 (float32). window <= 0: no window. The signature is that of
// flash_attention_launch. Returns the launch's cudaError_t (0 = success);
// the wrapper raises on anything else.
extern "C" int flash_attention_tf32_launch(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int dtype, int B, int S, int Tk,
                                           int H, int KH, int HD, int causal,
                                           int window, float scale,
                                           void* stream) {
  if (dtype != 0 || B <= 0 || S <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const float *q_ = static_cast<const float*>(q),
              *k_ = static_cast<const float*>(k),
              *v_ = static_cast<const float*>(v);
  float *o_ = static_cast<float*>(o), *l_ = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return (int)launch<16>(q_, k_, v_, o_, l_, B, S, Tk, H, KH, causal, window, scale, st);
    case 32: return (int)launch<32>(q_, k_, v_, o_, l_, B, S, Tk, H, KH, causal, window, scale, st);
    case 64: return (int)launch<64>(q_, k_, v_, o_, l_, B, S, Tk, H, KH, causal, window, scale, st);
    case 80: return (int)launch<80>(q_, k_, v_, o_, l_, B, S, Tk, H, KH, causal, window, scale, st);
    case 128: return (int)launch<128>(q_, k_, v_, o_, l_, B, S, Tk, H, KH, causal, window, scale, st);
    case 256: return (int)launch<256>(q_, k_, v_, o_, l_, B, S, Tk, H, KH, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
