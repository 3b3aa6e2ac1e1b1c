// GQA flash attention, backward, for Hopper (sm_90a): the gradient of K2,
// the "fma" route (f32 at every head dim, bf16 at hd 16/32); bf16 at hd
// 64/80/128/256 takes flash_attention_bwd_wgmma.cu on the tensor cores.
//
// The Pallas TPU kernel `repro.kernels.attention.flash.flash_attention_pallas`
// (body `_flash_kernel`) is forward only; the reference trains through XLA's
// autodiff of its jnp attention. This file is the backward of the port's
// forward kernels (flash_attention_wgmma.cu, flash_attention.cu), joined to
// them by the autograd Function in ops.py. For out = softmax(q k^T * scale +
// mask) v over the kv head h / (H / KH), given dout:
//   L   = row log-sum-exp of the masked, scaled scores (f32)
//   D   = rowsum(dout * out)
//   P   = exp(S * scale - L),   dP = dout v^T,   dS = P * (dP - D)
//   dv  = sum over the GQA group of P^T dout
//   dk  = sum over the GQA group of dS^T q * scale
//   dq  = dS k * scale
// Masks are the forward's: masked scores take -1e30 (weight 0 in any row
// that sees a key), keys past T weigh 0. dq, dk, dv are accumulated in f32
// and returned in the inputs' dtype (f32 or bf16).
//
// What bounds it on this card. At qwen3-0.6b's training shape (bf16 q
// (8, 4096, 16, 128), k/v (8, 4096, 8, 128), causal) the backward is 2.5x
// the forward's 5.50e11 operations, 1.37e12: 1.39 ms at the 989 TFLOP/s
// bf16 tensor-core rate (1.67 ms with the recompute of q k^T for L), far
// above the 0.2 ms its bytes take at 3.35 TB/s. This kernel runs on the
// CUDA cores in f32 FMAs (67 TFLOP/s), and recomputes S in each of its
// three functions, so its own floor is ~33 ms; the wgmma route takes bf16
// at hd 64/80/128/256.
//
// What the design does about that. Three functions, each with one role, no
// atomics, the same result on every run:
//  * bwd_prep: one block per (q tile of 64 rows, q head, batch). Recomputes
//    L over the kv tiles in kv_tile_range (max, then sum of exp, in the
//    forward's order) and D = sum_d dout * out, into a (B, H, S) f32
//    scratch. The forward kernels stay as they are.
//  * bwd_dkdv: one block per (kv tile, kv head, batch). Loops over every
//    query head of the GQA group and every q tile in q_tile_range (the
//    exact inverse of kv_tile_range), recomputes P and dS, and accumulates
//    dV += P^T dout and dK += dS^T q in registers: the group's sum happens
//    inside the block.
//  * bwd_dq: one block per (q tile, q head, batch). Loops over the kv tiles
//    in kv_tile_range and accumulates dQ += dS k in registers.
//  * Tiles are staged in shared memory as f32 rows of HD + 4 floats (bf16
//    inputs converted on load, 4 elements per load). A score tile is
//    computed by 256 threads, each owning rows 4*ty + a and columns
//    tx + 16*c, from float4 reads along hd (conflict-free at this stride).
//    The accumulations read P / dS from shared memory as broadcasts.
//  * Tiles: 64 q rows; 64 kv rows for hd <= 128, 32 for hd 256 (dkdv's
//    K, V, Q, dout tiles, P and dS: 170 KB at hd 128, 218 KB at hd 256).
// Tile ranges mirror repro_torch.kernels.attention.flash.kv_tile_range and
// q_tile_range. Rows that see no key at all (only when S > T) are outside
// what the forward and this backward agree on.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads: (ty, tx)
constexpr int BQ = 64;         // q rows per tile
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int BKV = HD > 128 ? 32 : 64;   // kv rows per tile
  static constexpr int JC = BKV / 16;              // score columns a thread
  static constexpr int CPT = HD / 16;              // hd columns a thread
  static constexpr int LDH = HD + 4;               // row stride of q/k/v/do
  static constexpr int LDS = BKV + 4;              // row stride of P, dS
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// four consecutive elements as f32 (p is 4-element aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 is the high half of the f32 with the same bits
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The kv tiles [first, last] that hold a key some row of the q tile at q0
// may see. Mirrors repro_torch.kernels.attention.flash.kv_tile_range.
template <int BKV>
__device__ __forceinline__ void kv_tile_range(int q0, int S, int T,
                                              int causal, int window,
                                              int& first, int& last) {
  last = (T + BKV - 1) / BKV - 1;
  if (causal) last = min(last, (min(q0 + BQ, S) - 1) / BKV);
  first = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    first = lo > 0 ? lo / BKV : 0;
  }
}

// The q tiles [first, last] whose kv_tile_range holds the kv tile at k0
// (empty when first > last). Mirrors flash.q_tile_range.
template <int BKV>
__device__ __forceinline__ void q_tile_range(int k0, int S, int causal,
                                             int window, int& first,
                                             int& last) {
  const int nq = (S + BQ - 1) / BQ;
  first = 0;
  last = nq - 1;
  if (causal) first = k0 < S ? k0 / BQ : nq;
  if (window > 0) last = min(last, (k0 + BKV + window - 2) / BQ);
}

// dst[r][0..HD) = src row r0 + r (row stride `stride` elements), zeros
// past `nrows`; dst rows are LDH floats apart.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int r0, int nrows,
                                          int rows) {
  constexpr int V = HD / 4;
  for (int idx = threadIdx.x; idx < rows * V; idx += THREADS) {
    const int r = idx / V, d = (idx % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < nrows) x = load4(src + (size_t)(r0 + r) * stride + d);
    *reinterpret_cast<float4*>(&dst[r * Cfg<HD>::LDH + d]) = x;
  }
}

// s[a][c] = sum_d A[4*ty + a][d] * Bt[tx + 16*c][d] (both tiles row-major,
// LDH floats a row).
template <int HD>
__device__ __forceinline__ void score_tile(float (&s)[4][Cfg<HD>::JC],
                                           const float* A, const float* Bt,
                                           int ty, int tx) {
  constexpr int JC = Cfg<HD>::JC, LDH = Cfg<HD>::LDH;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < JC; ++c) s[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[JC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(&A[(4 * ty + a) * LDH + d]);
#pragma unroll
    for (int c = 0; c < JC; ++c)
      bv[c] = *reinterpret_cast<const float4*>(&Bt[(tx + 16 * c) * LDH + d]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < JC; ++c) {
        float x = s[a][c];
        x = fmaf(av[a].x, bv[c].x, x);
        x = fmaf(av[a].y, bv[c].y, x);
        x = fmaf(av[a].z, bv[c].z, x);
        x = fmaf(av[a].w, bv[c].w, x);
        s[a][c] = x;
      }
  }
}

// The forward's masked, scaled score: -1e30 where the mask forbids the key,
// -inf for keys past T.
__device__ __forceinline__ float masked(float s, float scale, int qr, int kr,
                                        int T, int causal, int window) {
  bool ok = true;
  if (causal) ok = kr <= qr;
  if (window > 0) ok = ok && kr > qr - window;
  float x = ok ? s * scale : NEG_INF;
  return kr < T ? x : -INFINITY;
}

// From the score tiles s (q k^T) and dp (dout v^T) of the q tile at q0 and
// the kv tile at k0: P and dS = P * (dP - D) into Ps / dSs [BQ][LDS]
// (dSs only when Ps is null). Ls / Ds hold the tile's rows' L and D.
template <int HD>
__device__ __forceinline__ void p_ds_tile(
    const float (&s)[4][Cfg<HD>::JC], const float (&dp)[4][Cfg<HD>::JC],
    const float* Ls, const float* Ds, float* Ps, float* dSs, int q0, int k0,
    int S, int T, int causal, int window, float scale, int ty, int tx) {
  constexpr int JC = Cfg<HD>::JC, LDS = Cfg<HD>::LDS;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = 4 * ty + a, qr = q0 + i;
#pragma unroll
    for (int c = 0; c < JC; ++c) {
      const int j = tx + 16 * c, kr = k0 + j;
      float p = 0.f;
      if (qr < S && kr < T)
        p = expf(masked(s[a][c], scale, qr, kr, T, causal, window) - Ls[i]);
      if (Ps) Ps[i * LDS + j] = p;
      dSs[i * LDS + j] = p * (dp[a][c] - Ds[i]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bwd_prep(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ o, const T* __restrict__ dout,
         float* __restrict__ L, float* __restrict__ D, int S, int Tk, int H,
         int KH, int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int BKV = C::BKV, JC = C::JC, CPT = C::CPT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [BQ][LDH]
  float* Ks = Qs + BQ * C::LDH;       // [BKV][LDH]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH), q0 = qi * BQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KH * HD;
  const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
  const T* kb = k + (size_t)b * Tk * krow + (size_t)kvh * HD;
  float* Lb = L + ((size_t)b * H + h) * S;
  float* Db = D + ((size_t)b * H + h) * S;

  // D = rowsum(dout * out): rows 4*ty + a, 16 threads a row
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qr = q0 + 4 * ty + a;
    float acc = 0.f;
    if (qr < S) {
      const size_t off = qoff + (size_t)qr * qrow;
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        acc = fmaf(to_f32(dout[off + tx + 16 * e]),
                   to_f32(o[off + tx + 16 * e]), acc);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (qr < S && tx == 0) Db[qr] = acc;
  }

  load_tile<T, HD>(Qs, q + qoff, qrow, q0, S, BQ);
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
  }
  int first, last;
  kv_tile_range<BKV>(q0, S, Tk, causal, window, first, last);
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, HD>(Ks, kb, krow, k0, Tk, BKV);
    __syncthreads();
    float s[4][JC];
    score_tile<HD>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qr = q0 + 4 * ty + a;
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < JC; ++c) {
        s[a][c] = masked(s[a][c], scale, qr, k0 + tx + 16 * c, Tk, causal,
                         window);
        rmax = fmaxf(rmax, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float mn = fmaxf(m[a], rmax);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < JC; ++c) rs += expf(s[a][c] - mn);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * expf(m[a] - mn) + rs;
      m[a] = mn;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qr = q0 + 4 * ty + a;
    // a row that saw no key keeps out = 0 in the forward: P = 0 here
    if (qr < S && tx == 0) Lb[qr] = l[a] > 0.f ? m[a] + logf(l[a]) : INFINITY;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ L, const float* __restrict__ D,
         T* __restrict__ dk, T* __restrict__ dv, int S, int Tk, int H,
         int KH, int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int BKV = C::BKV, JC = C::JC, CPT = C::CPT, LDH = C::LDH,
                LDS = C::LDS;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // [BKV][LDH]
  float* Vs = Ks + BKV * LDH;         // [BKV][LDH]
  float* Qs = Vs + BKV * LDH;         // [BQ][LDH]
  float* dOs = Qs + BQ * LDH;         // [BQ][LDH]
  float* Ps = dOs + BQ * LDH;         // [BQ][LDS]
  float* dSs = Ps + BQ * LDS;         // [BQ][LDS]
  float* Ls = dSs + BQ * LDS;         // [BQ]
  float* Ds = Ls + BQ;                // [BQ]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kj = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, k0 = kj * BKV;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KH * HD;
  const size_t koff = (size_t)b * Tk * krow + (size_t)kvh * HD;

  load_tile<T, HD>(Ks, k + koff, krow, k0, Tk, BKV);
  load_tile<T, HD>(Vs, v + koff, krow, k0, Tk, BKV);

  // dK, dV rows JC*ty + a of the tile, columns tx + 16*e
  float dK[JC][CPT], dV[JC][CPT];
#pragma unroll
  for (int a = 0; a < JC; ++a)
#pragma unroll
    for (int e = 0; e < CPT; ++e) dK[a][e] = dV[a][e] = 0.f;

  int first, last;
  q_tile_range<BKV>(k0, S, causal, window, first, last);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
    const float* Lb = L + ((size_t)b * H + h) * S;
    const float* Db = D + ((size_t)b * H + h) * S;
    for (int qi = first; qi <= last; ++qi) {
      const int q0 = qi * BQ;
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, HD>(Qs, q + qoff, qrow, q0, S, BQ);
      load_tile<T, HD>(dOs, dout + qoff, qrow, q0, S, BQ);
      if (tid < BQ) {
        Ls[tid] = q0 + tid < S ? Lb[q0 + tid] : 0.f;
        Ds[tid] = q0 + tid < S ? Db[q0 + tid] : 0.f;
      }
      __syncthreads();
      {
        float s[4][JC], dp[4][JC];
        score_tile<HD>(s, Qs, Ks, ty, tx);
        score_tile<HD>(dp, dOs, Vs, ty, tx);
        p_ds_tile<HD>(s, dp, Ls, Ds, Ps, dSs, q0, k0, S, Tk, causal, window,
                      scale, ty, tx);
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pv[JC], dsv[JC];
#pragma unroll
        for (int a = 0; a < JC; ++a) {
          pv[a] = Ps[i * LDS + JC * ty + a];
          dsv[a] = dSs[i * LDS + JC * ty + a];
        }
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          const float dov = dOs[i * LDH + tx + 16 * e];
          const float qv = Qs[i * LDH + tx + 16 * e];
#pragma unroll
          for (int a = 0; a < JC; ++a) {
            dV[a][e] = fmaf(pv[a], dov, dV[a][e]);
            dK[a][e] = fmaf(dsv[a], qv, dK[a][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < JC; ++a) {
    const int kr = k0 + JC * ty + a;
    if (kr >= Tk) continue;
    const size_t off = koff + (size_t)kr * krow;
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      dk[off + tx + 16 * e] = from_f32<T>(dK[a][e] * scale);
      dv[off + tx + 16 * e] = from_f32<T>(dV[a][e]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ L, const float* __restrict__ D,
       T* __restrict__ dq, int S, int Tk, int H, int KH, int causal,
       int window, float scale) {
  using C = Cfg<HD>;
  constexpr int BKV = C::BKV, JC = C::JC, CPT = C::CPT, LDH = C::LDH,
                LDS = C::LDS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [BQ][LDH]
  float* dOs = Qs + BQ * LDH;         // [BQ][LDH]
  float* Ks = dOs + BQ * LDH;         // [BKV][LDH]
  float* Vs = Ks + BKV * LDH;         // [BKV][LDH]
  float* dSs = Vs + BKV * LDH;        // [BQ][LDS]
  float* Ls = dSs + BQ * LDS;         // [BQ]
  float* Ds = Ls + BQ;                // [BQ]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qi = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH), q0 = qi * BQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KH * HD;
  const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
  const size_t koff = (size_t)b * Tk * krow + (size_t)kvh * HD;
  const float* Lb = L + ((size_t)b * H + h) * S;
  const float* Db = D + ((size_t)b * H + h) * S;

  load_tile<T, HD>(Qs, q + qoff, qrow, q0, S, BQ);
  load_tile<T, HD>(dOs, dout + qoff, qrow, q0, S, BQ);
  if (tid < BQ) {
    Ls[tid] = q0 + tid < S ? Lb[q0 + tid] : 0.f;
    Ds[tid] = q0 + tid < S ? Db[q0 + tid] : 0.f;
  }

  // dQ rows 4*ty + a, columns tx + 16*e
  float dQ[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < CPT; ++e) dQ[a][e] = 0.f;

  int first, last;
  kv_tile_range<BKV>(q0, S, Tk, causal, window, first, last);
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, HD>(Ks, k + koff, krow, k0, Tk, BKV);
    load_tile<T, HD>(Vs, v + koff, krow, k0, Tk, BKV);
    __syncthreads();
    {
      float s[4][JC], dp[4][JC];
      score_tile<HD>(s, Qs, Ks, ty, tx);
      score_tile<HD>(dp, dOs, Vs, ty, tx);
      p_ds_tile<HD>(s, dp, Ls, Ds, nullptr, dSs, q0, k0, S, Tk, causal,
                    window, scale, ty, tx);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BKV; ++j) {
      float dsv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = dSs[(4 * ty + a) * LDS + j];
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        const float kv = Ks[j * LDH + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a) dQ[a][e] = fmaf(dsv[a], kv, dQ[a][e]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qr = q0 + 4 * ty + a;
    if (qr >= S) continue;
    const size_t off = qoff + (size_t)qr * qrow;
#pragma unroll
    for (int e = 0; e < CPT; ++e)
      dq[off + tx + 16 * e] = from_f32<T>(dQ[a][e] * scale);
  }
}

template <typename F>
cudaError_t set_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* L, float* D, int B, int S, int Tk, int H,
                   int KH, int causal, int window, float scale,
                   cudaStream_t st) {
  using C = Cfg<HD>;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* do_ = static_cast<const T*>(dout);
  const int nq = (S + BQ - 1) / BQ, nk = (Tk + C::BKV - 1) / C::BKV;

  const size_t prep_smem = (size_t)(BQ + C::BKV) * C::LDH * sizeof(float);
  const size_t dkdv_smem = ((size_t)(2 * C::BKV + 2 * BQ) * C::LDH +
                            2 * BQ * C::LDS + 2 * BQ) * sizeof(float);
  const size_t dq_smem = ((size_t)(2 * BQ + 2 * C::BKV) * C::LDH +
                          BQ * C::LDS + 2 * BQ) * sizeof(float);
  cudaError_t err = set_smem(bwd_prep<T, HD>, prep_smem);
  if (err == cudaSuccess) err = set_smem(bwd_dkdv<T, HD>, dkdv_smem);
  if (err == cudaSuccess) err = set_smem(bwd_dq<T, HD>, dq_smem);
  if (err != cudaSuccess) return err;

  bwd_prep<T, HD><<<dim3(nq, H, B), THREADS, prep_smem, st>>>(
      q_, k_, o_, do_, L, D, S, Tk, H, KH, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkdv<T, HD><<<dim3(nk, KH, B), THREADS, dkdv_smem, st>>>(
      q_, k_, v_, do_, L, D, static_cast<T*>(dk), static_cast<T*>(dv), S,
      Tk, H, KH, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq<T, HD><<<dim3(nq, H, B), THREADS, dq_smem, st>>>(
      q_, k_, v_, do_, L, D, static_cast<T*>(dq), S, Tk, H, KH, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, void* dq, void* dk,
                         void* dv, float* L, float* D, int B, int S, int Tk,
                         int H, int KH, int HD, int causal, int window,
                         float scale, cudaStream_t st) {
#define FA_BWD_CASE(N)                                                     \
  case N:                                                                  \
    return launch<T, N>(q, k, v, o, dout, dq, dk, dv, L, D, B, S, Tk, H,   \
                        KH, causal, window, scale, st);
  switch (HD) {
    FA_BWD_CASE(16)
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(80)
    FA_BWD_CASE(128)
    FA_BWD_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef FA_BWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. L and D are
// (B, H, S) f32 scratch. Launches bwd_prep, then bwd_dkdv and bwd_dq on
// `stream`. Returns the first cudaError_t (0 = success); the wrapper raises
// on anything else.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* L, void* D,
    int dtype, int B, int S, int Tk, int H, int KH, int HD, int causal,
    int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* L_ = static_cast<float*>(L);
  float* D_ = static_cast<float*>(D);
  if (dtype == 0)
    return (int)launch_dtype<float>(q, k, v, o, dout, dq, dk, dv, L_, D_, B,
                                    S, Tk, H, KH, HD, causal, window, scale,
                                    st);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, L_,
                                            D_, B, S, Tk, H, KH, HD, causal,
                                            window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
