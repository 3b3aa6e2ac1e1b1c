// GQA flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// `repro.kernels.attention.flash.flash_attention_pallas` (body
// `_flash_kernel`): out[b, s, h] = softmax(q k^T / sqrt(hd) + mask) v over
// the kv heads h / (H / KH), with causal and/or sliding-window masking,
// an online softmax whose running (m, l, acc) stay in f32, and the output
// in q's dtype.
//
// What bounds it on this card. Causal attention at the LM prefill shape
// (qwen3-0.6b: B=4, S=4096, H=16, KH=8, hd=128, bf16) does
// 4*B*H*S^2/2*hd = 2.75e11 operations on 201 MB of q, k, v and out: it is
// bound by operations (0.278 ms at the 989 TFLOP/s bf16 tensor-core rate,
// against 0.060 ms for the bytes). This first kernel runs on the CUDA
// cores in f32 FMAs (67 TFLOP/s), so its own floor is ~4.1 ms; tensor
// cores (wgmma) and TMA are the next step.
//
// What the design does about that:
//  * Grid (q tile of 64 rows, q head, batch). The loop over kv tiles inside
//    the block takes the place of the Pallas kernel's sequential kv grid
//    axis, and visits only the tiles in [first, last] (kv_tile_range, the
//    same formula as flash.kv_tile_range in Python). Tiles wholly masked by
//    causality or the window are never loaded: ~S^2/2 (resp. S*W) work.
//    The reference's `last = qi * bq // bkv` is short when bq > bkv; here
//    last = (min(q0 + BQ, S) - 1) / BKV.
//  * The q tile is staged once, transposed, in shared memory; each kv tile
//    is staged transposed (K) and row-major (V). Every thread owns a 4x4
//    block of scores and reads its 4 q and 4 k values per depth step as
//    two float4 loads: 16 FMAs per 2 shared loads.
//  * The 16 threads of a row group reduce the row max and sum with warp
//    shuffles; P goes through shared memory for the P.V product, where
//    each thread owns 4 rows x hd/16 output columns in registers.
//  * Masked scores take the reference's -1e30 (so a fully masked row
//    behaves as in the reference); keys past T take -inf and weigh 0.
//  * Reads the (B, S, H, hd) / (B, T, KH, hd) layouts directly: no
//    transposes around the call. Dynamic shared memory above 48 KB
//    (cudaFuncSetAttribute): 80 KB at hd=80, 117 KB at hd=128, 217 KB at
//    hd=256. hd 80 (hubert-xlarge) gives each thread 5 output columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per thread block
constexpr int BKV = 64;        // key rows per kv tile
constexpr int THREADS = 256;   // 16 x 16 threads: (ty, tx)
constexpr int LDT = 64 + 4;    // row stride of the transposed tiles and P
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BKV && BQ == 64, "thread mapping assumes 64 x 64 tiles");

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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
          int KH, int causal, int window, float scale) {
  constexpr int CPT = HD / 16;        // output columns per thread
  static_assert(HD % 16 == 0, "16 threads share a row's columns");
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                   // [HD][LDT]  q tile, transposed
  float* Kt = Qt + HD * LDT;          // [HD][LDT]  k tile, transposed
  float* Vs = Kt + HD * LDT;          // [BKV][HD]  v tile
  float* Ps = Vs + BKV * HD;          // [BQ][LDT]  probabilities

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qi = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qi * BQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KH * HD;
  const T* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const T* kb = k + (size_t)b * Tk * krow + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * Tk * krow + (size_t)kvh * HD;
  T* ob = o + (size_t)b * S * qrow + (size_t)h * HD;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    Qt[d * LDT + r] = q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * qrow + d])
                                 : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[a][c] = 0.f;
  }

  int first, last;
  kv_tile_range(q0, S, Tk, causal, window, first, last);
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BKV * HD; idx += THREADS) {
      const int r = idx / HD, d = idx % HD;
      const bool in = k0 + r < Tk;
      const size_t off = (size_t)(k0 + r) * krow + d;
      Kt[d * LDT + r] = in ? to_f32(kb[off]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores: rows 4*ty + a, keys 4*tx + c of the tile
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * LDT + 4 * ty]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * LDT + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

    float rmax[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qr = q0 + 4 * ty + a;
      rmax[a] = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kr = k0 + 4 * tx + c;
        float x = s[a][c] * scale;
        bool ok = true;
        if (causal) ok = kr <= qr;
        if (window > 0) ok = ok && kr > qr - window;
        x = ok ? x : NEG_INF;
        if (kr >= Tk) x = -INFINITY;
        s[a][c] = x;
        rmax[a] = fmaxf(rmax[a], x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax[a] = fmaxf(rmax[a], __shfl_xor_sync(0xffffffffu, rmax[a], off));
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float mn = fmaxf(m[a], rmax[a]);
      const float corr = expf(m[a] - mn);
      m[a] = mn;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = expf(s[a][c] - mn);
        rs += s[a][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * corr + rs;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[a][c] *= corr;
      *reinterpret_cast<float4*>(&Ps[(4 * ty + a) * LDT + 4 * tx]) =
          make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
    }
    __syncthreads();

    // acc += P V: rows 4*ty + a, columns tx + 16*c
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = Ps[(4 * ty + a) * LDT + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vs[j * HD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(p[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qr = q0 + 4 * ty + a;
    if (qr >= S) continue;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[(size_t)qr * qrow + tx + 16 * c] = from_f32<T>(acc[a][c] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KH, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * HD * LDT + BKV * HD + BQ * LDT) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KH, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int Tk, int H, int KH,
                         int HD, int causal, int window, float scale,
                         cudaStream_t st) {
  switch (HD) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. `lse` must be
// null: this route writes no row log-sum-exp (its backward, the fma one,
// recomputes it); the signature is that of flash_attention_wgmma_launch.
// Returns the launch's cudaError_t (0 = success); the wrapper raises on
// anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int B, int S, int Tk, int H,
                                      int KH, int HD, int causal, int window,
                                      float scale, void* stream) {
  if (lse != nullptr) return (int)cudaErrorNotSupported;
  if (B <= 0 || S <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dtype<float>(q, k, v, o, B, S, Tk, H, KH, HD, causal,
                                    window, scale, st);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(q, k, v, o, B, S, Tk, H, KH, HD,
                                            causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
