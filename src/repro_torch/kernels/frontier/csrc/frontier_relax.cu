// Frontier-masked semiring relaxation step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `frontier_relax_pallas`
// (src/repro/kernels/frontier/frontier.py, body `_make_relax_kernel`).
// For query b and destination tile t it computes
//
//     out[b, t] = carry[b, t] ⊕ ⊕_{i : bdst[i] = t} sv[b, bsrc[i]] ⊗ W[i]
//
// with W[i][s][v] the ⊗ operand of source lane s -> destination lane v,
// absent edges holding the ⊕-identity. At feature width d > 1 the state
// carries a trailing (T, d) slab and each block is a (T, T) x (T, d)
// contraction.
//
// What bounds it: the bytes of the weight blocks it streams. A block is
// T*T*4 B (64 KiB at T = 128) and is used for B*d lanes per destination,
// so at the main path's widths (B <= 8, d <= 8) the arithmetic per byte
// is far below the card's fp32 ridge point.
//
// What the design does about it:
//   * One thread block per (destination tile, chunk of QB queries,
//     slab of FD features) walks its own segment dst_start[t] ..
//     dst_start[t+1] of the (bdst, bsrc)-sorted block list. No atomics,
//     no dependence on block order, and every output is written exactly
//     once as carry ⊕ acc -- a tile no block writes gets its carry.
//   * Before a weight block is read, the chunk's source slabs are staged
//     in shared memory and the packet-trigger rule is tested there: a
//     query whose source tile is all ⊕-identity skips the block, and
//     when no query of the chunk is active the block never leaves HBM.
//     This is exact (the ⊕-identity annihilates ⊗) and replaces the
//     reference's compaction pre-pass and sentinel block.
//   * Each weight element is loaded once per thread block (coalesced:
//     thread v reads column v of row s) and reused from a register for
//     all QB x FD accumulators of the chunk.
//   * The accumulators live in registers; the semiring is a template
//     parameter. No fast-math: min/max results are bit-equal to the
//     plain PyTorch version, (+, x) differs only in summation order.
//   * ⊕ and ⊗ of the min/max semirings are the PTX `min.NaN.f32` /
//     `max.NaN.f32` (one instruction each, sm_80+), which return NaN
//     when either operand is NaN, as torch.minimum / jnp.minimum do.
//     fminf/fmaxf would drop a NaN operand, so a poisoned weight block
//     would read as a missing edge and the serving layer's NaN guard
//     would never trip. The packet trigger `x != zero` counts a NaN
//     lane as active, as the plain version does.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

enum Op { kMinPlus = 0, kMaxMin = 1, kOrAnd = 2, kPlusTimes = 3 };

// IEEE min/max that propagate NaN (fminf/fmaxf return the other operand)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <int OP> struct Semiring;

template <> struct Semiring<kMinPlus> {
  static __device__ __forceinline__ float zero() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float add(float a, float b) { return min_nan(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return a + b; }
};

template <> struct Semiring<kMaxMin> {
  static __device__ __forceinline__ float zero() { return __int_as_float(0xff800000); }
  static __device__ __forceinline__ float add(float a, float b) { return max_nan(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return min_nan(a, b); }
};

template <> struct Semiring<kOrAnd> {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) { return max_nan(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return min_nan(a, b); }
};

template <> struct Semiring<kPlusTimes> {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) { return a + b; }
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
};

// sv: (B, nsrc, T, d) f32; carry, out: (B, ntiles, T, d) f32; all contiguous
// (d = 1 for scalar state). nsrc = ntiles for a whole layout; a rank of the
// distributed fixpoint relaxes its slab of ntiles destination tiles from
// the replicated state of all nsrc tiles.
// blocks: (nb, T, T) f32; bsrc: (nb,) i32 in [0, nsrc);
// dst_start: (ntiles + 1,) i32
// grid: (ntiles, ceil(B / QB), ceil(d / FD)); block: T rounded up to 32
// dynamic shared memory: QB * T * FD floats
template <int OP, int QB, int FD>
__global__ void relax_kernel(const float* __restrict__ sv,
                             const float* __restrict__ carry,
                             const float* __restrict__ blocks,
                             const int* __restrict__ bsrc,
                             const int* __restrict__ dst_start,
                             float* __restrict__ out,
                             int B, int nsrc, int ntiles, int T, int d) {
  using S = Semiring<OP>;
  extern __shared__ float slab[];  // [QB][T][FD] source values of one block
  __shared__ int active[QB];

  const int t = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int f0 = blockIdx.z * FD;
  const int nq = min(QB, B - q0);
  const int nf = min(FD, d - f0);
  const int v = threadIdx.x;
  const float zero = S::zero();

  float acc[QB * FD];
#pragma unroll
  for (int k = 0; k < QB * FD; ++k) acc[k] = zero;

  const int seg_end = dst_start[t + 1];
  for (int i = dst_start[t]; i < seg_end; ++i) {
    const long long src_tile = bsrc[i];
    if (threadIdx.x < QB) active[threadIdx.x] = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < nq * T * FD; e += blockDim.x) {
      const int f = e % FD;
      const int s = (e / FD) % T;
      const int q = e / (FD * T);
      float x = zero;
      if (f < nf)
        x = sv[(((long long)(q0 + q) * nsrc + src_tile) * T + s) * d + f0 + f];
      slab[e] = x;
      if (x != zero) active[q] = 1;  // packet trigger: any non-identity lane
    }
    __syncthreads();

    bool on[QB];
    bool any = false;
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      on[q] = q < nq && active[q] != 0;
      any = any || on[q];
    }
    if (any && v < T) {
      const float* w = blocks + (long long)i * T * T + v;
#pragma unroll 4
      for (int s = 0; s < T; ++s) {
        const float ws = w[(long long)s * T];
#pragma unroll
        for (int q = 0; q < QB; ++q) {
          if (on[q]) {
            const float* x = slab + (q * T + s) * FD;
#pragma unroll
            for (int f = 0; f < FD; ++f)
              acc[q * FD + f] = S::add(acc[q * FD + f], S::mul(x[f], ws));
          }
        }
      }
    }
    __syncthreads();  // the slab and flags are rewritten for the next block
  }

  if (v < T) {
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (q >= nq) break;
#pragma unroll
      for (int f = 0; f < FD; ++f) {
        if (f >= nf) break;
        const long long o = (((long long)(q0 + q) * ntiles + t) * T + v) * d + f0 + f;
        out[o] = S::add(carry[o], acc[q * FD + f]);
      }
    }
  }
}

template <int OP, int QB, int FD>
cudaError_t launch(const float* sv, const float* carry, const float* blocks,
                   const int* bsrc, const int* dst_start, float* out, int B,
                   int nsrc, int ntiles, int T, int d, cudaStream_t stream) {
  const dim3 grid(ntiles, (B + QB - 1) / QB, (d + FD - 1) / FD);
  const int threads = (T + 31) / 32 * 32;
  const size_t smem = (size_t)QB * T * FD * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        relax_kernel<OP, QB, FD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  relax_kernel<OP, QB, FD><<<grid, threads, smem, stream>>>(
      sv, carry, blocks, bsrc, dst_start, out, B, nsrc, ntiles, T, d);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_op(const float* sv, const float* carry, const float* blocks,
                      const int* bsrc, const int* dst_start, float* out, int B,
                      int nsrc, int ntiles, int T, int d, cudaStream_t stream) {
  if (d == 1)
    return launch<OP, 8, 1>(sv, carry, blocks, bsrc, dst_start, out, B, nsrc,
                            ntiles, T, d, stream);
  return launch<OP, 8, 8>(sv, carry, blocks, bsrc, dst_start, out, B, nsrc,
                          ntiles, T, d, stream);
}

}  // namespace

extern "C" int frontier_relax_launch(const void* sv, const void* carry,
                                     const void* blocks, const void* bsrc,
                                     const void* dst_start, void* out, int B,
                                     int nsrc, int ntiles, int T, int d, int op,
                                     void* stream) {
  const float* s = static_cast<const float*>(sv);
  const float* c = static_cast<const float*>(carry);
  const float* w = static_cast<const float*>(blocks);
  const int* bs = static_cast<const int*>(bsrc);
  const int* ds = static_cast<const int*>(dst_start);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kMinPlus: return launch_op<kMinPlus>(s, c, w, bs, ds, o, B, nsrc, ntiles, T, d, st);
    case kMaxMin: return launch_op<kMaxMin>(s, c, w, bs, ds, o, B, nsrc, ntiles, T, d, st);
    case kOrAnd: return launch_op<kOrAnd>(s, c, w, bs, ds, o, B, nsrc, ntiles, T, d, st);
    case kPlusTimes: return launch_op<kPlusTimes>(s, c, w, bs, ds, o, B, nsrc, ntiles, T, d, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* frontier_relax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
