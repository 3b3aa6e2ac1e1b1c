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
// What bounds it: the bytes of the weight blocks it streams, and at B = 8
// the issue rate. A block is T*T*4 B (64 KiB at T = 128) and is used for
// B*d lanes per destination, so at the main path's widths the arithmetic
// per byte is far below the card's fp32 ridge point; but at 3.35 TB/s,
// B = 8 and d = 1 ask for 13.4e12 semiring operations a second, each one
// instruction (FADD or FMNMX), which is about half of what the SMs can
// issue. So the weight stream has to keep tens of KiB in flight per SM,
// and the inner loop has to spend next to nothing beyond its ⊕ and ⊗.
//
// What the design does about it (two kernels, launched back to back on
// the caller's stream):
//   * `relax_kernel_activity`, once per step: for every source tile and
//     chunk of QB queries (and slab of FD features) it tests the packet
//     trigger -- bit q is set when query q's source tile holds a lane !=
//     the ⊕-identity, NaN counting as active -- and writes the tile's
//     source values transposed to [s][q][f], zero-padded to QB x FD, so
//     one 16-byte shared load brings 4 queries. It also zeroes the work
//     counters of the main kernel. The main kernel then decides about a
//     block from one word, mask[bsrc[i]]: a block no query needs never
//     leaves HBM and costs no barrier, and a step with an empty frontier
//     costs a scan of bsrc and the carry -> out copy.
//   * `relax_kernel`: a persistent grid (one to four thread blocks an
//     SM) takes work items -- a destination tile, or one of `split`
//     equal block ranges of its segment -- from an atomic counter. In
//     each thread block one producer warp scans an item's blocks 128 at a
//     time, and for each active block issues TMA bulk copies
//     (`cp.async.bulk`, a block is contiguous) of its weight rows and of
//     the matching transposed source rows into a ring of shared-memory
//     stages with full/empty mbarriers. A stage holds `rows` rows of one
//     block (32 KiB of weights; 16 KiB where several blocks share an SM),
//     so T = 256 blocks stream in row chunks, and the ring (160 KiB at
//     T = 128 on a Kronecker graph) keeps 64 KiB or more in flight per
//     SM. The ring runs on across items: one item's epilogue overlaps the
//     next item's loads.
//   * Consumer warps relax from shared memory. At d = 1 each thread owns
//     LPT = 4 destination lanes (one 16-byte load of a weight row) and all
//     QB = 8 queries: 1 weight load, 2 broadcast 16-byte source loads and
//     64 semiring operations a row. Row groups split a stage's rows;
//     their partial sums are combined in shared memory in row-group order
//     at the item's end. A stage whose every query is active takes a loop
//     with no per-query predicate.
//   * Combine: with split = 1 an item writes out = carry ⊕ acc itself.
//     With split > 1 each part writes its partial to a scratch buffer,
//     and the part that finishes last (an integer counter) combines the
//     parts in part order. Every output is written exactly once, a tile
//     no block writes gets its carry, no float atomics are used, and the
//     result is the same from launch to launch.
//   * The launch plan (ring depth, rows a stage, split, consumers, grid)
//     is `frontier.launch_plan`, from T, d, B and the mean blocks per
//     destination tile; this source takes it as arguments.
//   * ⊕ and ⊗ of the min/max semirings are the PTX `min.NaN.f32` /
//     `max.NaN.f32` (one instruction each, sm_80+), which return NaN
//     when either operand is NaN, as torch.minimum / jnp.minimum do.
//     fminf/fmaxf would drop a NaN operand, so a poisoned weight block
//     would read as a missing edge and the serving layer's NaN guard
//     would never trip. No fast-math: min/max results are bit-equal to
//     the plain PyTorch version, (+, x) differs only in summation order.
//     A query whose source tile is all ⊕-identity skips the block (exact:
//     the ⊕-identity annihilates ⊗), as it always has.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

// ---- mbarrier and bulk-copy PTX ------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of the given parity has completed; a wait that
// never ends (a broken pipeline) traps, so the launch fails and does not
// hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// TMA bulk copy of `bytes` contiguous bytes (16-byte aligned, a multiple
// of 16) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the consumer warps alone (the producer warp does not take part)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;" :: "r"(threads) : "memory");
}

// ---- the activity pre-pass -----------------------------------------------

constexpr int kActivityTiles = 4;          // source tiles a pre-pass block
constexpr int kActivityThreads = 512;      // 128 threads a tile

// sv: (B, nsrc, T, d) f32. For each source tile of the block's
// kActivityTiles (from blockIdx.x), query chunk blockIdx.y (QB queries)
// and feature slab blockIdx.z (FD features):
// svt[(qc, fc, src)] = the tile's values as [T][QB][FD], ⊕-identity where
// q >= B or f >= d; mask[(qc, fc, src)] = bit q for each query with a lane
// != zero (the packet trigger; NaN != zero counts as active). Zeroes
// counters[0 .. ncounters) on the way (grid-stride).
template <int QB, int FD>
__global__ void __launch_bounds__(kActivityThreads) relax_kernel_activity(
    const float* __restrict__ sv, float* __restrict__ svt,
    int* __restrict__ mask, int* __restrict__ counters, int ncounters,
    int B, int nsrc, int T, int d, float zero) {
  constexpr int kIn = 8;                    // loads in flight a thread
  constexpr int kGroup = kActivityThreads / kActivityTiles;
  __shared__ int bits[kActivityTiles];
  const int qc = blockIdx.y, fc = blockIdx.z;
  const int g = threadIdx.x / kGroup, gt = threadIdx.x % kGroup;
  const int src = blockIdx.x * kActivityTiles + g;   // this group's tile
  const long long cta =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const long long stride =
      (long long)gridDim.x * gridDim.y * gridDim.z * blockDim.x;
  for (long long k = cta * blockDim.x + threadIdx.x; k < ncounters; k += stride)
    counters[k] = 0;
  if (gt == 0) bits[g] = 0;
  __syncthreads();
  const int q0 = qc * QB, f0 = fc * FD;
  const int nq = min(QB, B - q0), nf = min(FD, d - f0);
  const int n = src < nsrc ? T * QB * FD : 0;
  float* dst = svt + ((long long)(qc * gridDim.z + fc) * nsrc + src) * T * QB * FD;
  const float* from = sv + ((long long)q0 * nsrc + src) * T * d + f0;
  const long long q_stride = (long long)nsrc * T * d;
  int mine = 0;
  for (int e0 = gt; e0 < n; e0 += kIn * kGroup) {
    float x[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k) {
      const int e = e0 + k * kGroup;
      const int f = e % FD, q = (e / FD) % QB, s = e / (FD * QB);
      x[k] = e < n && q < nq && f < nf ? from[q * q_stride + (long long)s * d + f]
                                       : zero;
    }
#pragma unroll
    for (int k = 0; k < kIn; ++k) {
      const int e = e0 + k * kGroup;
      if (e < n) {
        dst[e] = x[k];
        if (x[k] != zero) mine |= 1 << ((e / FD) % QB);
      }
    }
  }
  mine = __reduce_or_sync(0xffffffffu, mine);    // a warp is in one group
  if ((threadIdx.x & 31) == 0 && mine) atomicOr(&bits[g], mine);
  __syncthreads();
  if (gt == 0 && src < nsrc) mask[(qc * gridDim.z + fc) * nsrc + src] = bits[g];
}

// ---- the relaxation ------------------------------------------------------

struct Args {
  const float* svt;        // (nqc, nfc, nsrc, T, QB, FD), from the pre-pass
  const int* mask;         // (nqc, nfc, nsrc)
  const float* carry;      // (B, ntiles, T, d)
  const float* blocks;     // (nb, T, T)
  const int* bsrc;         // (nb,)
  const int* dst_start;    // (ntiles + 1,)
  float* out;              // (B, ntiles, T, d)
  float* part;             // (nitems, QB, T, FD) when split > 1
  int* counters;           // [0] next item; [1 + key] parts done of a tile
  int B, nsrc, ntiles, T, d;
  int rows, stages, split, nitems, nfc;
};

enum Kind { kSome = 0, kAll = 1, kEnd = 2, kDone = 3 };

struct Header {            // what a ring stage holds
  int item, mask, rows, kind;
};

// Relax `rows` rows of one stage into this thread's accumulators: lanes
// lg*LPT .. +LPT of the destination tile, rows rg, rg + G, ... of the
// stage. x holds the stage's source values as [row][QB][FD]. ALL: every
// query of the chunk is active (no predicate).
template <int OP, int QB, int FD, int LPT, bool ALL>
__device__ __forceinline__ void relax_rows(float (&acc)[QB][LPT][FD],
                                           const float* __restrict__ w,
                                           const float* __restrict__ x,
                                           int rows, int T, int rg, int G,
                                           int lg, int mask) {
  using S = Semiring<OP>;
  static_assert(QB % 4 == 0 && (FD == 1 || FD % 4 == 0), "16-byte loads");
  const float* wr = w + rg * T + lg * LPT;
  const float* xr = x + rg * QB * FD;
#pragma unroll(FD == 1 ? 2 : 1)
  for (int s = rg; s < rows; s += G, wr += G * T, xr += G * QB * FD) {
    float wv[LPT];
    if constexpr (LPT == 4) {
      const float4 t4 = *reinterpret_cast<const float4*>(wr);
      wv[0] = t4.x;
      wv[1] = t4.y;
      wv[2] = t4.z;
      wv[3] = t4.w;
    } else {
#pragma unroll
      for (int l = 0; l < LPT; ++l) wv[l] = wr[l];
    }
    if constexpr (FD == 1) {
      float xv[QB];                         // every query of the row at once
#pragma unroll
      for (int k = 0; k < QB; k += 4) {
        const float4 t4 = *reinterpret_cast<const float4*>(xr + k);
        xv[k] = t4.x;
        xv[k + 1] = t4.y;
        xv[k + 2] = t4.z;
        xv[k + 3] = t4.w;
      }
#pragma unroll
      for (int q = 0; q < QB; ++q)
        if (ALL || ((mask >> q) & 1))
#pragma unroll
          for (int l = 0; l < LPT; ++l)
            acc[q][l][0] = S::add(acc[q][l][0], S::mul(xv[q], wv[l]));
    } else {
#pragma unroll
      for (int q = 0; q < QB; ++q) {
        if (!(ALL || ((mask >> q) & 1))) continue;
        float xv[FD];                       // one query's features
#pragma unroll
        for (int f = 0; f < FD; f += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(xr + q * FD + f);
          xv[f] = t4.x;
          xv[f + 1] = t4.y;
          xv[f + 2] = t4.z;
          xv[f + 3] = t4.w;
        }
#pragma unroll
        for (int l = 0; l < LPT; ++l)
#pragma unroll
          for (int f = 0; f < FD; ++f)
            acc[q][l][f] = S::add(acc[q][l][f], S::mul(xv[f], wv[l]));
      }
    }
  }
}

__device__ __forceinline__ float4 splat(float x) { return make_float4(x, x, x, x); }

template <int OP>
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  using S = Semiring<OP>;
  return make_float4(S::add(a.x, b.x), S::add(a.y, b.y), S::add(a.z, b.z),
                     S::add(a.w, b.w));
}

// read-only for the whole kernel: the loads may run ahead of the stores
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// After a part wrote its partial: true in every consumer thread of the
// thread block whose part of the tile finished last (an integer counter
// the pre-pass zeroed), which then sees every part's partial.
__device__ __forceinline__ bool last_part(int* done, int split, int tid,
                                          int nct, int* flag) {
  __threadfence();
  consumer_sync(nct);
  if (tid == 0) *flag = atomicAdd(done, 1) == split - 1;
  consumer_sync(nct);
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// at most 512 consumer threads and the producer warp at d = 1; at d > 1
// (64 accumulators a thread) at most 256, so that ptxas may give a thread
// the registers it needs
template <int OP, int QB, int FD, int LPT>
__global__ void __launch_bounds__(FD == 1 ? 544 : 288) relax_kernel(const Args a) {
  using S = Semiring<OP>;
  static_assert(FD > 1 || LPT == 4, "d = 1 takes four lanes a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = a.T;
  const int nct = blockDim.x - 32;          // consumer threads
  const int tpr = T / LPT;                  // consumer threads a row
  const int G = nct / tpr;                  // row groups
  const int stage_w = a.rows * T;           // floats of weights a stage
  const int stage_f = stage_w + a.rows * QB * FD;
  float* ring = reinterpret_cast<float*>(smem);
  float* comb = ring + (long long)a.stages * stage_f;
  const int comb_f = G > 1 ? nct * LPT * QB * FD : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(comb + comb_f);
  uint64_t* empty = full + a.stages;
  Header* hdr = reinterpret_cast<Header*>(empty + a.stages);
  int* flag = reinterpret_cast<int*>(hdr + a.stages);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nct / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= nct) {
    // ---- the producer warp ----
    const int lane = threadIdx.x & 31;
    uint32_t stage = 0, phase = 0;
    int next = lane == 0 ? atomicAdd(&a.counters[0], 1) : 0;
    next = __shfl_sync(0xffffffffu, next, 0);
    while (next < a.nitems) {
      const int item = next;
      if (lane == 0) next = atomicAdd(&a.counters[0], 1);
      const int key = item / a.split, p = item % a.split;
      const int slab = key / a.ntiles, t = key % a.ntiles;
      const int qc = slab / a.nfc;
      const int nq = min(QB, a.B - qc * QB);
      const int all = (1 << nq) - 1;
      const int s0 = a.dst_start[t], len = a.dst_start[t + 1] - s0;
      const int lo = s0 + (int)((long long)len * p / a.split);
      const int hi = s0 + (int)((long long)len * (p + 1) / a.split);
      const int* mk = a.mask + (long long)slab * a.nsrc;
      const float* xs = a.svt + (long long)slab * a.nsrc * T * QB * FD;
      for (int base = lo; base < hi; base += 128) {
        int src[4], m[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = base + 32 * k + lane;
          src[k] = i < hi ? __ldg(a.bsrc + i) : 0;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = base + 32 * k + lane;
          m[k] = i < hi ? mk[src[k]] : 0;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          unsigned act = __ballot_sync(0xffffffffu, m[k] != 0);
          while (act) {
            const int j = __ffs(act) - 1;
            act &= act - 1;
            const int sj = __shfl_sync(0xffffffffu, src[k], j);
            const int mj = __shfl_sync(0xffffffffu, m[k], j);
            if (lane == 0) {
              const float* w = a.blocks + (long long)(base + 32 * k + j) * T * T;
              const float* x = xs + (long long)sj * T * QB * FD;
              for (int r0 = 0; r0 < T; r0 += a.rows) {
                const int nr = min(a.rows, T - r0);
                mbar_wait(&empty[stage], phase ^ 1);
                hdr[stage] = Header{item, mj, nr, mj == all ? kAll : kSome};
                float* dw = ring + (long long)stage * stage_f;
                const uint32_t bw = nr * T * 4, bx = nr * QB * FD * 4;
                mbar_arrive_tx(&full[stage], bw + bx);
                bulk_copy(dw, w + (long long)r0 * T, bw, &full[stage]);
                bulk_copy(dw + stage_w, x + (long long)r0 * QB * FD, bx,
                          &full[stage]);
                if (++stage == (uint32_t)a.stages) { stage = 0; phase ^= 1; }
              }
            }
          }
        }
      }
      if (lane == 0) {                      // the item's end
        mbar_wait(&empty[stage], phase ^ 1);
        hdr[stage] = Header{item, 0, 0, kEnd};
        mbar_arrive(&full[stage]);
        if (++stage == (uint32_t)a.stages) { stage = 0; phase ^= 1; }
      }
      next = __shfl_sync(0xffffffffu, next, 0);
    }
    if (lane == 0) {                        // no items left
      mbar_wait(&empty[stage], phase ^ 1);
      hdr[stage] = Header{0, 0, 0, kDone};
      mbar_arrive(&full[stage]);
    }
    return;
  }

  // ---- the consumer warps ----
  const int tid = threadIdx.x;
  const int rg = tid / tpr, lg = tid % tpr;
  const bool rows_mine = rg < G;
  float acc[QB][LPT][FD];
#pragma unroll
  for (int q = 0; q < QB; ++q)
#pragma unroll
    for (int l = 0; l < LPT; ++l)
#pragma unroll
      for (int f = 0; f < FD; ++f) acc[q][l][f] = S::zero();

  uint32_t stage = 0, phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    const Header h = hdr[stage];
    if (h.kind == kDone) break;
    if (h.kind != kEnd && rows_mine) {
      const float* w = ring + (long long)stage * stage_f;
      // d > 1 keeps to the predicated loop: one copy of its loop of 64
      // accumulators keeps the build short
      if (FD == 1 && h.kind == kAll)
        relax_rows<OP, QB, FD, LPT, FD == 1>(acc, w, w + stage_w, h.rows, T,
                                             rg, G, lg, h.mask);
      else
        relax_rows<OP, QB, FD, LPT, false>(acc, w, w + stage_w, h.rows, T,
                                           rg, G, lg, h.mask);
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[stage]);
    if (++stage == (uint32_t)a.stages) { stage = 0; phase ^= 1; }
    if (h.kind != kEnd) continue;

    // ---- the item's end: combine, then out = carry ⊕ acc ----
    const int item = h.item;
    const int key = item / a.split;
    const int slab = key / a.ntiles, t = key % a.ntiles;
    const int qc = slab / a.nfc, fc = slab % a.nfc;
    const int q0 = qc * QB, f0 = fc * FD;
    const int nq = min(QB, a.B - q0), nf = min(FD, a.d - f0);
    float* part = a.part + (long long)item * QB * T * FD;
    const float* parts = a.part + (long long)key * a.split * QB * T * FD;
    if (G > 1 && rows_mine) {
#pragma unroll
      for (int q = 0; q < QB; ++q)
#pragma unroll
        for (int l = 0; l < LPT; ++l)
#pragma unroll
          for (int f = 0; f < FD; ++f)
            comb[((rg * QB + q) * T + lg * LPT + l) * FD + f] = acc[q][l][f];
    }
    if (G > 1) consumer_sync(nct);
    if constexpr (FD == 1) {
      // d = 1: a query's outputs are T contiguous floats; 4 lanes a step
      const int T4 = T / 4;
      float* out_t = a.out + ((long long)q0 * a.ntiles + t) * T;
      const float* carry_t = a.carry + ((long long)q0 * a.ntiles + t) * T;
      const long long q_stride = (long long)a.ntiles * T;
      if (G > 1) {
#pragma unroll 2
        for (int e = tid; e < nq * T4; e += nct) {
          const int q = e / T4, v = (e - q * T4) * 4;
          float4 x = splat(S::zero());
          for (int g = 0; g < G; ++g)
            x = add4<OP>(x, *reinterpret_cast<const float4*>(comb + (g * QB + q) * T + v));
          if (a.split == 1)
            st4(out_t + q * q_stride + v, add4<OP>(ldg4(carry_t + q * q_stride + v), x));
          else
            st4(part + q * T + v, x);
        }
      } else if (rows_mine) {
#pragma unroll
        for (int q = 0; q < QB; ++q) {
          if (q < nq) {
            const float4 x = make_float4(acc[q][0][0], acc[q][1][0], acc[q][2][0], acc[q][3][0]);
            const int v = lg * 4;
            if (a.split == 1)
              st4(out_t + q * q_stride + v, add4<OP>(ldg4(carry_t + q * q_stride + v), x));
            else
              st4(part + q * T + v, x);
          }
        }
      }
      if (a.split > 1 && last_part(a.counters + 1 + key, a.split, tid, nct, flag)) {
        // the last part of the tile to finish combines all parts in order
#pragma unroll 2
        for (int e = tid; e < nq * T4; e += nct) {
          const int q = e / T4, v = (e - q * T4) * 4;
          float4 x = splat(S::zero());
          for (int pp = 0; pp < a.split; ++pp)
            x = add4<OP>(x, __ldcg(reinterpret_cast<const float4*>(parts + pp * QB * T + q * T + v)));
          st4(out_t + q * q_stride + v, add4<OP>(ldg4(carry_t + q * q_stride + v), x));
        }
      }
    } else {
      // d > 1: one output at a time, the carry read ahead of the stores
      const int n_out = nq * T * nf;
      auto at = [&](int q, int v, int f) {
        return (((long long)(q0 + q) * a.ntiles + t) * T + v) * a.d + f0 + f;
      };
      if (G > 1) {
#pragma unroll 4
        for (int e = tid; e < n_out; e += nct) {
          const int f = e % nf, v = (e / nf) % T, q = e / (nf * T);
          float x = S::zero();
          for (int g = 0; g < G; ++g)
            x = S::add(x, comb[((g * QB + q) * T + v) * FD + f]);
          if (a.split == 1)
            a.out[at(q, v, f)] = S::add(__ldg(a.carry + at(q, v, f)), x);
          else
            part[(q * T + v) * FD + f] = x;
        }
      } else if (rows_mine) {
#pragma unroll
        for (int q = 0; q < QB; ++q) {
          if (q >= nq) continue;
#pragma unroll
          for (int l = 0; l < LPT; ++l) {
            const int v = lg * LPT + l;
            float c[FD];
#pragma unroll
            for (int f = 0; f < FD; ++f)
              if (a.split == 1 && f < nf) c[f] = __ldg(a.carry + at(q, v, f));
#pragma unroll
            for (int f = 0; f < FD; ++f) {
              if (f >= nf) continue;
              if (a.split == 1)
                a.out[at(q, v, f)] = S::add(c[f], acc[q][l][f]);
              else
                part[(q * T + v) * FD + f] = acc[q][l][f];
            }
          }
        }
      }
      if (a.split > 1 && last_part(a.counters + 1 + key, a.split, tid, nct, flag)) {
#pragma unroll 4
        for (int e = tid; e < n_out; e += nct) {
          const int f = e % nf, v = (e / nf) % T, q = e / (nf * T);
          float x = S::zero();
          for (int pp = 0; pp < a.split; ++pp)
            x = S::add(x, __ldcg(parts + ((long long)pp * QB * T + q * T + v) * FD + f));
          a.out[at(q, v, f)] = S::add(__ldg(a.carry + at(q, v, f)), x);
        }
      }
    }
    consumer_sync(nct);                     // comb and flag are reused
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
      for (int l = 0; l < LPT; ++l)
#pragma unroll
        for (int f = 0; f < FD; ++f) acc[q][l][f] = S::zero();
  }
}

// the shared memory the plan's layout takes (frontier.launch_plan computes
// the same): the ring, the row groups' combine buffer, barriers, headers
size_t layout_bytes(int T, int d_slab, int lanes, int consumers, int rows,
                    int stages) {
  const int qb = 8;
  const size_t stage = (size_t)rows * T * 4 + (size_t)rows * qb * d_slab * 4;
  const int groups = consumers / (T / lanes);
  const size_t comb = groups > 1 ? (size_t)consumers * lanes * qb * d_slab * 4 : 0;
  return stages * stage + comb + (size_t)stages * (8 + 8 + 16) + 16;
}

template <int OP, int QB, int FD, int LPT>
cudaError_t launch(const Args& a, int consumers, int grid, int smem,
                   cudaStream_t stream) {
  if ((size_t)smem < layout_bytes(a.T, FD, LPT, consumers, a.rows, a.stages))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      relax_kernel<OP, QB, FD, LPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  relax_kernel<OP, QB, FD, LPT><<<grid, consumers + 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_op(const Args& a, int consumers, int grid, int smem,
                      cudaStream_t stream) {
  if (a.d == 1) return launch<OP, 8, 1, 4>(a, consumers, grid, smem, stream);
  return launch<OP, 8, 8, 1>(a, consumers, grid, smem, stream);
}

float zero_of(int op) {
  union { unsigned u; float f; } z;
  z.u = op == kMinPlus ? 0x7f800000u : op == kMaxMin ? 0xff800000u : 0u;
  return z.f;
}

}  // namespace

// One relaxation step: the activity pre-pass, then the relaxation, on
// `stream`. scratch holds svt (nqc*nfc*nsrc*T*8*fd floats), then mask
// (nqc*nfc*nsrc ints), then counters (1 + ntiles*nqc*nfc ints), then,
// when split > 1, the parts (nitems*8*T*fd floats), each 16-byte aligned;
// `plan` = {rows, stages, split, consumers, grid, smem} from
// frontier.launch_plan.
extern "C" int frontier_relax_launch(const void* sv, const void* carry,
                                     const void* blocks, const void* bsrc,
                                     const void* dst_start, void* out,
                                     void* scratch, int B, int nsrc,
                                     int ntiles, int T, int d, int op,
                                     const int* plan, void* stream) {
  if (op < kMinPlus || op > kPlusTimes) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fd = d == 1 ? 1 : 8;
  const int nqc = (B + 7) / 8, nfc = (d + fd - 1) / fd;
  const long long n_svt = (long long)nqc * nfc * nsrc * T * 8 * fd;
  const long long n_mask = (long long)nqc * nfc * nsrc;
  const long long n_count = 1 + (long long)ntiles * nqc * nfc;
  auto up16 = [](long long bytes) { return (bytes + 15) / 16 * 16; };
  char* base = static_cast<char*>(scratch);
  float* svt = reinterpret_cast<float*>(base);
  int* mask = reinterpret_cast<int*>(base + up16(n_svt * 4));
  int* counters = reinterpret_cast<int*>(base + up16(n_svt * 4) + up16(n_mask * 4));
  float* part = reinterpret_cast<float*>(
      base + up16(n_svt * 4) + up16(n_mask * 4) + up16(n_count * 4));

  const float* s = static_cast<const float*>(sv);
  const dim3 pre((nsrc + kActivityTiles - 1) / kActivityTiles, nqc, nfc);
  if (d == 1)
    relax_kernel_activity<8, 1><<<pre, kActivityThreads, 0, st>>>(
        s, svt, mask, counters, (int)n_count, B, nsrc, T, d, zero_of(op));
  else
    relax_kernel_activity<8, 8><<<pre, kActivityThreads, 0, st>>>(
        s, svt, mask, counters, (int)n_count, B, nsrc, T, d, zero_of(op));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  Args a;
  a.svt = svt;
  a.mask = mask;
  a.carry = static_cast<const float*>(carry);
  a.blocks = static_cast<const float*>(blocks);
  a.bsrc = static_cast<const int*>(bsrc);
  a.dst_start = static_cast<const int*>(dst_start);
  a.out = static_cast<float*>(out);
  a.part = part;
  a.counters = counters;
  a.B = B;
  a.nsrc = nsrc;
  a.ntiles = ntiles;
  a.T = T;
  a.d = d;
  a.rows = plan[0];
  a.stages = plan[1];
  a.split = plan[2];
  a.nitems = ntiles * a.split * nqc * nfc;
  a.nfc = nfc;
  const int consumers = plan[3], grid = plan[4], smem = plan[5];
  switch (op) {
    case kMinPlus: return launch_op<kMinPlus>(a, consumers, grid, smem, st);
    case kMaxMin: return launch_op<kMaxMin>(a, consumers, grid, smem, st);
    case kOrAnd: return launch_op<kOrAnd>(a, consumers, grid, smem, st);
    default: return launch_op<kPlusTimes>(a, consumers, grid, smem, st);
  }
}

extern "C" const char* frontier_relax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
