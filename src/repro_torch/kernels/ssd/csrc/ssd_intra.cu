// Mamba-2 SSD intra-chunk form for Hopper (sm_90a): 3xTF32 tensor-core
// products with f32 accumulation, and one G = C.B^T panel shared by a
// group of heads.
//
// Replaces the Pallas TPU kernel `repro.kernels.ssd.ssd.ssd_intra_pallas`
// (src/repro/kernels/ssd/ssd.py, body `_ssd_kernel`). It computes that
// kernel's function, not its block structure. Per (batch*chunk c, head h),
// with i, j rows of the chunk (Q rows), N the state size, P the head dim:
//   G[i,j]   = sum_n C[i,n] B[j,n]                    (independent of h)
//   att[i,j] = G[i,j] * exp(cums[i] - cums[j])   for i >= j, else 0
//   y[i,p]   = sum_j att[i,j] dtx[j,p]
//   S[n,p]   = sum_j B[j,n] exp(cums[Q-1] - cums[j]) dtx[j,p]
//
// What bounds it on this card. At the mamba2-370m prefill shape (b=4,
// nc=16, Q=256, N=128, H=32, P=64) the function needs 1.782e10 operations
// (G once per chunk over the i >= j pairs; per head the decay, att.dtx and
// the state) on 354,418,688 bytes (C, B, dtx, cums read once; y, S written
// once). Every product runs as three TF32 products, so the bound is
// max(3 x 1.782e10 / 495 TFLOP/s = 0.1080 ms, 354,418,688 B / 3.35 TB/s =
// 0.1058 ms): 0.1080 ms of operations, with the bytes close behind. The
// same work as f32 FMAs on the CUDA cores is bounded at 0.2660 ms.
//
// Why 3xTF32 and not one TF32 product. The kernel is held in f32 against
// `ssd_intra_ref` at atol 1e-4 x max(1, max|ref|). Emulated on the CPU at
// b=1, L=1,024, H=8, P=64, N=128, chunk 256 against a float64 reference:
// f32 FMAs give y / S errors 7.8e-6 / 4.3e-7; one TF32 product 1.70e-2 /
// 1.08e-3, 6x and 4.4x over the tolerances (2.778e-3 / 2.436e-4); 3xTF32
// 4.8e-6 / 3.7e-7. So each operand x is split as hi = tf32(x) (cvt.rna,
// 10 mantissa bits) and lo = tf32(x - hi), and a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the small terms first), accumulated
// in f32. tests/test_torch_lm_kernels.py emulates this arithmetic.
//
// The products of y and S run as wgmma (m64n64k8, tf32), with A from
// registers and B from shared memory; G (the smaller part) as mma.sync
// m16n8k8. wgmma takes tf32 operands from shared memory only K-major (its
// transpose bits are for 16-bit types), while dtx (j, p) is MN-major as
// the B operand of y and S. The split needs a pass over every B operand
// anyway, and that pass writes the hi and lo planes transposed, in the
// K-major core-matrix layout wgmma reads, so the layout costs no extra
// copy. The A operands (att for y, B^T for S) are built and split in
// registers in the m16n8k8 A-fragment order, which is also wgmma's
// register A layout for tf32.
//
// The design:
//  * `ssd_intra_y`: one CTA (two warpgroups) per (64-row i tile, group of
//    HG = 8 heads, batch*chunk); the i tiles of one (chunk, group) are
//    neighbours in the grid, heaviest first, so the dtx j tiles they share
//    are re-read from L2. Phase 1 computes the G panel of the i tile,
//    64 x (it+1)*64 f32, once for the group, from staged 64-column chunks
//    of C and B (a cp.async double buffer), and keeps it in shared memory:
//    G is computed 4x per chunk at mamba2's 32 heads, not 32x. Phase 2
//    takes the group's slots (a slot is one head's 64 columns of P) two at
//    a time, one per warpgroup, and streams their dtx j tiles up to the
//    diagonal through a cp.async double buffer: per j tile a split pass,
//    then each warpgroup builds att from the panel and runs 24 wgmma
//    (8 k-steps x 3 products) into its m64n64 accumulator.
//  * `ssd_intra_state`: one CTA (two warpgroups, 64 state rows each) per
//    (pair of slots, batch*chunk) streams the 64-row j tiles of B and of
//    the two slots' dtx. The decay exp(last - cums_j) <= 1 weights the dtx
//    rows in the split pass, so the A operand (B^T, split in registers) is
//    head-free and serves both slots.
//  * The decay trap. Within a 256-row chunk cums falls to about -1,000
//    (and far lower under strong decay), so exp(cums_i) * exp(-cums_j)
//    overflows to inf and inf * 0 gives NaN. On the diagonal tile the
//    kernel takes the exp of the difference, masked to j <= i before the
//    exp (rows past Q get cums = -inf, so their decay is 0), as `ref.py`
//    does. Off the diagonal (j < i0 <= i) it takes exp(ci - c0) *
//    exp(c0 - cj) with c0 = cums[i0 - 1], the last row before the i tile:
//    cums never rises (la = -exp(A_log) dt <= 0), so both factors are <= 1
//    and neither can overflow; exp(c0 - cj) weights the dtx rows in the
//    split pass and exp(ci - c0) scales the accumulator before the
//    diagonal tile.
//  * Ragged edges. Q need not be a multiple of 64, nor N or P of 8: the
//    staged tiles are zero-filled past the last row and column (cp.async
//    with a zero source size), and only rows < Q, states < N and columns
//    < P are stored.
//  * Not pipelined across j tiles. A version that left each step's wgmma
//    in flight over the next step's split pass was slower: ptxas then
//    waited for every wgmma before issuing the next (a WARPGROUP.DEPBAR
//    after each HGMMA in the SASS). Overlapping the split with the tensor
//    cores needs warp specialisation instead, a later step.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;          // rows per i tile and per j tile
constexpr int HG = 8;           // heads that share one G panel in ssd_intra_y
constexpr int KC = 64;          // state columns per staged C / B chunk
constexpr int LDK = KC + 4;     // row stride of the staged C / B chunks
constexpr int MAXN = 128;       // state size: two warpgroups x 64 rows in S
constexpr int MAXP = 128;       // head dim (two 64-column slots)
constexpr int MAXQ = 256;       // chunk length: the G panel fits in smem
constexpr int SP = 64;          // columns of P per slot (8 n-tiles)
constexpr int LDX = SP + 4;     // row stride of a staged dtx slot
constexpr int SLOT_STAGE = BR * LDX + BR;     // raw slot + its cums
constexpr int KBLK = 2 * SP * 4;              // a k-step of a split plane
constexpr int PLANE = (BR / 8) * KBLK;        // a split plane: 64 x 64
constexpr int FRAG = 2 * PLANE;               // split slot: hi and lo
constexpr int Y_STAGE = 2 * SLOT_STAGE;       // >= the C + B chunks
static_assert(Y_STAGE >= 2 * BR * LDK, "phase 1 chunks fit a ring stage");
constexpr int Y_THREADS = 256;
constexpr int S_THREADS = 256;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

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

// A 64-row tile of a row-major global block (row stride lds; `rows` rows
// and `cols` columns valid) into shared memory (row stride ldd), with
// columns [cols, cpad) and rows [rows, 64) zero. `vec`: 16-byte copies
// (cols, lds and the pointers 16-byte aligned); else 4-byte ones.
template <int THREADS>
__device__ __forceinline__ void stage_tile(float* dst, int ldd,
                                           const float* src, size_t lds,
                                           int rows, int cols, int cpad,
                                           bool vec) {
  if (vec) {
    const int cw = cpad >> 2;
    for (int idx = threadIdx.x; idx < BR * cw; idx += THREADS) {
      const int r = idx / cw, c = (idx - r * cw) << 2;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * ldd + c, ok ? src + r * lds + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < BR * cpad; idx += THREADS) {
      const int r = idx / cpad, c = idx - r * cpad;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * ldd + c, ok ? src + r * lds + c : src, ok);
    }
  }
}

// cums of one head for a 64-row j tile (stride H in global), zero past Q
__device__ __forceinline__ void stage_cums(float* dst, const float* src,
                                           int H, int rows) {
  const int r = threadIdx.x;
  if (r < BR) {
    const bool ok = r < rows;
    cp_async4(dst + r, ok ? src + (size_t)r * H : src, ok);
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
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[nt] += a.b[nt] in 3xTF32 for one k-step of 8 over NT n-tiles: the
// small cross terms first, each product issued for every n-tile before
// the next product, so that NT independent accumulators keep the tensor
// core busy instead of one dependent chain of three.
template <int NT>
__device__ __forceinline__ void mma3(float (&d)[NT][4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bh)[NT][2],
                                     const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], alo, bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], ahi, bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], ahi, bh[nt][0], bh[nt][1]);
}

// wgmma shared-memory descriptor without swizzle (layout type 0): start
// address, leading byte offset (between the two 16-byte core-matrix
// columns of a k-step of 8, K-major) and stride byte offset (between
// 8-row core-matrix groups along N), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
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

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (m64 x n64, f32) += A (registers, tf32, the m16n8k8 A fragment of
// each warp's 16 rows) * B (shared memory, tf32, K-major): one k-step of 8.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a.b over the 8 k-steps of a 64-row slot in 3xTF32: per k-step the
// small cross terms first. `fr` is the split slot (hi plane, lo plane).
__device__ __forceinline__ void wgmma3_slot(float (&d)[32],
                                            const uint32_t (&ahi)[8][4],
                                            const uint32_t (&alo)[8][4],
                                            const float* fr) {
#pragma unroll
  for (int kk = 0; kk < BR / 8; ++kk) {
    const uint64_t bh = smem_desc(fr + kk * KBLK, 128, 256);
    const uint64_t bl = smem_desc(fr + PLANE + kk * KBLK, 128, 256);
    wgmma_tf32(d, alo[kk], bh);
    wgmma_tf32(d, ahi[kk], bl);
    wgmma_tf32(d, ahi[kk], bh);
  }
}

// The split pass over `nslot` staged slots (raw dtx [64][LDX] and row
// weights w[64] of slot q at raw + q * SLOT_STAGE; w taken as 1 when
// `unit`): w[j] * x[j][p] = hi + lo into the wgmma B-operand layout of
// slot q at frag + q * FRAG. K = j, N = p, K-major without swizzle: per
// k-step kk a block of KBLK floats holds 8 x 2 core matrices (8 p rows x
// 4 consecutive j, 16 bytes a row), the two j halves 128 bytes apart
// (LBO), the 8-row p groups 256 bytes apart (SBO). This is the transposed
// copy that wgmma's K-major tf32 operands need; the split needs the pass
// anyway, so the layout costs nothing more.
template <int THREADS>
__device__ __forceinline__ void split_slots(const float* raw, float* frag,
                                            int nslot, bool unit) {
  const int per_slot = (BR / 8) * (SP / 8) * 2 * 8;   // 4-value items
  for (int idx = threadIdx.x; idx < nslot * per_slot; idx += THREADS) {
    const int q = idx / per_slot, f = idx - q * per_slot;
    const int pr = f & 7, kh = (f >> 3) & 1, ng = (f >> 4) & 7, kk = f >> 7;
    const float* x = raw + q * SLOT_STAGE;
    const int j = kk * 8 + kh * 4, p = ng * 8 + pr;
    const float4 w = unit ? make_float4(1.f, 1.f, 1.f, 1.f)
                          : *reinterpret_cast<const float4*>(x + BR * LDX + j);
    uint4 hi, lo;
    split(x[j * LDX + p] * w.x, hi.x, lo.x);
    split(x[(j + 1) * LDX + p] * w.y, hi.y, lo.y);
    split(x[(j + 2) * LDX + p] * w.z, hi.z, lo.z);
    split(x[(j + 3) * LDX + p] * w.w, hi.w, lo.w);
    float* dst = frag + q * FRAG + kk * KBLK + ng * 64 + kh * 32 + pr * 4;
    *reinterpret_cast<uint4*>(dst) = hi;
    *reinterpret_cast<uint4*>(dst + PLANE) = lo;
  }
}

// y: grid (ceil(Q/64), ceil(H/HG), batch*chunk), 8 warps. A slot is one
// head's 64-column slab of P (one slot per head for P <= 64, two above).
// Phase 1: warp (rb, kh) = (w % 4, w / 4) computes rows 16rb..16rb+15 of
// the G panel, all 64 columns of each j tile, over half of each staged
// state chunk (mma.sync); the two halves are summed in the panel. Phase 2
// takes the group's slots two at a time: warpgroup w / 4 owns one slot,
// warp w % 4 of it rows 16rb.. of the i tile. Shared memory: the G panel
// [64][ldg]; two ring stages (phase 1: C and B chunks [64][LDK]; phase 2:
// two slots of {raw dtx [64][LDX], cums or weights [64]}); two split
// slots.
__global__ void __launch_bounds__(Y_THREADS, 1)
ssd_intra_y(const float* __restrict__ C, const float* __restrict__ B,
            const float* __restrict__ dtx, const float* __restrict__ cums,
            float* __restrict__ y, int Q, int N, int H, int P, int ldg,
            bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* Gp = smem;
  float* ring = Gp + BR * ldg;
  float* frag = ring + 2 * Y_STAGE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;               // the warp's rows of the tile
  const int sel = warp >> 2;                    // k half / slot of the pair
  const int it = gridDim.x - 1 - blockIdx.x;    // heaviest i tile first
  const int h0 = blockIdx.y * HG, nh = min(HG, H - h0);
  const size_t bc = blockIdx.z;
  const int i0 = it * BR, irows = min(BR, Q - i0);
  const float* Cc = C + bc * Q * N;
  const float* Bc = B + bc * Q * N;

  // ---- phase 1: Gp[i][j] = sum_n C[i0+i][n] B[j][n], j < (it+1)*64 ----
  const int nk = (N + KC - 1) / KC;
  const int steps1 = (it + 1) * nk;
  auto load1 = [&](int s) {
    const int jt = s / nk, n0 = (s - jt * nk) * KC;
    float* Cs = ring + (s & 1) * Y_STAGE;
    const int cols = min(KC, N - n0);
    stage_tile<Y_THREADS>(Cs, LDK, Cc + (size_t)i0 * N + n0, N, irows, cols,
                          KC, vec);
    stage_tile<Y_THREADS>(Cs + BR * LDK, LDK, Bc + (size_t)jt * BR * N + n0,
                          N, min(BR, Q - jt * BR), cols, KC, vec);
    cp_commit();
  };
  float acc[SP / 8][4];
  load1(0);
  for (int s = 0; s < steps1; ++s) {
    if (s + 1 < steps1) {
      load1(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int jt = s / nk, kc = s - jt * nk;
    const float* Cs = ring + (s & 1) * Y_STAGE;
    const float* Bs = Cs + BR * LDK;
    if (kc == 0) {
#pragma unroll
      for (int nt = 0; nt < SP / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
    }
#pragma unroll
    for (int k2 = 0; k2 < KC / 16; ++k2) {   // this warp's half of the chunk
      const int kk = (KC / 16) * sel + k2;
      const float* ca = Cs + (r0 + g) * LDK + kk * 8 + t;
      uint32_t ahi[4], alo[4];
      split(ca[0], ahi[0], alo[0]);
      split(ca[8 * LDK], ahi[1], alo[1]);
      split(ca[4], ahi[2], alo[2]);
      split(ca[8 * LDK + 4], ahi[3], alo[3]);
      uint32_t bh[SP / 8][2], bl[SP / 8][2];
#pragma unroll
      for (int nt = 0; nt < SP / 8; ++nt) {
        const float* bb = Bs + (nt * 8 + g) * LDK + kk * 8 + t;
        split(bb[0], bh[nt][0], bl[nt][0]);
        split(bb[4], bh[nt][1], bl[nt][1]);
      }
      mma3<SP / 8>(acc, ahi, alo, bh, bl);
    }
    if (kc == nk - 1) {   // the panel gets the sum of the two k halves
      float* gp = Gp + (r0 + g) * ldg + jt * BR + 2 * t;
      if (sel == 1) {
#pragma unroll
        for (int nt = 0; nt < SP / 8; ++nt) {
          gp[nt * 8] = acc[nt][0];
          gp[nt * 8 + 1] = acc[nt][1];
          gp[8 * ldg + nt * 8] = acc[nt][2];
          gp[8 * ldg + nt * 8 + 1] = acc[nt][3];
        }
      }
      __syncthreads();
      if (sel == 0) {
#pragma unroll
        for (int nt = 0; nt < SP / 8; ++nt) {
          gp[nt * 8] += acc[nt][0];
          gp[nt * 8 + 1] += acc[nt][1];
          gp[8 * ldg + nt * 8] += acc[nt][2];
          gp[8 * ldg + nt * 8 + 1] += acc[nt][3];
        }
      }
    }
    __syncthreads();   // the stage is free for the next load
  }

  // ---- phase 2: per slot pair, y over the j tiles <= it ----
  // Off the diagonal (j < i0 <= i) the decay is taken as
  // exp(ci - c0) * exp(c0 - cj) with c0 = cums[i0 - 1]: cums does not
  // rise, so both factors are <= 1 and neither overflows.
  // exp(c0 - cj) weights the dtx rows in the split pass, exp(ci - c0)
  // scales the accumulator before the diagonal tile, which takes the
  // masked exp(ci - cj) directly.
  const int cpb = (P + SP - 1) / SP;            // slots per head
  const int ns = nh * cpb;
  const int nj = it + 1;
  const int steps2 = (ns + 1) / 2 * nj;
  const size_t xrow = (size_t)H * P;
  auto slot_head = [&](int q) { return h0 + q / cpb; };
  auto slot_col = [&](int q) { return (q % cpb) * SP; };
  auto load2 = [&](int s) {
    const int pi = s / nj, jt = s - pi * nj;
    const int j0 = jt * BR, rows = min(BR, Q - j0);
    float* st = ring + (s & 1) * Y_STAGE;
    for (int u = 0; u < 2 && 2 * pi + u < ns; ++u) {
      const int q = 2 * pi + u, h = slot_head(q), c0 = slot_col(q);
      float* x = st + u * SLOT_STAGE;
      stage_tile<Y_THREADS>(x, LDX,
                            dtx + (bc * Q + j0) * xrow + (size_t)h * P + c0,
                            xrow, rows, min(SP, P - c0), SP, vec);
      stage_cums(x + BR * LDX, cums + (bc * Q + j0) * H + h, H, rows);
    }
    cp_commit();
  };
  const int ia = i0 + r0 + g, ib = ia + 8;      // the thread's two rows
  const int la = r0 + g, lb = la + 8;           // the same, in the tile
  const float* crow = cums + bc * Q * H;        // cums[bc][i][h] = crow[i*H+h]
  float yacc[32];                               // m64n64 accumulator
  float ci0 = 0.f, ci1 = 0.f;
  load2(0);
  for (int s = 0; s < steps2; ++s) {
    const int pi = s / nj, jt = s - pi * nj;
    const bool diag = jt == it;
    const int nvalid = min(2, ns - 2 * pi);
    const int q = 2 * pi + sel;
    // the cums this step reads from global memory, loaded before the waits
    const int wu = threadIdx.x / BR;            // weights: slot of the row
    const float wc0 = !diag && wu < nvalid
        ? crow[(size_t)(i0 - 1) * H + slot_head(2 * pi + wu)] : 0.f;
    const int hq = slot_head(min(q, ns - 1));
    const float c0 = it > 0 ? crow[(size_t)(i0 - 1) * H + hq] : 0.f;
    if (jt == 0) {
      ci0 = ia < Q ? crow[(size_t)ia * H + hq] : -INFINITY;
      ci1 = ib < Q ? crow[(size_t)ib * H + hq] : -INFINITY;
    }
    if (s + 1 < steps2) {
      load2(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float* st = ring + (s & 1) * Y_STAGE;
    if (!diag && threadIdx.x < 2 * BR && wu < nvalid) {
      float* w = st + wu * SLOT_STAGE + BR * LDX;   // cums -> exp(c0 - cj)
      w[threadIdx.x - wu * BR] = expf(wc0 - w[threadIdx.x - wu * BR]);
    }
    __syncthreads();
    split_slots<Y_THREADS>(st, frag, nvalid, diag);
    __syncthreads();

    if (q < ns) {
      const int h = hq;
      if (jt == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) yacc[e] = 0.f;
      }
      if (diag && it > 0) {
        const float s0 = expf(ci0 - c0), s1 = expf(ci1 - c0);
#pragma unroll
        for (int nt = 0; nt < SP / 8; ++nt) {
          yacc[4 * nt] *= s0;
          yacc[4 * nt + 1] *= s0;
          yacc[4 * nt + 2] *= s1;
          yacc[4 * nt + 3] *= s1;
        }
      }
      const float* cj = st + sel * SLOT_STAGE + BR * LDX;   // raw on diag
      const float* ga = Gp + la * ldg + jt * BR + t;
      uint32_t ahi[BR / 8][4], alo[BR / 8][4];  // att, all 8 k-steps
#pragma unroll
      for (int kk = 0; kk < BR / 8; ++kk) {
        const int j = kk * 8 + t;               // columns j and j + 4
        const float* gk = ga + kk * 8;
        float a[4] = {gk[0], gk[8 * ldg], gk[4], gk[8 * ldg + 4]};
        if (diag) {   // masked to j <= i before the exp
          const float cj0 = cj[j], cj1 = cj[j + 4];
          a[0] *= expf(j <= la ? ci0 - cj0 : -INFINITY);
          a[1] *= expf(j <= lb ? ci1 - cj0 : -INFINITY);
          a[2] *= expf(j + 4 <= la ? ci0 - cj1 : -INFINITY);
          a[3] *= expf(j + 4 <= lb ? ci1 - cj1 : -INFINITY);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[e], ahi[kk][e], alo[kk][e]);
      }
      fence_regs(yacc);
      wgmma_fence();
      wgmma3_slot(yacc, ahi, alo, frag + sel * FRAG);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(yacc);
      if (diag) {
        float* yh = y + bc * Q * xrow + (size_t)h * P + slot_col(q);
        const int pmax = P - slot_col(q);
#pragma unroll
        for (int nt = 0; nt < SP / 8; ++nt) {
          const int p = nt * 8 + 2 * t;
          if (ia < Q) {
            if (p < pmax) yh[(size_t)ia * xrow + p] = yacc[4 * nt];
            if (p + 1 < pmax) yh[(size_t)ia * xrow + p + 1] = yacc[4 * nt + 1];
          }
          if (ib < Q) {
            if (p < pmax) yh[(size_t)ib * xrow + p] = yacc[4 * nt + 2];
            if (p + 1 < pmax) yh[(size_t)ib * xrow + p + 1] = yacc[4 * nt + 3];
          }
        }
      }
    }
    __syncthreads();   // the stage and the split slots are free
  }
}

// S: grid (ceil(H * slots per head / 2), batch*chunk), 8 warps. Warp
// group wg = w / 4 owns state rows 64wg..64wg+63 of both slots of the
// CTA's pair (an m64n64 accumulator each), warp w % 4 of it 16 of those
// rows. The decay exp(last - cums_j) weights the dtx rows in the split
// pass, so the A operand (the B tile, transposed, split in registers) is
// head-free. Shared memory: two ring stages of {B tile [64][ldb], two
// slots of {raw dtx [64][LDX], cums or weights [64]}}; two split slots.
__global__ void __launch_bounds__(S_THREADS, 1)
ssd_intra_state(const float* __restrict__ B, const float* __restrict__ dtx,
                const float* __restrict__ cums, float* __restrict__ S, int Q,
                int N, int H, int P, int ldb, int stage, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* frag = smem + 2 * stage;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;                     // warpgroup: state rows 64wg..
  const int r0 = wg * 64 + (warp & 3) * 16;     // the warp's 16 of them
  const int cpb = (P + SP - 1) / SP;
  const int ns = H * cpb;
  const int q0 = blockIdx.x * 2, nvalid = min(2, ns - q0);
  const size_t bc = blockIdx.y;
  const size_t xrow = (size_t)H * P;
  const int nj = (Q + BR - 1) / BR;
  const int npad = (N + 63) & ~63;
  const float* crow = cums + bc * Q * H;
  auto load = [&](int jt) {
    const int j0 = jt * BR, rows = min(BR, Q - j0);
    float* Bs = smem + (jt & 1) * stage;
    stage_tile<S_THREADS>(Bs, ldb, B + (bc * Q + j0) * N, N, rows, N, npad,
                          vec);
    for (int u = 0; u < nvalid; ++u) {
      const int q = q0 + u, h = q / cpb, c0 = (q % cpb) * SP;
      float* x = Bs + BR * ldb + u * SLOT_STAGE;
      stage_tile<S_THREADS>(x, LDX,
                            dtx + (bc * Q + j0) * xrow + (size_t)h * P + c0,
                            xrow, rows, min(SP, P - c0), SP, vec);
      stage_cums(x + BR * LDX, crow + (size_t)j0 * H + h, H, rows);
    }
    cp_commit();
  };
  float acc[2][32];                             // m64n64, per slot
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[u][e] = 0.f;
  const bool active = wg * 64 < N;

  load(0);
  for (int jt = 0; jt < nj; ++jt) {
    if (jt + 1 < nj) {
      load(jt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float* Bs = smem + (jt & 1) * stage;
    float* st = Bs + BR * ldb;
    if (threadIdx.x < 2 * BR) {                 // cums -> exp(last - cj)
      const int u = threadIdx.x / BR, r = threadIdx.x - u * BR;
      if (u < nvalid) {
        const int h = (q0 + u) / cpb;
        float* w = st + u * SLOT_STAGE + BR * LDX;
        w[r] = expf(crow[(size_t)(Q - 1) * H + h] - w[r]);
      }
    }
    __syncthreads();
    split_slots<S_THREADS>(st, frag, nvalid, false);
    __syncthreads();
    if (active) {
      uint32_t ahi[BR / 8][4], alo[BR / 8][4];  // A[n][j] = B[j][n]
#pragma unroll
      for (int kk = 0; kk < BR / 8; ++kk) {
        const float* bb = Bs + (kk * 8 + t) * ldb + r0 + g;
        split(bb[0], ahi[kk][0], alo[kk][0]);
        split(bb[8], ahi[kk][1], alo[kk][1]);
        split(bb[4 * ldb], ahi[kk][2], alo[kk][2]);
        split(bb[4 * ldb + 8], ahi[kk][3], alo[kk][3]);
      }
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (u < nvalid) wgmma3_slot(acc[u], ahi, alo, frag + u * FRAG);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
    }
    __syncthreads();   // the stage and the split slots are free
  }

  if (!active) return;
  const int na = r0 + g, nb = na + 8;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u >= nvalid) continue;
    const int q = q0 + u, h = q / cpb, c0 = (q % cpb) * SP;
    const int pmax = P - c0;
    float* Sh = S + (bc * H + h) * (size_t)N * P + c0;
#pragma unroll
    for (int nt = 0; nt < SP / 8; ++nt) {
      const int p = nt * 8 + 2 * t;
      if (na < N) {
        if (p < pmax) Sh[(size_t)na * P + p] = acc[u][4 * nt];
        if (p + 1 < pmax) Sh[(size_t)na * P + p + 1] = acc[u][4 * nt + 1];
      }
      if (nb < N) {
        if (p < pmax) Sh[(size_t)nb * P + p] = acc[u][4 * nt + 2];
        if (p + 1 < pmax) Sh[(size_t)nb * P + p + 1] = acc[u][4 * nt + 3];
      }
    }
  }
}

}  // namespace

// C/B (BC, Q, N), dtx (BC, Q, H, P), cums (BC, Q, H): contiguous f32 with
// BC = batch * chunks, Q <= 256, N <= 128, P <= 128. Writes y (BC, Q, H, P)
// and S (BC, H, N, P). Returns the launches' cudaError_t (0 = success).
extern "C" int ssd_intra_launch(const float* C, const float* B,
                                const float* dtx, const float* cums,
                                float* y, float* S, int BC, int Q, int N,
                                int H, int P, void* stream) {
  if (BC <= 0 || BC > 65535 || Q <= 0 || Q > MAXQ || H <= 0 || N < 1 ||
      N > MAXN || P < 1 || P > MAXP)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = N % 4 == 0 && P % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(C) |
                     reinterpret_cast<uintptr_t>(B) |
                     reinterpret_cast<uintptr_t>(dtx)) & 15) == 0;
  const int nit = (Q + BR - 1) / BR;
  const int ldg = nit * BR + 4;
  const size_t smem_y =
      (size_t)(BR * ldg + 2 * Y_STAGE + 2 * FRAG) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_y, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_y);
  if (err != cudaSuccess) return (int)err;
  ssd_intra_y<<<dim3(nit, (H + HG - 1) / HG, BC), Y_THREADS, smem_y, st>>>(
      C, B, dtx, cums, y, Q, N, H, P, ldg, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // B-tile stride 8 mod 32 words: the transposed A-fragment reads of
  // (row t, column g) hit 32 banks
  const int ldb = ((N + 63) & ~63) + 8;
  const int stage = BR * ldb + 2 * SLOT_STAGE;
  const size_t smem_s = (size_t)(2 * stage + 2 * FRAG) * sizeof(float);
  err = cudaFuncSetAttribute(ssd_intra_state,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_s);
  if (err != cudaSuccess) return (int)err;
  const int slots = H * ((P + SP - 1) / SP);
  ssd_intra_state<<<dim3((slots + 1) / 2, BC), S_THREADS, smem_s, st>>>(
      B, dtx, cums, S, Q, N, H, P, ldb, stage, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
