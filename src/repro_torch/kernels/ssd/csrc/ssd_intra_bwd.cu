// Backward of the Mamba-2 SSD intra-chunk form for Hopper (sm_90a):
// 3xTF32 tensor-core products with f32 accumulation, one G panel shared by
// a group of heads, no atomics.
//
// The Pallas TPU kernel `repro.kernels.ssd.ssd.ssd_intra_pallas`
// (src/repro/kernels/ssd/ssd.py) has no backward of its own: the reference
// differentiates its jnp form `ssd_ref` (src/repro/kernels/ssd/ref.py).
// This kernel is the backward of the port's forward `ssd_intra.cu`, and
// its plain version is `ref.ssd_intra_bwd_ref`. Per batch*chunk c and head
// h, with i, j rows of the chunk (Q rows), X = dtx[:, h], c = cums[:, h],
// G = C.B^T, decay_ij = exp(c_i - c_j) for i >= j (else 0), att = G o decay,
// w_j = exp(c_last - c_j), and the cotangents dY = dy[:, h], dS = dS[h]:
//   dAtt    = dY.X^T                   dG = sum_h dAtt o decay
//   ddtx_j  = sum_i att_ij dY_i + w_j (B_j . dS)
//   dC      = dG.B                     dB = dG^T.C + sum_h w o (X.dS^T)
//   dcums_i = sum_j (dAtt o att)_ij - X_i . ddtx_i + [i = last] sum_j g_j
// with g_j = w_j X_j . (B_j . dS). The middle dcums term is the column sum
// sum_i' (dAtt o att)_i'i plus g_i, both in one dot product: X_j . ddtx_j.
//
// What bounds it on this card. At the mamba2-370m training shape (b=8,
// nc=16, Q=256, N=128, H=32, P=64) the function needs 7.222e10 operations
// (G recomputed, dC and dB over the i >= j pairs once per chunk; per head
// the decay, dAtt and att^T.dY over the pairs, B.dS and X.dS^T over Q x N
// x P) on 1,015,021,568 bytes (C, B, dtx, cums, dy, dS read once; dC, dB,
// ddtx, dcums written once; `chip_smoke.py::ssd_bwd_work`). Every product
// runs as three TF32 products, so the card's least time is max(3 x
// 7.222e10 / 495 TFLOP/s = 0.4377 ms, 1,015,021,568 B / 3.35 TB/s = 0.3030
// ms): 0.4377 ms of operations. The same work as f32 FMAs on the CUDA
// cores is bounded at 1.0779 ms, which is why this kernel left them.
//
// Why 3xTF32. The kernel is held in f32 against `ssd_intra_bwd_ref` at
// atol 1e-4 x max(1, max|ref|) per output. Emulated on the CPU in this
// decomposition (tests/test_torch_ssd_bwd.py: test_bwd_3xtf32_emulation on
// eight cases from Q = 16 to mamba2's widths and strong decay, and
// test_bwd_one_tf32_product_misses_the_hold), 3xTF32 holds it and one
// TF32 product per multiply does not. Each operand x is split as hi =
// tf32(x) (cvt.rna) and lo = tf32(x - hi), and a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the small terms first), accumulated
// in f32, as the forward does. The tensor cores' f32 accumulation
// truncates, so a long reduction drifts: accumulated in one MMA chain,
// dB's state term (H x P = 16,384 long at jamba's layer) missed the hold
// on the card. `ssd_bwd_dcdb` therefore takes each 32-long K chunk in
// fresh accumulators and adds it to the running sum with an f32 add; the
// other reductions are at most 256 long.
//
// The design. One call launches three functions in order on one stream:
//  * the dx function, one CTA (8 warps) per (32-row j tile, group of HG =
//    8 heads, batch*chunk). It computes the panel G^T_ji = B_j . C_i for
//    every i >= j0 once for the group and keeps it in shared memory: G is
//    computed 4x per chunk at mamba2's 32 heads, not once per head. Per
//    head it takes the state part (w o B_j.dS, and its g_j sums) first,
//    then streams the i tiles of dY through a cp.async double buffer, split
//    in place (hi over the raw value, lo in a second plane). Per element it
//    takes one decay exp(c_i - c_j) and uses it twice: dL = dAtt o decay
//    goes into the group's dG^T panel (shared memory, summed over the heads
//    in order) and into the row sums of dL o G (dcums), att = G o decay
//    into ddtx's product. The group's dG^T panel goes to scratch once.
//    - `ssd_bwd_dxw` (P <= 64, mamba2): 128-row i tiles, warpgroup wg
//      taking rows 64wg..; dAtt (64 i x 32 j) = dY_i.X_j^T as wgmma
//      m64n32k8 (A = dY_i's rows from registers, B = X_j split once per
//      head into the K-major core-matrix layout wgmma reads), att written
//      to shared memory in that layout, and ddtx^T (64 p x 32 j) += dY_i^T
//      .att as wgmma m64n32k8 (A = dY_i^T from registers). B_j.dS is taken
//      transposed on mma.sync, dS^T.(w o B_j)^T, so that it lands in that
//      accumulator. The row sums over the 32 columns are complete in one
//      warp.
//    - `ssd_bwd_dx` (64 < P <= 128, jamba): every product on mma.sync
//      m16n8k8, warp (s, q) owning j rows 16s.. and i columns 16q.. of a
//      64-row i tile; att^T is taken from the dAtt^T accumulator as the
//      next A operand (a TF32 A fragment holds columns t and t + 4 where
//      the accumulator holds 2t and 2t + 1, so that product's k index is
//      permuted and dY's rows are read in the same order); the four
//      i-quarter partials of ddtx are summed in order through shared
//      memory.
//  * `ssd_bwd_dgsum` sums the groups' dG^T partials in group order into
//    one dG^T, masked to i >= j.
//  * `ssd_bwd_dcdb`, one CTA per (64-row tile, dB or dC, batch*chunk), on
//    mma.sync: dB_j = dG^T_j.C + [w o X]_j . [dS stacked], the state term
//    as one product with a reduction of H x P (per head a 32-column K chunk
//    of w o X against dS^h), not a loop of head products; dC_i = dG_i.B.
//    Both stream 32-long K chunks through a cp.async double buffer. The dC
//    CTAs also write dcums: the row sums, minus X . ddtx, plus the g sums
//    on the last row.
// Staging is cp.async (16-byte copies where the widths and pointers allow,
// else 4-byte), zero-filled past the last row and column. Operands read by
// several warps are split once in shared memory; the others in registers.
//  * No wasted diagonal halves. i tiles start at the j tile's first row.
//    On mma.sync a 16 x 8 sub-tile of dAtt^T wholly above the diagonal is
//    skipped with its k-step of att^T.dY; on wgmma the 64 x 32 tile the
//    diagonal crosses is masked and none lies wholly above it. dC and dB
//    skip the k-steps of dG that are wholly zero.
//  * Deterministic. Every sum over heads (dG^T in the panel, dB's state
//    term), over groups (dgsum), over warps (ddtx's partials, the row
//    sums' stripes, the g sums) and over tiles (the row sums, the g sums)
//    runs inside one CTA in a fixed order, and every output element is
//    written by one thread: no atomics, and two calls are bit-equal.
//  * The decay trap. Within a 256-row chunk cums falls to about -1,000, so
//    a factored exp(c_i) * exp(-c_j) overflows. Every decay is the exp of
//    the difference c_i - c_j (<= 0 as cums never rises), masked to i >= j
//    before the exp, as `ref.py` does; w_j = exp(c_last - c_j) <= 1.
//  * Scratch (`ssd_intra_bwd_scratch_floats`): the groups' dG^T partials
//    (BC, H/HG, Q, Q), the summed dG^T (BC, Q, Q), the row sums (BC, H, j
//    tiles, Q), X . ddtx (BC, Q, H) and the g sums (BC, H, j tiles); at
//    mamba2's training shape 134 + 34 + 34 MB.
//
// What holds it back (PERF.md has the times). With one 8-warp CTA per SM
// the dx functions are bound by latency, not by the tensor cores: timed
// with parts compiled out (tools/ssd_bwd_ablation.py), ssd_bwd_dxw's two
// wgmma products are a small part of its time at mamba2's training shape;
// the split pass, the exps and panel updates, B.dS on mma.sync and each
// head's staging and epilogue take the rest. mma.sync's TF32 rate is well
// below wgmma's on this card, and with both operands split it is bound by
// shared memory. Keep ptxas from serializing the wgmma (a wait after each
// HGMMA in the SASS, which chip_smoke.py checks): versions that held G and
// dG in registers, or put B.dS on wgmma, crossed into it. What is left:
// warp specialisation (a producer warp for the loads, warpgroups that do
// not wait for each other), dcdb's state term on wgmma, and a persistent
// grid that balances the j tiles' unequal work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXN = 128;       // state size
constexpr int MAXP = 128;       // head dim
constexpr int MAXQ = 256;       // chunk length
constexpr int BJ = 32;          // rows per j tile in ssd_bwd_dx
constexpr int BI = 64;          // rows per i tile (and per dcdb row tile)
constexpr int HG = 8;           // heads that share one G panel
constexpr int KC = 32;          // K chunk of ssd_bwd_dcdb
constexpr int THREADS = 256;    // 8 warps
constexpr int LDG = MAXQ + 8;   // panel stride (8 mod 32: float2 rows)
constexpr int STAGE = BI * (MAXP + 8);          // one ring stage
constexpr int LDR = MAXN + 4;   // B_j and C tiles (4 mod 32)
// ssd_bwd_dx (P > 64): 64-row i tiles, X_j and dY tiles with row stride
// DX_LDY, dS^h with DX_LDD (8 mod 32), the row-sum partials with DX_LDRED.
// Shared memory, in floats: G^T and dG^T panels, B_j, X_j hi and lo, two
// ring stages and the lo plane (dS^h spans the second stage and the lo
// plane), the tiles' cums, w_j, the row-sum partials and the g sums.
constexpr int DX_LDY = MAXP + 4;
constexpr int DX_LDD = MAXP + 8;
constexpr int DX_LDRED = BI + 8;
constexpr int DX_FLOATS = 2 * BJ * LDG + BJ * LDR + 2 * BJ * DX_LDY +
                          3 * STAGE + 2 * BI + 2 * BJ + 16 * DX_LDRED + 8;
static_assert(BI * DX_LDY <= STAGE && BI * LDR <= STAGE, "tiles fit a stage");
static_assert(MAXN * DX_LDD <= 2 * STAGE, "dS^h fits stage 1 and lo");
static_assert(4 * BJ * DX_LDY <= 2 * STAGE, "ddtx's partials fit the ring");
static_assert(DX_FLOATS * 4 <= 232448, "ssd_bwd_dx fits one SM");
// ssd_bwd_dxw's strides: dY and X_j tiles (4 mod 32), dS^h (8 mod 32),
// the panels (4 mod 32: a warp reads a column of j rows)
constexpr int WG_LDY = 64 + 4;
constexpr int WG_LDD = 64 + 8;
constexpr int WG_LDG = MAXQ + 4;
// its shared memory, in floats: G^T and dG^T panels, X_j's two planes,
// two warpgroups' att planes, two ring stages and the lo plane, the
// tiles' cums, w_j and the g sums
constexpr int DXW_FLOATS = 2 * BJ * WG_LDG + 6 * 8 * 256 + 3 * STAGE +
                           4 * BI + 2 * BJ + 8;
static_assert(DXW_FLOATS * 4 <= 232448, "ssd_bwd_dxw fits one SM");
static_assert(MAXN * WG_LDD + BJ * LDR + BJ * WG_LDY <= 2 * STAGE,
              "dS^h, B_j and X_j fit stage 1 and the lo plane");
static_assert(2 * BI * WG_LDY <= STAGE, "a 128-row dY tile fits a stage");
// ssd_bwd_dcdb's stage: A (64 x 36, or 32 x 72), B (32 x 136, or 128 x 36),
// 64 cums and the chunk's last
constexpr int LDA = KC + 4;     // A as [row][k] (4 mod 32)
constexpr int LDAT = BI + 8;    // A as [k][row] (8 mod 32)
constexpr int LDB = MAXN + 8;   // B as [k][n] (8 mod 32)
constexpr int A_FLOATS = BI * LDA;
constexpr int B_FLOATS = MAXN * LDA;
constexpr int DC_STAGE = A_FLOATS + B_FLOATS + BI + 4;
static_assert(KC * LDAT <= A_FLOATS && KC * LDB <= B_FLOATS, "stage fits");

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

// `nrows` x `cpad` of a row-major global block (row stride lds; `rows`
// rows and `cols` columns valid) into shared memory (row stride ldd), zero
// past the valid part. `vec`: 16-byte copies (cols, lds and the pointers
// 16-byte aligned); else 4-byte ones.
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src,
                                      size_t lds, int rows, int cols,
                                      int nrows, int cpad, bool vec) {
  if (vec) {
    const int cw = cpad >> 2;
    for (int idx = threadIdx.x; idx < nrows * cw; idx += THREADS) {
      const int r = idx / cw, c = (idx - r * cw) << 2;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * ldd + c, ok ? src + r * lds + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * cpad; idx += THREADS) {
      const int r = idx / cpad, c = idx - r * cpad;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * ldd + c, ok ? src + r * lds + c : src, ok);
    }
  }
}

// `n` values of one head's cums (stride H in global), zero past `rows`
__device__ __forceinline__ void stage_cums(float* dst, const float* src,
                                           int H, int rows, int n) {
  const int r = threadIdx.x;
  if (r < n) {
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

// in place over ROWS x COLS of a tile (row stride ld a multiple of 4,
// COLS <= 128 a power of 2): hi over the raw value, lo at the same offset
// in `lo`; every thread takes 4-column pieces in turn
template <int ROWS, int COLS>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int ld) {
  constexpr int CW = COLS / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * CW; idx += THREADS) {
    const int r = idx / CW, c = (idx % CW) * 4;
    float4* ph = reinterpret_cast<float4*>(hi + r * ld + c);
    const float4 v = *ph;
    uint4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(ph) = h;
    *reinterpret_cast<uint4*>(lo + r * ld + c) = l;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[u] += a.b[u] in 3xTF32 for the n-tiles u < n of one k-step: each term
// is issued for every n-tile before the next term, so that n independent
// accumulators keep the tensor cores busy instead of one chain of three
template <int NT>
__device__ __forceinline__ void mma3n(float (*d)[4], const uint32_t (&ahi)[4],
                                      const uint32_t (&alo)[4],
                                      const uint32_t (&bh)[NT][2],
                                      const uint32_t (&bl)[NT][2], int n) {
#pragma unroll
  for (int u = 0; u < NT; ++u)
    if (u < n) mma_tf32(d[u], alo, bh[u][0], bh[u][1]);
#pragma unroll
  for (int u = 0; u < NT; ++u)
    if (u < n) mma_tf32(d[u], ahi, bl[u][0], bl[u][1]);
#pragma unroll
  for (int u = 0; u < NT; ++u)
    if (u < n) mma_tf32(d[u], ahi, bh[u][0], bh[u][1]);
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

// Element (n, k) of a 32-wide K-major B operand in that layout: per k-step
// of 8 a block of KB32 floats, 8 x 2 core matrices (8 n rows x 4 k, 16
// bytes a row), the two k halves 128 bytes apart (LBO), the 8-row n groups
// 256 bytes apart (SBO).
constexpr int KB32 = 256;
__device__ __forceinline__ int cm32(int n, int k) {
  return (k >> 3) * KB32 + (n >> 3) * 64 + ((k >> 2) & 1) * 32 +
         (n & 7) * 4 + (k & 3);
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
__device__ __forceinline__ void fence_regs(float (&d)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// Generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the 128 threads of warpgroup wg (named barrier wg + 1)
__device__ __forceinline__ void bar_warpgroup(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");
}

// D (m64 x n32, f32; d[nb][e] is the m16n8 C fragment of n-tile nb) += A
// (registers, tf32, the m16n8k8 A fragment of each warp's 16 rows) * B
// (shared memory, tf32, K-major): one k-step of 8.
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a.b over the k-steps kk < n (n <= 8) of a 32-wide B operand split
// in shared memory (hi plane at `bh`, lo plane at `bl`) in 3xTF32, the
// small terms first
__device__ __forceinline__ void wgmma3_n32(float (&d)[4][4],
                                           const uint32_t (&ahi)[8][4],
                                           const uint32_t (&alo)[8][4],
                                           const float* bh, const float* bl,
                                           int n) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk < n) {
      const uint64_t dh = smem_desc(bh + kk * KB32, 128, 256);
      const uint64_t dl = smem_desc(bl + kk * KB32, 128, 256);
      wgmma_n32(d, alo[kk], dh);
      wgmma_n32(d, ahi[kk], dl);
      wgmma_n32(d, ahi[kk], dh);
    }
  }
}

// the m16n8k8 A fragment of rows r, r + 8 and columns k, k + 4 of a
// row-major tile (stride ld), split in registers
__device__ __forceinline__ void frag_a(const float* p, int ld,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

// the same fragment from a tile split in shared memory already
__device__ __forceinline__ void frag_a_split(const float* h, const float* l,
                                             int off, int ld,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  hi[0] = __float_as_uint(h[off]);
  hi[1] = __float_as_uint(h[off + 8 * ld]);
  hi[2] = __float_as_uint(h[off + 4]);
  hi[3] = __float_as_uint(h[off + 8 * ld + 4]);
  lo[0] = __float_as_uint(l[off]);
  lo[1] = __float_as_uint(l[off + 8 * ld]);
  lo[2] = __float_as_uint(l[off + 4]);
  lo[3] = __float_as_uint(l[off + 8 * ld + 4]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The panel Gt[j][i - j0] = B_j . C_i (row stride ldg) for every i >= j0,
// over 64-row C tiles staged through the ring's two stages (`Bjs` is B_j,
// staged by the caller in the same copy group as the first tile; row
// stride LDR). Warp (s, q) takes rows 16s.. and columns 16q.. of each
// tile. The caller syncs before reading the panel.
__device__ __forceinline__ void g_panel(float* Gt, int ldg, const float* Bjs,
                                        float* ring, const float* Cc, int j0,
                                        int Q, int N, bool vecN) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 1), q = warp >> 1;
  const int kn = (N + 7) / 8;
  const int ngt = (Q - j0 + BI - 1) / BI;
  auto load_c = [&](int k) {
    const int i0 = j0 + k * BI;
    stage(ring + (k & 1) * STAGE, LDR, Cc + (size_t)i0 * N, N,
          min(BI, Q - i0), N, BI, 8 * kn, vecN);
    cp_commit();
  };
  load_c(0);
  for (int k = 0; k < ngt; ++k) {
    cp_wait<0>();
    __syncthreads();
    if (k + 1 < ngt) load_c(k + 1);
    const float* Cs = ring + (k & 1) * STAGE;
    float acc[2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      uint32_t ahi[4], alo[4];
      frag_a(Bjs + (r0 + g) * LDR + 8 * kk + t, LDR, ahi, alo);
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* bb = Cs + (16 * q + 8 * nt + g) * LDR + 8 * kk + t;
        split(bb[0], bh[nt][0], bl[nt][0]);
        split(bb[4], bh[nt][1], bl[nt][1]);
      }
      mma3n<2>(acc, ahi, alo, bh, bl, 2);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* gp = Gt + (r0 + g) * ldg + k * BI + 16 * q + 8 * nt + 2 * t;
      gp[0] = acc[nt][0];
      gp[1] = acc[nt][1];
      gp[8 * ldg] = acc[nt][2];
      gp[8 * ldg + 1] = acc[nt][3];
    }
  }
}

// ddtx, dG^T (the group's partial), the row sums, X . ddtx and the g sums
// of one (32-row j tile, group of HG heads), for 64 < P <= 128, every
// product on mma.sync. grid (j tiles, groups, batch*chunk), 8 warps.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_dx(const float* __restrict__ C, const float* __restrict__ B,
           const float* __restrict__ dtx, const float* __restrict__ cums,
           const float* __restrict__ dy, const float* __restrict__ dS,
           float* __restrict__ ddtx, float* __restrict__ dGp,
           float* __restrict__ rs, float* __restrict__ dcol,
           float* __restrict__ gsum, int Q, int N, int H, int P, bool vecN,
           bool vecP) {
  constexpr int NP = MAXP / 8;        // n-tiles over P
  constexpr int TI = BI, QW = TI / 4, NW = QW / 8, LDY = DX_LDY;
  constexpr int LDD = DX_LDD, LDRED = DX_LDRED;
  extern __shared__ __align__(16) float smem[];
  float* Gt = smem;                   // [BJ][LDG]: G^T_ji, i from j0
  float* dGt = Gt + BJ * LDG;         // [BJ][LDG]: the group's dG^T
  float* Bj = dGt + BJ * LDG;         // [BJ][LDR]: B_j, raw
  float* Xh = Bj + BJ * LDR;          // [BJ][LDY]: X_j, split in place
  float* Xl = Xh + BJ * LDY;
  float* ring = Xl + BJ * LDY;        // [2][STAGE]
  float* lo = ring + 2 * STAGE;       // [STAGE]: the lo plane of a dY tile
  float* ci = lo + STAGE;             // [2][TI]
  float* cj = ci + 2 * TI;            // [BJ]
  float* wj = cj + BJ;                // [BJ]
  float* red = wj + BJ;               // [2 x 8][LDRED]: row sums by (s, g)
  float* redg = red + 16 * LDRED;     // [8]: g sums by warp

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s = warp & 1;             // j rows 16s.. of the tile
  const int q = warp >> 1;            // i columns QW q.. of an i tile
  const int jt = blockIdx.x, grp = blockIdx.y;
  const int nj = gridDim.x, ng = gridDim.y;
  const size_t bc = blockIdx.z;
  const int j0 = jt * BJ, jrows = min(BJ, Q - j0);
  const int ni = Q - j0;              // the panel's columns
  const int nit = (ni + TI - 1) / TI;
  const int h0 = grp * HG, nh = min(HG, H - h0);
  const int kn = (N + 7) / 8, kp = (P + 7) / 8;
  const size_t xrow = (size_t)H * P;
  const int r0 = 16 * s;              // the warp's first row in the tile

  for (int idx = tid; idx < BJ * LDG; idx += THREADS) dGt[idx] = 0.f;
  stage(Bj, LDR, B + (bc * Q + j0) * N, N, jrows, N, BJ, 8 * kn, vecN);

  g_panel(Gt, LDG, Bj, ring, C + bc * Q * N, j0, Q, N, vecN);

  auto load_y = [&](int k, int h) {
    const int i0 = j0 + k * TI, rows = min(TI, Q - i0);
    stage(ring + (k & 1) * STAGE, LDY,
          dy + (bc * Q + i0) * xrow + (size_t)h * P, xrow, rows, P, TI,
          8 * kp, vecP);
    stage_cums(ci + (k & 1) * TI, cums + (bc * Q + i0) * H + h, H, rows, TI);
    cp_commit();
  };
  // the row sums of step k: the 16 (stripe, g) partials summed in order
  auto flush_rows = [&](float* rsh, int k) {
    const int i = j0 + k * TI + tid;
    if (tid < TI && i < Q) {
      float v = 0.f;
      for (int u = 0; u < 16; ++u) v += red[u * LDRED + tid];
      rsh[i] = v;
    }
  };

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    __syncthreads();                  // the ring, X_j and w_j are free
    stage(Xh, LDY, dtx + (bc * Q + j0) * xrow + (size_t)h * P, xrow, jrows,
          P, BJ, 8 * kp, vecP);
    stage_cums(cj, cums + (bc * Q + j0) * H + h, H, jrows, BJ);
    float* dSs = ring + STAGE;        // stage 1 and the lo plane
    stage(dSs, LDD, dS + (bc * H + h) * (size_t)N * P, P, N, P, 8 * kn,
          8 * kp, vecP);
    cp_commit();
    load_y(0, h);
    cp_wait<1>();
    __syncthreads();
    split_rows<BJ, 8 * NP>(Xh, Xl, LDY);
    if (tid < BJ) {
      const float clast = cums[(bc * Q + Q - 1) * H + h];
      wj[tid] = tid < jrows ? expf(clast - cj[tid]) : 0.f;
    }
    __syncthreads();

    // ---- B_j.dS over this warp's quarter of the states, then w o it ----
    float acc[NP][4];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pn][e] = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const int kk = 4 * q + k4;
      if (kk >= kn) break;
      uint32_t ahi[4], alo[4];
      frag_a(Bj + (r0 + g) * LDR + 8 * kk + t, LDR, ahi, alo);
#pragma unroll
      for (int p8 = 0; p8 < NP; p8 += 8) {
        if (p8 < kp) {
          const float* bb = dSs + (8 * kk + t) * LDD + 8 * p8 + g;
          uint32_t bh[8][2], bl[8][2];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            split(bb[8 * u], bh[u][0], bl[u][0]);
            split(bb[4 * LDD + 8 * u], bh[u][1], bl[u][1]);
          }
          mma3n<8>(acc + p8, ahi, alo, bh, bl, kp - p8);
        }
      }
    }
    {
      const float w[2] = {wj[r0 + g], wj[r0 + g + 8]};
      float gp = 0.f;
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        if (pn < kp) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = (r0 + g + 8 * (e >> 1)) * LDY + 8 * pn + 2 * t +
                          (e & 1);
            const float wv = w[e >> 1];
            gp += wv * ((Xh[o] + Xl[o]) * acc[pn][e]);
            acc[pn][e] *= wv;
          }
        }
      }
      gp = warp_sum(gp);
      if (lane == 0) redg[warp] = gp;
    }

    // ---- the i tiles: dAtt^T, dL, att^T, acc += att^T.dY_i ----
    float* rsh = rs + ((bc * H + h) * nj + jt) * Q;
    for (int k = 0; k < nit; ++k) {
      const int i0 = j0 + k * TI;
      cp_wait<0>();
      __syncthreads();                // tile k landed; step k - 1 is done
      if (k > 0) flush_rows(rsh, k - 1);
      float* Yh = ring + (k & 1) * STAGE;
      split_rows<TI, 8 * NP>(Yh, lo, LDY);
      __syncthreads();
      if (k + 1 < nit) load_y(k + 1, h);

      const float* cik = ci + (k & 1) * TI;
      // a sub-tile (16 rows x 8 columns) runs unless wholly above the
      // diagonal or past Q
      bool run[NW];
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        const int c0 = k * TI + QW * q + 8 * nt;     // from j0
        run[nt] = c0 + 7 >= r0 && j0 + c0 < Q;
      }
      bool any = false;
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) any = any || run[nt];
      // dAtt^T: the three terms in their own accumulators (3 NW chains
      // for the tensor cores), summed after the k loop
      float da[NW][4] = {};
      if (any) {
        float dlh[NW][4] = {}, dhl[NW][4] = {};
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
          if (kk >= kp) break;
          uint32_t ahi[4], alo[4];
          frag_a_split(Xh, Xl, (r0 + g) * LDY + 8 * kk + t, LDY, ahi, alo);
          uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
          for (int nt = 0; nt < NW; ++nt) {
            const int o = (QW * q + 8 * nt + g) * LDY + 8 * kk + t;
            bh[nt][0] = __float_as_uint(Yh[o]);
            bh[nt][1] = __float_as_uint(Yh[o + 4]);
            bl[nt][0] = __float_as_uint(lo[o]);
            bl[nt][1] = __float_as_uint(lo[o + 4]);
          }
#pragma unroll
          for (int nt = 0; nt < NW; ++nt)
            if (run[nt]) mma_tf32(dlh[nt], alo, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < NW; ++nt)
            if (run[nt]) mma_tf32(dhl[nt], ahi, bl[nt][0], bl[nt][1]);
#pragma unroll
          for (int nt = 0; nt < NW; ++nt)
            if (run[nt]) mma_tf32(da[nt], ahi, bh[nt][0], bh[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            da[nt][e] += dlh[nt][e] + dhl[nt][e];
      }
      // one decay per element, used twice: dL = dAtt^T o decay into the
      // group's dG^T and the row sums, att^T = G^T o decay
      float att[NW][4] = {};
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        const int il = QW * q + 8 * nt + 2 * t;      // in the i tile
        float cs[2] = {0.f, 0.f};
        if (run[nt]) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8
            const int jr = r0 + g + 8 * hr;
            const int po = jr * LDG + k * TI + il;
            const float2 gv = *reinterpret_cast<const float2*>(Gt + po);
            float2 dv = *reinterpret_cast<float2*>(dGt + po);
            const float gg[2] = {gv.x, gv.y};
            float dl[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = i0 + il + u, j = j0 + jr;
              // masked to i >= j before the exp
              const bool on = i >= j && i < Q && j < Q;
              const float ex = __expf(on ? cik[il + u] - cj[jr] : -INFINITY);
              dl[u] = da[nt][2 * hr + u] * ex;
              att[nt][2 * hr + u] = gg[u] * ex;
              cs[u] = fmaf(dl[u], gg[u], cs[u]);
            }
            dv.x += dl[0];
            dv.y += dl[1];
            *reinterpret_cast<float2*>(dGt + po) = dv;
          }
        }
        // this thread's part of the row sums (its rows g and g + 8),
        // summed over (stripe, g) in flush_rows
        *reinterpret_cast<float2*>(red + (s * 8 + g) * LDRED + il) =
            make_float2(cs[0], cs[1]);
      }
      // acc += att^T.dY_i: the accumulator's columns (2t, 2t + 1) are the
      // A fragment's k (t, t + 4), so dY's rows are read in that order
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        if (!run[nt]) continue;
        uint32_t ahi[4], alo[4];
        split(att[nt][0], ahi[0], alo[0]);
        split(att[nt][2], ahi[1], alo[1]);
        split(att[nt][1], ahi[2], alo[2]);
        split(att[nt][3], ahi[3], alo[3]);
        const int o = (QW * q + 8 * nt + 2 * t) * LDY + g;
#pragma unroll
        for (int p8 = 0; p8 < NP; p8 += 8) {
          if (p8 < kp) {
            uint32_t bh[8][2], bl[8][2];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int a = o + 8 * (p8 + u);
              bh[u][0] = __float_as_uint(Yh[a]);
              bh[u][1] = __float_as_uint(Yh[a + LDY]);
              bl[u][0] = __float_as_uint(lo[a]);
              bl[u][1] = __float_as_uint(lo[a + LDY]);
            }
            mma3n<8>(acc + p8, ahi, alo, bh, bl, kp - p8);
          }
        }
      }
    }

    // ---- the last row sums; ddtx = the quarters' sum, X_j . ddtx_j ----
    __syncthreads();
    flush_rows(rsh, nit - 1);
    float* part = ring;               // [4][BJ][LDY]
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      if (pn < kp) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float* d = part + (q * BJ + r0 + g + 8 * hr) * LDY + 8 * pn + 2 * t;
          *reinterpret_cast<float2*>(d) =
              make_float2(acc[pn][2 * hr], acc[pn][2 * hr + 1]);
        }
      }
    }
    __syncthreads();
    for (int rr = 0; rr < BJ / 8; ++rr) {
      const int r = (BJ / 8) * warp + rr, j = j0 + r;
      float dot = 0.f;
      for (int p = lane; p < P; p += 32) {
        const int o = r * LDY + p;
        const float v = ((part[o] + part[BJ * LDY + o]) +
                         part[2 * BJ * LDY + o]) + part[3 * BJ * LDY + o];
        if (j < Q) ddtx[(bc * Q + j) * xrow + (size_t)h * P + p] = v;
        dot = fmaf(v, Xh[o] + Xl[o], dot);
      }
      dot = warp_sum(dot);
      if (lane == 0 && j < Q) dcol[(bc * Q + j) * H + h] = dot;
    }
    if (tid == 0) {
      float sg = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) sg += redg[w];
      gsum[(bc * H + h) * nj + jt] = sg;
    }
  }

  // ---- the group's dG^T partial, rows j of the tile, columns i >= j0 ----
  __syncthreads();
  float* out = dGp + ((bc * ng + grp) * Q + j0) * Q + j0;
  for (int idx = tid; idx < jrows * ni; idx += THREADS) {
    const int r = idx / ni, c = idx - r * ni;
    out[(size_t)r * Q + c] = dGt[r * LDG + c];
  }
}

// ssd_bwd_dx for P <= 64 with its two large products on wgmma: the same
// work, tiles and outputs, grid and launch as ssd_bwd_dx<8>. Per 128-row
// i tile warpgroup wg takes i rows 64wg..: dAtt (64 i x 32 j) = dY_i.X_j^T
// as wgmma m64n32k8 (A = dY_i's rows from registers, B = X_j from shared
// memory, split once per head into the K-major core-matrix layout), then
// per element one decay for dL and att; att goes to shared memory in the
// same layout, and ddtx^T (64 p x 32 j) += dY_i^T.att as wgmma m64n32k8
// (A = dY_i^T from registers). B_j.dS is taken transposed on mma.sync,
// (w o B_j dS)^T = dS^T.(w o B_j)^T, so that it lands in that accumulator:
// warpgroup wg takes states 64wg.. of it. The row sums of dL o G over the
// 32 j columns are complete in one warp's rows.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_dxw(const float* __restrict__ C, const float* __restrict__ B,
            const float* __restrict__ dtx, const float* __restrict__ cums,
            const float* __restrict__ dy, const float* __restrict__ dS,
            float* __restrict__ ddtx, float* __restrict__ dGp,
            float* __restrict__ rs, float* __restrict__ dcol,
            float* __restrict__ gsum, int Q, int N, int H, int P, bool vecN,
            bool vecP) {
  constexpr int TI = 2 * BI, LDY = WG_LDY, LDD = WG_LDD, LDG2 = WG_LDG;
  constexpr int XP = 8 * KB32;        // a split plane of X_j or of att
  extern __shared__ __align__(16) float smem[];
  float* Gt = smem;                   // [BJ][LDG2]: G^T_ji, i from j0
  float* dGt = Gt + BJ * LDG2;        // [BJ][LDG2]: the group's dG^T
  float* Xb = dGt + BJ * LDG2;        // X_j: hi plane, lo plane (cm32)
  float* atp = Xb + 2 * XP;           // att per warpgroup: hi, lo (cm32)
  float* ring = atp + 4 * XP;         // [2][STAGE]: dY tiles
  float* lo = ring + 2 * STAGE;       // [STAGE]: the lo plane of a dY tile
  float* ci = lo + STAGE;             // [2][TI]
  float* cj = ci + 2 * TI;            // [BJ]
  float* wj = cj + BJ;                // [BJ]
  float* redg = wj + BJ;              // [8]: g sums by warp
  // at a head's start stage 1 and the lo plane hold dS^h, B_j and X_j raw
  float* dSs = ring + STAGE;          // [N][LDD]
  float* Bjs = dSs + MAXN * WG_LDD;   // [BJ][LDR]
  float* Xr = Bjs + BJ * LDR;         // [BJ][LDY]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, w4 = warp & 3;
  const int jt = blockIdx.x, grp = blockIdx.y;
  const int nj = gridDim.x, ng = gridDim.y;
  const size_t bc = blockIdx.z;
  const int j0 = jt * BJ, jrows = min(BJ, Q - j0);
  const int ni = Q - j0;
  const int nit = (ni + TI - 1) / TI;
  const int h0 = grp * HG, nh = min(HG, H - h0);
  const int kn = (N + 7) / 8, kp = (P + 7) / 8;
  const size_t xrow = (size_t)H * P;

  for (int idx = tid; idx < BJ * LDG2; idx += THREADS) dGt[idx] = 0.f;
  stage(Bjs, LDR, B + (bc * Q + j0) * N, N, jrows, N, BJ, 8 * kn, vecN);
  g_panel(Gt, LDG2, Bjs, ring, C + bc * Q * N, j0, Q, N, vecN);

  auto load_y = [&](int k, int h) {
    const int i0 = j0 + k * TI, rows = min(TI, Q - i0);
    stage(ring + (k & 1) * STAGE, LDY,
          dy + (bc * Q + i0) * xrow + (size_t)h * P, xrow, rows, P, TI, 64,
          vecP);
    stage_cums(ci + (k & 1) * TI, cums + (bc * Q + i0) * H + h, H, rows, TI);
    cp_commit();
  };

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    __syncthreads();                  // the ring, X_j and w_j are free
    stage(dSs, LDD, dS + (bc * H + h) * (size_t)N * P, P, N, P, 8 * kn, 64,
          vecP);
    stage(Bjs, LDR, B + (bc * Q + j0) * N, N, jrows, N, BJ, 8 * kn, vecN);
    stage(Xr, LDY, dtx + (bc * Q + j0) * xrow + (size_t)h * P, xrow, jrows,
          P, BJ, 64, vecP);
    stage_cums(cj, cums + (bc * Q + j0) * H + h, H, jrows, BJ);
    cp_commit();
    load_y(0, h);
    cp_wait<1>();
    __syncthreads();
    // X_j into dAtt's B operand: hi and lo planes, K-major core matrices
    for (int idx = tid; idx < BJ * 16; idx += THREADS) {
      const int j = idx >> 4, p = (idx & 15) * 4;
      const float4 v = *reinterpret_cast<const float4*>(Xr + j * LDY + p);
      uint4 hv, lv;
      split(v.x, hv.x, lv.x);
      split(v.y, hv.y, lv.y);
      split(v.z, hv.z, lv.z);
      split(v.w, hv.w, lv.w);
      *reinterpret_cast<uint4*>(Xb + cm32(j, p)) = hv;
      *reinterpret_cast<uint4*>(Xb + XP + cm32(j, p)) = lv;
    }
    if (tid < BJ) {
      const float clast = cums[(bc * Q + Q - 1) * H + h];
      wj[tid] = tid < jrows ? expf(clast - cj[tid]) : 0.f;
    }
    __syncthreads();
    float cjr[4][2];                  // c_j of this thread's columns
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int u = 0; u < 2; ++u) cjr[nb][u] = cj[8 * nb + 2 * t + u];

    // ---- (w o B_j dS)^T over this warpgroup's half of the states ----
    float acc[4][4] = {};
    {
#pragma unroll
      for (int k8 = 0; k8 < 8; ++k8) {
        const int kk = 8 * wg + k8;
        if (kk >= kn) break;
        uint32_t ahi[4], alo[4];      // A = dS^T: row p, k = state
        const float* ap = dSs + (8 * kk + t) * LDD + 16 * w4 + g;
        split(ap[0], ahi[0], alo[0]);
        split(ap[8], ahi[1], alo[1]);
        split(ap[4 * LDD], ahi[2], alo[2]);
        split(ap[4 * LDD + 8], ahi[3], alo[3]);
        uint32_t bh[4][2], bl[4][2];  // B = (w o B_j)^T: k = state, n = j
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int j = 8 * nb + g;
          const float* bp = Bjs + j * LDR + 8 * kk + t;
          split(wj[j] * bp[0], bh[nb][0], bl[nb][0]);
          split(wj[j] * bp[4], bh[nb][1], bl[nb][1]);
        }
        mma3n<4>(acc, ahi, alo, bh, bl, 4);
      }
      // its g_j = X_j . (w o B_j dS)_j, summed over this thread's part
      float gp = 0.f;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * w4 + g + 8 * (e >> 1);
          const int j = 8 * nb + 2 * t + (e & 1);
          gp = fmaf(Xr[j * LDY + p], acc[nb][e], gp);
        }
      gp = warp_sum(gp);
      if (lane == 0) redg[warp] = gp;
    }

    // ---- the i tiles: dAtt, dL, att, ddtx^T += dY_i^T.att ----
    float* rsh = rs + ((bc * H + h) * nj + jt) * Q;
    float* ah = atp + wg * 2 * XP;    // this warpgroup's att planes
    float* al = ah + XP;
    for (int k = 0; k < nit; ++k) {
      const int i0 = j0 + k * TI;
      cp_wait<0>();
      __syncthreads();                // tile k landed; step k - 1 is done
      float* Yh = ring + (k & 1) * STAGE;
      split_rows<TI, 64>(Yh, lo, LDY);
      __syncthreads();
      if (k + 1 < nit) load_y(k + 1, h);
      const int ib = 64 * wg;         // this warpgroup's rows of the tile
      if (i0 + ib >= Q) continue;     // wholly past Q
      const float* cik = ci + (k & 1) * TI;

      uint32_t ahi[8][4], alo[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        if (kk < kp)
          frag_a_split(Yh, lo, (ib + 16 * w4 + g) * LDY + 8 * kk + t, LDY,
                       ahi[kk], alo[kk]);
      float da[4][4] = {};
      fence_regs(da);
      wgmma_fence();
      wgmma3_n32(da, ahi, alo, Xb, Xb + XP, kp);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(da);

      const float cr[2] = {cik[ib + 16 * w4 + g], cik[ib + 16 * w4 + g + 8]};
      float rsv[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int kl = 16 * w4 + g + 8 * hr;       // row in the warpgroup
          const int il = ib + kl;                    // row in the i tile
          const int jr = 8 * nb + 2 * t + (e & 1);   // column j - j0
          const int i = i0 + il, j = j0 + jr;
          // masked to i >= j before the exp
          const bool on = i >= j && i < Q && j < Q;
          const float ex =
              __expf(on ? cr[hr] - cjr[nb][e & 1] : -INFINITY);
          const int po = jr * LDG2 + k * TI + il;
          const float gv = Gt[po];
          const float dl = da[nb][e] * ex;
          rsv[hr] = fmaf(dl, gv, rsv[hr]);
          dGt[po] += dl;
          uint32_t hv, lv;
          split(gv * ex, hv, lv);
          ah[cm32(jr, kl)] = __uint_as_float(hv);
          al[cm32(jr, kl)] = __uint_as_float(lv);
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // row i's sum over the 32 columns
        float v = rsv[hr];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int i = i0 + ib + 16 * w4 + g + 8 * hr;
        if (t == 0 && i < Q) rsh[i] = v;
      }
      fence_proxy_async();
      bar_warpgroup(wg);

#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // A = dY_i^T: row p, k = i
        const int o = (ib + 8 * kk + t) * LDY + 16 * w4 + g;
        ahi[kk][0] = __float_as_uint(Yh[o]);
        ahi[kk][1] = __float_as_uint(Yh[o + 8]);
        ahi[kk][2] = __float_as_uint(Yh[o + 4 * LDY]);
        ahi[kk][3] = __float_as_uint(Yh[o + 4 * LDY + 8]);
        alo[kk][0] = __float_as_uint(lo[o]);
        alo[kk][1] = __float_as_uint(lo[o + 8]);
        alo[kk][2] = __float_as_uint(lo[o + 4 * LDY]);
        alo[kk][3] = __float_as_uint(lo[o + 4 * LDY + 8]);
      }
      fence_regs(acc);
      wgmma_fence();
      wgmma3_n32(acc, ahi, alo, ah, al, 8);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }

    // ---- ddtx = the warpgroups' sum (transposed back), X_j . ddtx_j ----
    __syncthreads();
    float* part = ring;               // [2][BJ][LDY]
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * w4 + g + 8 * (e >> 1);
        const int j = 8 * nb + 2 * t + (e & 1);
        part[(wg * BJ + j) * LDY + p] = acc[nb][e];
      }
    __syncthreads();
    for (int rr = 0; rr < BJ / 8; ++rr) {
      const int r = (BJ / 8) * warp + rr, j = j0 + r;
      float dot = 0.f;
      for (int p = lane; p < P; p += 32) {
        const float v = part[r * LDY + p] + part[(BJ + r) * LDY + p];
        if (j < Q) ddtx[(bc * Q + j) * xrow + (size_t)h * P + p] = v;
        dot = fmaf(v, Xb[cm32(r, p)] + Xb[XP + cm32(r, p)], dot);
      }
      dot = warp_sum(dot);
      if (lane == 0 && j < Q) dcol[(bc * Q + j) * H + h] = dot;
    }
    if (tid == 0) {
      float sg = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) sg += redg[w];
      gsum[(bc * H + h) * nj + jt] = sg;
    }
  }

  // ---- the group's dG^T partial, rows j of the tile, columns i >= j0 ----
  __syncthreads();
  float* out = dGp + ((bc * ng + grp) * Q + j0) * Q + j0;
  for (int idx = tid; idx < jrows * ni; idx += THREADS) {
    const int r = idx / ni, c = idx - r * ni;
    out[(size_t)r * Q + c] = dGt[r * LDG2 + c];
  }
}

// dG^T[j][i] = the groups' partials summed in group order for i >= j,
// else 0. grid (Q, batch*chunk).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dgsum(const float* __restrict__ dGp, float* __restrict__ dG, int Q,
              int ng) {
  const int j = blockIdx.x;
  const size_t bc = blockIdx.y;
  for (int i = threadIdx.x; i < Q; i += THREADS) {
    float v = 0.f;
    if (i >= j)
      for (int gi = 0; gi < ng; ++gi)
        v += dGp[((bc * ng + gi) * Q + j) * Q + i];
    dG[(bc * Q + j) * Q + i] = v;
  }
}


// part[u] += a.b[u] over the n-tiles u < n of one k-step, B split in
// registers: from a [k][n] tile (bb at row k = t, column n = g) ...
__device__ __forceinline__ void mma_kn(float (&part)[8][4],
                                       const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4],
                                       const float* bb, int n) {
  uint32_t bh[8][2], bl[8][2];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    split(bb[8 * u], bh[u][0], bl[u][0]);
    split(bb[4 * LDB + 8 * u], bh[u][1], bl[u][1]);
  }
  mma3n<8>(part, ahi, alo, bh, bl, n);
}

// ... or from an [n][k] tile (bb at row n = g, column k = t)
__device__ __forceinline__ void mma_nk(float (&part)[8][4],
                                       const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4],
                                       const float* bb, int n) {
  uint32_t bh[8][2], bl[8][2];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    split(bb[8 * u * LDA], bh[u][0], bl[u][0]);
    split(bb[8 * u * LDA + 4], bh[u][1], bl[u][1]);
  }
  mma3n<8>(part, ahi, alo, bh, bl, n);
}

// dB (blockIdx.y = 0) or dC (1) of one 64-row tile, and dcums with dC.
// grid (row tiles, 2, batch*chunk), 8 warps: warp (r, c) owns rows 16r..
// and state columns 64c.. (8 n-tiles). K runs in 32-long chunks through a
// cp.async double buffer: dB takes dG^T_j.C_i over the i chunks >= the
// tile, then w o X^h . dS^hT over (head, 32 columns of P); dC takes
// dG_i.B_j over the j chunks <= the tile.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dcdb(const float* __restrict__ C, const float* __restrict__ B,
             const float* __restrict__ dtx, const float* __restrict__ cums,
             const float* __restrict__ dS, const float* __restrict__ dG,
             const float* __restrict__ rs, const float* __restrict__ dcol,
             const float* __restrict__ gsum, float* __restrict__ dC,
             float* __restrict__ dB, float* __restrict__ dcums, int Q, int N,
             int H, int P, int nj, bool vecN, bool vecP, bool vecQ) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp & 3), wc = 64 * (warp >> 2);
  const bool is_dc = blockIdx.y == 1;
  const size_t bc = blockIdx.z;
  const int t0 = blockIdx.x * BI, trows = min(BI, Q - t0);
  const int kn = (N + 7) / 8;
  const size_t xrow = (size_t)H * P;
  const int npc = (P + KC - 1) / KC;          // K chunks per head
  const int nI = (Q - t0 + KC - 1) / KC;      // dB: i chunks from t0
  const int nitems = is_dc ? (min(Q, t0 + BI) + KC - 1) / KC : nI + H * npc;

  if (is_dc) {   // dcums_i = row sums - X_i . ddtx_i (+ the g sums)
    for (int idx = tid; idx < trows * H; idx += THREADS) {
      const int r = idx / H, h = idx - r * H, i = t0 + r;
      const float* rh = rs + (bc * H + h) * nj * (size_t)Q + i;
      float v = 0.f;
      for (int jt = 0; jt <= i / BJ; ++jt) v += rh[(size_t)jt * Q];
      v -= dcol[(bc * Q + i) * H + h];
      if (i == Q - 1)
        for (int jt = 0; jt < nj; ++jt) v += gsum[(bc * H + h) * nj + jt];
      dcums[(bc * Q + i) * H + h] = v;
    }
  }

  auto issue = [&](int it) {
    float* As = smem + (it & 1) * DC_STAGE;
    float* Bs = As + A_FLOATS;
    float* cs = Bs + B_FLOATS;
    if (is_dc) {
      const int jc = it * KC, rows = min(KC, Q - jc);
      stage(As, LDAT, dG + (bc * Q + jc) * Q + t0, Q, rows, trows, KC, BI,
            vecQ);
      stage(Bs, LDB, B + (bc * Q + jc) * N, N, rows, N, KC, 8 * kn, vecN);
    } else if (it < nI) {
      const int ic = t0 + it * KC, cols = min(KC, Q - ic);
      stage(As, LDA, dG + (bc * Q + t0) * Q + ic, Q, trows, cols, BI, KC,
            vecQ);
      stage(Bs, LDB, C + (bc * Q + ic) * N, N, cols, N, KC, 8 * kn, vecN);
    } else {
      const int u = it - nI, h = u / npc, p0 = (u - h * npc) * KC;
      const int cols = min(KC, P - p0);
      stage(As, LDA, dtx + (bc * Q + t0) * xrow + (size_t)h * P + p0, xrow,
            trows, cols, BI, KC, vecP);
      stage(Bs, LDA, dS + (bc * H + h) * (size_t)N * P + p0, P, N, cols,
            8 * kn, KC, vecP);
      stage_cums(cs, cums + (bc * Q + t0) * H + h, H, trows, BI);
      if (tid == BI)
        cp_async4(cs + BI, cums + (bc * Q + Q - 1) * H + h, true);
    }
    cp_commit();
  };

  // this warp's n-tiles of N
  const int nvt = min(8, max(0, (N - wc + 7) / 8));
  float acc[8][4] = {};
  issue(0);
  for (int it = 0; it < nitems; ++it) {
    if (it + 1 < nitems) {
      issue(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* As = smem + (it & 1) * DC_STAGE;
    const float* Bs = As + A_FLOATS;
    const float* cs = Bs + B_FLOATS;
    float part[8][4] = {};            // this chunk's products
    if (is_dc) {                      // A = dG_i (from dG^T), B = B_j
      const int jc = it * KC;
      const int ks = (min(KC, Q - jc) + 7) / 8;
      for (int kk = 0; kk < ks; ++kk) {
        if (jc + 8 * kk > t0 + wr + 15) break;     // dG_ij = 0 for j > i
        uint32_t ahi[4], alo[4];
        const float* ap = As + (8 * kk + t) * LDAT + wr + g;
        split(ap[0], ahi[0], alo[0]);
        split(ap[8], ahi[1], alo[1]);
        split(ap[4 * LDAT], ahi[2], alo[2]);
        split(ap[4 * LDAT + 8], ahi[3], alo[3]);
        mma_kn(part, ahi, alo, Bs + (8 * kk + t) * LDB + wc + g, nvt);
      }
    } else if (it < nI) {             // A = dG^T_j, B = C_i
      const int ic = t0 + it * KC;
      const int ks = (min(KC, Q - ic) + 7) / 8;
      for (int kk = 0; kk < ks; ++kk) {
        if (ic + 8 * kk + 7 < t0 + wr) continue;   // dG_ij = 0 for i < j
        uint32_t ahi[4], alo[4];
        frag_a(As + (wr + g) * LDA + 8 * kk + t, LDA, ahi, alo);
        mma_kn(part, ahi, alo, Bs + (8 * kk + t) * LDB + wc + g, nvt);
      }
    } else {                          // A = w o X^h_j, B = dS^hT
      const int u = it - nI, h = u / npc, p0 = (u - h * npc) * KC;
      const int ks = (min(KC, P - p0) + 7) / 8;
      const int ra = wr + g, rb = ra + 8;
      const float w0 = ra < trows ? expf(cs[BI] - cs[ra]) : 0.f;
      const float w1 = rb < trows ? expf(cs[BI] - cs[rb]) : 0.f;
      for (int kk = 0; kk < ks; ++kk) {
        uint32_t ahi[4], alo[4];
        const float* ap = As + ra * LDA + 8 * kk + t;
        split(w0 * ap[0], ahi[0], alo[0]);
        split(w1 * ap[8 * LDA], ahi[1], alo[1]);
        split(w0 * ap[4], ahi[2], alo[2]);
        split(w1 * ap[8 * LDA + 4], ahi[3], alo[3]);
        mma_nk(part, ahi, alo, Bs + (wc + g) * LDA + 8 * kk + t, nvt);
      }
    }
    // into the running sum with an f32 add: the tensor cores' f32
    // accumulation truncates, and over dB's H x P-long reduction (16,384
    // at jamba's layer) that bias grows past the hold
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
    __syncthreads();                  // the stage is free for the next issue
  }

  float* out = (is_dc ? dC : dB) + (bc * Q + t0) * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wr + g + 8 * (e >> 1);
      const int n = wc + 8 * nt + 2 * t + (e & 1);
      if (r < trows && n < N) out[(size_t)r * N + n] = acc[nt][e];
    }
  }
}

// scratch offsets, in floats, each a multiple of 4: the groups' dG^T
// partials (BC, groups, Q, Q), dG^T (BC, Q, Q), the row sums (BC, H, j
// tiles, Q), X . ddtx (BC, Q, H), the g sums (BC, H, j tiles)
struct Scratch {
  size_t dgp, dg, rs, dcol, gsum, total;
  Scratch(int BC, int Q, int H) {
    const size_t bc = BC, nj = (Q + BJ - 1) / BJ, ng = (H + HG - 1) / HG;
    auto up4 = [](size_t x) { return (x + 3) & ~size_t(3); };
    dgp = 0;
    dg = dgp + up4(bc * ng * Q * Q);
    rs = dg + up4(bc * Q * Q);
    dcol = rs + up4(bc * H * nj * Q);
    gsum = dcol + up4(bc * Q * H);
    total = gsum + up4(bc * H * nj);
  }
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// floats of scratch that `ssd_intra_bwd_launch` needs
extern "C" long long ssd_intra_bwd_scratch_floats(int BC, int Q, int H) {
  return (long long)Scratch(BC, Q, H).total;
}

// C/B (BC, Q, N), dtx and dy (BC, Q, H, P), cums (BC, Q, H), dS (BC, H, N,
// P): contiguous f32 with BC = batch * chunks, Q <= 256, N <= 128, P <=
// 128. Writes dC, dB (BC, Q, N), ddtx (BC, Q, H, P) and dcums (BC, Q, H),
// using `scratch` (ssd_intra_bwd_scratch_floats floats, 16-byte aligned).
// Returns the launches' cudaError_t (0 = success).
extern "C" int ssd_intra_bwd_launch(const float* C, const float* B,
                                    const float* dtx, const float* cums,
                                    const float* dy, const float* dS,
                                    float* dC, float* dB, float* ddtx,
                                    float* dcums, float* scratch, int BC,
                                    int Q, int N, int H, int P,
                                    void* stream) {
  if (BC <= 0 || BC > 65535 || Q <= 0 || Q > MAXQ || H <= 0 || H > 65535 ||
      N < 1 || N > MAXN || P < 1 || P > MAXP || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s(BC, Q, H);
  float* dGp = scratch + s.dgp;
  float* dG = scratch + s.dg;
  float* rs = scratch + s.rs;
  float* dcol = scratch + s.dcol;
  float* gsum = scratch + s.gsum;
  const int nj = (Q + BJ - 1) / BJ, ng = (H + HG - 1) / HG;
  const bool vecN = N % 4 == 0 && aligned16(C) && aligned16(B);
  const bool vecP = P % 4 == 0 && aligned16(dtx) && aligned16(dy) &&
                    aligned16(dS);
  const bool vecQ = Q % 4 == 0;

  const dim3 gdx(nj, ng, BC);
  // P <= 64 takes the wgmma variant of the dx function
  const bool wide = P > 64;
  const size_t dx_bytes = (wide ? DX_FLOATS : DXW_FLOATS) * sizeof(float);
  cudaError_t err = wide ? set_smem(ssd_bwd_dx, dx_bytes)
                         : set_smem(ssd_bwd_dxw, dx_bytes);
  if (err != cudaSuccess) return (int)err;
  if (wide)
    ssd_bwd_dx<<<gdx, THREADS, dx_bytes, st>>>(C, B, dtx, cums, dy, dS,
                                              ddtx, dGp, rs, dcol, gsum, Q,
                                              N, H, P, vecN, vecP);
  else
    ssd_bwd_dxw<<<gdx, THREADS, dx_bytes, st>>>(C, B, dtx, cums, dy, dS,
                                               ddtx, dGp, rs, dcol, gsum, Q,
                                               N, H, P, vecN, vecP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ssd_bwd_dgsum<<<dim3(Q, BC), THREADS, 0, st>>>(dGp, dG, Q, ng);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t bytes = 2 * DC_STAGE * sizeof(float);
  err = set_smem(ssd_bwd_dcdb, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_dcdb<<<dim3((Q + BI - 1) / BI, 2, BC), THREADS, bytes, st>>>(
      C, B, dtx, cums, dS, dG, rs, dcol, gsum, dC, dB, dcums, Q, N, H, P, nj,
      vecN, vecP, vecQ);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_intra_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
