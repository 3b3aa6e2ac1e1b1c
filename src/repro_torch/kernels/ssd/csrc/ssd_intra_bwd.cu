// Backward of the Mamba-2 SSD intra-chunk form for Hopper (sm_90a): f32
// FMAs on the CUDA cores, three functions, no atomics.
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
// ddtx, dcums written once; `chip_smoke.py::ssd_bwd_work`). The card's
// least time is that of 3xTF32 tensor-core products, which meet the
// forward's tolerance: max(3 x 7.222e10 / 495 TFLOP/s = 0.4377 ms,
// 1,015,021,568 B / 3.35 TB/s = 0.3030 ms), 0.4377 ms of operations. This
// first version runs f32 FMAs on the CUDA cores, whose own floor is
// 7.222e10 / 67 TFLOP/s = 1.0779 ms; it works on whole 64 x 64 tiles
// (1.25x the i >= j pairs at Q = 256), stages every tile with plain loads
// and no double buffer, and moves G, dG and the row-sum partials through
// scratch. 3xTF32 products are a later step.
//
// The design: 64-row i and j tiles; every product is a register-blocked
// f32 FMA product of two shared-memory tiles (256 threads, 4 rows x 4 or
// 8 columns each). One call launches three functions in order on one
// stream:
//  * `ssd_bwd_pair`, one CTA per (i tile >= j tile, batch*chunk): G_ij =
//    C_i.B_j^T once, then per head dAtt_ij = dY_i.X_j^T; it accumulates
//    dG_ij over every head in registers and writes G_ij and dG_ij to
//    scratch, and each head's row sums of dAtt o att over the tile (a
//    partial over j tiles) to scratch.
//  * `ssd_bwd_dx`, one CTA per (j tile, head, batch*chunk): ddtx_j =
//    sum over i tiles of att_ij^T.dY_i (att from the scratch G) plus w_j
//    (B_j.dS), written once; X_j . ddtx_j per row, and the tile's sum of
//    g_j, to scratch.
//  * `ssd_bwd_dcdb`, one CTA per (row tile, dC or dB, batch*chunk): dC_i
//    = sum_j dG_ij.B_j; dB_j = sum_i dG_ij^T.C_i + sum_h (w^h X^h_j).dS^hT;
//    the dC CTAs also write dcums for their rows: the row-sum partials,
//    minus X . ddtx, plus the g sums on the last row.
// Every sum over heads (dG, dB's state term) and over tiles (the row-sum
// partials, the g sums) runs inside one CTA in a fixed order, and every
// output element is written by one thread: two calls are bit-equal.
//  * The decay trap. Within a 256-row chunk cums falls to about -1,000, so
//    a factored exp(c_i) * exp(-c_j) overflows. Every decay here is the exp
//    of the difference c_i - c_j (<= 0 as cums never rises), masked to i >=
//    j before the exp, as `ref.py` does; w_j = exp(c_last - c_j) <= 1.
//  * Ragged edges. Q need not be a multiple of 64, nor N or P of 4: the
//    tiles are zero-filled past the last row and column in shared memory,
//    and only rows < Q, states < N and columns < P are stored.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;          // rows per i tile and per j tile
constexpr int MAXN = 128;       // state size
constexpr int MAXP = 128;       // head dim
constexpr int MAXQ = 256;       // chunk length
constexpr int MAXK = 128;       // the longest reduction staged in one tile
constexpr int LDT = BR + 4;     // row stride of a 64-column tile
constexpr int THREADS = 256;    // 16 x 16: thread (tm, tn)
static_assert(MAXN <= MAXK && MAXP <= MAXK, "a staged tile holds N or P");

// acc[a][c] += sum_{k < K} A[k][4 tm + a] * Bm[k][col(c)], with col(c) =
// 64 (c / 4) + 4 tn + c % 4: A holds the product's rows as columns (k-major),
// Bm its columns; both 16-byte aligned with row strides a multiple of 4.
template <int NC>
__device__ __forceinline__ void gemm(float (&acc)[4][NC], const float* A,
                                     int lda, const float* Bm, int ldb,
                                     int K, int tm, int tn) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(A + k * lda + 4 * tm);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float b[NC];
#pragma unroll
    for (int g = 0; g < NC / 4; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(Bm + k * ldb + 64 * g + 4 * tn);
      b[4 * g] = v.x;
      b[4 * g + 1] = v.y;
      b[4 * g + 2] = v.z;
      b[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__device__ __forceinline__ int col_of(int c, int tn) {
  return 64 * (c / 4) + 4 * tn + (c & 3);
}

// dst[r][c] = src[r * lds + c] for r < rows, c < cols; zero up to nr x nc
__device__ __forceinline__ void load_rows(float* dst, int ldd,
                                          const float* src, size_t lds,
                                          int rows, int cols, int nr,
                                          int nc) {
  for (int idx = threadIdx.x; idx < nr * nc; idx += THREADS) {
    const int r = idx / nc, c = idx - r * nc;
    dst[r * ldd + c] = r < rows && c < cols ? src[r * lds + c] : 0.f;
  }
}

// the transpose: dst[c][r] = src[r * lds + c], zero up to nr rows of src
// and nc of its columns
__device__ __forceinline__ void load_cols(float* dst, int ldd,
                                          const float* src, size_t lds,
                                          int rows, int cols, int nr,
                                          int nc) {
  for (int idx = threadIdx.x; idx < nr * nc; idx += THREADS) {
    const int r = idx / nc, c = idx - r * nc;
    dst[c * ldd + r] = r < rows && c < cols ? src[r * lds + c] : 0.f;
  }
}

// the sum over the 16 threads (tn) of one half-warp that share tm
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// G, dG (head-summed) and each head's row sums of dAtt o att over one
// (i tile, j tile) pair. grid (pairs, batch*chunk). Shared memory: two
// k-major tiles [MAXK][LDT] (C_i^T and B_j^T, then per head dY_i^T and
// X_j^T) and the two tiles' cums.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pair(const float* __restrict__ C, const float* __restrict__ B,
             const float* __restrict__ dtx, const float* __restrict__ cums,
             const float* __restrict__ dy, float* __restrict__ Gs,
             float* __restrict__ dGs, float* __restrict__ rs, int Q, int N,
             int H, int P) {
  extern __shared__ __align__(16) float smem[];
  float* Ta = smem;
  float* Tb = Ta + MAXK * LDT;
  float* ci = Tb + MAXK * LDT;
  float* cj = ci + BR;
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= (int)blockIdx.x) ++it;
  const int jt = blockIdx.x - it * (it + 1) / 2;
  const size_t bc = blockIdx.y;
  const int nit = (Q + BR - 1) / BR;
  const int i0 = it * BR, j0 = jt * BR;
  const int irows = min(BR, Q - i0), jrows = min(BR, Q - j0);
  const size_t xrow = (size_t)H * P;

  load_cols(Ta, LDT, C + (bc * Q + i0) * N, N, irows, N, BR, N);
  load_cols(Tb, LDT, B + (bc * Q + j0) * N, N, jrows, N, BR, N);
  __syncthreads();
  float G[4][4] = {};
  gemm<4>(G, Ta, LDT, Tb, LDT, N, tm, tn);
  float dg[4][4] = {};
  for (int h = 0; h < H; ++h) {
    __syncthreads();                      // the tiles are free
    load_cols(Ta, LDT, dy + (bc * Q + i0) * xrow + (size_t)h * P, xrow,
              irows, P, BR, P);
    load_cols(Tb, LDT, dtx + (bc * Q + j0) * xrow + (size_t)h * P, xrow,
              jrows, P, BR, P);
    if (threadIdx.x < BR) {
      const int r = threadIdx.x;
      ci[r] = r < irows ? cums[(bc * Q + i0 + r) * H + h] : 0.f;
    } else if (threadIdx.x < 2 * BR) {
      const int r = threadIdx.x - BR;
      cj[r] = r < jrows ? cums[(bc * Q + j0 + r) * H + h] : 0.f;
    }
    __syncthreads();
    float da[4][4] = {};
    gemm<4>(da, Ta, LDT, Tb, LDT, P, tm, tn);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * tm + a;
      float rsum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * tn + b;
        // masked to j <= i before the exp
        const bool on = i0 + i >= j0 + j && i < irows && j < jrows;
        const float dl = on ? da[a][b] * expf(ci[i] - cj[j]) : 0.f;
        dg[a][b] += dl;
        rsum = fmaf(dl, G[a][b], rsum);
      }
      rsum = sum16(rsum);
      if (tn == 0 && i < irows)
        rs[((bc * nit + jt) * Q + i0 + i) * H + h] = rsum;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = 4 * tm + a;
    if (i >= irows) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = 4 * tn + b;
      if (j < jrows) {
        const size_t o = (bc * Q + i0 + i) * Q + j0 + j;
        Gs[o] = G[a][b];
        dGs[o] = dg[a][b];
      }
    }
  }
}

// ddtx of one (j tile, head): the i tiles' att^T.dY, then w (B_j.dS).
// grid (j tiles, H, batch*chunk); NC = P columns / 16. Shared memory: a
// k-major tile [64][LDT] (att_ij, then B_j^T chunks), a row tile
// [64][16 NC + 4] (dY_i, then dS chunks), the tiles' cums, the g sums.
template <int NC>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dx(const float* __restrict__ B, const float* __restrict__ dtx,
           const float* __restrict__ cums, const float* __restrict__ dy,
           const float* __restrict__ dS, const float* __restrict__ Gs,
           float* __restrict__ ddtx, float* __restrict__ dcol,
           float* __restrict__ gsum, int Q, int N, int H, int P) {
  constexpr int LDW = 16 * NC + 4;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + BR * LDT;
  float* ci = Bs + BR * LDW;
  float* cj = ci + BR;
  float* red = cj + BR;
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int jt = blockIdx.x, h = blockIdx.y;
  const size_t bc = blockIdx.z;
  const int nit = (Q + BR - 1) / BR;
  const int j0 = jt * BR, jrows = min(BR, Q - j0);
  const size_t xrow = (size_t)H * P;
  if (threadIdx.x < BR)
    cj[threadIdx.x] = threadIdx.x < jrows
        ? cums[(bc * Q + j0 + threadIdx.x) * H + h] : 0.f;

  float acc[4][NC] = {};
  for (int it = jt; it < nit; ++it) {
    const int i0 = it * BR, irows = min(BR, Q - i0);
    __syncthreads();                      // the tiles are free
    if (threadIdx.x < BR)
      ci[threadIdx.x] = threadIdx.x < irows
          ? cums[(bc * Q + i0 + threadIdx.x) * H + h] : 0.f;
    load_rows(Bs, LDW, dy + (bc * Q + i0) * xrow + (size_t)h * P, xrow,
              irows, P, BR, 16 * NC);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BR * BR; idx += THREADS) {
      const int i = idx / BR, j = idx - i * BR;
      const bool on = i < irows && j < jrows && i0 + i >= j0 + j;
      As[i * LDT + j] = on ? Gs[(bc * Q + i0 + i) * Q + j0 + j] *
                                 expf(ci[i] - cj[j])
                           : 0.f;
    }
    __syncthreads();
    gemm<NC>(acc, As, LDT, Bs, LDW, BR, tm, tn);
  }

  float sacc[4][NC] = {};                 // B_j . dS
  for (int n0 = 0; n0 < N; n0 += BR) {
    const int nk = min(BR, N - n0);
    __syncthreads();
    load_cols(As, LDT, B + (bc * Q + j0) * N + n0, N, jrows, nk, BR, nk);
    load_rows(Bs, LDW, dS + ((bc * H + h) * N + n0) * P, P, nk, P, nk,
              16 * NC);
    __syncthreads();
    gemm<NC>(sacc, As, LDT, Bs, LDW, nk, tm, tn);
  }

  const float clast = cums[(bc * Q + Q - 1) * H + h];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = 4 * tm + a;
    const bool jv = j < jrows;
    const float w = jv ? expf(clast - cj[j]) : 0.f;
    float xd = 0.f, xs = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = col_of(c, tn);
      if (jv && p < P) {
        const size_t o = (bc * Q + j0 + j) * xrow + (size_t)h * P + p;
        const float x = dtx[o];
        const float d = fmaf(w, sacc[a][c], acc[a][c]);
        ddtx[o] = d;
        xd = fmaf(x, d, xd);
        xs = fmaf(x, sacc[a][c], xs);
      }
    }
    xd = sum16(xd);
    xs = sum16(xs);
    if (tn == 0) {
      if (jv) dcol[(bc * Q + j0 + j) * H + h] = xd;
      red[j] = w * xs;                    // g_j; 0 past Q
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int j = 0; j < BR; ++j) s += red[j];
    gsum[(bc * nit + jt) * H + h] = s;
  }
}

// dC (blockIdx.y = 0) or dB (1) of one 64-row tile, and dcums with dC.
// grid (row tiles, 2, batch*chunk); NC = N columns / 16. Shared memory: a
// k-major tile [64][LDT], a row tile [64][16 NC + 4], the w of a head.
template <int NC>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dcdb(const float* __restrict__ C, const float* __restrict__ B,
             const float* __restrict__ dtx, const float* __restrict__ cums,
             const float* __restrict__ dS, const float* __restrict__ dGs,
             const float* __restrict__ rs, const float* __restrict__ dcol,
             const float* __restrict__ gsum, float* __restrict__ dC,
             float* __restrict__ dB, float* __restrict__ dcums, int Q, int N,
             int H, int P) {
  constexpr int LDW = 16 * NC + 4;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + BR * LDT;
  float* wj = Bs + BR * LDW;
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int t = blockIdx.x;
  const bool is_dc = blockIdx.y == 0;
  const size_t bc = blockIdx.z;
  const int nit = (Q + BR - 1) / BR;
  const int t0 = t * BR, trows = min(BR, Q - t0);
  const size_t xrow = (size_t)H * P;
  float acc[4][NC] = {};

  if (is_dc) {                            // dC_i = sum_j dG_ij . B_j
    for (int jt = 0; jt <= t; ++jt) {
      const int j0 = jt * BR, jrows = min(BR, Q - j0);
      __syncthreads();
      load_cols(As, LDT, dGs + (bc * Q + t0) * Q + j0, Q, trows, jrows, BR,
                BR);
      load_rows(Bs, LDW, B + (bc * Q + j0) * N, N, jrows, N, BR, 16 * NC);
      __syncthreads();
      gemm<NC>(acc, As, LDT, Bs, LDW, BR, tm, tn);
    }
  } else {                                // dB_j = sum_i dG_ij^T . C_i ...
    for (int it = t; it < nit; ++it) {
      const int i0 = it * BR, irows = min(BR, Q - i0);
      __syncthreads();
      load_rows(As, LDT, dGs + (bc * Q + i0) * Q + t0, Q, irows, trows, BR,
                BR);
      load_rows(Bs, LDW, C + (bc * Q + i0) * N, N, irows, N, BR, 16 * NC);
      __syncthreads();
      gemm<NC>(acc, As, LDT, Bs, LDW, BR, tm, tn);
    }
    for (int h = 0; h < H; ++h) {         // ... + sum_h (w^h X^h) . dS^hT
      const float clast = cums[(bc * Q + Q - 1) * H + h];
      __syncthreads();
      if (threadIdx.x < BR)
        wj[threadIdx.x] = threadIdx.x < trows
            ? expf(clast - cums[(bc * Q + t0 + threadIdx.x) * H + h]) : 0.f;
      for (int p0 = 0; p0 < P; p0 += BR) {
        const int pk = min(BR, P - p0);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BR * pk; idx += THREADS) {
          const int j = idx / pk, p = idx - j * pk;
          As[p * LDT + j] = j < trows
              ? wj[j] * dtx[(bc * Q + t0 + j) * xrow + (size_t)h * P + p0 + p]
              : 0.f;
        }
        const float* ds = dS + (bc * H + h) * (size_t)N * P + p0;
        for (int idx = threadIdx.x; idx < 16 * NC * pk; idx += THREADS) {
          const int n = idx / pk, p = idx - n * pk;
          Bs[p * LDW + n] = n < N ? ds[(size_t)n * P + p] : 0.f;
        }
        __syncthreads();
        gemm<NC>(acc, As, LDT, Bs, LDW, pk, tm, tn);
      }
    }
  }

  float* out = (is_dc ? dC : dB) + (bc * Q + t0) * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * tm + a;
    if (r >= trows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int n = col_of(c, tn);
      if (n < N) out[(size_t)r * N + n] = acc[a][c];
    }
  }
  if (!is_dc) return;
  // dcums_i = the row sums of dAtt o att - X_i . ddtx_i (+ the g sums on
  // the chunk's last row)
  for (int idx = threadIdx.x; idx < trows * H; idx += THREADS) {
    const int r = idx / H, h = idx - r * H;
    const size_t row = bc * Q + t0 + r;
    float v = 0.f;
    for (int jt = 0; jt <= t; ++jt) v += rs[((bc * nit + jt) * Q + t0 + r) * H + h];
    v -= dcol[row * H + h];
    if (t0 + r == Q - 1)
      for (int jt = 0; jt < nit; ++jt) v += gsum[(bc * nit + jt) * H + h];
    dcums[row * H + h] = v;
  }
}

// scratch offsets, in floats: G and dG (BC, Q, Q) each, the row-sum
// partials (BC, j tiles, Q, H), X . ddtx (BC, Q, H), the g sums (BC, j
// tiles, H)
struct Scratch {
  size_t g, dg, rs, dcol, gsum, total;
  Scratch(int BC, int Q, int H) {
    const size_t nit = (Q + BR - 1) / BR, bc = BC;
    g = 0;
    dg = g + bc * Q * Q;
    rs = dg + bc * Q * Q;
    dcol = rs + bc * nit * Q * H;
    gsum = dcol + bc * Q * H;
    total = gsum + bc * nit * H;
  }
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NC>
cudaError_t launch_dx(dim3 grid, cudaStream_t st, const float* B,
                      const float* dtx, const float* cums, const float* dy,
                      const float* dS, const float* Gs, float* ddtx,
                      float* dcol, float* gsum, int Q, int N, int H, int P) {
  const size_t bytes = (BR * LDT + BR * (16 * NC + 4) + 3 * BR) * sizeof(float);
  cudaError_t err = set_smem(ssd_bwd_dx<NC>, bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_dx<NC><<<grid, THREADS, bytes, st>>>(B, dtx, cums, dy, dS, Gs,
                                               ddtx, dcol, gsum, Q, N, H, P);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dcdb(dim3 grid, cudaStream_t st, const float* C,
                        const float* B, const float* dtx, const float* cums,
                        const float* dS, const float* dGs, const float* rs,
                        const float* dcol, const float* gsum, float* dC,
                        float* dB, float* dcums, int Q, int N, int H, int P) {
  const size_t bytes = (BR * LDT + BR * (16 * NC + 4) + BR) * sizeof(float);
  cudaError_t err = set_smem(ssd_bwd_dcdb<NC>, bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_dcdb<NC><<<grid, THREADS, bytes, st>>>(
      C, B, dtx, cums, dS, dGs, rs, dcol, gsum, dC, dB, dcums, Q, N, H, P);
  return cudaGetLastError();
}

}  // namespace

// floats of scratch that `ssd_intra_bwd_launch` needs
extern "C" long long ssd_intra_bwd_scratch_floats(int BC, int Q, int H) {
  return (long long)Scratch(BC, Q, H).total;
}

// C/B (BC, Q, N), dtx and dy (BC, Q, H, P), cums (BC, Q, H), dS (BC, H, N,
// P): contiguous f32 with BC = batch * chunks, Q <= 256, N <= 128, P <=
// 128. Writes dC, dB (BC, Q, N), ddtx (BC, Q, H, P) and dcums (BC, Q, H),
// using `scratch` (ssd_intra_bwd_scratch_floats floats). Returns the
// launches' cudaError_t (0 = success).
extern "C" int ssd_intra_bwd_launch(const float* C, const float* B,
                                    const float* dtx, const float* cums,
                                    const float* dy, const float* dS,
                                    float* dC, float* dB, float* ddtx,
                                    float* dcums, float* scratch, int BC,
                                    int Q, int N, int H, int P,
                                    void* stream) {
  if (BC <= 0 || BC > 65535 || Q <= 0 || Q > MAXQ || H <= 0 || H > 65535 ||
      N < 1 || N > MAXN || P < 1 || P > MAXP)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s(BC, Q, H);
  float* Gs = scratch + s.g;
  float* dGs = scratch + s.dg;
  float* rs = scratch + s.rs;
  float* dcol = scratch + s.dcol;
  float* gsum = scratch + s.gsum;
  const int nit = (Q + BR - 1) / BR;

  const size_t smem_pair = (2 * MAXK * LDT + 2 * BR) * sizeof(float);
  cudaError_t err = set_smem(ssd_bwd_pair, smem_pair);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_pair<<<dim3(nit * (nit + 1) / 2, BC), THREADS, smem_pair, st>>>(
      C, B, dtx, cums, dy, Gs, dGs, rs, Q, N, H, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 gdx(nit, H, BC);
  err = P <= 64 ? launch_dx<4>(gdx, st, B, dtx, cums, dy, dS, Gs, ddtx, dcol,
                               gsum, Q, N, H, P)
                : launch_dx<8>(gdx, st, B, dtx, cums, dy, dS, Gs, ddtx, dcol,
                               gsum, Q, N, H, P);
  if (err != cudaSuccess) return (int)err;

  const dim3 gcb(nit, 2, BC);
  err = N <= 64 ? launch_dcdb<4>(gcb, st, C, B, dtx, cums, dS, dGs, rs, dcol,
                                 gsum, dC, dB, dcums, Q, N, H, P)
                : launch_dcdb<8>(gcb, st, C, B, dtx, cums, dS, dGs, rs, dcol,
                                 gsum, dC, dB, dcums, Q, N, H, P);
  return (int)err;
}

extern "C" const char* ssd_intra_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
