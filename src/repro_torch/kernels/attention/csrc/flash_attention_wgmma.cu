// GQA flash attention, forward only, on Hopper's tensor cores (sm_90a):
// the bf16 route for head dims 64, 80, 128 and 256.
//
// Replaces, with flash_attention.cu (the f32 route and bf16 at hd 16/32),
// the Pallas TPU kernel `repro.kernels.attention.flash.flash_attention_pallas`
// (body `_flash_kernel`): out[b, s, h] = softmax(q k^T / sqrt(hd) + mask) v
// over the kv head h / (H / KH), with causal and/or sliding-window masking
// (masked scores at -1e30, keys past T weighing 0), an online softmax whose
// running (m, l, acc) stay in f32, and the output in q's dtype.
//
// What bounds it on this card. Causal attention at the LM prefill shape
// (qwen3-0.6b: B=4, S=4096, H=16, KH=8, hd=128, bf16) does
// 4*B*H*S^2/2*hd = 2.75e11 operations on 201 MB of q, k, v and out: it is
// bound by operations, 0.278 ms at the 989 TFLOP/s bf16 tensor-core rate
// against 0.060 ms for the bytes. The CUDA-core kernel of flash_attention.cu
// cannot go below ~4.1 ms (67 TFLOP/s f32); this one runs both products on
// the tensor cores.
//
// What the design does about that:
//  * One CTA per (128-row q tile, q head, batch), three warpgroups. The
//    grid's slowest axis is the q tile, heaviest causal tiles first, so the
//    longest CTAs start in the first wave; heads sharing a kv head are
//    neighbours in launch order (L2 reuse of K/V).
//  * Warpgroup 0 is the producer: one thread issues TMA loads, the Q tile
//    once, then K and V tiles of the in-range kv tiles (kv_tile_range, the
//    same formula as flash.kv_tile_range in Python; wholly masked tiles are
//    never loaded) into a two-stage ring, with "full" mbarriers (K and V
//    apart, so Q.K^T starts before V lands) and "empty" mbarriers. It drops
//    its registers to 40 (setmaxnreg.dec).
//  * Warpgroups 1 and 2 are consumers, 64 q rows each, 232 registers
//    (setmaxnreg.inc). S = Q.K^T is wgmma m64nBKVk16 with both operands in
//    shared memory, K-major, 128-byte swizzle (the TMA maps' swizzle). The
//    online softmax runs on the S accumulator in registers, in log2 units
//    (exp2f, log2(e) folded into the scale): four threads share a row, so
//    the row max is two quad shuffles; the row sum stays per thread until
//    the epilogue. Masks are applied only on tiles that hold a masked or
//    ragged key.
//  * O += P.V is wgmma m64nHDk16 in its RS form: P is packed to bf16 pairs
//    in registers (the f32 accumulator layout of S, eight values per k-step,
//    is the A-fragment layout) and never touches shared memory; V is read
//    in its stored [kv][hd] layout as an MN-major operand (transpose bit).
//  * Epilogue: O / max(l, 1e-30) in bf16, written into the consumer's own
//    (now idle) Q rows in the swizzled layout, and stored by TMA, which
//    clips the rows past S. When the caller passes a (B, H, S) f32 `lse`
//    (training: the wgmma backward reads it instead of recomputing it), one
//    thread of each quad writes its two rows' log-sum-exp of the masked,
//    scaled scores, in natural-log units: L = (m + log2 l) ln 2, from the
//    running max m and the quad-summed l it already holds in log2 units.
//    A row that saw no allowed key (m never rose above the -1e30 mask, so
//    l = 0 or l counts masked keys only) gets L = +inf: the backward's P is
//    0 there, not NaN. Inference passes null and pays one branch.
//  * q, k, v and out keep their (B, S, H, hd) / (B, T, KH, hd) layouts: the
//    tensor maps are 4-D over (hd, heads, rows, batch), built on each call
//    (they encode the base pointers) and passed as __grid_constant__. Rows
//    past T arrive as zeros from TMA, so keys >= T are masked to -inf.
//  * hd=256 takes a 64-row kv tile: Q 64 KB + 2 x (K + V) 128 KB of the
//    227 KB of shared memory; hd=128: 32 + 128 KB; hd=64: 16 + 64 KB.
//  * hd=80 (hubert-xlarge) runs in the hd=128 tile layout: the tensor maps
//    carry the true inner extent, 80 columns (a 160-byte row stride), so
//    TMA fills the second box's columns 80-127 with zeros on load, as it
//    does rows past T. The zero columns add nothing to Q.K^T, P.V gives
//    zeros there, and the TMA store of O clips them. It costs 128/80 = 1.6x
//    the products of a native hd-80 tile, on the tensor cores; the scale
//    is the wrapper's 1/sqrt(80).
// The two consumers do not yet overlap one's softmax with the other's
// products (ping-pong), and the grid is not persistent.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;        // q rows per CTA: 64 per consumer warpgroup
constexpr int STAGES = 2;      // K/V ring depth
constexpr int THREADS = 384;   // producer + two consumer warpgroups
constexpr int BOX = 64;        // bf16 columns per 128-byte swizzled box
constexpr float NEG_BIG = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int BKV = HD == 256 ? 64 : 128;   // kv rows per tile
  static constexpr int NC = HD / BOX;                // boxes across hd
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;      // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  static_assert(HD % BOX == 0, "hd must be a multiple of 64");
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

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
  // D (m64 x n128, f32) += A (smem, K-major) * B (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        : "l"(a), "l"(b), "r"(scale_d));
  }
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

template <> struct Wgmma<256> {
  // D (m64 x n256, f32) += A (registers, bf16 pairs) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

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
    const int lo = q0 - window + 1;   // the oldest key row q0 may see
    first = lo > 0 ? lo / BKV : 0;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap omap, float* __restrict__ lse,
            int S, int Tk, int H, int KH, int causal, int window,
            float scale_log2) {
  using C = Cfg<HD>;
  constexpr int BKV = C::BKV, NC = C::NC;
  constexpr int QBOX = 64 * 128;            // 64 rows x 128 B
  constexpr int KBOX = BKV * 128;           // BKV rows x 128 B
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 8 rows: tiles start 1024-aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::K_OFF, sV = base + C::V_OFF;
  const uint32_t q_full = base + C::BAR_OFF;
  const uint32_t k_full = q_full + 8;                  // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest tiles first
  const int kvh = h / (H / KH);
  int first, last;
  kv_tile_range<BKV>(q0, S, Tk, causal, window, first, last);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sQ + (w * NC + c) * QBOX, &qmap, q_full, c * BOX, h,
                   q0 + 64 * w, b);
      for (int kt = first, i = 0; kt <= last; ++kt, ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sK + s * C::KV_BYTES + c * KBOX, &kmap, k_full + 8 * s,
                   c * BOX, kvh, kt * BKV, b);
        mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sV + s * C::KV_BYTES + c * KBOX, &vmap, v_full + 8 * s,
                   c * BOX, kvh, kt * BKV, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int rlo = q0 + 64 * cw;                  // this warpgroup's rows
    const int row0 = rlo + 16 * warp + lane / 4;   // this thread's two rows
    const int row1 = row0 + 8;
    const int qc = 2 * (lane % 4);                 // its column in each 8
    const uint32_t sQw = sQ + cw * NC * QBOX;

    float o[HD / 2], s[BKV / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) s[j] = 0.f;
    float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int kt = first, i = 0; kt <= last; ++kt, ++i) {
      const int st = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int k0 = kt * BKV;
      const uint32_t sKs = sK + st * C::KV_BYTES, sVs = sV + st * C::KV_BYTES;

      // S = Q K^T: A and B in shared memory, K-major; each k-step of 16
      // moves 32 bytes inside a 128-byte box, every 4th to the next box
      mbar_wait(k_full + 8 * st, ph);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<BKV>::ss(s,
                       smem_desc(sQw + (kk / 4) * QBOX + (kk % 4) * 32, 16,
                                 1024),
                       smem_desc(sKs + (kk / 4) * KBOX + (kk % 4) * 32, 16,
                                 1024),
                       kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // s[j] is row (j & 2 ? row1 : row0), key k0 + 8 (j / 4) + qc + (j & 1)
      const bool cut = k0 + BKV > Tk || (causal && k0 + BKV - 1 > rlo) ||
                       (window > 0 && k0 <= rlo + 63 - window);
      if (cut) {
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) {
          const int key = k0 + 8 * (j / 4) + qc + (j & 1);
          const int row = (j & 2) ? row1 : row0;
          bool ok = true;
          if (causal) ok = key <= row;
          if (window > 0) ok = ok && key > row - window;
          float x = ok ? s[j] * scale_log2 : NEG_BIG;
          if (key >= Tk) x = -INFINITY;
          s[j] = x;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) s[j] *= scale_log2;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) {
        if (j & 2) mx1 = fmaxf(mx1, s[j]);
        else mx0 = fmaxf(mx0, s[j]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= c0;
      l1 *= c1;
      // P in bf16 pairs: the accumulator values 8kk..8kk+7 are the A
      // fragment of k-step kk (rows row0, row1, row0, row1)
      uint32_t p[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 8 * kk + 2 * r;
          const float mr = (r & 1) ? m1 : m0;
          const float e0 = exp2f(s[j] - mr), e1 = exp2f(s[j + 1] - mr);
          if (r & 1) l1 += e0 + e1;
          else l0 += e0 + e1;
          p[kk][r] = pack_bf16(e0, e1);
        }
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] *= (j & 2) ? c1 : c0;

      // O += P V: A from registers, B = V as stored ([kv][hd], MN-major):
      // k-step kk is 16 kv rows (2048 B); the boxes across hd are LBO apart
      mbar_wait(v_full + 8 * st, ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        Wgmma<HD>::rs(o, p[kk], smem_desc(sVs + kk * 2048, KBOX, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(empty + 8 * st);
    }

    // epilogue: the row sums across the quad, O / l in bf16 into this
    // warpgroup's Q rows (swizzled as TMA wrote them), then a TMA store
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    if (lse != nullptr && lane % 4 == 0) {
      float* lrow = lse + ((size_t)b * H + h) * S;
      if (row0 < S)
        lrow[row0] = m0 > NEG_BIG ? (m0 + log2f(l0)) * 0.6931471805599453f
                                  : INFINITY;
      if (row1 < S)
        lrow[row1] = m1 > NEG_BIG ? (m1 + log2f(l1)) * 0.6931471805599453f
                                  : INFINITY;
    }
    const int r0 = 16 * warp + lane / 4;           // row in the box; r0 % 8
    const int sw = lane / 4;                       //   == (r0 + 8) % 8 == sw
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const uint32_t at = sQw + (jj / 8) * QBOX + ((jj % 8) ^ sw) * 16 + qc * 2;
      const uint32_t lo = pack_bf16(o[4 * jj] / d0, o[4 * jj + 1] / d0);
      const uint32_t hi = pack_bf16(o[4 * jj + 2] / d1, o[4 * jj + 3] / d1);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + r0 * 128), "r"(lo)
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + (r0 + 8) * 128),
                   "r"(hi)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_store(&omap, sQw + c * QBOX, c * BOX, h, rlo, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// ---- host side: tensor maps and the launch ----
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
// of 64 hd columns x `box_rows` rows of one head, 128-byte swizzle;
// out-of-bounds rows and columns (past hd, for a tile wider than the
// tensor) read as zeros and are not written.
int make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int rows,
             int batch, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)box_rows, 1};
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
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Tk, int H, int KH, int hd, int causal,
           int window, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qm, km, vm, om;
  int err;
  if ((err = make_map(&qm, q, hd, H, S, B, 64))) return err;
  if ((err = make_map(&km, k, hd, KH, Tk, B, C::BKV))) return err;
  if ((err = make_map(&vm, v, hd, KH, Tk, B, C::BKV))) return err;
  if ((err = make_map(&om, o, hd, H, S, B, 64))) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_wgmma<HD><<<grid, THREADS, C::SMEM, stream>>>(
      qm, km, vm, om, lse, S, Tk, H, KH, causal, window,
      scale * 1.4426950408889634f);   // log2(e): the softmax runs in exp2
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,S,H,hd), k/v (B,T,KH,hd), out (B,S,H,hd), all contiguous and
// 16-byte aligned; lse null, or a contiguous (B,H,S) f32 output for the row
// log-sum-exp (natural log; +inf on a row that saw no key); dtype must be 1
// (bfloat16; the signature is that of flash_attention_launch); hd in {64,
// 80, 128, 256} (80 in the hd-128 tile). window <= 0: no window.
// Returns 0, a cudaError_t, or one of the tensor-map errors above; the
// wrapper raises on anything but 0.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int dtype, int B, int S, int Tk,
                                            int H, int KH, int HD, int causal,
                                            int window, float scale,
                                            void* stream) {
  if (dtype != 1 || B <= 0 || S <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* L = static_cast<float*>(lse);
  switch (HD) {
    case 64: return launch<64>(q, k, v, o, L, B, S, Tk, H, KH, 64, causal, window, scale, st);
    case 80: return launch<128>(q, k, v, o, L, B, S, Tk, H, KH, 80, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, o, L, B, S, Tk, H, KH, 128, causal, window, scale, st);
    case 256: return launch<256>(q, k, v, o, L, B, S, Tk, H, KH, 256, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_wgmma_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  if (err == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
