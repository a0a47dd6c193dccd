/*
 * K2 for NVIDIA Hopper, sm_90a: the int8 3x3 conv site of the fast trunk and
 * the tiled GEMM, both on wgmma.
 *
 * Replaces scripts/bench_int8_pallas.py:pallas_matmul (body _mm_kernel), the
 * Pallas TPU kernel K2: a (tm, tk, tn) tiled GEMM whose K loop accumulates
 * in a scratch tile, int8 -> int32 or bf16 -> fp32. Entry points:
 *
 *   isr_conv3x3_int8  the trunk site of models/quantized.py:int8_forward as
 *                     an implicit GEMM: x (B,H,W,Cin) NHWC, either the fp32
 *                     residual stream, requantized as it is loaded,
 *                     q = clamp(rint(x * inv_x), -127, 127), or int8 already
 *                     (handed over by the site before); zero padding 1; the
 *                     weights K-major, (Npad, 9*Cin) int8, columns (dy, dx,
 *                     cin), rows past Cout zero; int32 sums, then per output
 *                     channel y = fl(fl(float(acc) * deq[o]) + bias[o]),
 *                     leaky 0.01 on conv0 sites; on conv1 sites and
 *                     trunk_conv the residual update fl(res + fl(y * rate));
 *                     then stored fp32, and / or requantized for the next
 *                     site (clamp(rint(y * out_inv_x), +-127)) and stored
 *                     int8. Cin % 32 == 0, any Cout, B, H, W.
 *   isr_matmul        (M,K) x (K,N) -> (M,N), int8 -> int32 (exact) or
 *                     bf16 -> fp32, from A and B^T (isr_transpose makes it,
 *                     any N);
 *                     any M and N, K % 32 (int8) / % 16 (bf16).
 *
 * Bound of one 128 -> 128 site at b256 t24 (147,456 pixels) on an H100 SXM
 * (data sheet: 1,979 TOP/s dense int8, 3.35 TB/s): 2 * 1152 * 128 * 147,456
 * = 4.35e10 int8 operations, 22.0 us; bytes, each input (the residual
 * included) read once and each output written once. Measured on an H100
 * 80GB HBM3 at 700 W by CUDA events: at b256 t24 (chip_smoke.py phase 4)
 * and at 8 x 270 x 480, video frames, 7.03 times the pixels
 * (scripts/torch_k2_variants.py --shape 8,270,480, three rounds):
 *
 *   site: variant, epilogue             per forward   bytes    bound       b256 t24  frames
 *   block 0's conv0: fp32 -> int8             1       94.5 MB  28.2 us     0.088 ms  0.503 ms
 *   conv0 1-13: int8 -> int8                 13       37.9 MB  22.0 (ops)  0.062     0.316
 *   conv1 0-12: int8 -> fp32 + int8, res     13      188.9 MB  56.4 us     0.109     0.595
 *   the last conv1: int8 -> int8, res         1      113.4 MB  33.8 us     0.085     0.415
 *   trunk_conv: int8 -> fp32, res             1      170.0 MB  50.8 us     0.098     0.526
 *
 * So the sites are bound by bytes but for the int8 -> int8 conv0, and the
 * int8 hand-offs cut the bytes: each site requantizes its output in its
 * epilogue with the next site's scale (the same function as requantizing
 * the fp32 value at the next site's load), and a conv1 site finishes its
 * residual block there, h + rate * y, so that the block's fp32 stream
 * crosses memory twice (conv1's residual read and its store), not seven
 * times (conv0's load and two elementwise ops besides). The
 * 4096^3 GEMM is bound by operations: 69 us in int8, 139 us in bf16.
 *
 * What held the first version (mma.sync, 0.281 ms per site) back, and what
 * this design does about it:
 *   1. Its fp32 input was read about 9 times (once per tap, requantized each
 *      time). Here a producer warpgroup loads each rectangle's halo patch
 *      once, requantizes it once and keeps it int8 in shared memory: each
 *      input element crosses from L2 about 1.35 times.
 *   2. The whole weight matrix was read from L2 once per 128 pixels and
 *      transposed through registers every K step. Here the wrapper lays the
 *      weights out K-major once, and a persistent block copies all of them
 *      (147,456 bytes at Cin 128) into shared memory once.
 *   3. mma.sync with 32-bit fragment loads, two stages and one barrier per
 *      32 bytes of K. Here wgmma m64n128k32 .s32.s8.s8 reads both operands
 *      from shared memory; a tile's 36 wgmmas run with one wait.
 *
 * Design of the conv (one persistent block per SM, 512 threads):
 *   - A block owns output rectangles of 24 x 8 pixels (three 64-row tiles,
 *     8 image rows of 8 pixels each) times 128 output channels, and walks
 *     them gridDim.x apart. Three consumer warpgroups, one per tile, and
 *     one producer warpgroup. Cin above 128 runs in K chunks of <= 128
 *     channels, whose weights are copied per chunk (correct, not fast).
 *   - The producer loads the 26 x 10 halo patch of the next rectangle: fp32
 *     through registers (four 64-byte chunks in flight per thread),
 *     requantized with __float2int_rn and clamped, stored int8; or int8
 *     copied straight in with cp.async. The patch holds 16-channel chunks
 *     of all pixels one after the other (chunk stride 261 x 16 bytes, odd,
 *     so the producer's 16-byte stores are free of bank conflicts). Two
 *     patch buffers: the producer fills one while the consumers multiply
 *     the other. Named barriers pair the producer with each consumer
 *     warpgroup on its own, so the consumers drift apart and one's
 *     epilogue overlaps another's wgmmas (0.068 against 0.073 ms in
 *     lockstep, int8 -> fp32).
 *   - The A operand comes straight from shared memory: tap (dy, dx) of tile
 *     m is the patch at pixel (8m + dy) * 10 + dx, 8 consecutive pixels per
 *     core matrix (128 contiguous bytes), image rows 160 bytes apart. One
 *     tap per loop iteration, its K steps unrolled with the descriptor
 *     offsets as immediates (unrolled across all taps, ptxas precomputes
 *     every descriptor and spills).
 *   - The consumer warpgroups take turns on the tensor cores (a named
 *     barrier each, passed on once a warpgroup's wgmmas are issued): all
 *     issued at once, their wgmmas interleave and end together, and the
 *     three epilogues then run with the tensor cores idle (frames: int8 ->
 *     int8 0.317 against 0.340 ms).
 *   - The epilogue works on the 64 int32 accumulators in registers with
 *     deq and bias from shared memory, __fadd_rn(__fmul_rn(...)) so no FMA
 *     fuses it. Whole N tiles go through a staging buffer per warp (8
 *     pixels x 32 channels, fp32 and int8, swizzled), so that global
 *     memory sees 16-byte accesses on whole lines, not 8-byte (fp32) and
 *     2-byte (int8) pieces of eight pixels: the residual is loaded through
 *     it and the outputs stored through it. A tile's residual is
 *     prefetched into L2 before its wgmmas (frames: conv1 0.594 against
 *     0.621 ms without).
 *   Left on the table: the epilogue itself. At the frames shape an int8 ->
 *   int8 site takes 0.139 ms without its epilogue and 0.22 ms without its
 *   wgmmas; neither its stores (0.303 ms without them) nor its F2I
 *   conversions (0.283 without) are what holds it: three epilogue warps per
 *   scheduler hide little latency. Then the fp32 producer of block 0's
 *   conv0 (0.32 ms without the epilogue); TMA for the patch (no room beside
 *   resident weights for an fp32 staging buffer).
 *
 * Design of the GEMM: 128 x 256 block tiles; two consumer warpgroups issue
 * wgmma m64n256 (k32 s8 or k16 bf16) from a ring of four stages of 128
 * bytes of K, which one producer thread fills by TMA (128-byte swizzle,
 * zeros past M, N and K) under mbarriers. Both operands are K-major, so B
 * is transposed once per call (isr_transpose), inside the call's time.
 */

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace {

using namespace hopper;

// wgmma's accumulator operands: 8 (ISR_OP8) or 128 (ISR_OP128) registers
// d[i] with constraint C, and the register list %0 .. %127 of the latter.
#define ISR_OP8(C, i)                                                                   \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), \
      C(d[i + 7])
#define ISR_OP128(C)                                                                    \
  ISR_OP8(C, 0), ISR_OP8(C, 8), ISR_OP8(C, 16), ISR_OP8(C, 24), ISR_OP8(C, 32),           \
      ISR_OP8(C, 40), ISR_OP8(C, 48), ISR_OP8(C, 56), ISR_OP8(C, 64), ISR_OP8(C, 72),     \
      ISR_OP8(C, 80), ISR_OP8(C, 88), ISR_OP8(C, 96), ISR_OP8(C, 104), ISR_OP8(C, 112),   \
      ISR_OP8(C, 120)
#define ISR_REGS128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"

// ------------------------------------------------------------------ conv --

constexpr int TILES = 3;                   // 64-row tiles = consumer warpgroups
constexpr int RW = 8, RH = 8 * TILES;      // output rectangle: 24 rows x 8 columns
constexpr int PW = RW + 2;                 // halo patch: (RH + 2) x PW pixels
constexpr int PPIX = (RH + 2) * PW;        // 260
constexpr int CSTRIDE = PPIX + 1;          // 16-byte units between channel chunks
constexpr int NT = 128;                    // output channels per block (wgmma N)
constexpr int MAX_CC = 128;                // input channels per K chunk
constexpr int CONSUMERS = 128 * TILES;
constexpr int CONV_THREADS = CONSUMERS + 128;  // + one producer warpgroup
constexpr int UNROLL = 4;                  // 16-channel chunks in flight per producer thread
// Named barriers. kFull + TILES * b + m: patch buffer b is full, between
// the producer and consumer warpgroup m (256 threads); kEmpty + b: every
// consumer is done with buffer b (all threads); kWFull + m, kWEmpty: the
// same for the weights; kTurn + m: consumer warpgroup m's turn on the
// tensor cores, from warpgroup m - 1 (256 threads).
constexpr int kFull = 1, kEmpty = kFull + 2 * TILES, kWFull = kEmpty + 2,
              kWEmpty = kWFull + TILES, kTurn = kWEmpty + 1;
constexpr int FULL_THREADS = 256;
static_assert(kTurn + TILES <= 16, "16 named barriers");

// The epilogue's staging buffers, one per consumer warp: 8 pixels x 32
// channels in fp32 (128 bytes a pixel) and in int8 (32 bytes a pixel).
constexpr int STAGE_F32 = 8 * 128, STAGE_I8 = 8 * 32, STAGE_WARP = STAGE_F32 + STAGE_I8;

__host__ __device__ constexpr int patch_bytes(int cc) { return cc / 16 * CSTRIDE * 16; }
__host__ __device__ constexpr int weight_bytes(int cc) { return 9 * cc * NT; }
__host__ __device__ constexpr int conv_smem_bytes(int cc) {
  // + deq, bias, the staging buffers
  return weight_bytes(cc) + 2 * patch_bytes(cc) + 2 * NT * 4 + CONSUMERS / 32 * STAGE_WARP;
}

// OUT: the outputs the conv's epilogue stores, fp32 and / or int8.
constexpr int kOutF32 = 1, kOutI8 = 2;

struct ConvArgs {
  const void* x;       // (B,H,W,Cin) fp32 or int8
  const int8_t* wk;    // (Npad, 9*Cin) int8, K-major
  const float* deq;    // (Cout,)
  const float* bias;   // (Cout,)
  const float* res;    // (B,H,W,Cout) fp32 residual (RES), or null
  float* out;          // (B,H,W,Cout) fp32 (OUT & kOutF32), or null
  int8_t* out8;        // (B,H,W,Cout) int8 (OUT & kOutI8), or null
  int H, W, Cin, Cout;
  int cc, nch;         // K chunk: channels, chunks (cc * nch == Cin)
  int rects_w, rects_h, rects;
  int leaky;
  float slope, rate, inv_x, out_inv_x;
};

// D (64 x 128 int32, registers) (+)= A (64 x 32 int8) * B (32 x 128 int8),
// both from shared memory, K-major, at descriptors a + AO and b + BO (16-byte
// units, added inside the asm so that ptxas cannot hoist 2 x 36 descriptors
// into registers); scale_d == 0 overwrites D.
#define ISR_WGMMA_S8                                                                         \
  "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "        \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "         \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "         \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
template <int AO, int BO>
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %66, 0;\n"
      "add.s64 da, %64, %67;\nadd.s64 db, %65, %68;\n" ISR_WGMMA_S8 "da, db, p;\n}\n"
      : ISR_OP8("+r", 0), ISR_OP8("+r", 8), ISR_OP8("+r", 16), ISR_OP8("+r", 24),
        ISR_OP8("+r", 32), ISR_OP8("+r", 40), ISR_OP8("+r", 48), ISR_OP8("+r", 56)
      : "l"(a), "l"(b), "r"(scale_d), "n"(AO), "n"(BO));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  wgmma_s8<0, 0>(d, a, b, scale_d);
}
#undef ISR_WGMMA_S8

// The KS wgmmas of one tap, unrolled: K step I reads two 16-byte channel
// chunks of the patch (CSTRIDE apart) and 32 K rows of the weights (whose
// 16-byte chunk kc sits at kc * NT * 16 bytes).
template <int... I>
__device__ __forceinline__ void tap_wgmmas(int (&d)[64], uint64_t a, uint64_t b, int scale_d,
                                           std::integer_sequence<int, I...>) {
  (wgmma_s8<2 * I * CSTRIDE, 2 * I * NT>(d, a, b, I == 0 ? scale_d : 1), ...);
}

// Four fp32 values -> four int8 in one word: clamp(rint(v * inv_x), +-127),
// rounding half to even (__float2int_rn), as torch.round / jnp.round do.
__device__ __forceinline__ uint32_t requant4(float4 v, float inv_x) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = min(max(__float2int_rn(__fmul_rn(f[i], inv_x)), -127), 127);
    out |= (uint32_t)(q & 0xff) << (8 * i);
  }
  return out;
}

__device__ __forceinline__ int requant1(float v, float inv_x) {
  return min(max(__float2int_rn(__fmul_rn(v, inv_x)), -127), 127);
}

__device__ __forceinline__ uint16_t requant2(float2 v, float inv_x) {
  return (uint16_t)((requant1(v.x, inv_x) & 0xff) | ((requant1(v.y, inv_x) & 0xff) << 8));
}

// The residual update res + y * rate, each op rounded once (no FMA), as
// h + t * rate in two PyTorch ops.
__device__ __forceinline__ float residual(float res, float y, float rate) {
  return __fadd_rn(res, __fmul_rn(y, rate));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// KS: wgmma K steps per tap (cc / 32) as a constant, so that the 9 * KS
// wgmmas of a tile are unrolled and issued back to back; 0: taken from
// p.cc at run time (other widths; ptxas then waits between the wgmmas).
// OUT: kOutF32, kOutI8 or both; RES: the epilogue adds res + y * rate.
template <bool IN_F32, int OUT, bool RES, int KS>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv3x3_int8_kernel(const __grid_constant__ ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = smem_addr(smem);
  const int pbytes = patch_bytes(p.cc), wbytes = weight_bytes(p.cc);
  float* s_deq = reinterpret_cast<float*>(smem + wbytes + 2 * pbytes);
  float* s_bias = s_deq + NT;
  unsigned char* s_stage = reinterpret_cast<unsigned char*>(s_bias + NT);
  // The warpgroup index through a shuffle, so that ptxas knows it is
  // warp-uniform and keeps the wgmma descriptors in uniform registers.
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int n0 = blockIdx.y * NT;
  const int mine = (p.rects - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int items = mine * p.nch;  // (rectangle, K chunk) pairs, chunk fastest
  const long long K = 9LL * p.Cin;

  // Rectangle r: image pixel index of (b, 0, 0) and the output origin.
  auto origin = [&](int r, long long& img, int& h0, int& w0) {
    w0 = (r % p.rects_w) * RW;
    r /= p.rects_w;
    h0 = (r % p.rects_h) * RH;
    img = (long long)(r / p.rects_h) * p.H * p.W;
  };

  if (wg == TILES) {  // ---------------------------------------- producer
    const int pt = tid - CONSUMERS;
    const int cpp = p.cc / 16, total = PPIX * cpp;
    for (int s = 0; s < items; ++s) {
      const int r = blockIdx.x + (s / p.nch) * gridDim.x, ch = s % p.nch;
      const int c0 = ch * p.cc;  // first input channel of the chunk
      if (s == 0 || p.nch > 1) {
        // Weights of the chunk: 16-byte chunk (kc, n) at (kc * NT + n) * 16,
        // K row k = tap * cc + c of the chunk.
        if (s > 0) bar_sync(kWEmpty, CONV_THREADS);
        for (int i = pt; i < 9 * cpp * NT; i += 128) {
          const int n = i % NT, kc = i / NT;
          const int tap = kc / cpp, c = (kc % cpp) * 16;
          cp_async16(w_s + i * 16, p.wk + (n0 + n) * K + tap * p.Cin + c0 + c, true);
        }
        if (s == 0) {  // this tile's deq and bias, zero past Cout
          const int n = n0 + pt;
          s_deq[pt] = n < p.Cout ? p.deq[n] : 0.f;
          s_bias[pt] = n < p.Cout ? p.bias[n] : 0.f;
        }
        cp_async_commit();
        cp_async_wait<0>();
        fence_proxy_async();
        for (int m = 0; m < TILES; ++m) bar_arrive(kWFull + m, FULL_THREADS);
      }
      const int b = s & 1;
      if (s >= 2) bar_sync(kEmpty + b, CONV_THREADS);
      long long img;
      int h0, w0;
      origin(r, img, h0, w0);
      unsigned char* patch = smem + wbytes + b * pbytes;
      // Chunk i: pixel i / cpp of the patch, channels c0 + 16 (i % cpp) + 0..15,
      // zeros outside the image (the conv's padding).
      if constexpr (IN_F32) {
        const float* x = static_cast<const float*>(p.x);
        for (int i0 = pt; i0 < total; i0 += 128 * UNROLL) {
          float4 v[UNROLL][4];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int i = i0 + u * 128, pix = i / cpp, c = i - pix * cpp;
            const int hs = h0 - 1 + pix / PW, ws = w0 - 1 + pix % PW;
            const bool ok = i < total && hs >= 0 && hs < p.H && ws >= 0 && ws < p.W;
            const float4* src = reinterpret_cast<const float4*>(
                x + (img + (long long)hs * p.W + ws) * p.Cin + c0 + 16 * c);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v[u][k] = ok ? __ldg(src + k) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int i = i0 + u * 128;
            if (i >= total) break;
            const int pix = i / cpp, c = i - pix * cpp;
            *reinterpret_cast<uint4*>(patch + (c * CSTRIDE + pix) * 16) =
                make_uint4(requant4(v[u][0], p.inv_x), requant4(v[u][1], p.inv_x),
                           requant4(v[u][2], p.inv_x), requant4(v[u][3], p.inv_x));
          }
        }
      } else {
        const int8_t* x = static_cast<const int8_t*>(p.x);
        const uint32_t patch_s = smem_addr(patch);
        for (int i = pt; i < total; i += 128) {
          const int pix = i / cpp, c = i - pix * cpp;
          const int hs = h0 - 1 + pix / PW, ws = w0 - 1 + pix % PW;
          const bool ok = hs >= 0 && hs < p.H && ws >= 0 && ws < p.W;
          const int8_t* src =
              ok ? x + (img + (long long)hs * p.W + ws) * p.Cin + c0 + 16 * c : x;
          cp_async16(patch_s + (c * CSTRIDE + pix) * 16, src, ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      fence_proxy_async();
      for (int m = 0; m < TILES; ++m) bar_arrive(kFull + TILES * b + m, FULL_THREADS);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int ksteps = KS > 0 ? KS : p.cc / 32;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int s = 0; s < items; ++s) {
    const int r = blockIdx.x + (s / p.nch) * gridDim.x, ch = s % p.nch;
    const int b = s & 1;
    long long img;
    int h0, w0;
    origin(r, img, h0, w0);
    if (RES && ch == 0) {
      // The residual of this tile's outputs into L2 while its wgmmas run, so
      // that the epilogue's loads of it hit L2: thread t takes tile pixel
      // t / 2 (image row 8 wg + t / 16 of the rectangle, column t / 2 % 8)
      // and two of the (up to) four 128-byte lines of its NT channels.
      const int t = tid % 128, oh = h0 + 8 * wg + t / 16, ow = w0 + t / 2 % 8;
      if (oh < p.H && ow < p.W) {
        const char* row = reinterpret_cast<const char*>(
            p.res + (img + (long long)oh * p.W + ow) * p.Cout + n0);
        const int span = min(NT, p.Cout - n0) * 4;
        for (int k = 2 * (t % 2); k < 2 * (t % 2) + 2; ++k)
          if (k * 128 < span) prefetch_l2(row + k * 128);
      }
    }
    if (s == 0 || p.nch > 1) bar_sync(kWFull + wg, FULL_THREADS);
    bar_sync(kFull + TILES * b + wg, FULL_THREADS);
    const uint32_t patch = w_s + wbytes + b * pbytes;
    // Tile wg is image rows 8 wg .. 8 wg + 7 of the rectangle: at tap
    // (dy, dx) its row group i reads patch pixels (8 wg + i + dy) * PW +
    // dx + 0..7, one core matrix per 16 channels, CSTRIDE apart along K.
    const uint64_t a0 = smem_desc(patch + 8 * wg * PW * 16, CSTRIDE * 16, PW * 16);
    const uint64_t b0 = smem_desc(w_s, NT * 16, 128);
    // The warpgroups take turns on the tensor cores, m after m - 1 (0 after
    // TILES - 1 on the item before): issued together, their wgmmas would
    // interleave and end together, and all three epilogues would then run
    // with the tensor cores idle; in turns, each one's epilogue overlaps
    // the others' wgmmas.
    if (s > 0 || wg > 0) bar_sync(kTurn + wg, 256);
    // One tap per iteration, its K steps unrolled with the descriptor
    // offsets as immediates: unrolling all 9 taps makes ptxas compute every
    // descriptor up front, more than the uniform registers hold.
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t at = a0 + (tap / 3) * PW + tap % 3, bt = b0 + tap * 2 * ksteps * NT;
      const int scale_d = (ch | tap) != 0;
      wgmma_fence();
      if constexpr (KS > 0) {
        tap_wgmmas(acc, at, bt, scale_d, std::make_integer_sequence<int, KS>());
      } else {
        for (int ks = 0; ks < ksteps; ++ks)
          wgmma_s8(acc, at + 2 * ks * CSTRIDE, bt + 2 * ks * NT, scale_d | ks);
      }
    }
    wgmma_commit();
    if (s + 1 < items || wg + 1 < TILES) bar_arrive(kTurn + (wg + 1) % TILES, 256);
    wgmma_wait<0>();
    if (s + 2 < items) bar_arrive(kEmpty + b, CONV_THREADS);
    if (p.nch > 1 && s + 1 < items) bar_arrive(kWEmpty, CONV_THREADS);
    if (ch != p.nch - 1) continue;

    // Epilogue from the accumulators: element 4j + 2h + e is tile row
    // 16 warp + lane / 4 + 8h (image row 8 wg + 2 warp + h of the rectangle,
    // column lane / 4), output channel n0 + 8j + 2 (lane % 4) + e.
    const int px = lane / 4, q = lane % 4, nl = 2 * q;
    // Whole tiles (the serving case) go through the warp's staging buffers,
    // 32 channels (four column pairs j) at a time, so that global memory
    // sees 16-byte accesses, eight consecutive lanes on a pixel's 128 fp32
    // bytes and two on its 32 int8 bytes, not 8- or 2-byte pieces of
    // eight pixels. The buffers are swizzled (16-byte chunk c of pixel x at
    // c ^ 2x in fp32, half c at c ^ (x / 4) in int8) so that neither side
    // conflicts on banks.
    const bool whole = n0 + NT <= p.Cout && p.Cout % 16 == 0;
    unsigned char* sf = s_stage + (tid / 32) * STAGE_WARP;
    unsigned char* si = sf + STAGE_F32;
    auto f32_at = [&](int x, int c) { return sf + x * 128 + 16 * (c ^ (2 * x & 7)); };
    auto i8_at = [&](int x, int c) { return si + x * 32 + 16 * (c ^ (x >> 2 & 1)); };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oh = h0 + 8 * wg + 2 * warp + h;
      if (oh >= p.H) continue;
      // output element (channel n0) of the row's first pixel, column w0
      const long long row = (img + (long long)oh * p.W + w0) * p.Cout + n0;
      auto y2 = [&](int j) {
        const float2 dq = *reinterpret_cast<const float2*>(s_deq + 8 * j + nl);
        const float2 bs = *reinterpret_cast<const float2*>(s_bias + 8 * j + nl);
        float2 y = make_float2(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), dq.x), bs.x),
            __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), dq.y), bs.y));
        if (p.leaky) {
          y.x = y.x > 0.f ? y.x : __fmul_rn(p.slope, y.x);
          y.y = y.y > 0.f ? y.y : __fmul_rn(p.slope, y.y);
        }
        return y;
      };
      if (whole) {
        // Lane L's fp32 chunk of group g: pixel 4i + L / 8, chunk L % 8.
        auto f32_global = [&](int g, int i) {
          return row + (long long)(4 * i + lane / 8) * p.Cout + 32 * g + 4 * (lane % 8);
        };
        auto in_image = [&](int x) { return w0 + x < p.W; };
        float4 rs[2][2];  // the residual of groups g and g + 1
        auto load_res = [&](int g, float4 (&r)[2]) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            r[i] = in_image(4 * i + lane / 8)
                       ? __ldg(reinterpret_cast<const float4*>(p.res + f32_global(g, i)))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        };
        if constexpr (RES) load_res(0, rs[0]);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if constexpr (RES) {
            if (g < 3) load_res(g + 1, rs[(g + 1) & 1]);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              *reinterpret_cast<float4*>(f32_at(4 * i + lane / 8, lane % 8)) = rs[g & 1][i];
            __syncwarp();
          }
          float2 y[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            y[a] = y2(4 * g + a);
            float2* at = reinterpret_cast<float2*>(f32_at(px, 2 * a + q / 2) + 8 * (q & 1));
            if constexpr (RES)
              y[a] = make_float2(residual(at->x, y[a].x, p.rate), residual(at->y, y[a].y, p.rate));
            if constexpr ((OUT & kOutF32) != 0) *at = y[a];
            if constexpr ((OUT & kOutI8) != 0)
              *reinterpret_cast<uint16_t*>(i8_at(px, a / 2) + (8 * a + nl) % 16) =
                  requant2(y[a], p.out_inv_x);
          }
          __syncwarp();
          if constexpr ((OUT & kOutF32) != 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (in_image(4 * i + lane / 8))
                *reinterpret_cast<float4*>(p.out + f32_global(g, i)) =
                    *reinterpret_cast<const float4*>(f32_at(4 * i + lane / 8, lane % 8));
          }
          if constexpr ((OUT & kOutI8) != 0) {
            const int x = lane / 2, c = lane % 2;
            if (lane < 16 && in_image(x))
              *reinterpret_cast<uint4*>(p.out8 + row + (long long)x * p.Cout + 32 * g + 16 * c) =
                  *reinterpret_cast<const uint4*>(i8_at(x, c));
          }
          __syncwarp();  // the buffers take the next group
        }
      } else {
        const int ow = w0 + px;
        if (ow >= p.W) continue;
        const long long o = row + (long long)px * p.Cout;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = 8 * j + nl;
          const float2 y = y2(j);
          for (int e = 0; e < 2; ++e) {
            if (n0 + n + e >= p.Cout) break;
            float v = e ? y.y : y.x;
            if constexpr (RES) v = residual(p.res[o + n + e], v, p.rate);
            if constexpr ((OUT & kOutF32) != 0) p.out[o + n + e] = v;
            if constexpr ((OUT & kOutI8) != 0)
              p.out8[o + n + e] = (int8_t)requant1(v, p.out_inv_x);
          }
        }
      }
    }
  }
}

template <bool IN_F32, int OUT, bool RES>
cudaError_t launch_conv(const ConvArgs& p, int grid_x, int ntiles, cudaStream_t stream) {
  auto kernel = p.cc == MAX_CC ? conv3x3_int8_kernel<IN_F32, OUT, RES, MAX_CC / 32>
                               : conv3x3_int8_kernel<IN_F32, OUT, RES, 0>;
  const int bytes = conv_smem_bytes(p.cc);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(grid_x, ntiles), CONV_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The instantiation for p's input type, outputs and residual.
template <bool IN_F32>
cudaError_t dispatch_conv(const ConvArgs& p, int grid_x, int ntiles, cudaStream_t stream) {
  const int out = (p.out ? kOutF32 : 0) | (p.out8 ? kOutI8 : 0);
  if (p.res) {
    if (out == kOutF32) return launch_conv<IN_F32, kOutF32, true>(p, grid_x, ntiles, stream);
    if (out == kOutI8) return launch_conv<IN_F32, kOutI8, true>(p, grid_x, ntiles, stream);
    return launch_conv<IN_F32, kOutF32 | kOutI8, true>(p, grid_x, ntiles, stream);
  }
  if (out == kOutF32) return launch_conv<IN_F32, kOutF32, false>(p, grid_x, ntiles, stream);
  if (out == kOutI8) return launch_conv<IN_F32, kOutI8, false>(p, grid_x, ntiles, stream);
  return launch_conv<IN_F32, kOutF32 | kOutI8, false>(p, grid_x, ntiles, stream);
}

// ------------------------------------------------------------------ GEMM --

// Block tile GM x GN, two consumer warpgroups of 64 rows each issuing
// wgmma m64n256, and a producer warpgroup whose one thread feeds a ring of
// GSTAGES stages by TMA (128 bytes of K per stage, 128-byte swizzle).
constexpr int GM = 128, GN = 256, GKB = 128, GSTAGES = 4;
constexpr int GA_BYTES = GM * GKB, GB_BYTES = GN * GKB, GSTAGE_BYTES = GA_BYTES + GB_BYTES;
constexpr int GTHREADS = 384;
constexpr int GSMEM = GSTAGES * GSTAGE_BYTES + 1024 + 2 * GSTAGES * 8;  // + alignment, mbarriers

// Descriptor of a K-major tile written by TMA with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024) | (1ull << 62);
}

// D (64 x 256, registers) (+)= A (64 x 32 bytes of K) * B (32 bytes of K x
// 256), both K-major in shared memory: .s8 k32 -> int32, .bf16 k16 -> fp32.
template <typename T>
struct Gmma;

template <>
struct Gmma<int8_t> {
  using Acc = int;
  __device__ static void run(int (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" ISR_REGS128 "}, "
        "%128, %129, p;\n}\n"
        : ISR_OP128("+r")
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Gmma<__nv_bfloat16> {
  using Acc = float;
  __device__ static void run(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" ISR_REGS128 "}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"  // both operands K-major: no transpose
        : ISR_OP128("+f")
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// C (M, N) = A (M, K) x B, from A and Bt = B^T (N, K), both row-major (K
// contiguous), through the tensor maps tmA (box 128 bytes x GM rows) and tmB
// (128 bytes x GN rows); TMA fills zeros past M, N and K.
template <typename T>
__global__ void __launch_bounds__(GTHREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
            void* __restrict__ out, int M, int N, int K) {
  using Acc = typename Gmma<T>::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = (smem_addr(smem) + 1023) & ~1023u;  // swizzled tiles: 1024-aligned
  const uint32_t full = s0 + GSTAGES * GSTAGE_BYTES, empty = full + GSTAGES * 8;
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int kstep = GKB / sizeof(T);  // K elements per stage
  const int ktiles = (K + kstep - 1) / kstep;
  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one thread of each consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every TMA load
    if (tid == 256) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % GSTAGES;
        if (kt >= GSTAGES) mbar_wait(empty + 8 * s, (kt / GSTAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, GSTAGE_BYTES);
        const uint32_t st = s0 + s * GSTAGE_BYTES;
        tma_load_2d(st, &tmA, kt * kstep, m0, full + 8 * s);
        tma_load_2d(st + GA_BYTES, &tmB, kt * kstep, n0, full + 8 * s);
      }
    }
    return;
  }

  Acc acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = Acc(0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % GSTAGES;
    mbar_wait(full + 8 * s, (kt / GSTAGES) & 1);
    const uint32_t st = s0 + s * GSTAGE_BYTES;
    const uint64_t ad = sw128_desc(st + wg * 64 * GKB), bd = sw128_desc(st + GA_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < GKB / 32; ++ks)  // 32 bytes of K per wgmma, inside the swizzle row
      Gmma<T>::run(acc, ad + 2 * ks, bd + 2 * ks, kt > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the wgmmas of tile kt - 1 are done: release its stage
    if (kt > 0 && tid % 128 == 0) mbar_arrive(empty + 8 * ((kt - 1) % GSTAGES));
  }
  wgmma_wait<0>();

  // Epilogue: element 4j + 2h + e is row 64 wg + 16 warp + lane / 4 + 8h,
  // column 8j + 2 (lane % 4) + e.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
    if (m >= M) continue;
    Acc* o = static_cast<Acc*>(out) + (long long)m * N;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      const Acc v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (n + 1 < N && N % 2 == 0) {
        if constexpr (std::is_same<Acc, float>::value)
          *reinterpret_cast<float2*>(o + n) = make_float2(v0, v1);
        else
          *reinterpret_cast<int2*>(o + n) = make_int2(v0, v1);
      } else {
        if (n < N) o[n] = v0;
        if (n + 1 < N) o[n + 1] = v1;
      }
    }
  }
}

// A 2-D tensor map over a row-major (rows, K) matrix of T: boxes of 128
// bytes of K x box_rows rows, 128-byte swizzle.
template <typename T>
CUresult gemm_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(GKB / sizeof(T)), (cuuint32_t)box_rows};
  return encode_map(map, sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    ptr, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

// Bt = B^T for the GEMM: B (R, C) row-major of ES-byte elements, R * ES a
// multiple of 16 (K's step), any C. A block moves a tile of 64 rows x 64
// bytes through shared memory with 16-byte stores, and 16-byte loads where
// the input rows are 16-byte multiples (byte loads, masked at the row's
// end, where they are not: ragged N).
template <int ES>
__global__ void __launch_bounds__(256) transpose_kernel(const uint8_t* __restrict__ in,
                                                        uint8_t* __restrict__ out, int R,
                                                        int C) {
  __shared__ uint8_t tile[64][64 + 16];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.y * 64, cb0 = (long long)blockIdx.x * 64;
  const long long rb = (long long)C * ES;  // bytes per input row
  {
    const int row = t / 4, q = t % 4;
    const long long cb = cb0 + 16 * q;
    if (r0 + row < R && cb < rb) {
      const uint8_t* src = in + (r0 + row) * rb + cb;
      if (rb % 16 == 0) {
        *reinterpret_cast<uint4*>(&tile[row][16 * q]) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (cb + j < rb) tile[row][16 * q + j] = src[j];
      }
    }
  }
  __syncthreads();
  // Output row oc (input column cb0 / ES + oc), its 16-byte chunk q: input
  // rows r0 + q * 16 / ES + 0 .. 16 / ES - 1.
  const int oc = t / (4 * ES), q = t % (4 * ES), per = 16 / ES;
  const long long c = cb0 / ES + oc, r = r0 + (long long)q * per;
  if (c >= C || r >= R) return;
  uint8_t v[16];
#pragma unroll
  for (int e = 0; e < per; ++e)
#pragma unroll
    for (int b = 0; b < ES; ++b) v[e * ES + b] = tile[q * per + e][oc * ES + b];
  *reinterpret_cast<uint4*>(out + (c * R + r) * ES) = *reinterpret_cast<const uint4*>(v);
}

template <typename T>
int launch_gemm(const void* a, const void* bt, void* out, int M, int N, int K, void* stream) {
  CUtensorMap tmA, tmB;
  if (gemm_map<T>(&tmA, a, M, K, GM) != CUDA_SUCCESS ||
      gemm_map<T>(&tmB, bt, N, K, GN) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kernel = gemm_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((N + GN - 1) / GN), (unsigned)((M + GM - 1) / GM));
  kernel<<<grid, GTHREADS, GSMEM, static_cast<cudaStream_t>(stream)>>>(tmA, tmB, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// (M,K) x (K,N) on `stream`, from A (M,K) and Bt = B^T (N,K), both
// row-major and 16-byte aligned. dtype 0: int8 -> int32 out; 1: bf16 ->
// fp32 out. K % 32 (int8) or K % 16 (bf16), K > 0. Returns a cudaError_t (0
// on success).
extern "C" int isr_matmul(const void* a, const void* bt, void* out, long long M, int N,
                          int K, int dtype, void* stream) {
  if (M > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_gemm<int8_t>(a, bt, out, (int)M, N, K, stream);
  return launch_gemm<__nv_bfloat16>(a, bt, out, (int)M, N, K, stream);
}

// out (C, R) = in (R, C)^T on `stream`, elements of esize (1 or 2) bytes;
// R * esize a multiple of 16, any C, both 16-byte aligned.
extern "C" int isr_transpose(const void* in, void* out, int R, int C, int esize,
                             void* stream) {
  if ((long long)R * esize % 16 || (esize != 1 && esize != 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long long)C * esize + 63) / 64), (unsigned)((R + 63) / 64));
  auto kernel = esize == 1 ? transpose_kernel<1> : transpose_kernel<2>;
  kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), R, C);
  return (int)cudaGetLastError();
}

// Implicit-GEMM 3x3 conv, zero padding 1, on `stream`: x (B,H,W,Cin) fp32
// (in_f32, requantized on load with inv_x) or int8; w_k (Npad, 9*Cin) int8
// K-major (ops/kernels/matmul.py:weights_k_major), Npad = 128 * ntiles >=
// Cout; deq/bias (Cout,) fp32; y = fl(fl(acc * deq) + bias), leaky; with
// res (B,H,W,Cout) fp32, not null, y becomes res + y * rate; then stored
// in fp32 to out and / or requantized with out_inv_x to int8 out8 (each
// (B,H,W,Cout) or null, not both null; none of them aliases res or x). The
// launch plan (conv_plan in the wrapper): K chunks of cc channels (cc % 32
// == 0, cc <= 128, Cin % cc == 0) and grid_x persistent blocks per 128
// output channels (at most one per rectangle); the RH x RW rectangles that
// cover each image are counted here. Returns a cudaError_t (0 on success).
extern "C" int isr_conv3x3_int8(const void* x, const void* w_k, const void* deq,
                                const void* bias, const void* res, void* out, void* out8,
                                int B, int H, int W, int Cin, int Cout, int in_f32, int leaky,
                                float slope, float rate, float inv_x, float out_inv_x, int cc,
                                int grid_x, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 32 || Cin % 32 || Cout < 1 || cc < 32 || cc % 32 ||
      cc > MAX_CC || Cin % cc || grid_x < 1 || (out == nullptr && out8 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rects_h = (H + RH - 1) / RH, rects_w = (W + RW - 1) / RW;
  ConvArgs p;
  p.x = x;
  p.wk = static_cast<const int8_t*>(w_k);
  p.deq = static_cast<const float*>(deq);
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const float*>(res);
  p.out = static_cast<float*>(out);
  p.out8 = static_cast<int8_t*>(out8);
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.cc = cc;
  p.nch = Cin / cc;
  p.rects_w = rects_w;
  p.rects_h = rects_h;
  p.rects = B * rects_h * rects_w;
  p.leaky = leaky;
  p.slope = slope;
  p.rate = rate;
  p.inv_x = inv_x;
  p.out_inv_x = out_inv_x;
  const int ntiles = (Cout + NT - 1) / NT;
  grid_x = grid_x < p.rects ? grid_x : p.rects;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = in_f32 ? dispatch_conv<true>(p, grid_x, ntiles, st)
                               : dispatch_conv<false>(p, grid_x, ntiles, st);
  return (int)e;
}

// Dynamic shared memory of the conv kernel for K chunks of cc channels, and
// of the GEMM.
extern "C" int isr_conv3x3_int8_smem_bytes(int cc) { return conv_smem_bytes(cc); }

// The conv's tiling, for the wrapper's launch plan: {RH, RW, NT, MAX_CC}.
extern "C" void isr_conv3x3_int8_tiling(int* out) {
  out[0] = RH;
  out[1] = RW;
  out[2] = NT;
  out[3] = MAX_CC;
}
extern "C" int isr_matmul_smem_bytes() { return GSMEM; }

extern "C" const char* isr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
