/*
 * Fused residual dense block (RDB) for NVIDIA Hopper, sm_90a.
 *
 * Replaces image_super_resolution_tpu/ops/pallas/fused_rdb.py:scatter_rdb_pallas
 * (the Pallas TPU kernel). Computes one whole RDB on NHWC bf16 activations,
 * C = 64, g = 32, for any batch B and any H, W, from the scatter-form
 * weights sx, s0..s3 ((9*Cin, Cout) bf16, rows (dy, dx, cin)) and bias:
 *
 *   y_i = bf16(leaky(bias[ig:(i+1)g] + conv(x, W_xi) + sum_{j<i} conv(y_j, W_ji)))
 *   out = bf16((bias[4g:] + conv(x, W_xf) + sum_j conv(y_j, W_jf)) * add_rate + x)
 *
 * with every 3x3 conv zero-padded by 1 at the image border. W_ji are column
 * slices of the scatter-form matrices, read in place: y_i's slice of sx is
 * sx[:, ig:(i+1)g], of s_j it is s_j[:, (i-j-1)g:(i-j)g]. This is the
 * function the scatter form computes; only the order of the fp32 sums
 * differs. The launch plan (which source, channels, weight rows and columns
 * each launch reads) is built by ops/kernels/fused_rdb.py:dense_plan and
 * passed in as integers, so the CPU tests hold the same plan.
 *
 * Bound on an H100 SXM at the serving shape B=256, 24x24 tiles: the five
 * convs are 2 * 9 * (64*192 + 32*160 + 32*128 + 32*96 + 32*64) = 479,232
 * FLOP per pixel, 7.07e10 FLOP per call over 147,456 pixels: about 71 us at
 * 989 TFLOP/s dense bf16. The bytes that must move are x in and out
 * (2 x 18.9 MB) plus 0.5 MB of weights, about 38 MB: 11 us at 3.35 TB/s.
 * So the RDB is bound by operations, by a factor of about 6.
 *
 * Design. Five launches of one implicit-GEMM kernel in dense (gather) form:
 * launch i reads the bf16 sources that exist so far (x, y_0..y_{i-1}) and
 * keeps one fp32 accumulator per output in registers; nothing but bf16
 * y_0..y_3 (one (B,H,W,128) buffer) and the output go to device memory.
 *   - A block owns a 24 x 24 rectangle of output pixels of one image (one
 *     serving tile): 576 rows, three warpgroups of three 64-row tiles each,
 *     one block per SM. Ragged edges are masked, so any H, W. (8 x 24
 *     rectangles, one 64-row tile per warpgroup and two blocks per SM,
 *     took 0.35 ms at the serving shape against 0.29 for 24 x 24: every
 *     block re-reads the weights from L2, and the larger rectangle reads
 *     them for three times the rows.)
 *   - K walks 32-channel source groups (2 for x, 1 per y_j). For each group
 *     the block copies the 26 x 26 halo patch (zero-filled outside the
 *     image) and the group's 288 x N weight rows into shared memory with
 *     cp.async, in a ring of 3 stages (2 for the N=64 last launch), so the
 *     next groups' copies fly while this one is multiplied. One barrier per
 *     group.
 *   - The nine taps read the patch at shifted pixel addresses: ldmatrix.x4
 *     loads each 16 x 16 A fragment into registers (patch rows XOR-swizzled
 *     in 16-byte chunks, free of bank conflicts), and wgmma m64nNk16 (N = 32
 *     for y_i, 64 for the output) multiplies it with the weights, which are
 *     its B operand from shared memory, N-major (the matmul form's own
 *     layout) in 8 x 8 core matrices. Each step issues one tap of one
 *     64-row tile; two A register buffers alternate between steps, so one
 *     step's loads overlap the previous step's wgmma, and consecutive steps
 *     feed different accumulators.
 *   - The epilogue works on the registers: bias, then leaky and the bf16
 *     rounding (y_i), or * add_rate + x and the rounding (output), with
 *     __fadd_rn/__fmul_rn so no FMA fuses the residual.
 *
 * What it leaves on the table, at 25% of its bound: a producer warp with
 * TMA and mbarriers in place of cp.async issued by every thread, and more
 * than one barrier-free step in flight per warpgroup (each step waits for
 * the one two before it, and every source group ends in a block barrier);
 * the weights re-read from L2 by every block (TMA multicast across a
 * cluster would share them); the y's kept on chip across launches (halo
 * recompute); 16-byte epilogue stores (each thread writes 4 bytes per
 * fragment column pair). A persistent grid, whose ring runs on across tile
 * boundaries, was tried and was not faster at the serving shape.
 */

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int C = 64;                     // block width
constexpr int G = 32;                     // growth channels = channels per K group
constexpr int YC = 4 * G;                 // channels of the y buffer
constexpr int MT = 3;                     // 64-row tiles per warpgroup
constexpr int TH = 8 * MT, TW = 24;       // output rectangle of one block
constexpr int PW = TW + 2;                // halo patch width
constexpr int PPIX = (TH + 2) * PW;       // halo patch pixels (676)
constexpr int THREADS = 384;              // three warpgroups
constexpr int SLAB = THREADS / 2;         // rows of one tile in all warpgroups (192)
static_assert(TH * TW == MT * SLAB, "the rectangle's pixels are the block's rows");
constexpr int KG = 9 * G;                 // K rows per source group (288)
constexpr int PATCH_BYTES = PPIX * G * 2; // 43,264
constexpr int MAX_GROUPS = 6;
constexpr int PLAN_INTS = 5 + 5 * MAX_GROUPS;  // one launch of the plan
constexpr int COUTS[5] = {4 * G + C, 3 * G + C, 2 * G + C, G + C, C};

struct Group {       // one 32-channel slice of a source and its weight rows
  const bf16* src;   // (B,H,W,src_ld)
  int src_ld, src_c0;
  const bf16* w;     // (9*w_cin, w_ld), rows (dy, dx, cin)
  int w_ld, w_cin, w_c0, w_col0;
};

struct Launch {
  Group g[MAX_GROUPS];
  int groups;
  const float* bias;  // this launch's N biases
  bf16* dst;          // y buffer or output
  int dst_ld, dst_c0;
  const bf16* x;      // the residual (last launch)
  int H, W, tiles_h, tiles_w;
  float add_rate, slope;
};

// D (64 x N fp32, registers) += A (64 x 16 bf16, registers) * B (descriptor),
// B transposed (N-major).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ static void run(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// Byte offset of 16-byte chunk `chunk` (0..3) of patch pixel `pix`: pixels
// are 64 bytes apart and their chunks XOR-swizzled, so the 8 rows one
// ldmatrix phase reads (8 neighbouring pixels) fall in 8 distinct banks.
__device__ __forceinline__ uint32_t patch_offset(int pix, int chunk) {
  return pix * (G * 2) + ((chunk ^ ((pix >> 1) & 3)) << 4);
}

template <int N>
__host__ __device__ constexpr int stages() {
  return N == 32 ? 3 : 2;  // three 61.7 KB or two 80.1 KB stages
}

template <int N>
__host__ __device__ constexpr int smem_bytes() {
  return stages<N>() * (PATCH_BYTES + KG * N * 2);
}

template <int N, bool LAST>
__global__ void __launch_bounds__(THREADS, 1) rdb_dense_conv(const __grid_constant__ Launch p) {
  constexpr int STAGES = stages<N>();
  constexpr int B_BYTES = KG * N * 2;
  constexpr int STAGE_BYTES = PATCH_BYTES + B_BYTES;
  static_assert(STAGE_BYTES % 128 == 0 && PATCH_BYTES % 128 == 0, "stage alignment");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t smem0 = smem_addr(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int t = blockIdx.x;
  const int tw_i = t % p.tiles_w;
  t /= p.tiles_w;
  const int th_i = t % p.tiles_h;
  const long long img = (long long)(t / p.tiles_h) * p.H * p.W;  // pixel (b, 0, 0)
  const int h0 = th_i * TH, w0 = tw_i * TW;

  // Copy group gi's halo patch and weight rows into ring stage `stage`.
  auto load_group = [&](int gi, int stage) {
    const Group& g = p.g[gi];
    const uint32_t patch = smem0 + stage * STAGE_BYTES;
    for (int i = tid; i < PPIX * 4; i += THREADS) {
      const int pix = i >> 2, chunk = i & 3;
      const int hs = h0 - 1 + pix / PW, ws = w0 - 1 + pix % PW;
      const bool inside = hs >= 0 && hs < p.H && ws >= 0 && ws < p.W;
      const bf16* src = g.src;
      if (inside) src += (img + (long long)hs * p.W + ws) * g.src_ld + g.src_c0 + chunk * 8;
      cp_async16(patch + patch_offset(pix, chunk), src, inside);
    }
    // Chunk i holds k row (i / N) * 8 + i % 8, columns 8 * ((i % N) / 8) + 0..7:
    // core matrix (k / 8, n / 8) at byte ((k / 8) * (N / 8) + n / 8) * 128.
    const uint32_t bs = patch + PATCH_BYTES;
    for (int i = tid; i < KG * N / 8; i += THREADS) {
      const int k = (i / N) * 8 + (i & 7);
      const int row = (k >> 5) * g.w_cin + g.w_c0 + (k & 31);  // tap, channel
      cp_async16(bs + i * 16, g.w + (long long)row * g.w_ld + g.w_col0 + ((i % N) >> 3) * 8,
                 true);
    }
  };

  float acc[MT][N / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;

  // Rows (pixels, row-major in the rectangle) 192m .. 192m+191 are row
  // tile m of the three warpgroups; warp w holds rows 192m + 16w + 0..15.
  // ldmatrix addressing: lane l gives row l % 16 of its warp's 16, 16-byte
  // chunk l / 16 of the k16 step.
  int apix[MT];  // patch pixel of that row at tap (0, 0)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = m * SLAB + warp * 16 + (lane & 15);
    apix[m] = (r / TW) * PW + r % TW;
  }
  const int akc = lane >> 4;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < p.groups) load_group(s, s);
    cp_async_commit();
  }

  for (int gi = 0; gi < p.groups; ++gi) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // group gi is in; every warpgroup is done with stage gi-1
    const int nx = gi + STAGES - 1;
    if (nx < p.groups) load_group(nx, nx % STAGES);
    cp_async_commit();

    const uint32_t patch = smem0 + (gi % STAGES) * STAGE_BYTES;
    const uint32_t bs = patch + PATCH_BYTES;
    uint32_t a[2][2][4];  // [step parity][k16 step][fragment]
#pragma unroll
    for (int u = 0; u < 9 * MT; ++u) {  // step u: tap u / MT of row tile u % MT
      const int tap = u / MT, m = u % MT;
      uint32_t(&ab)[2][4] = a[u & 1];
      if (u >= 2) wgmma_wait<1>();  // step u-2, the last reader of `ab`, is done
      const int pix = apix[m] + (tap / 3) * PW + tap % 3;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4(ab[ks], patch + patch_offset(pix, ks * 2 + akc));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t k0 = tap * G + ks * 16;
        // B (16 x N, N-major): 8 x 8 core matrices, N * 16 bytes apart
        // along K, 128 along N
        Wgmma<N>::run(acc[m], ab[ks], smem_desc(bs + k0 * N * 2, N * 16, 128));
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
  }

  // Epilogue from the accumulators: element 4j + 2h + e of tile m is row
  // 192m + 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e.
#pragma unroll
  for (int mh = 0; mh < 2 * MT; ++mh) {
    const int m = mh >> 1, h = mh & 1;
    const int r = m * SLAB + warp * 16 + (lane >> 2) + 8 * h;
    const int oh = h0 + r / TW, ow = w0 + r % TW;
    if (oh >= p.H || ow >= p.W) continue;
    const long long pix = img + (long long)oh * p.W + ow;
    bf16* dst = p.dst + pix * p.dst_ld + p.dst_c0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + 2 * (lane & 3);
      float v0 = __fadd_rn(acc[m][4 * j + 2 * h], p.bias[n]);
      float v1 = __fadd_rn(acc[m][4 * j + 2 * h + 1], p.bias[n + 1]);
      if constexpr (LAST) {
        const float2 xf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + pix * C + n));
        v0 = __fadd_rn(__fmul_rn(v0, p.add_rate), xf.x);
        v1 = __fadd_rn(__fmul_rn(v1, p.add_rate), xf.y);
      } else {
        v0 = v0 > 0.f ? v0 : __fmul_rn(p.slope, v0);
        v1 = v1 > 0.f ? v1 : __fmul_rn(p.slope, v1);
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int N, bool LAST>
cudaError_t launch(const Launch& p, int B, cudaStream_t stream) {
  auto kernel = rdb_dense_conv<N, LAST>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes<N>());
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((long long)B * p.tiles_h * p.tiles_w);
  kernel<<<grid, THREADS, smem_bytes<N>(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One RDB on `stream`: the launches of `plan` (dense_plan in
// ops/kernels/fused_rdb.py, PLAN_INTS ints per launch), all five, or only
// launch `only` if it is 0..4. Pointers: x, out (B,H,W,64) bf16; sx..s3 the
// (9*Cin, Cout) bf16 matmul-form kernels; bias (192,) fp32; y (B,H,W,128)
// bf16, written by launches 0-3. All contiguous and 16-byte aligned. Returns
// the first launch error (a cudaError_t), or 0.
extern "C" int isr_fused_rdb_forward(const void* x, const void* sx, const void* s0,
                                     const void* s1, const void* s2, const void* s3,
                                     const void* bias, void* y, void* out, int B, int H,
                                     int W, float add_rate, float slope, const int* plan,
                                     int only, void* stream) {
  const bf16* weights[5] = {static_cast<const bf16*>(sx), static_cast<const bf16*>(s0),
                            static_cast<const bf16*>(s1), static_cast<const bf16*>(s2),
                            static_cast<const bf16*>(s3)};
  const bf16* sources[2] = {static_cast<const bf16*>(x), static_cast<const bf16*>(y)};
  bf16* dsts[2] = {static_cast<bf16*>(y), static_cast<bf16*>(out)};
  const int source_ld[2] = {C, YC};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < 5; ++i) {
    if (only >= 0 && only != i) continue;
    // [groups, N, bias0, dst (0 y, 1 out), dst_c0, then per group:
    //  source (0 x, 1 y), source channel0, weight (0 sx .. 4 s3), weight
    //  channel0, weight column0]
    const int* q = plan + i * PLAN_INTS;
    Launch p = {};
    p.groups = q[0];
    const int n = q[1];
    if (p.groups < 1 || p.groups > MAX_GROUPS || (n != G && n != C) || (n == C) != (q[3] == 1))
      return (int)cudaErrorInvalidValue;
    p.bias = static_cast<const float*>(bias) + q[2];
    p.dst = dsts[q[3]];
    p.dst_ld = q[3] ? C : YC;
    p.dst_c0 = q[4];
    for (int k = 0; k < p.groups; ++k) {
      const int* e = q + 5 + 5 * k;
      Group& g = p.g[k];
      g.src = sources[e[0]];
      g.src_ld = source_ld[e[0]];
      g.src_c0 = e[1];
      g.w = weights[e[2]];
      g.w_ld = COUTS[e[2]];
      g.w_cin = e[2] == 0 ? C : G;
      g.w_c0 = e[3];
      g.w_col0 = e[4];
    }
    p.x = static_cast<const bf16*>(x);
    p.H = H;
    p.W = W;
    p.tiles_h = (H + TH - 1) / TH;
    p.tiles_w = (W + TW - 1) / TW;
    p.add_rate = add_rate;
    p.slope = slope;
    const cudaError_t e = n == C ? launch<C, true>(p, B, st) : launch<G, false>(p, B, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int isr_fused_rdb_plan_ints() { return PLAN_INTS; }

// Dynamic shared memory of the kernel for N = 32 (y launches) or 64 (last).
extern "C" int isr_fused_rdb_smem_bytes(int n) {
  return n == C ? smem_bytes<C>() : smem_bytes<G>();
}

extern "C" const char* isr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
