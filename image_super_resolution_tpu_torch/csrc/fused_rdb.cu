/*
 * Fused scatter-form residual dense block (RDB) for NVIDIA Hopper, sm_90a.
 *
 * Replaces image_super_resolution_tpu/ops/pallas/fused_rdb.py:scatter_rdb_pallas
 * (the Pallas TPU kernel). Computes one whole scatter-form RDB on NHWC bf16
 * activations, C = 64, g = 32, for any batch B and any H, W:
 *
 *   cx = conv(x, sx) + bias                 9C -> 4g+C   (fp32)
 *   y0 = bf16(leaky(cx[0:g]))               c0 = conv(y0, s0)   9g -> 3g+C
 *   y1 = bf16(leaky(cx[g:2g] + c0[0:g]))    c1 = conv(y1, s1)   9g -> 2g+C
 *   y2 = bf16(leaky(... + c1[0:g]))         c2 = conv(y2, s2)   9g -> g+C
 *   y3 = bf16(leaky(... + c2[0:g]))         c3 = conv(y3, s3)   9g -> C
 *   out = bf16((cx[4g:] + c0[3g:] + c1[2g:] + c2[g:] + c3) * add_rate + x)
 *
 * with every 3x3 conv zero-padded by 1 at the image border.
 *
 * Bound on an H100 SXM at the serving shape B=256, 24x24 tiles: the five
 * convs are 2 * 9 * (64*192 + 32*160 + 32*128 + 32*96 + 32*64) = 479,232
 * FLOP per pixel, 7.07e10 FLOP per call over 147,456 pixels: about 71 us at
 * 989 TFLOP/s dense bf16. The bytes that must move are x in and out
 * (2 x 18.9 MB) plus 0.5 MB of weights, about 38 MB: 11 us at 3.35 TB/s.
 * So the RDB is compute-bound, by a factor of about 6.
 *
 * Design (simple and right first). One implicit-GEMM 3x3 conv kernel,
 * launched five times per RDB into one fp32 scratch P of shape (B,H,W,4g+C):
 *   - launch 0 reads x and writes P = cx + bias;
 *   - launch i (1..4) reads y_{i-1} = bf16(leaky(P[..., (i-1)g : ig])),
 *     applied while the operand is loaded (zero outside the image), and ADDS
 *     its product into the slices of P it feeds, P[..., ig:]; it reads and
 *     writes disjoint channels of P, so no two threads touch one element;
 *   - the last launch's epilogue writes bf16(P[..., 4g:] + c3) * add_rate + x.
 * This keeps the Pallas kernel's order of fp32 sums (fused_rdb.py:63-77).
 * A block owns 128 pixels and all outputs of its launch; 8 warps as 4 (pixels)
 * x 2 (channels), bf16 wmma 16x16x16 fragments with fp32 accumulators. The K
 * loop walks the 9 taps: each tap gathers the shifted 128 x Cin operand and
 * the Cin x Nout weight slice into shared memory, then runs Cin/16 steps.
 *
 * What it leaves on the table: P makes a round trip through device memory
 * (about 113 MB written and read back per RDB at the serving shape, mostly
 * served by the 50 MB L2 only in part); there is no copy/compute overlap
 * (no cp.async or TMA pipeline, two barriers per tap); mma.sync-class wmma
 * instead of wgmma; and the 3x3 halo is re-gathered per tap from global
 * memory. Keeping the whole block on chip needs halo recompute, since P for
 * a 24x24 tile is 442 KB, above the 227 KB of shared memory per block.
 */

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int C = 64;           // block width
constexpr int G = 32;           // growth channels
constexpr int PC = 4 * G + C;   // channels of the fp32 running sums
constexpr int BM = 128;         // pixels per block
constexpr int THREADS = 256;    // 8 warps: 4 along pixels x 2 along channels
constexpr int CHUNKS = 8;       // 16-byte (x) or 4-float (P) chunks per A row
constexpr int ROW_STEP = THREADS / CHUNKS;     // 32 rows loaded per pass
constexpr int ROWS_PER_THREAD = BM / ROW_STEP;  // 4

enum Mode { kFirst, kMiddle, kLast };

template <int CIN, int NOUT>
struct Tile {
  static constexpr int LDA = CIN + 8;   // +8 bf16 skews rows across banks
  static constexpr int LDB = NOUT + 8;
  static constexpr int A_BYTES = BM * LDA * 2;
  static constexpr int B_BYTES = CIN * LDB * 2;
  static constexpr int OUT_LO = PC - NOUT;  // first channel of P this launch feeds
  static constexpr int IN_LO = OUT_LO - G;  // y_{i-1}'s channels of P
  static constexpr int WN = NOUT / 2;       // output channels per warp
  static constexpr int FN = WN / 16;        // accumulator fragments along N
};

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// bf16(p * add_rate + x) for two channels.
__device__ __forceinline__ __nv_bfloat162 residual2(float p0, float p1,
                                                    __nv_bfloat162 x, float add_rate) {
  const float2 xf = __bfloat1622float2(x);
  return __floats2bfloat162_rn(__fadd_rn(__fmul_rn(p0, add_rate), xf.x),
                               __fadd_rn(__fmul_rn(p1, add_rate), xf.y));
}

template <int CIN, int NOUT, int MODE>
__global__ void __launch_bounds__(THREADS)
rdb_conv3x3(const bf16* __restrict__ x, float* __restrict__ P,
            const bf16* __restrict__ w, const float* __restrict__ bias,
            bf16* __restrict__ out, int B, int H, int W, float add_rate,
            float slope) {
  using T = Tile<CIN, NOUT>;
  static_assert(CIN == (MODE == kFirst ? C : G), "operand width");
  static_assert(NOUT % 32 == 0 && CIN % 16 == 0, "wmma tiling");
  static_assert(T::A_BYTES >= 8 * 256 * 4, "epilogue staging reuses the A tile");
  __shared__ __align__(128) unsigned char smem[T::A_BYTES + T::B_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + T::A_BYTES);

  const long long HW = (long long)H * W;
  const long long M = HW * B;
  const long long m0 = (long long)blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;

  // This thread loads chunk `chunk` of A rows tid/CHUNKS + j*ROW_STEP.
  const int chunk = tid % CHUNKS;
  int ph[ROWS_PER_THREAD], pw[ROWS_PER_THREAD];
  long long pimg[ROWS_PER_THREAD];  // pixel index of (b, 0, 0); -1 past the end
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const long long m = m0 + tid / CHUNKS + j * ROW_STEP;
    if (m < M) {
      const long long b = m / HW;
      const long long rem = m - b * HW;
      ph[j] = (int)(rem / W);
      pw[j] = (int)(rem % W);
      pimg[j] = b * HW;
    } else {
      ph[j] = pw[j] = 0;
      pimg[j] = -1;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][T::FN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jn = 0; jn < T::FN; ++jn) wmma::fill_fragment(acc[i][jn], 0.f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __syncthreads();  // the previous tap's tiles are consumed
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      const int r = tid / CHUNKS + j * ROW_STEP;
      const int hs = ph[j] + dy, ws = pw[j] + dx;
      const bool inside = pimg[j] >= 0 && hs >= 0 && hs < H && ws >= 0 && ws < W;
      const long long src = pimg[j] + (long long)hs * W + ws;
      if constexpr (MODE == kFirst) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (inside) v = *reinterpret_cast<const uint4*>(x + src * C + chunk * 8);
        *reinterpret_cast<uint4*>(As + r * T::LDA + chunk * 8) = v;
      } else {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (inside)
          v = *reinterpret_cast<const float4*>(P + src * PC + T::IN_LO + chunk * 4);
        __nv_bfloat162* dst =
            reinterpret_cast<__nv_bfloat162*>(As + r * T::LDA + chunk * 4);
        dst[0] = __floats2bfloat162_rn(leaky(v.x, slope), leaky(v.y, slope));
        dst[1] = __floats2bfloat162_rn(leaky(v.z, slope), leaky(v.w, slope));
      }
    }
    const bf16* wt = w + (size_t)tap * CIN * NOUT;
    for (int v = tid; v < CIN * NOUT / 8; v += THREADS) {
      const int e = v * 8, row = e / NOUT, col = e % NOUT;
      *reinterpret_cast<uint4*>(Bs + row * T::LDB + col) =
          __ldg(reinterpret_cast<const uint4*>(wt + e));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CIN / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * T::LDA + kk * 16,
                               T::LDA);
#pragma unroll
      for (int jn = 0; jn < T::FN; ++jn) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
        wmma::load_matrix_sync(bfrag, Bs + kk * 16 * T::LDB + wn * T::WN + jn * 16,
                               T::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][jn], a[i], bfrag, acc[i][jn]);
      }
    }
  }

  // Epilogue: each warp stages one 16x16 fragment at a time in its own slice
  // of the (now free) A tile; lane l then owns row l/2, 8 columns.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
  const int srow = lane / 2, scol = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int jn = 0; jn < T::FN; ++jn) {
      wmma::store_matrix_sync(stage, acc[i][jn], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * 32 + i * 16 + srow;
      const int n = wn * T::WN + jn * 16 + scol;  // output channel of this launch
      if (m < M) {
        const float4* a = reinterpret_cast<const float4*>(stage + srow * 16 + scol);
        float4* dst = reinterpret_cast<float4*>(P + m * PC + T::OUT_LO + n);
        if constexpr (MODE == kFirst) {  // cx + bias
          const float4* b = reinterpret_cast<const float4*>(bias + n);
          dst[0] = add4(a[0], b[0]);
          dst[1] = add4(a[1], b[1]);
        } else {  // running sum + this conv's slice
          const float4 p0 = add4(dst[0], a[0]);
          const float4 p1 = add4(dst[1], a[1]);
          if constexpr (MODE == kMiddle) {
            dst[0] = p0;
            dst[1] = p1;
          } else {  // kLast: out = bf16(fuse * add_rate + x)
            const uint4 xv = *reinterpret_cast<const uint4*>(x + m * C + n);
            const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&xv);
            uint4 ov;
            __nv_bfloat162* os = reinterpret_cast<__nv_bfloat162*>(&ov);
            os[0] = residual2(p0.x, p0.y, xs[0], add_rate);
            os[1] = residual2(p0.z, p0.w, xs[1], add_rate);
            os[2] = residual2(p1.x, p1.y, xs[2], add_rate);
            os[3] = residual2(p1.z, p1.w, xs[3], add_rate);
            *reinterpret_cast<uint4*>(out + m * C + n) = ov;
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int CIN, int NOUT, int MODE>
cudaError_t launch(const bf16* x, float* P, const void* w, const float* bias,
                   bf16* out, int B, int H, int W, float add_rate, float slope,
                   cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const unsigned grid = (unsigned)((M + BM - 1) / BM);
  rdb_conv3x3<CIN, NOUT, MODE><<<grid, THREADS, 0, stream>>>(
      x, P, static_cast<const bf16*>(w), bias, out, B, H, W, add_rate, slope);
  return cudaGetLastError();
}

}  // namespace

// One scatter-form RDB: five launches on `stream`. Returns the first launch
// error (a cudaError_t), or 0. Pointers: x, out (B,H,W,64) bf16; sx..s3 the
// (9*Cin, Cout) bf16 matmul-form kernels; bias (192,) fp32; scratch
// (B,H,W,192) fp32, fully overwritten. All 16-byte aligned and contiguous.
extern "C" int isr_fused_rdb_forward(const void* x, const void* sx, const void* s0,
                                     const void* s1, const void* s2, const void* s3,
                                     const void* bias, void* scratch, void* out,
                                     int B, int H, int W, float add_rate, float slope,
                                     void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  float* P = static_cast<float*>(scratch);
  const float* bs = static_cast<const float*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = launch<C, PC, kFirst>(xb, P, sx, bs, ob, B, H, W, add_rate, slope, st)))
    return (int)e;
  if ((e = launch<G, PC - G, kMiddle>(xb, P, s0, bs, ob, B, H, W, add_rate, slope, st)))
    return (int)e;
  if ((e = launch<G, PC - 2 * G, kMiddle>(xb, P, s1, bs, ob, B, H, W, add_rate, slope, st)))
    return (int)e;
  if ((e = launch<G, PC - 3 * G, kMiddle>(xb, P, s2, bs, ob, B, H, W, add_rate, slope, st)))
    return (int)e;
  if ((e = launch<G, C, kLast>(xb, P, s3, bs, ob, B, H, W, add_rate, slope, st)))
    return (int)e;
  return 0;
}

extern "C" const char* isr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
