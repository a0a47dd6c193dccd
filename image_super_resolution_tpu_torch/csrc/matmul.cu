/*
 * Tiled GEMM with a K loop, int8 x int8 -> int32 or bf16 x bf16 -> fp32, for
 * NVIDIA Hopper, sm_90a, and the int8 3x3 convolution built on it.
 *
 * Replaces scripts/bench_int8_pallas.py:pallas_matmul (body _mm_kernel), the
 * Pallas TPU kernel K2: a (tm, tk, tn) tiled GEMM whose K loop accumulates
 * in a scratch tile. Two entry points share one tile core here:
 *
 *   isr_matmul        (M,K) x (K,N) -> (M,N), int8 -> int32 (exact) or
 *                     bf16 -> fp32; any M and N, K % 32 (int8) / % 16 (bf16);
 *   isr_conv3x3_int8  the trunk site of models/quantized.py:int8_forward as
 *                     an implicit GEMM: x (B,H,W,Cin) fp32 NHWC, the
 *                     residual stream, requantized while it is loaded,
 *                     q = clamp(rint(x * inv_x), -127, 127), as int8_forward
 *                     requantizes before every site; zero padding of 1,
 *                     w_q (9*Cin, Cout) rows (dy, dx, cin), int32
 *                     accumulation, then per output channel
 *                     y = fl(fl(float(acc) * deq[o]) + bias[o]) and leaky 0.01
 *                     on conv0 sites; fp32 NHWC out. Cin % 32 == 0.
 *
 * Bound on an H100 SXM (data sheet: 1,979 TOP/s dense int8, 989 TFLOP/s
 * dense bf16, 3.35 TB/s):
 *
 *   shape                          operations             bytes                 bound
 *   one 128->128 site, b256 t24    2*147456*1152*128      75.5 MB fp32 in +     45 us (bytes)
 *                                  = 4.35e10 -> 22 us     75.5 MB fp32 out
 *                                                         = 151 MB -> 45 us
 *   the probe's 4096^3 int8 GEMM   1.37e11 -> 69 us       ~100 MB -> 30 us      69 us (operations)
 *
 * So the serving site is bound by bytes: it reads and writes the fp32
 * stream. (Fed int8 it would move 94 MB, 28 us.) The real saving is beyond
 * one kernel: requantizing in the previous site's epilogue (int8 out
 * instead of fp32) would cut the site's bytes by about 3x.
 *
 * Design (simple and right first). One block computes a 128 x 128 output
 * tile with 256 threads (8 warps as 4 along M x 2 along N, 32 x 64 each);
 * the K loop steps 32 bytes of K at a time (32 int8 or 16 bf16 values), so
 * one mma.sync per (16 x 8) fragment and step: m16n8k32 .s8.s8.s32, or
 * m16n8k16 .bf16.bf16.f32. Both operands sit in shared memory K-major
 * (32 bytes of K per row plus 16 bytes of skew, free of bank conflicts), so
 * the fragment loads are the same 32-bit loads for both types. The GEMM
 * copies A with cp.async (16 bytes a thread, zero-filled outside the
 * matrix); the conv loads 16 fp32 values a thread into registers (zeros
 * outside the image: that is its padding) and stores them requantized to
 * 16 int8 bytes. B (K, N) row-major is transposed on
 * the way in, through registers: each thread reads 4 bytes of 4 (int8) or
 * 8 bytes of 2 (bf16) K rows and writes them as 4 K-major words. Two stages
 * in shared memory: the next step's copies are in flight while this step
 * computes; one barrier per step.
 *
 * What it leaves on the table: wgmma (the full tensor-core rate) and TMA;
 * a deeper pipeline; the conv re-reads its 3x3 halo and the whole weight
 * matrix once per 128-pixel block (from L2); the fp32 epilogue output, which
 * dominates the site's bytes, instead of requantizing to int8 for the next
 * site inside the epilogue.
 */

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows (pixels) per block
constexpr int BN = 128;          // output columns (channels) per block
constexpr int KB = 32;           // bytes of K per step
constexpr int LDS = KB + 16;     // shared row stride in bytes (skewed)
constexpr int THREADS = 256;
constexpr int WM = 32, WN = 64;  // warp tile
constexpr int FM = WM / 16, FN = WN / 8;

enum Mode { kMatmul, kConv };  // kConv: fp32 A, requantized on load

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <typename T>
struct Types;

template <>
struct Types<int8_t> {
  using Acc = int;
  static constexpr int ROWS = 4;  // K rows one thread transposes
  __device__ static void mma(int* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Types<__nv_bfloat16> {
  using Acc = float;
  static constexpr int ROWS = 2;
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// B staging: one thread moves ROWS K rows x 4 columns per step, 16 bytes
// held as four 32-bit words. Loaded row by row (w[i] = row i for int8;
// w[2i], w[2i+1] = columns 0-1 and 2-3 of row i for bf16), then transposed
// with byte permutes so that word j holds column j's ROWS K values.
template <typename T>
__device__ __forceinline__ void load_b(uint32_t (&w)[4], const T* __restrict__ B, int N,
                                       long long k, int n, bool vec) {
  constexpr int ROWS = Types<T>::ROWS;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const T* row = B + (k + i) * N;
    if constexpr (sizeof(T) == 1) {
      if (vec && n + 3 < N) {
        w[i] = __ldg(reinterpret_cast<const uint32_t*>(row + n));
      } else {
        const uint8_t* r = reinterpret_cast<const uint8_t*>(row);
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) v |= (uint32_t)r[n + j] << (8 * j);
        w[i] = v;
      }
    } else {
      if (vec && n + 3 < N) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + n));
        w[2 * i] = v.x;
        w[2 * i + 1] = v.y;
      } else {
        const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
        uint32_t v[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) v[j / 2] |= (uint32_t)r[n + j] << (16 * (j % 2));
        w[2 * i] = v[0];
        w[2 * i + 1] = v[1];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_b(const uint32_t (&w)[4], unsigned char* Bs, int col,
                                        int kbyte) {
  uint32_t c[4];
  if constexpr (sizeof(T) == 1) {  // 4x4 byte transpose
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
    c[0] = __byte_perm(lo01, lo23, 0x5410);
    c[1] = __byte_perm(lo01, lo23, 0x7632);
    c[2] = __byte_perm(hi01, hi23, 0x5410);
    c[3] = __byte_perm(hi01, hi23, 0x7632);
  } else {  // 2x4 transpose of 16-bit values
    c[0] = __byte_perm(w[0], w[2], 0x5410);
    c[1] = __byte_perm(w[0], w[2], 0x7632);
    c[2] = __byte_perm(w[1], w[3], 0x5410);
    c[3] = __byte_perm(w[1], w[3], 0x7632);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint32_t*>(Bs + (col + j) * LDS + kbyte) = c[j];
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.f ? v : __fmul_rn(slope, v);
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

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const void* __restrict__ Av, const T* __restrict__ B, void* __restrict__ out,
            const float* __restrict__ deq, const float* __restrict__ bias, long long M,
            int N, int K, int H, int W, int Cin, int apply_leaky, float slope,
            float inv_x, int vecB) {
  using Acc = typename Types<T>::Acc;
  const T* A = static_cast<const T*>(Av);
  constexpr int ELEM = sizeof(T);
  constexpr int KE = KB / ELEM;                 // K elements per step
  constexpr int ROWS = Types<T>::ROWS;
  static_assert(KE / ROWS == 8 && BN == 4 * 4 * (THREADS / 32),
                "one B block per thread and step");
  __shared__ __align__(128) unsigned char As[2][BM * LDS];
  __shared__ __align__(128) unsigned char Bs[2][BN * LDS];

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane / 4, t = lane % 4;

  // A: this thread copies 16-byte chunk `achunk` of row `arow`, every step.
  const int arow = tid / 2, achunk = tid % 2;
  const long long am = m0 + arow;
  const bool arow_ok = am < M;
  int ah = 0, aw = 0;
  long long apix = 0;  // conv: pixel index of (b, 0, 0)
  if constexpr (MODE == kConv) {
    const long long HW = (long long)H * W;
    if (arow_ok) {
      const long long b = am / HW, rem = am - b * HW;
      ah = (int)(rem / W);
      aw = (int)(rem % W);
      apix = b * HW;
    }
  }
  // B: this thread transposes K rows bk .. bk+ROWS-1 of columns bc .. bc+3;
  // a warp covers 16 columns, its 8 K groups on neighbouring lanes, which
  // keeps the K-major stores to 2-way bank conflicts.
  const int bk = (lane % 8) * ROWS, bc = (warp * 4 + lane / 8) * 4;

  // The A chunk of step ks: its source offset in elements and whether it
  // lies inside the matrix (or, for the conv, inside the image).
  auto a_src = [&](int ks, long long& off) {
    const long long k0 = (long long)ks * KE;
    if constexpr (MODE == kMatmul) {
      off = am * K + k0 + achunk * (16 / ELEM);
      return arow_ok;
    } else {
      const int tap = (int)(k0 / Cin), c0 = (int)(k0 % Cin);
      const int hs = ah + tap / 3 - 1, ws = aw + tap % 3 - 1;
      off = (apix + (long long)hs * W + ws) * Cin + c0 + achunk * 16;
      return arow_ok && hs >= 0 && hs < H && ws >= 0 && ws < W;
    }
  };
  auto issue_a = [&](int stage, int ks) {  // matmul: straight copy
    long long off = 0;
    const bool ok = a_src(ks, off);
    cp_async16(&As[stage][arow * LDS + achunk * 16], ok ? A + off : A, ok);
    cp_async_commit();
  };
  // kConv: 16 fp32 values per chunk go through registers and are
  // requantized to 16 int8 values on the way into shared memory.
  const float* Af = static_cast<const float*>(Av);
  float4 areg[4];
  auto load_a = [&](int ks) {
    long long off = 0;
    const bool ok = a_src(ks, off);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      areg[i] = ok ? __ldg(reinterpret_cast<const float4*>(Af + off) + i)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store_a = [&](int stage) {
    uint32_t q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = requant4(areg[i], inv_x);
    *reinterpret_cast<uint4*>(&As[stage][arow * LDS + achunk * 16]) =
        make_uint4(q[0], q[1], q[2], q[3]);
  };

  Acc acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  const int steps = K / KE;
  uint32_t breg[4];
  if constexpr (MODE == kConv) {
    load_a(0);
    store_a(0);
  } else {
    issue_a(0, 0);
  }
  load_b(breg, B, N, bk, n0 + bc, vecB);
  store_b<T>(breg, Bs[0], bc, bk * ELEM);

  for (int ks = 0; ks < steps; ++ks) {
    const int cur = ks & 1, nxt = cur ^ 1;
    cp_async_wait_all();
    __syncthreads();  // step ks's tiles are in; everyone is done with `nxt`
    const bool more = ks + 1 < steps;
    if (more) {
      if constexpr (MODE == kConv) load_a(ks + 1);
      else issue_a(nxt, ks + 1);
      load_b(breg, B, N, (long long)(ks + 1) * KE + bk, n0 + bc, vecB);
    }
    const unsigned char* a_s = As[cur];
    const unsigned char* b_s = Bs[cur];
    uint32_t af[FM][4], bfr[FN][2];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      const unsigned char* p = a_s + (wm * WM + i * 16 + g) * LDS + t * 4;
      af[i][0] = *reinterpret_cast<const uint32_t*>(p);
      af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
      af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const unsigned char* p = b_s + (wn * WN + j * 8 + g) * LDS + t * 4;
      bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
      bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) Types<T>::mma(acc[i][j], af[i], bfr[j]);
    if (more) {
      store_b<T>(breg, Bs[nxt], bc, bk * ELEM);
      if constexpr (MODE == kConv) store_a(nxt);
    }
  }

  // Epilogue straight from the accumulators: element e of fragment (i, j)
  // is row g (+8 for e >= 2), column 2t + (e & 1).
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * WM + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = n0 + wn * WN + j * 8 + t * 2;
        if (n >= N) continue;
        const bool pair = n + 1 < N;
        const Acc a0 = acc[i][j][half * 2], a1 = acc[i][j][half * 2 + 1];
        if constexpr (MODE == kConv) {
          float y[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (e == 1 && !pair) break;
            const float v = __int2float_rn(e ? a1 : a0);
            y[e] = __fadd_rn(__fmul_rn(v, deq[n + e]), bias[n + e]);
            if (apply_leaky) y[e] = leaky(y[e], slope);
          }
          float* o = static_cast<float*>(out) + m * N + n;
          if (pair && N % 2 == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
          } else {
            o[0] = y[0];
            if (pair) o[1] = y[1];
          }
        } else {  // int32 or fp32, the accumulator's type
          Acc* o = static_cast<Acc*>(out) + m * N + n;
          o[0] = a0;
          if (pair) o[1] = a1;
        }
      }
    }
  }
}

template <typename T, int MODE>
int launch(const void* a, const void* b, void* out, const float* deq, const float* bias,
           long long M, int N, int K, int H, int W, int Cin, int apply_leaky, float slope,
           float inv_x, void* stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  gemm_kernel<T, MODE><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(b), out, deq, bias, M, N, K, H, W, Cin, apply_leaky, slope,
      inv_x, N % 4 == 0);
  return (int)cudaGetLastError();
}

}  // namespace

// (M,K) x (K,N) row-major on `stream`. dtype 0: int8 -> int32 out; 1: bf16
// -> fp32 out. K % 32 (int8) or K % 16 (bf16), K > 0; rows 16-byte aligned.
// Returns the launch's cudaError_t (0 on success).
extern "C" int isr_matmul(const void* a, const void* b, void* out, long long M, int N,
                          int K, int dtype, void* stream) {
  if (dtype == 0)
    return launch<int8_t, kMatmul>(a, b, out, nullptr, nullptr, M, N, K, 0, 0, 0, 0, 0.f,
                                   0.f, stream);
  return launch<__nv_bfloat16, kMatmul>(a, b, out, nullptr, nullptr, M, N, K, 0, 0, 0, 0,
                                        0.f, 0.f, stream);
}

// Implicit-GEMM 3x3 conv, zero padding 1: x (B,H,W,Cin) fp32, requantized
// on load with inv_x, w_q (9*Cin, Cout) int8, deq/bias (Cout,) fp32, out
// (B,H,W,Cout) fp32. Cin % 32 == 0.
extern "C" int isr_conv3x3_int8(const void* x, const void* w_q, const void* deq,
                                const void* bias, void* out, int B, int H, int W,
                                int Cin, int Cout, int apply_leaky, float slope,
                                float inv_x, void* stream) {
  const long long M = (long long)B * H * W;
  return launch<int8_t, kConv>(x, w_q, out, static_cast<const float*>(deq),
                               static_cast<const float*>(bias), M, Cout, 9 * Cin, H, W,
                               Cin, apply_leaky, slope, inv_x, stream);
}

extern "C" const char* isr_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
