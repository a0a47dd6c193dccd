/*
 * K3: the end of RCAN's residual channel attention block (models/rcan.py),
 * wrapped by ops/kernels/channel_attention.py. A port kernel with no TPU
 * counterpart: the JAX package has no RCAN.
 *
 * After a block's second conv gives r (NHWC, in the stream's dtype, bf16 or
 * fp32, conv1's bias b not yet added) the block ends with
 *
 *   m  = mean over H*W of (r + b)                  per image and channel
 *   s  = sigmoid(W2 relu(W1 m + b1) + b2)          C -> hidden -> C, fp32
 *   x' = x + (r + b) * s                           the residual stream
 *
 * Bound: device-memory bytes. At the frames shape (8 x 270 x 480 x 64) r
 * is 133 MB in bf16, more than the 50 MB L2, so the global mean needs a
 * pass of its own before the scale can be applied: r is read twice, x read
 * and x' written once. The operations are a few per byte.
 *
 * Design:
 * - channel_attention_reduce, grid (chunks, B): each CTA sums r over a
 *   contiguous range of one image's pixels. A thread owns 8 channels (one
 *   16-byte load of bf16) of every (256 / (C / 8))-th pixel and keeps 8
 *   fp32 sums; the CTA then adds its threads' sums pixel-lane by pixel-lane,
 *   in order, and writes C partial sums. No atomics: the next pass adds
 *   the partials in a fixed order, so the result does not change from run
 *   to run.
 * - channel_attention_scale, grid (tiles, B): each CTA adds its image's
 *   partials (four interleaved sums, then those four in a fixed order),
 *   divides by H*W and adds b (the bias folded in analytically), and
 *   computes the MLP itself (C * hidden * 2 multiply-adds, nothing against
 *   its 1024 pixels' traffic). Then it streams its SCALE_PIXELS pixels, 8
 *   channels a thread, and writes x'. The products and sums are rounded
 *   one by one (__fmul_rn, __fadd_rn: no contraction), as the plain
 *   version computes them.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;
constexpr int MAX_C = 256;
constexpr int MAX_HIDDEN = 16;
constexpr int SCALE_PIXELS = 1024;
constexpr int MAX_CHUNKS = 64;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void load8(const bf16* __restrict__ p, float (&v)[VEC]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    channel_attention_reduce(const T* __restrict__ r, float* __restrict__ partials, int hw,
                             int c, int chunks) {
  __shared__ float sums[THREADS * VEC];  // [pixel lane][channel]
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int groups = c / VEC;          // threads per pixel
  const int lanes = THREADS / groups;  // pixels per step
  const int g = threadIdx.x % groups, lane = threadIdx.x / groups;
  const long long per = (hw + chunks - 1) / chunks;
  const long long p0 = chunk * per;
  const long long p1 = p0 + per < hw ? p0 + per : hw;
  const T* base = r + (long long)b * hw * c + g * VEC;
  float acc[VEC] = {};
#pragma unroll 4
  for (long long p = p0 + lane; p < p1; p += lanes) {
    float v[VEC];
    load8(base + p * c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += v[i];
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) sums[lane * c + g * VEC + i] = acc[i];
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += sums[l * c + ch];
    partials[((long long)b * chunks + chunk) * c + ch] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) channel_attention_scale(
    const T* __restrict__ x, const T* __restrict__ r, const float* __restrict__ bias,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ partials, T* __restrict__ out,
    int hw, int c, int hidden, int chunks) {
  __shared__ float part[4][MAX_C];
  __shared__ float mean[MAX_C];
  __shared__ float scale[MAX_C];
  __shared__ float hid[MAX_HIDDEN];
  const int b = blockIdx.y;

  // The image's mean: four interleaved sums over its chunks, then those four.
  const float* pb = partials + (long long)b * chunks * c;
  for (int t = threadIdx.x; t < 4 * c; t += THREADS) {
    const int ch = t % c, q = t / c;
    float s = 0.f;
    for (int k = q; k < chunks; k += 4) s += pb[k * c + ch];
    part[q][ch] = s;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += THREADS)
    mean[ch] = ((part[0][ch] + part[1][ch]) + (part[2][ch] + part[3][ch])) / (float)hw +
               bias[ch];
  __syncthreads();

  // The MLP: a warp per hidden unit, then a thread per channel.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < hidden; j += THREADS / 32) {
    float s = 0.f;
    for (int ch = lane; ch < c; ch += 32) s += w1[j * c + ch] * mean[ch];
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) hid[j] = fmaxf(s + b1[j], 0.f);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    float z = b2[ch];
    for (int j = 0; j < hidden; ++j) z += w2[ch * hidden + j] * hid[j];
    scale[ch] = 1.f / (1.f + expf(-z));
  }
  __syncthreads();

  // The stream: 8 channels of every (256 / (C / 8))-th pixel a thread.
  const int groups = c / VEC, lanes = THREADS / groups;
  const int g = threadIdx.x % groups, pl = threadIdx.x / groups;
  float sv[VEC], bv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sv[i] = scale[g * VEC + i];
    bv[i] = bias[g * VEC + i];
  }
  const long long p0 = (long long)blockIdx.x * SCALE_PIXELS;
  const long long p1 = p0 + SCALE_PIXELS < hw ? p0 + SCALE_PIXELS : hw;
  const long long img = (long long)b * hw * c + g * VEC;
#pragma unroll 2
  for (long long p = p0 + pl; p < p1; p += lanes) {
    const long long off = img + p * c;
    float xv[VEC], rv[VEC];
    load8(x + off, xv);
    load8(r + off, rv);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      xv[i] = __fadd_rn(xv[i], __fmul_rn(__fadd_rn(rv[i], bv[i]), sv[i]));
    store8(out + off, xv);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const float* const (&p)[5], float* partials,
                   void* out, int B, int hw, int c, int hidden, int chunks, cudaStream_t st) {
  channel_attention_reduce<T><<<dim3(chunks, B), THREADS, 0, st>>>(
      static_cast<const T*>(r), partials, hw, c, chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  channel_attention_scale<T><<<dim3((hw + SCALE_PIXELS - 1) / SCALE_PIXELS, B), THREADS, 0,
                               st>>>(static_cast<const T*>(x), static_cast<const T*>(r), p[0],
                                     p[1], p[2], p[3], p[4], partials, static_cast<T*>(out), hw,
                                     c, hidden, chunks);
  return cudaGetLastError();
}

}  // namespace

// Both passes of one block, in order, on `stream`; x, r and out fp32 (f32)
// or bf16. partials: B * chunks * C floats of scratch. Returns a CUDA error code, 0 on success.
extern "C" int isr_ca_residual(const void* x, const void* r, const void* bias, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* partials,
                               void* out, int B, int hw, int C, int hidden, int f32,
                               int chunks, void* stream) {
  if (B < 1 || B > 65535 || hw < 1 || C < VEC || C > MAX_C || (C & (C - 1)) || hidden < 1 ||
      hidden > MAX_HIDDEN || chunks < 1 || chunks > MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  const float* const p[5] = {static_cast<const float*>(bias), static_cast<const float*>(w1),
                             static_cast<const float*>(b1), static_cast<const float*>(w2),
                             static_cast<const float*>(b2)};
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(f32 ? launch<float>(x, r, p, part, out, B, hw, C, hidden, chunks, st)
                   : launch<bf16>(x, r, p, part, out, B, hw, C, hidden, chunks, st));
}

// THREADS, VEC, SCALE_PIXELS, MAX_CHUNKS, MAX_HIDDEN: the wrapper refuses a
// library built with constants other than its own.
extern "C" void isr_ca_constants(int* out) {
  out[0] = THREADS;
  out[1] = VEC;
  out[2] = SCALE_PIXELS;
  out[3] = MAX_CHUNKS;
  out[4] = MAX_HIDDEN;
}

extern "C" const char* isr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
