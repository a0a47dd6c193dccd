/*
 * K4: BasicVSR's flow warp (models/basicvsr.py), a bilinear gather of NHWC
 * features by a float32 optical flow, wrapped by ops/kernels/flow_warp.py.
 * A port kernel with no TPU counterpart: the JAX package has no video model.
 *
 * For output pixel (i, j) of image b it samples x[b] at
 *
 *   (ix, iy) = (j + flow[b, i, j, 0], i + flow[b, i, j, 1])        fp32
 *
 * bilinearly, as F.grid_sample(..., align_corners=True) samples BasicSR's
 * mesh-plus-flow grid (a side of length 1 samples coordinate 0). Padding
 * "zeros" (the propagation: a corner outside the image reads 0) or
 * "border" (SPyNet: the coordinate is clipped to the image first). The
 * four corner weights and the blend are the grid sampler's, in fp32.
 *
 * Fused trunk input: with a frame slot (F channels, F a multiple of 8) the
 * output pixel is [frame slot, warped x] in the frame's dtype, so the
 * propagation step writes the trunk's input buffer directly: no mesh grid,
 * no normalisation and no concatenation run beside it.
 *
 * x's pixels lie x_pixel elements apart (>= C), its images x_image apart:
 * a contiguous x has x_pixel = C, or x is a channel window of a wider NHWC
 * tensor. The propagation warps both branches' states in one launch, each
 * a 64-channel window of the 128-channel tensor that stacks them (image
 * stride 64, pixel stride 128).
 *
 * Bound: device-memory bytes. A propagation warp at 270 x 480 x 64 bf16
 * reads the feature (16.6 MB), the flow (1.0 MB) and the frame slot (2.1
 * MB) and writes the 72-channel buffer (18.7 MB): some 11.5 us at 3.35 TB/s
 * if the four corners of neighbouring pixels meet in L1/L2, as they do for
 * smooth flows. Each thread owns V channels of one output pixel: V = 8 (one
 * 16-byte load of bf16 from each corner, one 16-byte store) where C and F
 * are multiples of 8, else V = 1 (SPyNet's 3-channel images). The threads
 * of one pixel read its flow once between them (one address, broadcast).
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;

using bf16 = __nv_bfloat16;

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __ldg(p + i);
  }
}

template <int V>
__device__ __forceinline__ void load(const bf16* __restrict__ p, float (&v)[V]) {
  if constexpr (V == VEC) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&v)[V]) {
  if constexpr (V == VEC) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// acc += weight * x[y, x] (its V channels from `ch`; pixels `stride` elements
// apart) where (y, x) lies in the image.
template <typename Tin, int V>
__device__ __forceinline__ void corner(const Tin* __restrict__ img, int y, int x, int h, int w,
                                       int stride, int ch, float weight, float (&acc)[V]) {
  if (y < 0 || y >= h || x < 0 || x >= w) return;
  float v[V];
  load<V>(img + ((long long)y * w + x) * stride + ch, v);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] += v[i] * weight;
}

template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(THREADS)
    flow_warp_kernel(const Tin* __restrict__ x, const float* __restrict__ flow,
                     const Tout* __restrict__ frame, Tout* __restrict__ out, long long pixels,
                     int h, int w, int c, int f, long long x_image, int x_pixel, int border) {
  const int groups = (f + c) / V;  // threads of one output pixel
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= pixels * groups) return;
  const long long p = t / groups;
  const int g = (int)(t - p * groups);
  Tout* o = out + p * (f + c) + g * V;
  float acc[V];
  if (g * V < f) {  // the frame slot, copied
    load<V>(frame + p * f + g * V, acc);
    store<V>(o, acc);
    return;
  }
  const int ch = g * V - f;
  const int j = (int)(p % w);
  const long long bi = p / w;
  const int i = (int)(bi % h);
  const Tin* img = x + (bi / h) * x_image;
  const float2 fl = __ldg(reinterpret_cast<const float2*>(flow) + p);
  float ix = w > 1 ? (float)j + fl.x : 0.f;
  float iy = h > 1 ? (float)i + fl.y : 0.f;
  if (border) {
    ix = fminf(fmaxf(ix, 0.f), (float)(w - 1));
    iy = fminf(fmaxf(iy, 0.f), (float)(h - 1));
  } else {  // beyond one pixel outside, every corner reads 0: keep floor() in int range
    ix = fminf(fmaxf(ix, -2.f), (float)(w + 1));
    iy = fminf(fmaxf(iy, -2.f), (float)(h + 1));
  }
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float x1 = x0 + 1.f, y1 = y0 + 1.f;
  const int xa = (int)x0, ya = (int)y0;
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  corner<Tin, V>(img, ya, xa, h, w, x_pixel, ch, (x1 - ix) * (y1 - iy), acc);          // nw
  corner<Tin, V>(img, ya, xa + 1, h, w, x_pixel, ch, (ix - x0) * (y1 - iy), acc);      // ne
  corner<Tin, V>(img, ya + 1, xa, h, w, x_pixel, ch, (x1 - ix) * (iy - y0), acc);      // sw
  corner<Tin, V>(img, ya + 1, xa + 1, h, w, x_pixel, ch, (ix - x0) * (iy - y0), acc);  // se
  store<V>(o, acc);
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const float* flow, const void* frame, void* out,
                   long long pixels, int h, int w, int c, int f, long long x_image, int x_pixel,
                   int border, int vec, cudaStream_t st) {
  const long long threads = pixels * ((f + c) / (vec ? VEC : 1));
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  if (vec)
    flow_warp_kernel<Tin, Tout, VEC><<<blocks, THREADS, 0, st>>>(
        static_cast<const Tin*>(x), flow, static_cast<const Tout*>(frame),
        static_cast<Tout*>(out), pixels, h, w, c, f, x_image, x_pixel, border);
  else
    flow_warp_kernel<Tin, Tout, 1><<<blocks, THREADS, 0, st>>>(
        static_cast<const Tin*>(x), flow, static_cast<const Tout*>(frame),
        static_cast<Tout*>(out), pixels, h, w, c, f, x_image, x_pixel, border);
  return cudaGetLastError();
}

}  // namespace

// One warp of B images on `stream`: x (B, h, w, C) with its images x_image
// and its pixels x_pixel elements apart, flow (B, h, w, 2) fp32, frame (B,
// h, w, F) or null with F = 0, out (B, h, w, F + C); flow, frame and out
// contiguous. x in fp32 (in_f32) or bf16, frame and out in fp32 (out_f32)
// or bf16. vec: 8 channels a thread (C, F, x_image and x_pixel multiples of
// 8, x, frame and out 16-byte aligned), else 1. Returns a CUDA error code,
// 0 on success.
extern "C" int isr_flow_warp(const void* x, const void* flow, const void* frame, void* out,
                             int B, int h, int w, int C, int F, long long x_image, int x_pixel,
                             int in_f32, int out_f32, int border, int vec, void* stream) {
  if (B < 1 || h < 1 || w < 1 || C < 1 || F < 0 || (F > 0 && frame == nullptr) ||
      x_image < 0 || x_pixel < C ||
      (vec && (C % VEC || F % VEC || x_image % VEC || x_pixel % VEC)))
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)B * h * w;
  if ((pixels * (F + C) + THREADS - 1) / THREADS > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const float* fl = static_cast<const float*>(flow);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32 && out_f32)
    return (int)launch<float, float>(x, fl, frame, out, pixels, h, w, C, F, x_image, x_pixel,
                                     border, vec, st);
  if (in_f32)
    return (int)launch<float, bf16>(x, fl, frame, out, pixels, h, w, C, F, x_image, x_pixel,
                                    border, vec, st);
  if (out_f32)
    return (int)launch<bf16, float>(x, fl, frame, out, pixels, h, w, C, F, x_image, x_pixel,
                                    border, vec, st);
  return (int)launch<bf16, bf16>(x, fl, frame, out, pixels, h, w, C, F, x_image, x_pixel, border,
                                 vec, st);
}

// THREADS, VEC: the wrapper refuses a library built with constants other
// than its own.
extern "C" void isr_flow_warp_constants(int* out) {
  out[0] = THREADS;
  out[1] = VEC;
}

extern "C" const char* isr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
