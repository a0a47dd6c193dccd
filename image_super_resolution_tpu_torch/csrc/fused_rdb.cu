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
 * passed in as integers, so the CPU tests hold the same plan; so is the
 * grid (ops/kernels/fused_rdb.py:tile_schedule).
 *
 * Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s). The five convs
 * are 2 * 9 * (64*192 + 32*160 + 32*128 + 32*96 + 32*64) = 479,232 FLOP per
 * pixel. At the serving shape B=256, 24x24 tiles (147,456 pixels) that is
 * about 71 us, against 11 us for x in and out and the weights: bound by
 * operations. At video frames, 8 x 270 x 480 (1,036,800 pixels), 0.50 ms by
 * operations; but the five-launch design moves more than x in and out:
 * launch i reads x and y_0..y_{i-1} and writes y_i (the last launch reads x
 * again for the residual and writes the output), 1,792 bytes a pixel, about
 * 2.0 KB with the halo rows read again. Launch by launch the y launches are
 * bound by bytes and the last by operations, a floor of 0.59 ms a call.
 *
 * Design. Five launches of one implicit-GEMM kernel in dense (gather) form:
 * launch i reads the bf16 sources that exist so far (x, y_0..y_{i-1}) and
 * keeps one fp32 accumulator per output in registers; nothing but bf16
 * y_0..y_3 (one (B,H,W,128) buffer) and the output go to device memory.
 *   - Rectangles of 24 x 24 output pixels of one image (one serving tile),
 *     nine row tiles of 8 x 8 pixels: three consumer warpgroups, warpgroup
 *     w the three tiles of columns 8w .. 8w + 7, row r of a tile its pixel
 *     (r / 8, r % 8). Ragged edges are masked, so any H, W. (8 x 24
 *     rectangles with two blocks per SM took 0.35 ms at the serving shape
 *     against 0.29 for 24 x 24.)
 *   - Persistent blocks: a launch starts min(rectangles, SMs) blocks, one
 *     per SM, and block k walks rectangles k, k + grid, ... . Where there are
 *     no more rectangles than SMs (photo tile batches, small requests, the
 *     sharded paths) every block owns one rectangle.
 *   - Warp specialisation: a fourth warpgroup produces, and gives registers
 *     to the consumers with setmaxnreg (24 against 160 a thread). K walks
 *     32-channel source groups (2 for x, 1 per y_j). One producer thread
 *     loads each group's 26 x 26 halo patch by TMA into a ring of 3-4 stages
 *     under full and empty mbarriers; the ring runs on across every group
 *     of every rectangle a block owns, so the next rectangle's patches load
 *     while this one is multiplied and stored. The patch is a box of a 4-D
 *     tensor map over (B, H, W, channels) at signed coordinates (h0 - 1,
 *     w0 - 1): TMA fills the zeros at the image border and past the ragged
 *     edge, and its 64-byte swizzle XORs 16-byte chunk c of pixel p with
 *     (p / 2) % 4.
 *   - Weights (wgmma's B operand, N-major), also by TMA, one box per tap in
 *     the N * 2-byte swizzle, from another producer thread: a y launch
 *     (N = 32, 36,864 to 92,160 bytes) copies all its weights into shared
 *     memory once per block; the last launch (N = 64, 221,184 bytes)
 *     streams each group's weights through a ring of its own, two stages
 *     beside three patch stages.
 *   - wgmma reads A straight from the patch. At tap (dy, dx) core matrix j
 *     of a tile is its row j, 8 consecutive patch pixels, and the next core
 *     matrix is a patch row on: one descriptor in the 64-byte swizzle mode
 *     with a uniform stride. The swizzle applies to the address computed, so
 *     a descriptor starts at any pixel with a base offset of 0 (the base
 *     offset (start >> 7) & 7 reads wrong values). Tiles, taps and k16 steps
 *     are immediate offsets of one descriptor: a group is 9 taps x 2 k16
 *     steps x 3 tiles, 54 wgmma m64nNk16 under one commit, and a warpgroup
 *     waits only before it hands the group before's stages back on the
 *     empty barriers. No block barrier is left in the loop, so a
 *     warpgroup's epilogue overlaps the producers' loads.
 *   - Every accumulator sums group, then tap, then k16 step, in the plan's
 *     order, whatever the schedule: the outputs do not depend on the grid,
 *     and are bit for bit those of the one-block-a-rectangle cp.async design
 *     and of the ldmatrix design this replaced.
 *   - The epilogue works on the registers: bias (from shared memory), then
 *     leaky and the bf16 rounding (y_i), or * add_rate + x and the rounding
 *     (output), with __fadd_rn/__fmul_rn so no FMA fuses the residual; a
 *     row's residual loads go before its stores.
 *
 * The shared-memory floor. wgmma with A from shared memory reads A (2 KB)
 * and B (N * 32 bytes) a k16 step; at 128 bytes a clock an SM that is 24
 * clocks for m64n32k16 against 16 of arithmetic, 32 for m64n64k16, equal to
 * its arithmetic (a microbenchmark on the card read 24.2 and 32.4 clocks,
 * with A from registers 16.4 and 32.3). At the frames shape the y launches'
 * loops need 0.44 ms and the last launch's 0.25 ms.
 *
 * Measured on an H100 80GB HBM3 at 700 W (CUDA events, the frames shape,
 * best of four in turns with the ldmatrix design): 1.14-1.16 ms a call
 * against 1.19-1.20, launch by launch 0.113-0.119, 0.156-0.159,
 * 0.180-0.190, 0.225-0.231 and 0.472-0.484 ms (the ldmatrix design's last
 * launch 0.452-0.457). What bounds it now:
 *   - the y launches, the memory side: with 1 tap of 9 they take 0.101,
 *     0.144, 0.142 and 0.182 ms, and without loads 0.100, 0.133, 0.166 and
 *     0.198. Without their stores they move a third fewer bytes and take a
 *     third less time.
 *   - the last launch, shared-memory bandwidth (the floor above) and its
 *     weight ring: 0.367 ms without loads, 0.401 without waiting for the
 *     weights.
 * Tried (scripts/torch_k1_variants.py keeps the first two): the patch as
 * four 8-channel planes with no swizzle, 16 bytes a pixel, four TMA boxes a
 * group (K2's layout): bit for bit the same, 1.29 ms a call (its loads alone
 * take 1.05 ms against 0.84); warpgroups taking turns on the tensor cores,
 * as K2's do; a third weight stage (two patch stages) for the last launch;
 * the taps unrolled; the patch map's L2 promotion at 64 and 256 bytes or
 * none. None was faster.
 *
 * What it leaves on the table: the y's round trip through device memory
 * between launches (kept on chip, with halo recompute, the memory side of
 * the y launches goes); 4-byte epilogue stores; the last launch's weights,
 * read from L2 by every block for every rectangle (TMA multicast across a
 * cluster). A persistent grid was first tried at the serving shape, b256
 * t24, under 2 rectangles per SM, with a ring every thread filled and a
 * block barrier per group, and was not faster there; that said nothing of
 * shapes with many rectangles per SM.
 */

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int C = 64;                     // block width
constexpr int G = 32;                     // growth channels = channels per K group
constexpr int YC = 4 * G;                 // channels of the y buffer
constexpr int MT = 3;                     // 8 x 8 row tiles per warpgroup
constexpr int CONSUMERS = 384;            // three warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int TH = 8 * MT, TW = 8 * (CONSUMERS / 128);  // output rectangle: 3 x 3 row tiles
constexpr int PW = TW + 2;                // halo patch width
constexpr int PPIX = (TH + 2) * PW;       // halo patch pixels (676)
// Registers a thread after setmaxnreg. Each SM sub-partition holds 16,384
// and one warp of each warpgroup.
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 160;
static_assert(32 * (PRODUCER_REGS + 3 * CONSUMER_REGS) <= 16384, "register file");
constexpr int KG = 9 * G;                 // K rows per source group (288)
constexpr int PATCH_BYTES = PPIX * G * 2; // 43,264, one TMA box
// The patch as wgmma reads A: a pixel's 32 channels in 64 bytes, in TMA's
// 64-byte swizzle.
constexpr int PIX_BYTES = G * 2;          // A: from one patch pixel to the next
constexpr int KSTEP_BYTES = 32;           // A: from one k16 step to the next
// TMA's 64-byte swizzle (patches, N = 32 weights) starts over every 512
// bytes, its 128-byte swizzle (N = 64 weights) every 1024: boxes start
// there.
constexpr int ALIGN = 1024;
__host__ __device__ constexpr int round_up(int v, int to) { return (v + to - 1) / to * to; }
constexpr int PATCH_STRIDE = round_up(PATCH_BYTES, 512);  // 43,520
constexpr int MAX_GROUPS = 6;
constexpr int MAX_STAGES = 4;   // patch ring
constexpr int WSTAGES = 2;      // weight ring of the last launch
static_assert(WSTAGES == 2, "the weight ring's stage and phase are bits of the group count");
// Behind the weights and the patch ring: mbarriers (patch full and empty,
// weight full and empty, resident weights) and the launch's biases.
constexpr int TAIL_BYTES = (2 * MAX_STAGES + 2 * WSTAGES + 1) * 8 + C * 4;
constexpr int SMEM_LIMIT = 232448;                   // a block's shared memory on sm_90
constexpr int PLAN_INTS = 5 + 5 * MAX_GROUPS;  // one launch of the plan
constexpr int COUTS[5] = {4 * G + C, 3 * G + C, 2 * G + C, G + C, C};

__host__ __device__ constexpr int group_weight_bytes(int n) { return KG * n * 2; }

// Weights in shared memory: all of a y launch's (N = 32), or the last
// launch's ring of WSTAGES groups (N = 64).
__host__ __device__ constexpr int weight_bytes(int n, int groups) {
  return (n == C ? WSTAGES : groups) * group_weight_bytes(n);
}

// Patch ring stages: as many as fit, up to MAX_STAGES.
__host__ __device__ constexpr int stages(int n, int groups) {
  const int fit = (SMEM_LIMIT - ALIGN - TAIL_BYTES - weight_bytes(n, groups)) / PATCH_STRIDE;
  return fit < MAX_STAGES ? fit : MAX_STAGES;
}

// Dynamic shared memory: alignment slack, the weights, the patch ring, the
// tail.
__host__ __device__ constexpr int smem_bytes(int n, int groups) {
  return ALIGN + weight_bytes(n, groups) + stages(n, groups) * PATCH_STRIDE + TAIL_BYTES;
}

static_assert(stages(C, MAX_GROUPS) >= 2 && stages(G, MAX_GROUPS - 1) >= 2, "ring fits");

struct Group {       // one 32-channel slice of a source and its weight rows
  int src;           // 0: x, 1: the y buffer
  int src_c0;
  int w;             // 0: sx, 1..4: s0..s3
  int w_cin, w_c0, w_col0;
};

struct Launch {
  Group g[MAX_GROUPS];
  int groups, stages;
  const float* bias;  // this launch's N biases
  bf16* dst;          // y buffer or output
  int dst_ld, dst_c0;
  const bf16* x;      // the residual (last launch)
  int H, W, tiles_h, tiles_w, tiles;
  float add_rate, slope;
};

// Tensor maps: each source's halo patches, and each weight matrix in boxes
// of this launch's N columns.
struct Maps {
  CUtensorMap src[2];
  CUtensorMap w[5];
};

// D (64 x N fp32, registers) += A (64 x 16 bf16, descriptor, K-major) *
// B (descriptor), B transposed (N-major).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ static void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

// Descriptor of 64 rows of A, an 8 x 8 pixel row tile, from patch pixel
// `addr` on (plus 32 bytes for the second k16 step): K-major in the 64-byte
// swizzle, core matrix j the 8 pixels of the tile's row j, the next a patch
// row on. The swizzle applies to the address computed, so the descriptor
// may start at any pixel with a base offset of 0, as TMA wrote the patch.
__device__ __forceinline__ uint64_t patch_desc(uint32_t addr) {
  return smem_desc(addr, 16, PW * PIX_BYTES) | (2ull << 62);
}

// Descriptor of 16 K rows of weights as TMA writes them: rows of N bf16
// (N-major), 8-row groups 8 * N * 2 bytes apart, in the N * 2-byte swizzle.
template <int N>
__device__ __forceinline__ uint64_t weight_desc(uint32_t addr) {
  constexpr uint64_t layout = N == 64 ? 1 : 2;  // 128- or 64-byte swizzle
  return smem_desc(addr, 0, 8 * N * 2) | (layout << 62);
}

template <int N, bool LAST>
__global__ void __launch_bounds__(THREADS, 1)
    rdb_dense_conv(const __grid_constant__ Launch p, const __grid_constant__ Maps maps) {
  constexpr int W_BYTES = group_weight_bytes(N);
  constexpr int TAP_BYTES = G * N * 2;  // the weight rows of one tap of a group
  static_assert(W_BYTES % ALIGN == 0 && TAP_BYTES % 512 == 0, "weight alignment");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t smem0 = smem_addr(smem);
  const uint32_t wts = (smem0 + ALIGN - 1) & ~uint32_t(ALIGN - 1);  // weights
  const uint32_t ring = wts + weight_bytes(N, p.groups);            // patches
  const uint32_t bars = ring + p.stages * PATCH_STRIDE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  auto wfull = [&](int s) { return bars + 8 * (2 * MAX_STAGES + s); };
  auto wempty = [&](int s) { return bars + 8 * (2 * MAX_STAGES + WSTAGES + s); };
  const uint32_t wbar = bars + 8 * (2 * MAX_STAGES + 2 * WSTAGES);
  // In shared memory, the epilogue's loads of the biases can pass its stores.
  float* s_bias = reinterpret_cast<float*>(smem + (wbar + 8 - smem0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < N) s_bias[tid] = p.bias[tid];
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 128);  // one thread of each consumer warpgroup
    }
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), CONSUMERS / 128);
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Rectangle t: its image and output origin.
  auto origin = [&](int t, int& b, int& h0, int& w0) {
    w0 = (t % p.tiles_w) * TW;
    t /= p.tiles_w;
    h0 = (t % p.tiles_h) * TH;
    b = t / p.tiles_h;
  };

  // Group gi's weights: K rows (tap, channel) of N bf16 each, one box per
  // tap (32 K rows).
  auto load_weights = [&](int gi, uint32_t dst, uint32_t bar) {
    const Group& g = p.g[gi];
    for (int tap = 0; tap < 9; ++tap)
      tma_load_2d(dst + tap * TAP_BYTES, &maps.w[g.w], g.w_col0, tap * g.w_cin + g.w_c0, bar);
  };

  // One thread loads the patches, group after group of every rectangle.
  auto load_patches = [&] {
    int stage = 0, round = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int b, h0, w0;
      origin(t, b, h0, w0);
      for (int gi = 0; gi < p.groups; ++gi) {
        if (round > 0) mbar_wait(empty(stage), (round - 1) & 1);
        mbar_expect_tx(full(stage), PATCH_BYTES);
        const Group& g = p.g[gi];
        tma_load_4d(ring + stage * PATCH_STRIDE, &maps.src[g.src], g.src_c0, w0 - 1, h0 - 1, b,
                    full(stage));
        if (++stage == p.stages) {
          stage = 0;
          ++round;
        }
      }
    }
  };

  // Another the weights: a y launch's all at once, the last launch's group
  // after group of every rectangle through their own ring.
  auto load_all_weights = [&] {
    if constexpr (!LAST) {
      mbar_expect_tx(wbar, p.groups * W_BYTES);
      for (int gi = 0; gi < p.groups; ++gi) load_weights(gi, wts + gi * W_BYTES, wbar);
    } else {
      int stage = 0, round = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        for (int gi = 0; gi < p.groups; ++gi) {
          if (round > 0) mbar_wait(wempty(stage), (round - 1) & 1);
          mbar_expect_tx(wfull(stage), W_BYTES);
          load_weights(gi, wts + stage * W_BYTES, wfull(stage));
          if (++stage == WSTAGES) {
            stage = 0;
            ++round;
          }
        }
      }
    }
  };

  // Three warpgroups multiply and store.
  auto consume = [&] {
    float acc[MT][N / 2];
    // Row tile m of warpgroup wg is the 8 x 8 pixels (8m + r / 8, 8wg +
    // r % 8), r = 0..63, of the rectangle; warp q of the warpgroup holds
    // rows 16q .. 16q + 15 of each. At tap (dy, dx) its core matrix j reads
    // patch pixels (8m + j + dy) * PW + 8wg + dx + 0..7: the tiles, taps and
    // k16 steps of a group are offsets of one descriptor (in 16-byte units).
    // The warpgroup index through a shuffle, so that ptxas knows it is
    // warp-uniform and keeps the descriptors in uniform registers.
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), q = warp & 3;
    const uint64_t a0 = patch_desc(ring + 8 * wg * PIX_BYTES);
    const bool signals = tid % 128 == 0;  // arrives on the empty barriers

    if constexpr (!LAST) mbar_wait(wbar, 0);
    // Groups consumed: k (weight ring stage k % 2, phase k / 2 % 2), and the
    // patch ring's next stage and the last group's.
    int k = 0, stage = 0, round = 0, held = 0;
    // Hands the last group's stages back to the producers.
    auto release = [&] {
      if (signals) {
        mbar_arrive(empty(held));
        if constexpr (LAST) mbar_arrive(wempty((k - 1) & 1));
      }
    };

    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int b, h0, w0;
      origin(t, b, h0, w0);
      const long long img = (long long)b * p.H * p.W;  // pixel (b, 0, 0)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;

      // Group gi: 9 taps x 2 k16 steps x MT tiles, 54 wgmmas under one
      // commit; each accumulator sums tap after tap, k16 step after step.
      for (int gi = 0; gi < p.groups; ++gi) {
        mbar_wait(full(stage), round & 1);
        if constexpr (LAST) mbar_wait(wfull(k & 1), (k >> 1) & 1);
        const uint64_t as = a0 + stage * (PATCH_STRIDE >> 4);
        const uint64_t bs = weight_desc<N>(wts + (LAST ? k & 1 : gi) * W_BYTES);
        wgmma_fence();
        // One tap an iteration, its k16 steps and tiles unrolled with the
        // descriptor offsets as immediates (the taps unrolled too were no
        // faster).
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const uint64_t at = as + ((tap / 3 * PW + tap % 3) * PIX_BYTES >> 4);
          const uint64_t bt = bs + (tap * TAP_BYTES >> 4);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int m = 0; m < MT; ++m)
              Wgmma<N>::run(acc[m], at + ((8 * m * PW * PIX_BYTES + ks * KSTEP_BYTES) >> 4),
                            bt + (ks * 16 * N * 2 >> 4));
        }
        wgmma_commit();
        // The group before is done: its stages go back.
        if (gi > 0) {
          wgmma_wait<1>();
          release();
        }
        held = stage;
        if (++stage == p.stages) {
          stage = 0;
          ++round;
        }
        ++k;
      }
      wgmma_wait<0>();
      release();

      // Epilogue from the accumulators: element 4j + 2h + e of tile m is
      // its row 16q + lane / 4 + 8h (rectangle pixel (8m + 2q + h, 8wg +
      // lane / 4)), column 8j + 2 (lane % 4) + e.
#pragma unroll
      for (int mh = 0; mh < 2 * MT; ++mh) {
        const int m = mh >> 1, h = mh & 1;
        const int oh = h0 + 8 * m + 2 * q + h, ow = w0 + 8 * wg + (lane >> 2);
        if (oh >= p.H || ow >= p.W) continue;
        const long long pix = img + (long long)oh * p.W + ow;
        bf16* dst = p.dst + pix * p.dst_ld + p.dst_c0;
        // The row's residual loads all go before its first store, which the
        // compiler could not move them past (they might alias).
        __nv_bfloat162 res[N / 8];
        if constexpr (LAST) {
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
            res[j] = *reinterpret_cast<const __nv_bfloat162*>(p.x + pix * C + 8 * j +
                                                             2 * (lane & 3));
        }
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int n = 8 * j + 2 * (lane & 3);
          float v0 = __fadd_rn(acc[m][4 * j + 2 * h], s_bias[n]);
          float v1 = __fadd_rn(acc[m][4 * j + 2 * h + 1], s_bias[n + 1]);
          if constexpr (LAST) {
            const float2 xf = __bfloat1622float2(res[j]);
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
  };

  // Warp specialisation: the producer warpgroup gives registers to the
  // consumers. The warpgroup index through a shuffle, so that ptxas knows
  // it is uniform.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == CONSUMERS / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) load_patches();
    if (tid == CONSUMERS + 32) load_all_weights();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume();
  }
}

// The halo-patch map of a (B,H,W,ld) bf16 source: boxes of 32 channels x
// PW x (TH + 2) pixels x 1 image, 64-byte swizzle.
CUresult source_map(CUtensorMap* map, const void* src, int ld, int B, int H, int W) {
  const cuuint64_t dims[4] = {(cuuint64_t)ld, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ld * 2, (cuuint64_t)W * ld * 2,
                                 (cuuint64_t)H * W * ld * 2};
  const cuuint32_t box[4] = {G, PW, TH + 2, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, src, 4, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_64B);
}

// The map of a (rows, cout) bf16 weight matrix: boxes of one tap of a
// group, 32 rows x n columns, in the n * 2-byte swizzle.
CUresult weight_map(CUtensorMap* map, const void* w, int rows, int cout, int n) {
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t box[2] = {(cuuint32_t)n, G};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, dims, strides, box,
                    n == C ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// Encoded tensor maps, kept across calls: an sr forward makes 48 calls of 11
// maps, and encoding one costs about a microsecond of host time. A map is a
// function of its key alone (address, shape, box), so a buffer freed and
// another allocated at its address gets the map its shape calls for.
struct MapKey {
  const void* ptr;
  int ld_or_rows, b_or_cout, h_or_n, w;  // source: ld, B, H, W; weight: rows, cout, n, 0
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && ld_or_rows == o.ld_or_rows && b_or_cout == o.b_or_cout &&
           h_or_n == o.h_or_n && w == o.w;
  }
};
constexpr int MAP_CACHE = 1 << 12;  // direct-mapped: a collision encodes again
std::mutex map_mutex;
MapKey map_keys[MAP_CACHE];
CUtensorMap map_values[MAP_CACHE];

template <typename Encode>
CUresult cached_map(CUtensorMap* map, const MapKey& key, Encode encode) {
  uint64_t h = reinterpret_cast<uintptr_t>(key.ptr) >> 4;
  for (const int v : {key.ld_or_rows, key.b_or_cout, key.h_or_n, key.w}) h = h * 31 + (uint32_t)v;
  const int slot = (int)((h * 0x9E3779B97F4A7C15ull) >> 52);  // the top 12 bits
  std::lock_guard<std::mutex> lock(map_mutex);
  if (map_keys[slot] == key && key.ptr != nullptr) {
    *map = map_values[slot];
    return CUDA_SUCCESS;
  }
  const CUresult r = encode(map);
  if (r == CUDA_SUCCESS) {
    map_keys[slot] = key;
    map_values[slot] = *map;
  }
  return r;
}

template <int N, bool LAST>
cudaError_t launch(const Launch& p, const Maps& maps, int grid, cudaStream_t stream) {
  auto kernel = rdb_dense_conv<N, LAST>;
  const int smem = smem_bytes(N, p.groups);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

}  // namespace

// One RDB on `stream`: the launches of `plan` (dense_plan in
// ops/kernels/fused_rdb.py, PLAN_INTS ints per launch), all five, or only
// launch `only` if it is 0..4, each on `grid` persistent blocks
// (tile_schedule there). Pointers: x, out (B,H,W,64) bf16; sx..s3 the
// (9*Cin, Cout) bf16 matmul-form kernels; bias (192,) fp32; y (B,H,W,128)
// bf16, written by launches 0-3. All contiguous and 16-byte aligned. Returns
// the first launch error (a cudaError_t), or 0.
extern "C" int isr_fused_rdb_forward(const void* x, const void* sx, const void* s0,
                                     const void* s1, const void* s2, const void* s3,
                                     const void* bias, void* y, void* out, int B, int H,
                                     int W, float add_rate, float slope, const int* plan,
                                     int only, int grid, void* stream) {
  const void* weights[5] = {sx, s0, s1, s2, s3};
  bf16* dsts[2] = {static_cast<bf16*>(y), static_cast<bf16*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  Maps maps;
  const void* sources[2] = {x, y};
  for (int s = 0; s < 2; ++s) {
    const int ld = s ? YC : C;
    if (cached_map(&maps.src[s], {sources[s], ld, B, H, W}, [&](CUtensorMap* m) {
          return source_map(m, sources[s], ld, B, H, W);
        }) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
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
    p.stages = stages(n, p.groups);
    p.bias = static_cast<const float*>(bias) + q[2];
    p.dst = dsts[q[3]];
    p.dst_ld = q[3] ? C : YC;
    p.dst_c0 = q[4];
    for (int k = 0; k < p.groups; ++k) {
      const int* e = q + 5 + 5 * k;
      Group& g = p.g[k];
      g.src = e[0];
      g.src_c0 = e[1];
      g.w = e[2];
      g.w_cin = e[2] == 0 ? C : G;
      g.w_c0 = e[3];
      g.w_col0 = e[4];
      const int rows = 9 * g.w_cin, cout = COUTS[g.w];
      if (cached_map(&maps.w[g.w], {weights[g.w], rows, cout, n, 0}, [&](CUtensorMap* m) {
            return weight_map(m, weights[g.w], rows, cout, n);
          }) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
    p.x = static_cast<const bf16*>(x);
    p.H = H;
    p.W = W;
    p.tiles_h = (H + TH - 1) / TH;
    p.tiles_w = (W + TW - 1) / TW;
    p.tiles = B * p.tiles_h * p.tiles_w;
    p.add_rate = add_rate;
    p.slope = slope;
    const cudaError_t e =
        n == C ? launch<C, true>(p, maps, grid, st) : launch<G, false>(p, maps, grid, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int isr_fused_rdb_plan_ints() { return PLAN_INTS; }

// The output rectangle, rows (dim 0) or columns (dim 1): the grid's unit.
extern "C" int isr_fused_rdb_rectangle(int dim) { return dim == 0 ? TH : TW; }

// The most dynamic shared memory a launch asks for: N = 32 (y launches) or
// 64 (last).
extern "C" int isr_fused_rdb_smem_bytes(int n) {
  if (n == C) return smem_bytes(C, MAX_GROUPS);
  int most = 0;
  for (int groups = 2; groups < MAX_GROUPS; ++groups)
    most = smem_bytes(G, groups) > most ? smem_bytes(G, groups) : most;
  return most;
}

extern "C" const char* isr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
