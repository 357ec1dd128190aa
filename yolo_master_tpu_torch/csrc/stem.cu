// Fused detector stem: conv0 (3->c0, k3 s2 p1) + bias + SiLU, then
// conv1 (c0->c1, k3 s2 p1) + bias + SiLU, in one pass over the letterboxed
// NHWC image. BatchNorm and the /255 input scale are folded into the
// weights by the caller (yolo_master_tpu_torch/utils/fuse.py). Two kernels,
// one for each path; the weights are float32 in both:
//   stem_kernel       uint8 -> float32 and float32 -> float32 (the fp32 path),
//                     split-TF32 products at fp32 accuracy (below);
//   stem_bf16_kernel  uint8 -> bfloat16 and bfloat16 -> bfloat16 (the bf16
//                     path), split-bf16 products (mma_bf16.cuh) summed in
//                     fp32, the output rounded once to bfloat16 (its own
//                     section, further down).

// Replaces: yolo_master_tpu/ops/pallas_stem.py:fused_stem (the TPU kernel
// _make_stem_kernel, which reads a space-to-depth(4) blob because the TPU
// cannot stride inside a kernel; here the image is read as it is).
//
// What bounds it on the H100. At B=16, 640x640 uint8 (2 flops per
// multiply-add), counted at three peaks: both convs' multiply-adds are matrix
// products (conv0 27 deep and c0 wide per conv0 pixel, conv1 9*c0 deep and c1
// wide per output pixel) at 495 TFLOP/s in TF32; both convs' bias and SiLU
// run in fp32 at 67 TFLOP/s; the image in and conv1's output out move at
// 3.35 TB/s:
//   c0/c1    conv0 + conv1 products   bias + SiLU (fp32)    bytes            bound
//   16/32    1.4 + 3.8 GFLOP 0.010 ms  0.20 GFLOP 0.003 ms   72 MB 0.022 ms   0.022 ms
//   32/64    2.8 + 15.1 GFLOP 0.036 ms 0.39 GFLOP 0.006 ms  125 MB 0.037 ms   0.037 ms
//   64/128   5.7 + 60.4 GFLOP 0.133 ms 0.79 GFLOP 0.012 ms  230 MB 0.069 ms   0.133 ms
//   96/192   8.5 + 135.9 GFLOP 0.292 ms 1.18 GFLOP 0.018 ms 335 MB 0.100 ms   0.292 ms
// The split-TF32 products below run three tensor-core passes (conv0 two on
// uint8 input), so the tensor time is about three times its column. Unfused,
// the fp32 conv0 map ([B,320,320,c0], 6.6-39 MB per image) would also be
// written and read back.
//
// What the design does about it: each block owns a TH x 16 tile of conv1
// outputs (TH = 8, or 4 at c1 >= 128) and two warpgroups, each with 64 of its
// pixels and all of c1, or all of the pixels and half of c1. It stages the
// uint8 input tile with its halo ((4TH+3) x 67 x 3) in shared memory, then
// walks c0 in 16-channel chunks, both convs on the tensor cores:
//   1. conv0 as a small implicit GEMM: M = the (2TH+1) x 33 conv0 positions of
//      the tile (the one-row/one-column halo conv1 needs included) in 64-row
//      tiles, N = the chunk's 16 channels, K = 3x3 taps x 3 channels, 27
//      padded to 32. A is the stride-2 gather of the input tile, loaded by
//      each thread into its wgmma fragment (RS form); uint8 pixels are
//      exact in TF32, so A needs no split and two passes against w0's halves
//      keep fp32 accuracy (float32 input: three). Bias and SiLU on the CUDA cores;
//      positions outside [0,H/2)x[0,W/2) are stored as 0: they are conv1's
//      zero padding, not SiLU(b0). The result goes to a conv0 tile in shared
//      memory, 20 floats per position;
//   2. conv1 as an implicit GEMM: M = the warpgroup's 64 pixels, N = its
//      slice of c1, K = (tap, channel), w1 copied in 32-deep chunks of two
//      taps x 16 channels. A is the stride-2 im2col gather of the conv0 tile, which no
//      shared-memory descriptor can describe, so each thread loads its
//      fragment with 8-byte loads, two channels at a time (the 20-float
//      position pitch keeps a half-warp's loads on distinct banks), and splits
//      it in registers. B is w1, written transposed, split, reordered to match
//      the fragment's channel pairs and zero-padded to a scratch bank by a
//      small kernel once per w1 (ops/stem.py:stem_bank keeps the bank), and
//      streamed chunk by chunk through a cp.async ring into 128-byte-swizzled
//      tiles.
// The tensor cores round every accumulation toward zero, so each tap's
// 16-deep product starts from zero, small terms first, and joins the sum by an
// fp32 add on the CUDA cores (as esmoe.cu's 32-channel chunks do). After the
// last chunk, bias and SiLU (full-precision expf) are applied on the store;
// only conv1's output goes to device memory.
//
// The block's layout is a function of c1 (kPlans, below, which the wrapper and
// the launch both read): at c1 <= 64 an 8x16 tile, one warpgroup per 64 pixels
// with all of c1; at 128 and 192 a 4x16 tile, two warpgroups with half of c1
// each. Two blocks share an SM up to c1 = 128 (128 registers, under 113 KB of
// shared memory), so one block's conv0, copies and barriers overlap the
// other's products; at 192 one block (about 240 registers).

#include <math.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kCin = 3;
constexpr int kTW = 16;                                    // conv1 tile columns: one warp's 16 pixels of a tile row
constexpr int kCC = 16;                                    // conv0 channels per chunk
constexpr int kCP = kCC + 4;                               // floats per conv0 tile position: 20 = 4 mod 16, so a
                                                           // half-warp's 8-byte fragment loads hit distinct banks
constexpr int kTapsPerChunk = tf32::kTileK / kCC;          // 2 taps x 16 channels = one 32-deep K-chunk
constexpr int kChunksPerCC = (9 + kTapsPerChunk - 1) / kTapsPerChunk;  // 5; the last holds tap 8 alone
static_assert(kTapsPerChunk == 2, "the bank's column order and the ring's copies assume two taps per K-chunk");
constexpr int kK0 = 9 * kCin;                              // conv0's depth, 27, padded to one 32-deep tile
constexpr int kW0TileFloats = 2 * kCC * tf32::kTileK;      // one chunk of w0: hi and lo, [16][32] each

// Cuts for timing the kernel's phases apart (scripts/ablate_stem.py builds copies with -DSTEM_CUT=<bits>;
// a cut kernel computes wrong numbers). 0, the default, is the kernel itself.
#ifndef STEM_CUT
#define STEM_CUT 0
#endif
// kCutConv1Joins and kCutConv1Loads cut stem_bf16_kernel's phases only; kFastSiluDivision acts on stem_kernel only
// (stem_bf16_kernel's SiLU divides fast already).
enum StemCut {
  kCutConv1Products = 1, kCutConv0 = 2, kCutWeightCopies = 4, kCutConv0Silu = 8, kFastSiluDivision = 16,
  kCutConv1Joins = 32, kCutConv1Loads = 64
};
constexpr int kCut = STEM_CUT;

// One block's layout: a th x 16 tile of conv1 outputs; per 64 of its pixels,
// ng warpgroups with nw of c1 each (c1 padded to nw * ng); a ring of `stages`
// B chunks; `blocks_per_sm` the occupancy the registers are capped for.
struct StemPlan {
  int th, nw, ng, stages, blocks_per_sm;
};

constexpr StemPlan kPlans[] = {{8, 32, 1, 3, 2}, {8, 64, 1, 2, 2}, {4, 64, 2, 2, 2}, {4, 96, 2, 3, 1}};

// Index into kPlans for these widths, or -1 where no plan takes them.
int plan_index(int c1) {
  if (c1 <= 32) return 0;
  if (c1 <= 64) return 1;
  if (c1 <= 128) return 2;
  if (c1 <= 192) return 3;
  return -1;
}

int c0_padded(int c0) { return (c0 + kCC - 1) / kCC * kCC; }

int bank_chunks(int c0) { return c0_padded(c0) / kCC * kChunksPerCC; }

long long plan_smem_bytes(int c0, const StemPlan& p) {
  const long long n = static_cast<long long>(p.nw) * p.ng;
  const long long ring = static_cast<long long>(p.stages) * 2 * n * tf32::kTileK;
  const long long c0_tile = static_cast<long long>(2 * p.th + 1) * (2 * kTW + 1) * kCP;
  const long long in_tile = static_cast<long long>(4 * p.th + 3) * (4 * kTW + 3) * kCin;
  const long long floats = ring + kW0TileFloats + c0_tile + c0_padded(c0) + n + in_tile;
  return floats * 4 + 1024;  // + the ring's alignment to 1024 bytes
}

__device__ __forceinline__ float silu(float v) {
  if constexpr ((kCut & kFastSiluDivision) != 0) return __fdividef(v, 1.0f + expf(-v));
  return v / (1.0f + expf(-v));
}


// w1 [9 * c0, c1] (HWIO: row (kh * 3 + kw) * c0 + ic) -> bank [chunks][hi, lo][np][32]: chunk
// kc = cc * 5 + j holds conv0 channels [16 cc, 16 cc + 16) at taps 2j (columns 0-15) and 2j + 1
// (16-31); within each 8 columns, column c holds channel 2c (c < 4) or 2(c - 4) + 1, the order in
// which a thread's fragment loads take them. Zeros past tap 8, c0 and c1. One thread per column.
__global__ void __launch_bounds__(256)
stem_bank_kernel(const float* __restrict__ w1, float* __restrict__ bank, int c0, int c1, int np, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int q = i & 31, n = (i >> 5) % np, kc = (i >> 5) / np;
  const int cc = kc / kChunksPerCC, j = kc - cc * kChunksPerCC;
  const int tap = kTapsPerChunk * j + q / kCC, c8 = q & 7;
  const int ch = cc * kCC + (q & 8) + (c8 < 4 ? 2 * c8 : 2 * c8 - 7);
  float v = 0.0f;
  if (tap < 9 && ch < c0 && n < c1) v = __ldg(w1 + (static_cast<size_t>(tap) * c0 + ch) * c1 + n);
  uint32_t hi, lo;
  tf32::split(v, hi, lo);
  float* dst = bank + (static_cast<size_t>(kc) * 2 * np + n) * tf32::kTileK + q;
  dst[0] = __uint_as_float(hi);
  dst[static_cast<size_t>(np) * tf32::kTileK] = __uint_as_float(lo);
}

// x [B,H,W,3] of T (uint8 or float); w0 [3,3,3,c0] (kh,kw,cin,c0); bank from
// stem_bank_kernel; b0 [c0], b1 [c1]; out [B,H/4,W/4,c1] of OutT (float). c0 and c1
// multiples of 8, c1 <= NW * NG.
template <typename T, typename OutT, int TH, int NW, int NG, int STAGES, int MINB>
__global__ void __launch_bounds__(128 * (TH / 4) * NG, MINB)
stem_kernel(const T* __restrict__ x, const float* __restrict__ w0, const float* __restrict__ b0,
            const float* __restrict__ bank, const float* __restrict__ b1, OutT* __restrict__ out, int H, int W,
            int c0, int c1) {
  constexpr int kThreads = 128 * (TH / 4) * NG;
  constexpr int kWarpgroups = kThreads / 128;
  constexpr int kMG = TH / 4;                                 // warpgroups along the pixels: 64 pixels each
  constexpr int kN = NW * NG;                                 // c1, padded
  constexpr int kC0H = 2 * TH + 1, kC0W = 2 * kTW + 1;        // conv0 tile
  constexpr int kPos = kC0H * kC0W;                           // conv0 positions of the tile
  constexpr int kInH = 4 * TH + 3, kInW = 4 * kTW + 3;        // input tile
  constexpr int kInFloats = kInH * kInW * kCin;
  constexpr int kStageFloats = 2 * kN * tf32::kTileK;         // one B chunk: hi and lo, [kN][32] each
  constexpr bool kExactA = !std::is_same_v<T, float>;         // uint8 values are exact in TF32
  extern __shared__ unsigned char smem_raw[];
  const int c0p = (c0 + kCC - 1) / kCC * kCC;
  float* ring = tf32::align_tile(smem_raw);                   // [STAGES][hi, lo][kN][32], swizzled
  float* s_w0t = ring + STAGES * kStageFloats;                // [hi, lo][16][32], swizzled: w0's chunk, K-major
  float* s_c0 = s_w0t + kW0TileFloats;                        // [kPos][kCP]
  float* s_b0 = s_c0 + kPos * kCP;                            // [c0p]
  float* s_b1 = s_b0 + c0p;                                   // [kN]
  float* s_in = s_b1 + kN;                                    // [kInH * kInW * kCin]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * kTW;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int nkc = c0p / kCC * kChunksPerCC;

  // B chunks stream through the ring STAGES - 1 chunks ahead of the products.
  // Tap 8's chunk has no second tap: its columns 16-31 are not read, nor copied.
  int ld_kc = 0, ld_stage = 0;
  auto start_loads = [&]() {
    float* dst = ring + ld_stage * kStageFloats;
    const float* src = bank + static_cast<size_t>(ld_kc) * kStageFloats;
    const bool one_tap = ld_kc % kChunksPerCC == kChunksPerCC - 1;
    for (int i = tid; i < 2 * kN * 8; i += kThreads) {
      const int row = i >> 3, chunk = i & 7;
      if ((kCut & kCutWeightCopies) == 0 && (!one_tap || chunk < 4)) tf32::cp_async16(dst + tf32::swizzled_chunk(row, chunk), src + row * 32 + 4 * chunk, true);
    }
    ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
    ++ld_kc;
  };
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (ld_kc < nkc) start_loads();
    tf32::cp_async_commit();
  }

  for (int i = tid; i < c0p; i += kThreads) s_b0[i] = i < c0 ? b0[i] : 0.0f;
  for (int i = tid; i < kN; i += kThreads) s_b1[i] = i < c1 ? b1[i] : 0.0f;
  // Input tile: image rows 4*oy0-3 .. 4*oy0+4*TH-1, zero outside the image
  // (conv0's own padding). Consecutive threads read consecutive bytes; all of a
  // thread's loads are issued before its stores.
  {
    constexpr int kIters = (kInFloats + kThreads - 1) / kThreads;
    const int iy0 = 4 * oy0 - 3, ix0 = 4 * ox0 - 3;
    const T* xb = x + static_cast<size_t>(b) * H * W * kCin;
    float v[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kThreads;
      const int c = i % kCin, col = (i / kCin) % kInW, row = i / (kCin * kInW);
      const int gy = iy0 + row, gx = ix0 + col;
      v[it] = 0.0f;
      if (i < kInFloats && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v[it] = tf32::to_float(xb[(static_cast<size_t>(gy) * W + gx) * kCin + c]);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it)
      if (tid + it * kThreads < kInFloats) s_in[tid + it * kThreads] = v[it];
  }

  const int wg = tid >> 7, gt = tid & 127;
  const int kq = gt & 3;
  const int r0 = tf32::acc_row(gt, 0);  // this thread's first fragment row of a 64-row tile

  // conv0's fragment columns k = 8s + kq + 4h (s < 4, h < 2) are tap (k / 9, k % 9 / 3), channel k % 3:
  // their offsets in the input tile from a window's corner, and which of them lie past k = 27.
  int k0_off[2 * tf32::kStepsPerTile];
  unsigned k0_pad = 0;
#pragma unroll
  for (int i = 0; i < 2 * tf32::kStepsPerTile; ++i) {
    const int k = 8 * (i >> 1) + kq + 4 * (i & 1);
    k0_off[i] = ((k / 9) * kInW + k % 9 / 3) * kCin + k % 3;
    if (k >= kK0) {
      k0_off[i] = 0;
      k0_pad |= 1u << i;
    }
  }

  // conv1: warpgroup wg takes pixels [64 pg, 64 pg + 64) of the tile (tile rows 4 pg .. 4 pg + 3)
  // and columns [NW ng, NW ng + NW) of c1. Its fragment rows are pixels (ty, tx) and (ty, tx + 8);
  // their conv1 windows start at conv0 tile (2 ty, 2 tx).
  const int pg = wg % kMG, ng = wg / kMG;
  const int ty = 4 * pg + (gt >> 5), tx = (gt & 31) >> 2;
  const float* a_base = s_c0 + (2 * ty * kC0W + 2 * tx) * kCP + 2 * kq;

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;

  const int cy0 = 2 * oy0 - 1, cx0 = 2 * ox0 - 1;
  int stage_at = 0;
  for (int cc = 0; cc < c0p / kCC; ++cc) {
    __syncthreads();  // the input tile is whole; every fragment load of the previous chunk is done

    // w0's chunk, transposed and split for wgmma's K-major B: w0t[half][o][k] = split(w0[k][16 cc + o]),
    // zeros past k = 27 and c0.
    for (int i = tid; i < kCC * tf32::kTileK; i += kThreads) {
      const int o = i / tf32::kTileK, k = i % tf32::kTileK, ch = cc * kCC + o;
      uint32_t hi, lo;
      tf32::split(k < kK0 && ch < c0 ? __ldg(w0 + k * c0 + ch) : 0.0f, hi, lo);
      s_w0t[tf32::swizzled(o, k)] = __uint_as_float(hi);
      s_w0t[kCC * tf32::kTileK + tf32::swizzled(o, k)] = __uint_as_float(lo);
    }
    tf32::fence_proxy_async();
    __syncthreads();

    // conv0, channels [16 cc, 16 cc + 16), on conv1's padded grid: tile position p = (r, q) is conv0
    // pixel (cy0 + r, cx0 + q); its 3x3 window starts at input tile (2r, 2q). The warpgroups take the
    // 64-position tiles in turn (splitting each tile's channels between them instead, so that their
    // shares are equal, spilled ~400 bytes at 128 registers and was slower); rows past the last
    // position repeat it and are not stored.
    const uint64_t dw_hi = tf32::tile_desc(s_w0t), dw_lo = tf32::tile_desc(s_w0t + kCC * tf32::kTileK);
    for (int mt = wg; (kCut & kCutConv0) == 0 && mt * 64 < kPos; mt += kWarpgroups) {
      const int p0 = 64 * mt + r0;
      const float* win[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(p0 + 8 * h, kPos - 1);
        win[h] = s_in + (2 * (p / kC0W) * kInW + 2 * (p % kC0W)) * kCin;
      }
      uint32_t a_hi[tf32::kStepsPerTile][4], a_lo[tf32::kStepsPerTile][4];
#pragma unroll
      for (int s = 0; s < tf32::kStepsPerTile; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // a[i]: row r0 + 8 (i & 1), column 8s + kq + 4 (i >> 1)
          const int c = 2 * s + (i >> 1);
          const float v = (k0_pad >> c) & 1u ? 0.0f : win[i & 1][k0_off[c]];
          if constexpr (kExactA) a_hi[s][i] = __float_as_uint(v);
          else tf32::split(v, a_hi[s][i], a_lo[s][i]);
        }
      float d[kCC / 2];
#pragma unroll
      for (int i = 0; i < kCC / 2; ++i) d[i] = 0.0f;
      tf32::fence_registers(d);
      tf32::wgmma_fence();
#pragma unroll
      for (int s = 0; s < tf32::kStepsPerTile; ++s) {
        const uint64_t adv = s * tf32::kStepDescAdvance;
        if constexpr (!kExactA) tf32::wgmma_rs<kCC>(d, a_lo[s], dw_hi + adv);
        tf32::wgmma_rs<kCC>(d, a_hi[s], dw_lo + adv);
      }
#pragma unroll
      for (int s = 0; s < tf32::kStepsPerTile; ++s)
        tf32::wgmma_rs<kCC>(d, a_hi[s], dw_hi + s * tf32::kStepDescAdvance);
      tf32::wgmma_commit();
      tf32::wgmma_wait<0>();
      tf32::fence_registers(d);
      // bias, SiLU, the zero border: d[4j + 2h + e] is position p0 + 8h, chunk channel 8j + 2kq + e
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h;
        if (p >= kPos) continue;
        const int r = p / kC0W, q = p % kC0W;
        const bool in_map = cy0 + r >= 0 && cy0 + r < H2 && cx0 + q >= 0 && cx0 + q < W2;
#pragma unroll
        for (int j = 0; j < kCC / 8; ++j) {
          const int col = 8 * j + 2 * kq, ch = cc * kCC + col;
          float2 v = make_float2(0.0f, 0.0f);
          if (in_map && ch < c0) {
            v = make_float2(d[4 * j + 2 * h] + s_b0[ch], d[4 * j + 2 * h + 1] + s_b0[ch + 1]);
            if constexpr ((kCut & kCutConv0Silu) == 0) v = make_float2(silu(v.x), silu(v.y));
          }
          *reinterpret_cast<float2*>(s_c0 + p * kCP + col) = v;
        }
      }
    }

    // conv1's product over this channel chunk, one 32-deep K-chunk (two taps) of w1 at a time.
#pragma unroll
    for (int j = 0; j < kChunksPerCC; ++j) {
      tf32::cp_async_wait<STAGES - 2>();  // this thread's part of the chunk has landed
      tf32::fence_proxy_async();
      __syncthreads();  // the chunk (and at j = 0 the conv0 tile) is visible; the ring slot before it is free
      if (ld_kc < nkc) start_loads();
      tf32::cp_async_commit();
      const float* stage = ring + stage_at * kStageFloats;
      stage_at = stage_at + 1 == STAGES ? 0 : stage_at + 1;

      // Fragment of k-step s: tap 2j + s/2, channels 8 (s % 2) + {2 kq, 2 kq + 1} of the chunk,
      // rows ty, tx (a[0], a[2]) and ty, tx + 8 (a[1], a[3]).
      constexpr int kSteps = tf32::kStepsPerTile;
      uint32_t a_hi[kSteps][4], a_lo[kSteps][4];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int tap = kTapsPerChunk * j + s / 2;
        if (tap >= 9) continue;
        const int off = ((tap / 3) * kC0W + tap % 3) * kCP + 8 * (s % 2);
        const float2 v0 = *reinterpret_cast<const float2*>(a_base + off);
        const float2 v1 = *reinterpret_cast<const float2*>(a_base + off + 16 * kCP);
        tf32::split(v0.x, a_hi[s][0], a_lo[s][0]);
        tf32::split(v1.x, a_hi[s][1], a_lo[s][1]);
        tf32::split(v0.y, a_hi[s][2], a_lo[s][2]);
        tf32::split(v1.y, a_hi[s][3], a_lo[s][3]);
      }
      const uint64_t d_hi = tf32::tile_desc(stage + ng * NW * tf32::kTileK);
      const uint64_t d_lo = tf32::tile_desc(stage + (kN + ng * NW) * tf32::kTileK);
      // One chain per tap (16 deep: k-steps 2 tp, 2 tp + 1), each from zero, small terms first, joined
      // to acc by fp32 adds. With 32-deep chains the truncation's coherent bias moved yolo-master-n's
      // GPU-vs-CPU decode to 9.1e-4 logit of its 1e-3 limit on an H100; with 16-deep chains, 4.9e-4
      // (PERF.md section 6).
#pragma unroll
      for (int tp = 0; tp < kTapsPerChunk; ++tp) {
        if (kTapsPerChunk * j + tp >= 9) continue;
        float t[NW / 2];
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) t[i] = 0.0f;
        tf32::fence_registers(t);
        tf32::wgmma_fence();
        if constexpr ((kCut & kCutConv1Products) == 0) {
#pragma unroll
          for (int s = 2 * tp; s < 2 * tp + 2; ++s) {
            const uint64_t adv = s * tf32::kStepDescAdvance;
            tf32::wgmma_rs<NW>(t, a_lo[s], d_hi + adv);
            tf32::wgmma_rs<NW>(t, a_hi[s], d_lo + adv);
          }
#pragma unroll
          for (int s = 2 * tp; s < 2 * tp + 2; ++s) tf32::wgmma_rs<NW>(t, a_hi[s], d_hi + s * tf32::kStepDescAdvance);
        }
        tf32::wgmma_commit();
        tf32::wgmma_wait<0>();
        tf32::fence_registers(t);
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) acc[i] += t[i];
      }
    }
  }

  // bias + SiLU on the store: acc[4i + {0,1}] is pixel (ty, tx), acc[4i + {2,3}] pixel (ty, tx + 8),
  // channels NW ng + 8i + 2kq + {0,1}; c1 is even, so a pair is wholly in or out.
  const int oy = oy0 + ty;
  if (oy >= H4) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ox = ox0 + tx + 8 * half;
    if (ox >= W4) continue;
    OutT* dst = out + ((static_cast<size_t>(b) * H4 + oy) * W4 + ox) * c1;
#pragma unroll
    for (int i = 0; i < NW / 8; ++i) {
      const int n = ng * NW + 8 * i + 2 * kq;
      if (n >= c1) continue;
      tf32::store_pair(dst + n, silu(acc[4 * i + 2 * half] + s_b1[n]),
                       silu(acc[4 * i + 2 * half + 1] + s_b1[n + 1]));
    }
  }
}

template <typename T, typename OutT, int P>
int launch_plan(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out, int B,
                int H, int W, int c0, int c1, cudaStream_t stream) {
  constexpr StemPlan p = kPlans[P];
  auto kernel = stem_kernel<T, OutT, p.th, p.nw, p.ng, p.stages, p.blocks_per_sm>;
  const int smem = static_cast<int>(plan_smem_bytes(c0, p));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's L1 as shared memory, so that two blocks fit where the plan allows
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W / 4 + kTW - 1) / kTW, (H / 4 + p.th - 1) / p.th, B);
  kernel<<<grid, 128 * (p.th / 4) * p.ng, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(bank), static_cast<const float*>(b1), static_cast<OutT*>(out), H, W, c0, c1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OutT>
int launch(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out, int B, int H,
           int W, int c0, int c1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan_index(c1)) {
    case 0: return launch_plan<T, OutT, 0>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, s);
    case 1: return launch_plan<T, OutT, 1>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, s);
    case 2: return launch_plan<T, OutT, 2>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, s);
    case 3: return launch_plan<T, OutT, 3>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// The bf16 forms: stem_bf16_kernel, uint8 -> bfloat16 (the bf16 predict path)
// and bfloat16 -> bfloat16.
//
// The same function, with its products on the bf16 tensor cores (wgmma
// m64nNk16, mma_bf16.cuh) at about 2^-16 of each term: uint8 pixels and bf16
// values are exact in bf16; every other operand is split once, x = hi + lo in
// bf16, and a product runs three passes, small terms first (two where one side
// is exact). A block owns an 8 x 16 tile of conv1 outputs (128 pixels) at
// every width, stages its input tile with the halo in shared memory as bf16
// (16-byte vector loads where the image rows allow), and walks c0 in 16-channel
// chunks:
//   1. conv0: M = the 17 x 33 conv0 positions of the tile in 64-row tiles
//      taken in turn by the warpgroups, N = the chunk's 16 channels, K = 27
//      padded to 32, two depth-16 steps. A (the stride-2 gather) from registers,
//      B = w0's chunk: one 128-byte row a channel, hi in columns 0-31 and lo in
//      32-63, written for every chunk when the block starts; two passes, lo
//      then hi. Bias and SiLU (fast division: it errs by 2^-22, below the
//      split's 2^-16) on the CUDA cores, conv1's zero border as 0, and each value
//      split into bf16 hi and lo as it is stored: a position holds its 16
//      channels' halves in 16 words, thread kq's four (hi and lo of channels
//      2kq, 2kq + 1 and 8 + 2kq, 9 + 2kq) in one 16-byte group, 96 bytes a
//      position, so that a quarter-warp's 16-byte loads at stride-2 positions
//      hit distinct banks. No conv1 read splits again.
//   2. conv1: per tap (16 channels: one depth-16 step) a chain of three passes
//      from zero, joined to the sum by an fp32 add on the CUDA cores (the
//      tensor cores round an accumulation toward zero: mma_bf16_check.cu shows
//      it for bf16, as it was found for TF32). A comes from two 16-byte loads a
//      tap, the next tap's loaded while this tap's chain runs. B streams from a
//      bf16 hi/lo bank (stem_bank_bf16_kernel, once per w1: 4 bytes a weight
//      against the fp32 bank's 8) in K-chunks of four taps (128-byte rows)
//      through a cp.async ring; the last chunk of a conv0 chunk holds tap 8
//      alone and copies a quarter of its rows.
// At c1 >= 128 the block has four warpgroups (two pixel halves x two halves of
// c1, 128 registers, one block an SM): 128-pixel blocks read w1's bank from L2
// half as often as the fp32 kernel's 64-pixel ones. Below, two warpgroups with
// all of c1 each and two blocks an SM.
//
// Bound (B=16, 640x640, uint8 in, bfloat16 out): the products, counted once,
// at the bf16 tensor cores' 989 TFLOP/s, or the bytes at 3.35 TB/s (19.7 MB
// in, 6.6-39.3 MB out): 0.0137 ms at n, 0.0215 at s, 0.0668 at m/l (66.1
// GFLOP) and 0.146 at x (144.4 GFLOP).

constexpr int kTapsPerChunkBf16 = bf16x::kTileK / kCC;                                // 4 taps x 16 channels
constexpr int kChunksPerCCBf16 = (9 + kTapsPerChunkBf16 - 1) / kTapsPerChunkBf16;    // 3; the last holds tap 8
constexpr int kC0Words = 24;  // 32-bit words a conv0 tile position: 16 (hi and lo of 16 channels) + 8 of padding

constexpr StemPlan kBf16Plans[] = {{8, 32, 1, 3, 2}, {8, 64, 1, 2, 2}, {8, 64, 2, 3, 1}, {8, 96, 2, 2, 1}};

int bank_chunks_bf16(int c0) { return c0_padded(c0) / kCC * kChunksPerCCBf16; }

long long plan_smem_bytes_bf16(int c0, const StemPlan& p) {
  const long long n = static_cast<long long>(p.nw) * p.ng;
  const long long ring = static_cast<long long>(p.stages) * 2 * n * bf16x::kTileK * 2;
  const long long w0 = static_cast<long long>(c0_padded(c0)) * bf16x::kTileK * 2;
  const long long c0_tile = static_cast<long long>(2 * p.th + 1) * (2 * kTW + 1) * kC0Words * 4;
  const long long biases = (c0_padded(c0) + n + 32) * 4;  // and conv0's column table
  const long long in_tile = static_cast<long long>(4 * p.th + 3) * (4 * kTW + 3) * kCin * 2;
  return ring + w0 + c0_tile + biases + in_tile + 1024;  // + the ring's alignment to 1024 bytes
}

__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// A pixel value's bf16 bits (exact: 8 significant bits cover 0-255).
__device__ __forceinline__ uint32_t bf16_bits(uint8_t v) { return __float_as_uint(static_cast<float>(v)) >> 16; }
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// Element j of a 16-byte vector of T, as bf16 bits.
template <typename T>
__device__ __forceinline__ uint32_t vector_bf16_bits(const uint32_t (&w)[4], int j) {
  if constexpr (std::is_same_v<T, uint8_t>) return bf16_bits(static_cast<uint8_t>(w[j >> 2] >> (8 * (j & 3))));
  else return (w[j >> 1] >> (16 * (j & 1))) & 0xffffu;
}

// w1 [9 * c0, c1] (HWIO) -> bank [chunks][hi, lo][np][64] bf16: chunk kc = 3 cc + j holds conv0
// channels [16 cc, 16 cc + 16) at taps 4j + c / 16 (column c), channel 16 cc + c % 16, in the order
// of the A fragment's columns. Zeros past tap 8, c0 and c1. One thread per pair of columns.
__global__ void __launch_bounds__(256)
stem_bank_bf16_kernel(const float* __restrict__ w1, __nv_bfloat16* __restrict__ bank, int c0, int c1, int np,
                      int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int col = 2 * (i & 31), n = (i >> 5) % np, kc = (i >> 5) / np;
  const int cc = kc / kChunksPerCCBf16, tap = kTapsPerChunkBf16 * (kc % kChunksPerCCBf16) + col / kCC;
  const int ch = cc * kCC + col % kCC;
  float v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    v[e] = tap < 9 && ch + e < c0 && n < c1 ? __ldg(w1 + (static_cast<size_t>(tap) * c0 + ch + e) * c1 + n) : 0.0f;
  uint32_t hi, lo;
  bf16x::split(v[0], v[1], hi, lo);
  __nv_bfloat16* dst = bank + (static_cast<size_t>(kc) * 2 * np + n) * bf16x::kTileK + col;
  *reinterpret_cast<uint32_t*>(dst) = hi;
  *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(np) * bf16x::kTileK) = lo;
}

// x [B,H,W,3] of T (uint8 or bfloat16); w0 [3,3,3,c0] (kh,kw,cin,c0) float32; bank from
// stem_bank_bf16_kernel; b0 [c0], b1 [c1] float32; out [B,H/4,W/4,c1] bfloat16. c0 and c1 multiples
// of 8, c1 <= NW * NG. vec_in: x's rows may be read in 16-byte vectors (x 16-byte aligned, 3 W
// elements a multiple of 16 bytes).
template <typename T, int TH, int NW, int NG, int STAGES, int MINB>
__global__ void __launch_bounds__(128 * (TH / 4) * NG, MINB)
stem_bf16_kernel(const T* __restrict__ x, const float* __restrict__ w0, const float* __restrict__ b0,
                 const __nv_bfloat16* __restrict__ bank, const float* __restrict__ b1,
                 __nv_bfloat16* __restrict__ out, int H, int W, int c0, int c1, bool vec_in) {
  constexpr int kThreads = 128 * (TH / 4) * NG;
  constexpr int kWarpgroups = kThreads / 128;
  constexpr int kMG = TH / 4;                                 // warpgroups along the pixels: 64 pixels each
  constexpr int kN = NW * NG;                                 // c1, padded
  constexpr int kC0W = 2 * kTW + 1;                           // conv0 tile columns
  constexpr int kPos = (2 * TH + 1) * kC0W;                   // conv0 positions of the tile
  constexpr int kInH = 4 * TH + 3, kInRow = (4 * kTW + 3) * kCin;  // input tile: rows, elements a row
  constexpr int kStageElems = 2 * kN * bf16x::kTileK;         // one B chunk: hi and lo, [kN][64] each
  constexpr int kW0TileElems = kCC * bf16x::kTileK;           // one chunk of w0: [16][hi 32 | lo 32]
  extern __shared__ unsigned char smem_raw[];
  const int c0p = (c0 + kCC - 1) / kCC * kCC;
  // the 1024-byte boundary the swizzled tiles need, reached by indexing smem_raw (integer arithmetic on
  // the address would make every later shared access a generic one)
  const int pad = (1024 - (static_cast<int>(__cvta_generic_to_shared(smem_raw)) & 1023)) & 1023;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw + pad);  // [STAGES][hi, lo][kN][64], swizzled
  __nv_bfloat16* s_w0 = ring + STAGES * kStageElems;                        // [c0p / 16][16][64], swizzled
  uint32_t* s_c0 = reinterpret_cast<uint32_t*>(s_w0 + c0p * bf16x::kTileK);  // [kPos][kC0Words]
  float* s_b0 = reinterpret_cast<float*>(s_c0 + kPos * kC0Words);           // [c0p]
  float* s_b1 = s_b0 + c0p;                                                 // [kN]
  int* s_k0 = reinterpret_cast<int*>(s_b1 + kN);                            // [4][8]: conv0's A columns, below
  uint16_t* s_in = reinterpret_cast<uint16_t*>(s_k0 + 32);                  // [kInH][kInRow], bf16 bits

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * kTW;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int nkc = c0p / kCC * kChunksPerCCBf16;

  // B chunks stream through the ring STAGES - 1 chunks ahead of the products. The last chunk of each
  // conv0 chunk holds tap 8 alone: its columns 16-63 are not read, nor copied.
  int ld_kc = 0, ld_stage = 0;
  auto start_loads = [&]() {
    float* dst = reinterpret_cast<float*>(ring + ld_stage * kStageElems);
    const float* src = reinterpret_cast<const float*>(bank + static_cast<size_t>(ld_kc) * kStageElems);
    const bool one_tap = ld_kc % kChunksPerCCBf16 == kChunksPerCCBf16 - 1;
    for (int i = tid; i < 2 * kN * 8; i += kThreads) {
      const int row = i >> 3, chunk = i & 7;
      if ((kCut & kCutWeightCopies) == 0 && (!one_tap || chunk < 2))
        tf32::cp_async16(dst + tf32::swizzled_chunk(row, chunk), src + row * tf32::kTileK + 4 * chunk, true);
    }
    ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
    ++ld_kc;
  };
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (ld_kc < nkc) start_loads();
    tf32::cp_async_commit();
  }

  // w0, every chunk, transposed and split for wgmma's K-major B: row o of chunk cc holds
  // split(w0[k][16 cc + o]), hi at column k and lo at 32 + k; zeros past k = 27 and c0.
  for (int i = tid; i < c0p * kCC; i += kThreads) {  // a thread per channel and pair of columns k < 32
    const int ch = i / kCC, k = 2 * (i % kCC);
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) v[e] = k + e < kK0 && ch < c0 ? __ldg(w0 + (k + e) * c0 + ch) : 0.0f;
    uint32_t hi, lo;
    bf16x::split(v[0], v[1], hi, lo);
    __nv_bfloat16* tile = s_w0 + (ch / kCC) * kW0TileElems;
    *reinterpret_cast<uint32_t*>(tile + bf16x::swizzled(ch % kCC, k)) = hi;
    *reinterpret_cast<uint32_t*>(tile + bf16x::swizzled(ch % kCC, 32 + k)) = lo;
  }
  tf32::fence_proxy_async();
  for (int i = tid; i < c0p; i += kThreads) s_b0[i] = i < c0 ? b0[i] : 0.0f;
  for (int i = tid; i < kN; i += kThreads) s_b1[i] = i < c1 ? b1[i] : 0.0f;

  // Input tile: image rows 4*oy0-3 .. 4*oy0+4*TH-1, elements e0 .. e0+kInRow-1 of each row, zero
  // outside the image (conv0's own padding), as bf16 bits.
  {
    const int iy0 = 4 * oy0 - 3, e0 = (4 * ox0 - 3) * kCin;
    const int row_elems = W * kCin;
    const T* xb = x + static_cast<size_t>(b) * H * row_elems;
    if (vec_in) {
      // 16-byte vectors aligned in the row: each lies wholly inside the row or wholly outside it
      constexpr int kV = 16 / static_cast<int>(sizeof(T));
      constexpr int kVecs = kInRow / kV + 2;  // vectors a tile row can touch
      const int v0 = (e0 + 64 * kV) / kV - 64;  // floor(e0 / kV), e0 >= -9
      for (int i = tid; i < kInH * kVecs; i += kThreads) {
        const int row = i / kVecs, e = (v0 + i % kVecs) * kV, gy = iy0 + row;
        if (e >= e0 + kInRow) continue;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gy >= 0 && gy < H && e >= 0 && e < row_elems)
          v = __ldg(reinterpret_cast<const uint4*>(xb + static_cast<size_t>(gy) * row_elems + e));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < kV; ++j)
          if (e + j >= e0 && e + j < e0 + kInRow) s_in[row * kInRow + e + j - e0] = vector_bf16_bits<T>(w, j);
      }
    } else {
      for (int i = tid; i < kInH * kInRow; i += kThreads) {
        const int row = i / kInRow, e = e0 + i % kInRow, gy = iy0 + row;
        s_in[i] = gy >= 0 && gy < H && e >= 0 && e < row_elems
                      ? bf16_bits(xb[static_cast<size_t>(gy) * row_elems + e]) : 0u;
      }
    }
  }

  const int wg = tid >> 7, gt = tid & 127;
  const int kq = gt & 3;
  const int r0 = tf32::acc_row(gt, 0);  // this thread's first fragment row of a 64-row tile

  // conv0's fragment columns k = 16 s + 8 h + 2 kq + e (index 4 s + 2 h + e) are tap (k / 9, k % 9 / 3),
  // channel k % 3: s_k0[8 kq + index] is their offset in the input tile from a window's corner, -1 past
  // k = 27 (a table in shared memory, not 8 registers held through the kernel).
  if (tid < 32) {
    const int k = 16 * (tid >> 2 & 1) + 8 * (tid >> 1 & 1) + 2 * (tid >> 3) + (tid & 1);
    s_k0[tid] = k < kK0 ? (k / 9) * kInRow + k % 9 : -1;
  }
  // conv1: warpgroup wg takes pixels [64 pg, 64 pg + 64) of the tile (tile rows 4 pg .. 4 pg + 3)
  // and columns [NW ng, NW ng + NW) of c1. Its fragment rows are pixels (ty, tx) and (ty, tx + 8);
  // their conv1 windows start at conv0 tile (2 ty, 2 tx), 16 positions apart.
  const int pg = wg % kMG, ng = wg / kMG;
  const int ty = 4 * pg + (gt >> 5), tx = (gt & 31) >> 2;
  const uint32_t* a_base = s_c0 + (2 * ty * kC0W + 2 * tx) * kC0Words + 4 * kq;

  float acc[NW / 2], t[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = t[i] = 0.0f;

  const int cy0 = 2 * oy0 - 1, cx0 = 2 * ox0 - 1;
  int stage_at = 0;
  for (int cc = 0; cc < c0p / kCC; ++cc) {
    __syncthreads();  // w0, the input tile and the biases are whole; every conv1 read of the last chunk is done

    // conv0, channels [16 cc, 16 cc + 16), on conv1's padded grid: tile position p = (r, q) is conv0
    // pixel (cy0 + r, cx0 + q); its 3x3 window starts at input tile (2r, 2q). Rows past the last
    // position repeat it and are not stored.
    const uint64_t dw = tf32::tile_desc(reinterpret_cast<const float*>(s_w0 + cc * kW0TileElems));
    constexpr uint64_t kLoHalf = 64 >> 4;  // lo's columns 32-63: 64 bytes on
    for (int mt = wg; (kCut & kCutConv0) == 0 && mt * 64 < kPos; mt += kWarpgroups) {
      const int p0 = 64 * mt + r0;
      const uint16_t* win[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(p0 + 8 * h, kPos - 1);
        win[h] = s_in + 2 * (p / kC0W) * kInRow + 2 * (p % kC0W) * kCin;
      }
      uint32_t a[2][4];  // a[s][i]: row r0 + 8 (i & 1), columns 16 s + 8 (i >> 1) + 2 kq + {0, 1}
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * kq + 4 * s + 2 * (i >> 1), off0 = s_k0[c], off1 = s_k0[c + 1];
          const uint32_t e0 = off0 < 0 ? 0u : win[i & 1][off0], e1 = off1 < 0 ? 0u : win[i & 1][off1];
          a[s][i] = e0 | e1 << 16;
        }
      float d[kCC / 2];
      tf32::fence_registers(d);
      tf32::wgmma_fence();
      bf16x::wgmma_rs<kCC>(d, a[0], dw + kLoHalf, 0);
      bf16x::wgmma_rs<kCC>(d, a[1], dw + kLoHalf + tf32::kStepDescAdvance, 1);
      bf16x::wgmma_rs<kCC>(d, a[0], dw, 1);
      bf16x::wgmma_rs<kCC>(d, a[1], dw + tf32::kStepDescAdvance, 1);
      tf32::wgmma_commit();
      tf32::wgmma_wait<0>();
      tf32::fence_registers(d);
      // bias, SiLU, the zero border, the split: d[4j + 2h + e] is position p0 + 8h, chunk channel 8j + 2kq + e
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h;
        if (p >= kPos) continue;
        const int r = p / kC0W, q = p % kC0W;
        const bool in_map = cy0 + r >= 0 && cy0 + r < H2 && cx0 + q >= 0 && cx0 + q < W2;
        uint4 st = make_uint4(0u, 0u, 0u, 0u);
        if (in_map) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] = d[4 * (e >> 1) + 2 * h + (e & 1)] + s_b0[cc * kCC + 8 * (e >> 1) + 2 * kq + (e & 1)];
            if constexpr ((kCut & kCutConv0Silu) == 0) v[e] = silu_fast(v[e]);
          }
          bf16x::split(v[0], v[1], st.x, st.z);
          bf16x::split(v[2], v[3], st.y, st.w);
        }
        *reinterpret_cast<uint4*>(s_c0 + p * kC0Words + 4 * kq) = st;
      }
    }

    // conv1's product over this channel chunk, one K-chunk (four taps) of w1 at a time.
#pragma unroll
    for (int j = 0; j < kChunksPerCCBf16; ++j) {
      tf32::cp_async_wait<STAGES - 2>();  // this thread's part of the chunk has landed
      tf32::fence_proxy_async();
      __syncthreads();  // the chunk (and at j = 0 the conv0 tile) is visible; the ring slot before it is free
      if (ld_kc < nkc) start_loads();
      tf32::cp_async_commit();
      const __nv_bfloat16* stage = ring + stage_at * kStageElems;
      stage_at = stage_at + 1 == STAGES ? 0 : stage_at + 1;
      const uint64_t d_hi = tf32::tile_desc(reinterpret_cast<const float*>(stage + ng * NW * bf16x::kTileK));
      const uint64_t d_lo = tf32::tile_desc(reinterpret_cast<const float*>(stage + (kN + ng * NW) * bf16x::kTileK));
      constexpr int kTaps = kTapsPerChunkBf16;
      // fragment of a tap: pixel (ty, tx) f[0], (ty, tx + 8) f[1], each {hi, hi + 8 channels, lo, lo + 8}
      auto load_tap = [&](int tap, uint4 (&f)[2]) {
        const uint32_t* p = a_base + ((tap / 3) * kC0W + tap % 3) * kC0Words;
        f[0] = *reinterpret_cast<const uint4*>(p);
        f[1] = *reinterpret_cast<const uint4*>(p + 16 * kC0Words);
      };
      uint4 f[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      if constexpr ((kCut & kCutConv1Loads) == 0) load_tap(kTaps * j, f);
#pragma unroll
      for (int tp = 0; tp < kTaps; ++tp) {
        const int tap = kTaps * j + tp;
        if (tap >= 9) break;
        const uint32_t a_hi[4] = {f[0].x, f[1].x, f[0].y, f[1].y}, a_lo[4] = {f[0].z, f[1].z, f[0].w, f[1].w};
        const uint64_t adv = tp * tf32::kStepDescAdvance;
        tf32::fence_registers(t);
        tf32::wgmma_fence();
        if constexpr ((kCut & kCutConv1Products) == 0) {
          bf16x::wgmma_rs<NW>(t, a_lo, d_hi + adv, 0);
          bf16x::wgmma_rs<NW>(t, a_hi, d_lo + adv, 1);
          bf16x::wgmma_rs<NW>(t, a_hi, d_hi + adv, 1);
        }
        tf32::wgmma_commit();
        // the next tap's fragment, while this tap's chain runs
        if ((kCut & kCutConv1Loads) == 0 && tp + 1 < kTaps && tap + 1 < 9) load_tap(tap + 1, f);
        tf32::wgmma_wait<0>();
        tf32::fence_registers(t);
        if constexpr ((kCut & kCutConv1Joins) == 0) {
#pragma unroll
          for (int i = 0; i < NW / 2; ++i) acc[i] += t[i];
        }
      }
    }
  }

  // bias + SiLU on the store: acc[4i + {0,1}] is pixel (ty, tx), acc[4i + {2,3}] pixel (ty, tx + 8),
  // channels NW ng + 8i + 2kq + {0,1}; c1 is even, so a pair is wholly in or out.
  const int oy = oy0 + ty;
  if (oy >= H4) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ox = ox0 + tx + 8 * half;
    if (ox >= W4) continue;
    __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * H4 + oy) * W4 + ox) * c1;
#pragma unroll
    for (int i = 0; i < NW / 8; ++i) {
      const int n = ng * NW + 8 * i + 2 * kq;
      if (n >= c1) continue;
      tf32::store_pair(dst + n, silu_fast(acc[4 * i + 2 * half] + s_b1[n]),
                       silu_fast(acc[4 * i + 2 * half + 1] + s_b1[n + 1]));
    }
  }
}

template <typename T, int P>
int launch_plan_bf16(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out,
                     int B, int H, int W, int c0, int c1, cudaStream_t stream) {
  constexpr StemPlan p = kBf16Plans[P];
  auto kernel = stem_bf16_kernel<T, p.th, p.nw, p.ng, p.stages, p.blocks_per_sm>;
  const int smem = static_cast<int>(plan_smem_bytes_bf16(c0, p));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0 && W * kCin * sizeof(T) % 16 == 0;
  const dim3 grid((W / 4 + kTW - 1) / kTW, (H / 4 + p.th - 1) / p.th, B);
  kernel<<<grid, 128 * (p.th / 4) * p.ng, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const __nv_bfloat16*>(bank), static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(out), H, W,
      c0, c1, vec_in);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bf16(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out, int B,
                int H, int W, int c0, int c1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan_index(c1)) {
    case 0: return launch_plan_bf16<T, 0>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, s);
    case 1: return launch_plan_bf16<T, 1>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, s);
    case 2: return launch_plan_bf16<T, 2>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, s);
    case 3: return launch_plan_bf16<T, 3>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The block's layout for these widths: {tile rows, tile cols, c1 per warpgroup, warpgroups per 64
// pixels, ring stages}; all 0 where no plan takes the widths.
void stem_plan_of(int c0, int c1, int* plan) {
  const int i = plan_index(c1);
  const StemPlan p = i < 0 ? StemPlan{0, 0, 0, 0, 0} : kPlans[i];
  plan[0] = p.th;
  plan[1] = i < 0 ? 0 : kTW;
  plan[2] = p.nw;
  plan[3] = p.ng;
  plan[4] = p.stages;
}

// Shared memory one block needs, in bytes (the wrapper checks it against the card's limit); -1
// where no plan takes the widths.
long long stem_smem_bytes(int c0, int c1) {
  const int i = plan_index(c1);
  return i < 0 ? -1 : plan_smem_bytes(c0, kPlans[i]);
}

// Floats of the scratch bank ymt_stem_bank writes.
long long stem_bank_floats(int c0, int c1) {
  const int i = plan_index(c1);
  return i < 0 ? 0 : static_cast<long long>(bank_chunks(c0)) * 2 * kPlans[i].nw * kPlans[i].ng * tf32::kTileK;
}

// w1 [9 * c0, c1] float32 (HWIO) -> bank, stem_bank_floats(c0, c1) floats.
int ymt_stem_bank(const void* w1, void* bank, int c0, int c1, void* stream) {
  const int i = plan_index(c1);
  if (i < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int np = kPlans[i].nw * kPlans[i].ng;
  const int total = bank_chunks(c0) * np * tf32::kTileK;
  stem_bank_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w1), static_cast<float*>(bank), c0, c1, np, total);
  return static_cast<int>(cudaGetLastError());
}

// uint8 -> float32
int ymt_stem_u8(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out, int B,
                int H, int W, int c0, int c1, void* stream) {
  return launch<uint8_t, float>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, stream);
}

// float32 -> float32
int ymt_stem_f32(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out, int B,
                 int H, int W, int c0, int c1, void* stream) {
  return launch<float, float>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, stream);
}

// The bf16 forms' block layout (as stem_plan_of), shared memory and bank size in bytes, and bank.
void stem_bf16_plan_of(int c0, int c1, int* plan) {
  const int i = plan_index(c1);
  const StemPlan p = i < 0 ? StemPlan{0, 0, 0, 0, 0} : kBf16Plans[i];
  plan[0] = p.th;
  plan[1] = i < 0 ? 0 : kTW;
  plan[2] = p.nw;
  plan[3] = p.ng;
  plan[4] = p.stages;
}

long long stem_bf16_smem_bytes(int c0, int c1) {
  const int i = plan_index(c1);
  return i < 0 ? -1 : plan_smem_bytes_bf16(c0, kBf16Plans[i]);
}

long long stem_bank_bf16_bytes(int c0, int c1) {
  const int i = plan_index(c1);
  return i < 0 ? 0
               : static_cast<long long>(bank_chunks_bf16(c0)) * 2 * kBf16Plans[i].nw * kBf16Plans[i].ng *
                     bf16x::kTileK * 2;
}

// w1 [9 * c0, c1] float32 (HWIO) -> bank, stem_bank_bf16_bytes(c0, c1) bytes of bf16.
int ymt_stem_bank_bf16(const void* w1, void* bank, int c0, int c1, void* stream) {
  const int i = plan_index(c1);
  if (i < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int np = kBf16Plans[i].nw * kBf16Plans[i].ng;
  const int total = bank_chunks_bf16(c0) * np * bf16x::kTileK / 2;
  stem_bank_bf16_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w1), static_cast<__nv_bfloat16*>(bank), c0, c1, np, total);
  return static_cast<int>(cudaGetLastError());
}

// uint8 -> bfloat16, bank from ymt_stem_bank_bf16
int ymt_stem_u8_bf16(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out,
                     int B, int H, int W, int c0, int c1, void* stream) {
  return launch_bf16<uint8_t>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, stream);
}

// bfloat16 -> bfloat16, bank from ymt_stem_bank_bf16
int ymt_stem_bf16(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out, int B,
                  int H, int W, int c0, int c1, void* stream) {
  return launch_bf16<__nv_bfloat16>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, stream);
}

}  // extern "C"
