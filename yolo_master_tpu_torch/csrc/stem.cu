// Fused detector stem: conv0 (3->c0, k3 s2 p1) + bias + SiLU, then
// conv1 (c0->c1, k3 s2 p1) + bias + SiLU, in one pass over the letterboxed
// uint8 NHWC image. BatchNorm and the /255 input scale are folded into the
// weights by the caller (yolo_master_tpu_torch/utils/fuse.py). The kernel
// computes in fp32 and is built for four (input, output) types: uint8 ->
// float32 and float32 -> float32 (the fp32 path), uint8 -> bfloat16 and
// bfloat16 -> bfloat16 (the bf16 path); the weights are float32 in all four.
//
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
// With a bfloat16 output the bytes at 16/32 are 19.7 MB in and 26.2 MB out,
// 45.9 MB, 0.014 ms. The split-TF32 products below run three tensor-core
// passes (conv0 two on uint8 or bfloat16 input), so the tensor time is about
// three times its column. Unfused,
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
//      each thread into its wgmma fragment (RS form); uint8 pixels and
//      bfloat16 values (8 significant bits against TF32's 11) are exact in
//      TF32, so A needs no split and two passes against w0's halves keep
//      fp32 accuracy (float32 input: three). Bias and SiLU on the CUDA cores;
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
// last chunk, bias and SiLU (full-precision expf) are applied on the store,
// rounded to nearest for a bfloat16 output; only conv1's output goes to
// device memory.
//
// The block's layout is a function of c1 (kPlans, below, which the wrapper and
// the launch both read): at c1 <= 64 an 8x16 tile, one warpgroup per 64 pixels
// with all of c1; at 128 and 192 a 4x16 tile, two warpgroups with half of c1
// each. Two blocks share an SM up to c1 = 128 (128 registers, under 113 KB of
// shared memory), so one block's conv0, copies and barriers overlap the
// other's products; at 192 one block (about 240 registers).

#include <math.h>

#include <type_traits>

#include "mma_tf32.cuh"

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
enum StemCut { kCutConv1Products = 1, kCutConv0 = 2, kCutWeightCopies = 4, kCutConv0Silu = 8, kFastSiluDivision = 16 };
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

// x [B,H,W,3] of T (uint8, float or bfloat16); w0 [3,3,3,c0] (kh,kw,cin,c0); bank from
// stem_bank_kernel; b0 [c0], b1 [c1]; out [B,H/4,W/4,c1] of OutT (float or bfloat16). c0 and c1
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
  constexpr bool kExactA = !std::is_same_v<T, float>;         // uint8 and bfloat16 values are exact in TF32
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

// uint8 -> bfloat16
int ymt_stem_u8_bf16(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out,
                     int B, int H, int W, int c0, int c1, void* stream) {
  return launch<uint8_t, __nv_bfloat16>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, stream);
}

// bfloat16 -> bfloat16
int ymt_stem_bf16(const void* x, const void* w0, const void* b0, const void* bank, const void* b1, void* out, int B,
                  int H, int W, int c0, int c1, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w0, b0, bank, b1, out, B, H, W, c0, c1, stream);
}

}  // extern "C"
