// Whole-block C3k2 (Bottleneck inner blocks, BN folded) in one kernel.
//
// Replaces: yolo_master_tpu/ops/pallas_c3k2.py:pallas_c3k2 and pallas_c3k2_cf
// (the two differ only in the TPU's lane layout; one kernel covers both).
//
// For one image, x [H,W,C1] NHWC -> out [H,W,C2] NHWC:
//   y     = SiLU(x @ Wcv1 + b)                  1x1, 2c channels: y_a = y[:c], y_b = y[c:]
//   h_0   = y_b
//   a     = SiLU(conv3x3(h_i, W1_i) + b1_i)     cb channels, zero padding
//   h_i+1 = h_i + SiLU(conv3x3(a, W2_i) + b2_i) c channels (the shortcut)
//   out   = SiLU([y_a, y_b, h_1 .. h_n] @ Wcv2 + b)
//
// What bounds it on the H100. At yolo-master-n's layers 2 and 5 (C1 = 32/64,
// c = 16/32, cb = c/2, C2 = 64/128, n = 1) the block does 6400 or 25600
// multiply-adds per pixel against 384 or 768 bytes of fp32 in and out. Counted
// as matrix products at 495 TFLOP/s (TF32 tensor cores) that is 5.24 GFLOP per
// layer at B=16, 0.011 ms, below the bytes' 0.047 and 0.023 ms at 3.35 TB/s:
// bytes bound the function once its products run on the tensor cores (on the
// CUDA cores, at 67 TFLOP/s, the products alone would take 0.078 ms a layer).
// This kernel does not reach that bound: its stages are narrow (N = 8 to 32
// channels a slab), so each wgmma does little work beside the instructions
// that gather, split and address its operands, and the SMs' instruction issue
// sets its time (PERF.md, PR 9).
//
// What the design does: the TPU kernel keeps the whole [H,W,C] plane in VMEM
// (3.3 MB); a Hopper block has 227 KB. So each block computes one image's
// 8x16-pixel output tile, and everything in between stays in shared memory,
// never in device memory:
//   1. x over the tile plus a halo of 2n pixels (zeros outside the image);
//   2. cv1's y_b over that region and y_a over the tile;
//   3. per bottleneck, its hidden map a over a window one pixel smaller than
//      its input on each side, then h in place over a window one more pixel
//      smaller: after n bottlenecks the window is the tile;
//   4. cv2 over the concat [y_a, y_b, h_1 .. h_n] on the tile, to device memory.
// Every map that a 3x3 conv reads is zero outside the image (its SAME
// padding): a stage writes 0, not SiLU(bias), at a pixel outside the image.
//
// Each stage is an implicit GEMM on split-TF32 wgmma (csrc/mma_tf32.cuh), one
// function for the 1x1 (taps = 1) and the 3x3 (taps = 3) convs:
//   - M = the stage's output window in 64-pixel groups, which the block's two
//     warpgroups take in turn (rows past the window repeat its last pixel and
//     are not stored); N = the stage's output channels, in slabs of 32, 16 or 8;
//     K = taps x input channels, tap-major (for cv2 the concat's channels).
//   - A is gathered from the input map in shared memory into registers (RS
//     form): a tap is an address offset, and each thread loads its fragment
//     rows two channels at a time with 8-byte loads, then splits them hi/lo.
//     A map keeps C floats per pixel (a pitch padded for the banks would not
//     fit n = 2 at layer 5's widths, or n = 4 at layer 2's), its 8-channel
//     groups permuted by pixel (map_offset) so that the four pixels of a
//     half-warp's loads read four distinct 8-bank segments.
//   - B comes from a weight bank that the wrapper builds once per weight set
//     in plain PyTorch (ops/c3k2.py:c3k2_bank): each stage's weights transposed
//     K-major, each 8 K-columns in the order (0,2,4,6,1,3,5,7) (so one 8-byte
//     load fills a fragment's two columns), split hi/lo, zero-padded to 32-deep
//     k-tiles (hi's rows, then lo's), slab by slab. A slab (all of K for one N
//     slab: at most 40 KB, at layer 5's second 3x3 conv) is copied by cp.async
//     into 128-byte-swizzled tiles before the warpgroups' products: the whole
//     split bank (200 KB at layer 5) does not fit beside the maps. cv1's slabs
//     have a place of their own; every later stage's lies where x was.
//   - The tensor cores round every accumulation toward zero, so each 16-deep
//     chain (two depth-8 steps) starts from zero, small terms first, and joins
//     the stage's sum by an fp32 add, as stem.cu's conv1 does. Chains go in
//     pairs, one k-tile of B a pair: the second's fragments are gathered while
//     the first runs.
//   - Bias, SiLU, the zero border and the shortcut add run on the CUDA cores
//     after the last chain, the bias loaded before the products.
// Two blocks share an SM where their shared memory fits (layer 2: 74 KB a
// block; registers then capped at 128), else one (layer 5: 155 KB; no cap):
// c3k2_kernel<2> and <1>. Widths must be multiples of 8 (the depth of a wgmma
// step and the narrowest N); the wrapper refuses others.

#include <math.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpgroups = kThreads / 128;
constexpr int kTH = 8;
constexpr int kTW = 16;
constexpr int kTP = kTH * kTW;  // 128 tile pixels
constexpr int kMaxN = 4;        // bottlenecks
constexpr int kMaxStages = 3 + 2 * kMaxN;
constexpr int kChainSteps = 2;  // depth-8 wgmma steps per chain: 16 deep
constexpr int kSmemPerSM = 233472;  // bytes of shared memory an H100 SM gives its blocks (228 KB), 1 KB each reserved

enum Mode { kStore = 0, kAdd = 1, kGlobal = 2 };

// A map in shared memory holds cs channels (a multiple of 8) per pixel, pixel P at P * cs. Its
// 8-channel group g lies at group g ^ sw(P): with cs / 8 a multiple of 4, sw(P) = P % 4; a multiple
// of 2, (P / 2) % 2; odd, 0. Four consecutive pixels' group g then start 8 banks apart.
struct Swizzle {
  int shift, mask;
};

__device__ __forceinline__ Swizzle swizzle_of(int cs) {
  const int groups = cs >> 3;
  return groups % 4 == 0 ? Swizzle{0, 3} : groups % 2 == 0 ? Swizzle{1, 1} : Swizzle{0, 0};
}

// Offset in floats of channel ch of pixel P.
__device__ __forceinline__ int map_offset(int P, int ch, int cs, Swizzle z) {
  return P * cs + ((((ch >> 3) ^ ((P >> z.shift) & z.mask))) << 3) + (ch & 7);
}

// Output channels per bank slab, for a stage of `n` output channels (a multiple of 8).
__host__ __device__ int slab_width(int n) { return n % 32 == 0 ? 32 : n % 16 == 0 ? 16 : 8; }

__host__ __device__ int k_tiles(int k) { return (k + tf32::kTileK - 1) / tf32::kTileK; }

// One slab: [k_tiles][hi, lo][slab_width][32] floats.
__host__ __device__ int slab_floats(int k, int n) { return 2 * k_tiles(k) * tf32::kTileK * slab_width(n); }

// A stage's bank: its N / slab_width slabs, one after the other.
__host__ __device__ long long stage_bank_floats(int k, int n) {
  return static_cast<long long>(n / slab_width(n)) * slab_floats(k, n);
}

// The stages in the block's order, as (K, N): cv1's y_b and y_a, each bottleneck's two 3x3 convs, cv2.
__host__ __device__ int stage_count(int n) { return 3 + 2 * n; }
__host__ __device__ void stage_shape(int s, int C1, int c, int cb, int C2, int n, int& k, int& o) {
  if (s < 2) {
    k = C1;
    o = c;
  } else if (s < 2 + 2 * n) {
    const bool first = (s - 2) % 2 == 0;
    k = 9 * (first ? c : cb);
    o = first ? cb : c;
  } else {
    k = (2 + n) * c;
    o = C2;
  }
}

struct C3k2Params {
  const float* bank[kMaxStages];  // each stage's slabs
  const float* cv1_b;             // [2c]
  const float* m_b1[kMaxN];       // [cb]
  const float* m_b2[kMaxN];       // [c]
  const float* cv2_b;             // [C2]
};

// One conv stage: an oh x ow window of output pixels whose image origin is (gy0, gx0). Output
// pixel (y, x), channel o < N:
//   r = SiLU(bias[o] + sum over taps (dy, dx) < taps x taps, channels j < cin of
//            in[pixel in0 + (y + dy) * ipitch + x + dx, channel j] * w[(dy * taps + dx) * cin + j][o])
// in0 is the input window's origin (one pixel up and left of the output window's for taps = 3).
// kStore writes r to out's pixel out0 + y * opitch + x, or 0 outside the image; kAdd adds r inside
// the image; kGlobal writes r inside the image to device memory, pixel (y, x) at out + (y * opitch + x) * ocs.
struct Stage {
  const float* in;
  int in0, ipitch, ics, taps, cin;
  const float* bank;
  int N;
  const float* bias;
  int oh, ow, gy0, gx0;
  float* out;
  int out0, opitch, ocs;
};

// SiLU with the fast exponential and division (2 ulp each): the IEEE ones cost a large part of the
// epilogues' time, and the error against the plain version stays as it is.
__device__ __forceinline__ float silu(float z) { return __fdividef(z, 1.0f + __expf(-z)); }

// Where the next depth-8 step of a stage reads its A fragment: its channel, its tap (dx within the
// tap's row) and the tap's pixel offset, and per fragment row the tap's input pixel (its offset in
// floats, this thread's channel pair included, and its swizzle). Taps advance by additions only.
struct Gather {
  int ch, dx, tp, at[2], sw[2];
};

__device__ __forceinline__ void gather_tap(const Stage& s, const int (&pin)[2], int kq, Swizzle zi, Gather& g) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    g.at[h] = (pin[h] + g.tp) * s.ics + 2 * kq;
    g.sw[h] = ((pin[h] + g.tp) >> zi.shift) & zi.mask;
  }
}

// The next step's fragment, split: channels ch + {2 kq, 2 kq + 1} (fragment columns kq and kq + 4,
// as the bank orders them) of rows r0 (a[0], a[2]) and r0 + 8 (a[1], a[3]). Map values are finite.
__device__ __forceinline__ void gather_step(const Stage& s, const int (&pin)[2], int kq, Swizzle zi, Gather& g,
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 v0 = *reinterpret_cast<const float2*>(s.in + g.at[0] + (((g.ch >> 3) ^ g.sw[0]) << 3));
  const float2 v1 = *reinterpret_cast<const float2*>(s.in + g.at[1] + (((g.ch >> 3) ^ g.sw[1]) << 3));
  tf32::split_finite(v0.x, hi[0], lo[0]);
  tf32::split_finite(v1.x, hi[1], lo[1]);
  tf32::split_finite(v0.y, hi[2], lo[2]);
  tf32::split_finite(v1.y, hi[3], lo[3]);
  g.ch += 8;
  if (g.ch == s.cin) {
    g.ch = 0;
    if (++g.dx < s.taps) {
      g.tp += 1;
    } else {
      g.dx = 0;
      g.tp += s.ipitch - s.taps + 1;
    }
    gather_tap(s, pin, kq, zi, g);
  }
}

// Issues one chain of S depth-8 steps into t, from zero, small terms first: lo_a hi_b and hi_a lo_b,
// then hi_a hi_b. d describes the hi rows of the chain's first step (a k-tile holds hi's NW rows,
// then lo's); each step is 32 bytes on (the descriptors count 16 bytes).
template <int NW, int S>
__device__ __forceinline__ void issue_chain(float (&t)[NW / 2], const uint32_t (&hi)[2][4], const uint32_t (&lo)[2][4],
                                            uint64_t d) {
  constexpr uint64_t kLoRows = NW * tf32::kTileK * 4 / 16;  // lo's rows, after hi's
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) t[i] = 0.0f;
  tf32::fence_registers(t);
  tf32::wgmma_fence();
#pragma unroll
  for (int j = 0; j < S; ++j) {
    tf32::wgmma_rs<NW>(t, lo[j], d + j * tf32::kStepDescAdvance);
    tf32::wgmma_rs<NW>(t, hi[j], d + kLoRows + j * tf32::kStepDescAdvance);
  }
#pragma unroll
  for (int j = 0; j < S; ++j) tf32::wgmma_rs<NW>(t, hi[j], d + j * tf32::kStepDescAdvance);
  tf32::wgmma_commit();
}

template <int NW>
__device__ __forceinline__ void join(float (&acc)[NW / 2], float (&t)[NW / 2]) {
  tf32::fence_registers(t);
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] += t[i];
}

template <int kMode, int NW>
__device__ void gemm_stage(const Stage& s, float* slab, int H, int W) {
  const int tid = threadIdx.x, wg = tid >> 7, gt = tid & 127, kq = gt & 3;
  const int r0 = tf32::acc_row(gt, 0);  // this thread's first fragment row of a 64-row group
  const int npix = s.oh * s.ow, groups = (npix + 63) / 64;
  const int K = s.taps * s.taps * s.cin, steps = K / 8, kt = k_tiles(K);
  const int slab_f = 2 * kt * tf32::kTileK * NW;
  const Swizzle zi = swizzle_of(s.ics), zo = swizzle_of(s.ocs);
  for (int n0 = 0; n0 < s.N; n0 += NW) {
    __syncthreads();  // the input map is whole; every wgmma and load of the previous slab is done
    const float* src = s.bank + static_cast<size_t>(n0 / NW) * slab_f;
    for (int i = tid; i < slab_f / 4; i += kThreads)
      tf32::cp_async16(slab + tf32::swizzled_chunk(i >> 3, i & 7), src + 4 * i, true);
    tf32::cp_async_commit();
    tf32::cp_async_wait<0>();  // this thread's copies (and, in the first stage, x) have landed
    tf32::fence_proxy_async();
    __syncthreads();
    const uint64_t d0 = tf32::tile_desc(slab);
    constexpr uint64_t kTileDesc = 2 * NW * tf32::kTileK * 4 / 16;  // one k-tile of B (hi and lo), in descriptor units
    // this thread's bias pairs, loaded before the products that hide their latency
    float2 bias[NW / 8];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) bias[j] = __ldg(reinterpret_cast<const float2*>(s.bias + n0 + 8 * j + 2 * kq));

    // The warpgroups take the 64-pixel groups in turn, both the same number of times (the second's
    // last one may lie past the window: its rows repeat the last pixel and nothing is stored), so that
    // the loop is uniform across the block.
    for (int it = 0; it < (groups + kWarpgroups - 1) / kWarpgroups; ++it) {
      const int mg = kWarpgroups * it + wg;
      // fragment rows r0 and r0 + 8: pixels p0 and p0 + 8 (past the last pixel: the last, not stored)
      const int p0 = 64 * mg + r0;
      int py[2], px[2], pin[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(p0 + 8 * h, npix - 1);
        py[h] = p / s.ow;
        px[h] = p % s.ow;
        pin[h] = s.in0 + py[h] * s.ipitch + px[h];
      }
      Gather g{0, 0, 0, {0, 0}, {0, 0}};
      gather_tap(s, pin, kq, zi, g);
      float acc[NW / 2], t0[NW / 2], t1[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
      uint32_t h0[kChainSteps][4], l0[kChainSteps][4], h1[kChainSteps][4], l1[kChainSteps][4];
      // Chains in pairs, one k-tile of B a pair: the second chain's fragments are gathered while the
      // first runs, and the first joins acc while the second runs.
      static_assert(2 * kChainSteps == tf32::kStepsPerTile, "a pair of chains is one k-tile");
      const int pairs = steps / tf32::kStepsPerTile;
      uint64_t d = d0;
      for (int c = 0; c < pairs; ++c, d += kTileDesc) {
#pragma unroll
        for (int j = 0; j < kChainSteps; ++j) gather_step(s, pin, kq, zi, g, h0[j], l0[j]);
        issue_chain<NW, kChainSteps>(t0, h0, l0, d);
#pragma unroll
        for (int j = 0; j < kChainSteps; ++j) gather_step(s, pin, kq, zi, g, h1[j], l1[j]);
        issue_chain<NW, kChainSteps>(t1, h1, l1, d + kChainSteps * tf32::kStepDescAdvance);
        tf32::wgmma_wait<1>();
        join<NW>(acc, t0);
        tf32::wgmma_wait<0>();
        join<NW>(acc, t1);
      }
      // the last k-tile's 0 to 3 steps: a chain of two, then one of one
      const int rest = steps - pairs * tf32::kStepsPerTile;
      if (rest >= kChainSteps) {
#pragma unroll
        for (int j = 0; j < kChainSteps; ++j) gather_step(s, pin, kq, zi, g, h0[j], l0[j]);
        issue_chain<NW, kChainSteps>(t0, h0, l0, d);
        tf32::wgmma_wait<0>();
        join<NW>(acc, t0);
        d += kChainSteps * tf32::kStepDescAdvance;
      }
      if (rest % kChainSteps) {
        gather_step(s, pin, kq, zi, g, h0[0], l0[0]);
        issue_chain<NW, 1>(t0, h0, l0, d);
        tf32::wgmma_wait<0>();
        join<NW>(acc, t0);
      }

      // bias, SiLU, the border, the shortcut: acc[4j + 2h + e] is pixel p0 + 8h, channel n0 + 8j + 2kq + e
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (p0 + 8 * h >= npix) continue;
        const int y = py[h], x = px[h];
        const int gy = s.gy0 + y, gx = s.gx0 + x;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        if (kMode != kStore && !inside) continue;
        const int P = s.out0 + y * s.opitch + x;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int o = n0 + 8 * j + 2 * kq;
          float2 r = make_float2(0.0f, 0.0f);
          if (inside) r = make_float2(silu(acc[4 * j + 2 * h] + bias[j].x), silu(acc[4 * j + 2 * h + 1] + bias[j].y));
          float2* d = reinterpret_cast<float2*>(
              s.out + (kMode == kGlobal ? static_cast<size_t>(P) * s.ocs + o : map_offset(P, o, s.ocs, zo)));
          if (kMode == kAdd) {
            const float2 old = *d;
            r = make_float2(old.x + r.x, old.y + r.y);
          }
          *d = r;
        }
      }
    }
  }
}

template <int kMode>
__device__ void conv_stage(const Stage& s, float* slab, int H, int W) {
  switch (slab_width(s.N)) {
    case 32: gemm_stage<kMode, 32>(s, slab, H, W); break;
    case 16: gemm_stage<kMode, 16>(s, slab, H, W); break;
    default: gemm_stage<kMode, 8>(s, slab, H, W); break;
  }
}

// Copy h (c channels) on the tile from hs (region pitch RW, halo R) into cat's channels off .. off+c.
__device__ void tile_to_cat(const float* hs, int RW, int R, int c, float* cat, int ccs, int off) {
  const Swizzle zh = swizzle_of(c), zc = swizzle_of(ccs);
  const int c4n = c / 4;
  for (int q = threadIdx.x; q < kTP * c4n; q += kThreads) {
    const int p = q / c4n, ch = 4 * (q % c4n);
    *reinterpret_cast<float4*>(cat + map_offset(p, off + ch, ccs, zc)) =
        *reinterpret_cast<const float4*>(hs + map_offset((p / kTW + R) * RW + p % kTW + R, ch, c, zh));
  }
}

// Shared memory, in floats after the 1024-byte alignment: cv1's slab, then region0 (x; after cv1,
// the later stages' slab and then a bottleneck's hidden map a), then h over the region, then the concat.
struct Layout {
  int R, RH, RW, slab1, slab2, region0, hs_floats, cat_floats;
};

__host__ __device__ Layout layout(int C1, int c, int cb, int C2, int n) {
  Layout L;
  L.R = 2 * n;
  L.RH = kTH + 2 * L.R;
  L.RW = kTW + 2 * L.R;
  L.slab1 = slab_floats(C1, c);
  L.slab2 = 0;
  for (int s = 2; s < stage_count(n); ++s) {
    int k, o;
    stage_shape(s, C1, c, cb, C2, n, k, o);
    const int f = slab_floats(k, o);
    L.slab2 = f > L.slab2 ? f : L.slab2;
  }
  const int xs = L.RH * L.RW * C1, as = L.slab2 + (L.RH - 2) * (L.RW - 2) * cb;
  L.region0 = xs > as ? xs : as;
  L.hs_floats = L.RH * L.RW * c;
  L.cat_floats = kTP * (2 + n) * c;
  return L;
}

template <int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
c3k2_kernel(const float* __restrict__ x, float* __restrict__ out, C3k2Params P, int H, int W, int C1, int c, int cb,
            int C2, int n, int tiles_x) {
  extern __shared__ unsigned char smem_raw[];
  const Layout L = layout(C1, c, cb, C2, n);
  // The 1024-byte boundary for the swizzled tiles, reached by indexing smem_raw (not by integer
  // arithmetic on the address, after which the compiler no longer knows that the maps are shared memory
  // and makes every access a generic one).
  const int pad = (1024 - (static_cast<int>(__cvta_generic_to_shared(smem_raw)) & 1023)) & 1023;
  float* slab1 = reinterpret_cast<float*>(smem_raw + pad);  // cv1's slabs, swizzled tiles
  float* xs = slab1 + L.slab1;                // x over the region
  float* slab2 = xs;                          // after cv1: the later stages' slabs (1024-byte aligned)
  float* as = xs + L.slab2;                   // and a bottleneck's hidden map
  float* hs = xs + L.region0;
  float* cat = hs + L.hs_floats;
  const int R = L.R, RH = L.RH, RW = L.RW, ccs = (2 + n) * c;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const float* xb = x + static_cast<size_t>(b) * H * W * C1;

  // 1. x over the region, zeros outside the image, by cp.async: the first stage waits for it with its
  // weights
  const Swizzle zx = swizzle_of(C1);
  const int c4n = C1 / 4;
  for (int q = threadIdx.x; q < RH * RW * c4n; q += kThreads) {
    const int pix = q / c4n, c4 = q % c4n;
    const int gy = ty0 - R + pix / RW, gx = tx0 - R + pix % RW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    tf32::cp_async16(xs + map_offset(pix, 4 * c4, C1, zx),
                     inside ? xb + (static_cast<size_t>(gy) * W + gx) * C1 + 4 * c4 : xb, inside);
  }

  // 2. cv1: y_b over the region -> hs, y_a over the tile -> cat[:, 0:c]
  conv_stage<kStore>(Stage{xs, 0, RW, C1, 1, C1, P.bank[0], c, P.cv1_b + c, RH, RW, ty0 - R, tx0 - R, hs, 0, RW, c},
                     slab1, H, W);
  conv_stage<kStore>(Stage{xs, R * RW + R, RW, C1, 1, C1, P.bank[1], c, P.cv1_b, kTH, kTW, ty0, tx0, cat, 0, kTW,
                           ccs},
                     slab1, H, W);
  __syncthreads();
  tile_to_cat(hs, RW, R, c, cat, ccs, c);

  // 3. the bottlenecks; h_i's window has a halo of R - 2i pixels
  for (int i = 0; i < n; ++i) {
    const int h1 = R - 2 * i - 1, oh1 = kTH + 2 * h1, ow1 = kTW + 2 * h1;
    conv_stage<kStore>(Stage{hs, 2 * i * RW + 2 * i, RW, c, 3, c, P.bank[2 + 2 * i], cb, P.m_b1[i], oh1, ow1,
                             ty0 - h1, tx0 - h1, as, 0, ow1, cb},
                       slab2, H, W);
    const int h2 = h1 - 1;
    conv_stage<kAdd>(Stage{as, 0, ow1, cb, 3, cb, P.bank[3 + 2 * i], c, P.m_b2[i], kTH + 2 * h2, kTW + 2 * h2,
                           ty0 - h2, tx0 - h2, hs, (R - h2) * RW + R - h2, RW, c},
                     slab2, H, W);
    __syncthreads();
    tile_to_cat(hs, RW, R, c, cat, ccs, (2 + i) * c);
  }

  // 4. cv2 over the concat, to device memory (each stage starts with a barrier)
  conv_stage<kGlobal>(Stage{cat, 0, kTW, ccs, 1, ccs, P.bank[2 + 2 * n], C2, P.cv2_b, kTH, kTW, ty0, tx0,
                            out + ((static_cast<size_t>(b) * H + ty0) * W + tx0) * C2, 0, W, C2},
                      slab2, H, W);
}

int smem_bytes(int C1, int c, int cb, int C2, int n) {
  const Layout L = layout(C1, c, cb, C2, n);
  return static_cast<int>(sizeof(float)) * (L.slab1 + L.region0 + L.hs_floats + L.cat_floats) + 1024;  // + alignment
}

long long bank_floats(int C1, int c, int cb, int C2, int n) {
  long long total = 0;
  for (int s = 0; s < stage_count(n); ++s) {
    int k, o;
    stage_shape(s, C1, c, cb, C2, n, k, o);
    total += stage_bank_floats(k, o);
  }
  return total;
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
int c3k2_smem_bytes(int C1, int c, int cb, int C2, int n) { return smem_bytes(C1, c, cb, C2, n); }

// Floats of the weight bank ymt_c3k2 reads (ops/c3k2.py:c3k2_bank builds it).
long long c3k2_bank_floats(int C1, int c, int cb, int C2, int n) { return bank_floats(C1, c, cb, C2, n); }

int c3k2_max_bottlenecks() { return kMaxN; }

// x [B,H,W,C1] -> out [B,H,W,C2], float32 NHWC, contiguous, 16-byte aligned. bank: the stages'
// slabs in the block's order (c3k2_bank_floats floats, 16-byte aligned); b holds 2 + 2n bias
// pointers: cv1_b, (m{i}_b1, m{i}_b2) for each i, cv2_b. C1, c, cb and C2 are multiples of 8 and
// 1 <= n <= 4 (checked by the caller).
int ymt_c3k2(const void* x, void* out, const void* bank, const void* const* b, int B, int H, int W, int C1, int c,
             int cb, int C2, int n, void* stream) {
  C3k2Params P{};
  const float* at = static_cast<const float*>(bank);
  for (int s = 0; s < stage_count(n); ++s) {
    int k, o;
    stage_shape(s, C1, c, cb, C2, n, k, o);
    P.bank[s] = at;
    at += stage_bank_floats(k, o);
  }
  int q = 0;
  P.cv1_b = static_cast<const float*>(b[q++]);
  for (int i = 0; i < n; ++i) {
    P.m_b1[i] = static_cast<const float*>(b[q++]);
    P.m_b2[i] = static_cast<const float*>(b[q++]);
  }
  P.cv2_b = static_cast<const float*>(b[q++]);

  // Two blocks an SM where their shared memory fits (registers capped at 128), else one (no cap).
  const int smem = smem_bytes(C1, c, cb, C2, n);
  auto kernel = 2 * (smem + 1024) <= kSmemPerSM ? c3k2_kernel<2> : c3k2_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's L1 as shared memory, so that two blocks fit where the widths allow
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_y = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_x * tiles_y, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), P, H, W, C1, c, cb, C2, n, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
