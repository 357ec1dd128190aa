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
// What bounds it on the H100: operations. At yolo-master-n's layers 2 and 5
// (C1 = 32/64, c = 16/32, cb = c/2, C2 = 64/128, n = 1) the block does 6400 or
// 25600 multiply-adds per pixel against 384 or 768 bytes of fp32 in and out:
// 33 flops per byte, above the fp32 CUDA-core ridge of 20 (67 TFLOP/s over
// 3.35 TB/s). Every product stays in fp32 on the CUDA cores (no TF32).
//
// What the design does about it: the TPU kernel keeps the whole [H,W,C] plane
// in VMEM (3.3 MB); a Hopper block has 227 KB. So each block computes one
// image's 8x16-pixel output tile, and everything in between stays in shared
// memory, never in device memory:
//   1. x over the tile plus a halo of 2n pixels (zeros outside the image);
//   2. cv1's y_b over that region and y_a over the tile;
//   3. per bottleneck, its hidden map a over a window one pixel smaller than
//      its input on each side, then h in place over a window one more pixel
//      smaller: after n bottlenecks the window is the tile;
//   4. cv2 over the concat [y_a, y_b, h_1 .. h_n] on the tile, to device memory.
// Every map that a 3x3 conv reads is zero outside the image (its SAME
// padding): a stage writes 0, not SiLU(bias), at a pixel outside the image.
// In each stage a warp owns 128 pixels (4 per lane, a pixel per lane per
// load, channel strides odd so the lanes hit distinct banks) and 8 (or 4)
// output channels, whose weights are warp-uniform float4 loads from L1/L2:
// 4 shared loads and 2 weight loads per 32 FMAs. The TPU kernel's selector
// matmuls and zero-padded row blocks multiply by identity and by zeros; this
// kernel reads the same weight dict but only its live rows (a compact form).
// Tensor cores and a pipelined schedule are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 8;
constexpr int kTW = 16;
constexpr int kTP = kTH * kTW;  // 128 tile pixels
constexpr int kMaxN = 4;        // bottlenecks
constexpr int kMaxSegs = kMaxN + 1;

enum Mode { kStore = 0, kAdd = 1, kGlobal = 2 };

// The weights of one block, as prepare_c3k2_weights lays them out.
struct C3k2Params {
  const float* cv1_w;          // [C1][2c]
  const float* cv1_b;          // [2c]
  const float* m_w1[kMaxN];    // [9][2c][cb]; rows lo .. lo+c are live (lo = c for bottleneck 0, else 0)
  const float* m_b1[kMaxN];    // [cb]
  const float* m_w2[kMaxN];    // [9][cb][c]
  const float* m_b2[kMaxN];    // [c]
  const float* cv2_w[kMaxSegs];  // [2c][C2] (cv2_y), then [2c][C2] per bottleneck (cv2_m{i}; rows 0 .. c live)
  const float* cv2_b;          // [C2]
};

// The input channels of one stage: segment s reads input channels
// off[s] .. off[s] + k[s] against weight rows w[s] + r * ldw.
struct Segs {
  int n;
  int off[kMaxSegs];
  int k[kMaxSegs];
  const float* w[kMaxSegs];
};

__device__ __forceinline__ Segs one_seg(int k, const float* w) {
  Segs s{};
  s.n = 1;
  s.off[0] = 0;
  s.k[0] = k;
  s.w[0] = w;
  return s;
}

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

// One conv stage over an oh x ow window of output pixels whose image origin is
// (gy0, gx0). Output pixel (y, x), channel o < O:
//   r = SiLU(bias[o] + sum over taps (dy, dx) < taps x taps, segments s, rows j < k[s] of
//            in[((y + dy) * ipitch + x + dx) * ics + off[s] + j] * w[s][t * tap_stride + j * ldw + o])
// `in` points at the input window's origin (one pixel up and left of the
// output window's for taps = 3). kStore writes r, or 0 outside the image;
// kAdd adds r inside the image; kGlobal writes r inside the image.
template <int kMode, int OX>
__device__ void conv_stage_ox(const float* in, int ipitch, int ics, int taps, const Segs& segs, int tap_stride,
                              int ldw, const float* __restrict__ bias, int O, int oh, int ow, int gy0, int gx0,
                              int H, int W, float* out, int opitch, int ocs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int npix = oh * ow;
  const int pgroups = (npix + 127) / 128;
  const int ogroups = O / OX;
  for (int item = warp; item < pgroups * ogroups; item += kWarps) {
    const int o0 = (item % ogroups) * OX;
    const int pbase = (item / ogroups) * 128 + lane;
    int py[4], px[4], ip[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = pbase + 32 * j;
      py[j] = p < npix ? p / ow : 0;
      px[j] = p < npix ? p % ow : 0;
      ip[j] = (py[j] * ipitch + px[j]) * ics;
    }
    float acc[4][OX];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < OX; ++q) acc[j][q] = 0.0f;

    for (int t = 0; t < taps * taps; ++t) {
      const int toff = ((t / taps) * ipitch + t % taps) * ics;
      for (int s = 0; s < segs.n; ++s) {
        const float* ws = segs.w[s] + t * tap_stride + o0;
        const float* is = in + toff + segs.off[s];
        const int ks = segs.k[s];
#pragma unroll 4
        for (int r = 0; r < ks; ++r) {
          float wv[OX];
          const float4 w0 = __ldg(reinterpret_cast<const float4*>(ws + r * ldw));
          wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
          if (OX == 8) {
            const float4 w1 = __ldg(reinterpret_cast<const float4*>(ws + r * ldw + 4));
            wv[OX - 4] = w1.x; wv[OX - 3] = w1.y; wv[OX - 2] = w1.z; wv[OX - 1] = w1.w;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float a = is[ip[j] + r];
#pragma unroll
            for (int q = 0; q < OX; ++q) acc[j][q] = fmaf(a, wv[q], acc[j][q]);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (pbase + 32 * j >= npix) continue;
      const int gy = gy0 + py[j], gx = gx0 + px[j];
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float* dst = out + (static_cast<size_t>(py[j]) * opitch + px[j]) * ocs + o0;
      if (kMode == kGlobal) {
        if (!inside) continue;
#pragma unroll
        for (int q = 0; q < OX; q += 4) {
          float r[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) r[u] = silu(acc[j][q + u] + __ldg(bias + o0 + q + u));
          *reinterpret_cast<float4*>(dst + q) = make_float4(r[0], r[1], r[2], r[3]);
        }
      } else if (kMode == kAdd) {
        if (!inside) continue;
#pragma unroll
        for (int q = 0; q < OX; ++q) dst[q] += silu(acc[j][q] + __ldg(bias + o0 + q));
      } else {
#pragma unroll
        for (int q = 0; q < OX; ++q) dst[q] = inside ? silu(acc[j][q] + __ldg(bias + o0 + q)) : 0.0f;
      }
    }
  }
}

// 8 output channels per warp item where that still gives every warp an item, else 4.
template <int kMode>
__device__ void conv_stage(const float* in, int ipitch, int ics, int taps, const Segs& segs, int tap_stride, int ldw,
                           const float* bias, int O, int oh, int ow, int gy0, int gx0, int H, int W, float* out,
                           int opitch, int ocs) {
  const int pgroups = (oh * ow + 127) / 128;
  if (O % 8 == 0 && pgroups * (O / 8) >= kWarps)
    conv_stage_ox<kMode, 8>(in, ipitch, ics, taps, segs, tap_stride, ldw, bias, O, oh, ow, gy0, gx0, H, W, out,
                            opitch, ocs);
  else
    conv_stage_ox<kMode, 4>(in, ipitch, ics, taps, segs, tap_stride, ldw, bias, O, oh, ow, gy0, gx0, H, W, out,
                            opitch, ocs);
}

// Copy h (c channels) on the tile from hs (region pitch RW, halo R) into cat's channels off .. off+c.
__device__ void tile_to_cat(const float* hs, int RW, int R, int hcs, int c, float* cat, int ccs, int off) {
  for (int q = threadIdx.x; q < kTP * c; q += kThreads) {
    const int p = q / c, ch = q % c;
    cat[p * ccs + off + ch] = hs[((p / kTW + R) * RW + p % kTW + R) * hcs + ch];
  }
}

struct Layout {
  int R, RH, RW, xcs, hcs, acs, ccs, region0, hs_floats, cat_floats;
};

__host__ __device__ Layout layout(int C1, int c, int cb, int n) {
  Layout L;
  L.R = 2 * n;
  L.RH = kTH + 2 * L.R;
  L.RW = kTW + 2 * L.R;
  L.xcs = C1 + 1;
  L.hcs = c + 1;
  L.acs = cb + 1;
  L.ccs = (2 + n) * c + 1;
  const int xs = L.RH * L.RW * L.xcs, as = (L.RH - 2) * (L.RW - 2) * L.acs;
  L.region0 = xs > as ? xs : as;  // x, then (once cv1 is done) a bottleneck's hidden map
  L.hs_floats = L.RH * L.RW * L.hcs;
  L.cat_floats = kTP * L.ccs;
  return L;
}

__global__ void __launch_bounds__(kThreads)
c3k2_kernel(const float* __restrict__ x, float* __restrict__ out, C3k2Params P, int H, int W, int C1, int c, int cb,
            int C2, int n, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(C1, c, cb, n);
  float* xs = smem;
  float* as = smem;
  float* hs = smem + L.region0;
  float* cat = hs + L.hs_floats;
  const int R = L.R, RH = L.RH, RW = L.RW;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const float* xb = x + static_cast<size_t>(b) * H * W * C1;

  // 1. x over the region, zeros outside the image
  const int c4n = C1 / 4;
  for (int q = threadIdx.x; q < RH * RW * c4n; q += kThreads) {
    const int pix = q / c4n, c4 = q % c4n;
    const int gy = ty0 - R + pix / RW, gx = tx0 - R + pix % RW;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __ldg(reinterpret_cast<const float4*>(xb + (static_cast<size_t>(gy) * W + gx) * C1) + c4);
    float* d = xs + pix * L.xcs + 4 * c4;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();

  // 2. cv1: y_b over the region -> hs, y_a over the tile -> cat[:, 0:c]
  conv_stage<kStore>(xs, RW, L.xcs, 1, one_seg(C1, P.cv1_w + c), 0, 2 * c, P.cv1_b + c, c, RH, RW, ty0 - R, tx0 - R,
                     H, W, hs, RW, L.hcs);
  conv_stage<kStore>(xs + (R * RW + R) * L.xcs, RW, L.xcs, 1, one_seg(C1, P.cv1_w), 0, 2 * c, P.cv1_b, c, kTH, kTW,
                     ty0, tx0, H, W, cat, kTW, L.ccs);
  __syncthreads();
  tile_to_cat(hs, RW, R, L.hcs, c, cat, L.ccs, c);

  // 3. the bottlenecks; h_i's window has a halo of R - 2i pixels
  for (int i = 0; i < n; ++i) {
    const int h1 = R - 2 * i - 1, oh1 = kTH + 2 * h1, ow1 = kTW + 2 * h1;
    const int lo = i == 0 ? c : 0;
    conv_stage<kStore>(hs + (2 * i * RW + 2 * i) * L.hcs, RW, L.hcs, 3, one_seg(c, P.m_w1[i] + lo * cb),
                       2 * c * cb, cb, P.m_b1[i], cb, oh1, ow1, ty0 - h1, tx0 - h1, H, W, as, ow1, L.acs);
    __syncthreads();
    const int h2 = h1 - 1;
    conv_stage<kAdd>(as, ow1, L.acs, 3, one_seg(cb, P.m_w2[i]), cb * c, c, P.m_b2[i], c, kTH + 2 * h2, kTW + 2 * h2,
                     ty0 - h2, tx0 - h2, H, W, hs + ((R - h2) * RW + R - h2) * L.hcs, RW, L.hcs);
    __syncthreads();
    tile_to_cat(hs, RW, R, L.hcs, c, cat, L.ccs, (2 + i) * c);
  }
  __syncthreads();

  // 4. cv2 over the concat, one weight segment per piece of it, to device memory
  Segs segs{};
  segs.n = n + 1;
  segs.off[0] = 0;
  segs.k[0] = 2 * c;
  segs.w[0] = P.cv2_w[0];
  for (int i = 0; i < n; ++i) {
    segs.off[i + 1] = (2 + i) * c;
    segs.k[i + 1] = c;
    segs.w[i + 1] = P.cv2_w[i + 1];
  }
  conv_stage<kGlobal>(cat, kTW, L.ccs, 1, segs, 0, C2, P.cv2_b, C2, kTH, kTW, ty0, tx0, H, W,
                      out + ((static_cast<size_t>(b) * H + ty0) * W + tx0) * C2, W, C2);
}

int smem_bytes(int C1, int c, int cb, int n) {
  const Layout L = layout(C1, c, cb, n);
  return static_cast<int>(sizeof(float)) * (L.region0 + L.hs_floats + L.cat_floats);
}

}  // namespace

extern "C" {

// Shared memory one block needs.
int c3k2_smem_bytes(int C1, int c, int cb, int n) { return smem_bytes(C1, c, cb, n); }

int c3k2_max_bottlenecks() { return kMaxN; }

// x [B,H,W,C1] -> out [B,H,W,C2], float32 NHWC, contiguous, 16-byte aligned.
// w holds 4 + 5n pointers in the order cv1_w, cv1_b, (m{i}_w1, m{i}_b1,
// m{i}_w2, m{i}_b2) for each i, cv2_y, cv2_m{i} for each i, cv2_b. C1, c, cb
// and C2 are multiples of 4 and 1 <= n <= 4 (checked by the caller).
int ymt_c3k2(const void* x, void* out, const void* const* w, int B, int H, int W, int C1, int c, int cb, int C2,
             int n, void* stream) {
  C3k2Params P{};
  int q = 0;
  P.cv1_w = static_cast<const float*>(w[q++]);
  P.cv1_b = static_cast<const float*>(w[q++]);
  for (int i = 0; i < n; ++i) {
    P.m_w1[i] = static_cast<const float*>(w[q++]);
    P.m_b1[i] = static_cast<const float*>(w[q++]);
    P.m_w2[i] = static_cast<const float*>(w[q++]);
    P.m_b2[i] = static_cast<const float*>(w[q++]);
  }
  for (int i = 0; i <= n; ++i) P.cv2_w[i] = static_cast<const float*>(w[q++]);
  P.cv2_b = static_cast<const float*>(w[q++]);

  const int smem = smem_bytes(C1, c, cb, n);
  cudaError_t err = cudaFuncSetAttribute(c3k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_y = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_x * tiles_y, B);
  c3k2_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), P, H, W, C1, c, cb, C2, n, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
