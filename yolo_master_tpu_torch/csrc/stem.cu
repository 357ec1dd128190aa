// Fused detector stem: conv0 (3->c0, k3 s2 p1) + bias + SiLU, then
// conv1 (c0->c1, k3 s2 p1) + bias + SiLU, in one pass over the letterboxed
// uint8 NHWC image. BatchNorm and the /255 input scale are folded into the
// weights by the caller (yolo_master_tpu_torch/utils/fuse.py).
//
// Replaces: yolo_master_tpu/ops/pallas_stem.py:fused_stem (the TPU kernel
// _make_stem_kernel, which reads a space-to-depth(4) blob because the TPU
// cannot stride inside a kernel; here the image is read as it is).
//
// What bounds it on the H100: fp32 arithmetic and shared-memory bandwidth,
// not device memory. Per 640x640 image it reads 1.2 MB of uint8 and writes
// 3.3 MB of fp32 [160,160,32] (~1.3 us at 3.35 TB/s), against ~0.32 GFLOP
// of fp32 FMAs on the CUDA cores (~4.8 us at the 67 TFLOP/s fp32 peak).
// Unfused, the 320x320x16 fp32 conv0 activation (6.6 MB) would also be
// written and read back, and the image read as fp32.
//
// What the design does about it: each block owns a TH x TW tile of conv1
// outputs. It stages the uint8 input tile with its halo ((4TH+3)x(4TW+3)x3),
// conv0's weights and a slice of conv1's in shared memory, computes the
// (2TH+1)x(2TW+1)xc0 conv0 tile (with the one-row/one-column halo conv1
// needs) into shared memory, and only conv1's output goes to device memory.
// conv0 positions outside [0,H/2)x[0,W/2) are stored as 0: they are conv1's
// zero padding, not SiLU(b0). Each thread accumulates 8 output channels of
// one or two positions in registers from float4 weight loads, so one
// shared-memory load feeds 4-16 FMAs; the conv0 tile's odd per-position
// stride keeps the stride-2 reads free of bank conflicts. Plain fp32 FMAs on
// the CUDA cores; no tensor cores (fp32 has none but TF32), TMA or
// pipelining yet.
//
// The block's layout is a function of the widths (stem_plan, below, which
// the wrapper and the launch both read). Where it fits, an 8x16 tile with
// all of w1 resident and two positions per thread (scales n and s). Wider
// stems (c0/c1 = 64/128 at m and l, 96/192 at x) cannot hold all of w1 (up to
// 663 KB) beside the conv0 tile: the block then loops over slices of conv1's
// output channels, reloading only the w1 slice and reusing the conv0 tile,
// and the tile shrinks to 8x8 where c0 is wide. Of the plans that fit, the
// one with the most conv1 work per slice (tile area x slice width) wins.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 3;
constexpr int kThreads = 256;
constexpr long long kSmemLimitBytes = 232448;  // shared memory one Hopper block may use (227 KB)

// One block's layout: a th x tw tile of conv1 outputs, conv1's output
// channels in slices of c1s, `pairs` positions per thread work item.
struct StemPlan {
  int th, tw, c1s, pairs;
};

long long plan_floats(int c0, int c1, const StemPlan& p) {
  const long long in_tile = static_cast<long long>(4 * p.th + 3) * (4 * p.tw + 3) * kCin;
  const long long c0_tile = static_cast<long long>(2 * p.th + 1) * (2 * p.tw + 1) * (c0 | 1);
  return 9LL * c0 * p.c1s + 9LL * kCin * c0 + c0 + c1 + in_tile + c0_tile;
}

// The 8x16 tile with all of w1 if it fits; else, over the tiles 8x16 and 8x8
// and the slices of c1 that are multiples of 8 and divide it, the fitting
// plan with the largest tile area x slice (the larger tile on ties). If none
// fits, the smallest plan, which the wrapper then refuses.
StemPlan stem_plan(int c0, int c1) {
  const StemPlan whole{8, 16, c1, 2};
  if (plan_floats(c0, c1, whole) * 4 <= kSmemLimitBytes) return whole;
  const int tiles[2][2] = {{8, 16}, {8, 8}};
  StemPlan best{8, 8, 8, 1};
  long long best_work = 0;
  for (const auto& t : tiles) {
    for (int s = c1; s >= 8; s -= 8) {  // the widest slice that fits this tile
      const StemPlan p{t[0], t[1], s, 1};
      if (c1 % s || plan_floats(c0, c1, p) * 4 > kSmemLimitBytes) continue;
      const long long work = static_cast<long long>(t[0]) * t[1] * s;
      if (work > best_work) {
        best = p;
        best_work = work;
      }
      break;
    }
  }
  return best;
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float to_float(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// 8 fp32 FMAs: acc[j] += v * w[j] for the 8 weights in (wa, wb).
__device__ __forceinline__ void fma8(float* acc, float v, const float4& wa, const float4& wb) {
  acc[0] += v * wa.x;
  acc[1] += v * wa.y;
  acc[2] += v * wa.z;
  acc[3] += v * wa.w;
  acc[4] += v * wb.x;
  acc[5] += v * wb.y;
  acc[6] += v * wb.z;
  acc[7] += v * wb.w;
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// dst[0:8] = silu(acc + bias), as two 16-byte stores.
__device__ __forceinline__ void store_silu8(float* dst, const float* acc, const float* bias) {
  float4 lo, hi;
  lo.x = silu(acc[0] + bias[0]);
  lo.y = silu(acc[1] + bias[1]);
  lo.z = silu(acc[2] + bias[2]);
  lo.w = silu(acc[3] + bias[3]);
  hi.x = silu(acc[4] + bias[4]);
  hi.y = silu(acc[5] + bias[5]);
  hi.z = silu(acc[6] + bias[6]);
  hi.w = silu(acc[7] + bias[7]);
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

// s_w1[(k * c0 + ic) * c1s + j] = w1[(k * c0 + ic) * c1 + s0 + j]: one slice of conv1's output channels
// (all of w1, copied as it lies, when the slice is the whole of c1).
__device__ __forceinline__ void stage_w1_slice(float* s_w1, const float* __restrict__ w1, int c0, int c1, int c1s,
                                               int s0) {
  if (c1s == c1) {
    for (int i = threadIdx.x; i < 9 * c0 * c1; i += kThreads) s_w1[i] = w1[i];
    return;
  }
  for (int i = threadIdx.x; i < 9 * c0 * c1s; i += kThreads) {
    const int j = i % c1s, row = i / c1s;
    s_w1[i] = w1[static_cast<size_t>(row) * c1 + s0 + j];
  }
}

// x [B,H,W,3]; w0 [3,3,3,c0] (kh,kw,cin,c0); w1 [3,3,c0,c1]; out [B,H/4,W/4,c1].
// c0, c1 and c1s are multiples of 8: each thread computes 8 output channels
// at a time from float4 weight loads. TH x TW is the conv1 tile; P the
// positions per work item (2: (ty, tx) and (ty, tx + TW/2)).
template <typename T, int TH, int TW, int P>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const float* __restrict__ w0, const float* __restrict__ b0,
            const float* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ out,
            int H, int W, int c0, int c1, int c1s) {
  constexpr int kC0H = 2 * TH + 1;  // conv0 rows per block
  constexpr int kC0W = 2 * TW + 1;  // conv0 cols per block
  constexpr int kInH = 4 * TH + 3;  // input rows per block
  constexpr int kInW = 4 * TW + 3;  // input cols per block
  constexpr int kPW = TW / P;       // work items across a tile row
  extern __shared__ __align__(16) float smem[];
  const int cp = c0 | 1;                       // odd per-position stride of the conv0 tile:
                                               // stride-2 position reads hit distinct banks
  float* s_w1 = smem;                          // 9 * c0 * c1s, 16-byte aligned
  float* s_w0 = s_w1 + 9 * c0 * c1s;           // 9 * kCin * c0
  float* s_b0 = s_w0 + 9 * kCin * c0;          // c0
  float* s_b1 = s_b0 + c0;                     // c1
  float* s_in = s_b1 + c1;                     // kInH * kInW * kCin
  float* s_c0 = s_in + kInH * kInW * kCin;     // kC0H * kC0W * cp

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TW;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;

  stage_w1_slice(s_w1, w1, c0, c1, c1s, 0);
  for (int i = tid; i < 9 * kCin * c0; i += kThreads) s_w0[i] = w0[i];
  for (int i = tid; i < c0; i += kThreads) s_b0[i] = b0[i];
  for (int i = tid; i < c1; i += kThreads) s_b1[i] = b1[i];

  // Input tile: image rows 4*oy0-3 .. 4*oy0+4*TH-1, zero outside the image
  // (conv0's own padding). Consecutive threads read consecutive bytes.
  const int iy0 = 4 * oy0 - 3, ix0 = 4 * ox0 - 3;
  const T* xb = x + static_cast<size_t>(b) * H * W * kCin;
  for (int i = tid; i < kInH * kInW * kCin; i += kThreads) {
    const int c = i % kCin;
    const int col = (i / kCin) % kInW;
    const int row = i / (kCin * kInW);
    const int gy = iy0 + row, gx = ix0 + col;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_float(xb[(static_cast<size_t>(gy) * W + gx) * kCin + c]);
    s_in[i] = v;
  }
  __syncthreads();

  // conv0 on conv1's padded grid: tile position (r, q) is conv0 pixel
  // (2*oy0-1+r, 2*ox0-1+q); its 3x3 window starts at input tile (2r, 2q).
  // One work item: one position, 8 output channels.
  const int oct0 = c0 / 8;
  const int cy0 = 2 * oy0 - 1, cx0 = 2 * ox0 - 1;
  for (int u = tid; u < kC0H * kC0W * oct0; u += kThreads) {
    const int o = 8 * (u % oct0);
    const int pos = u / oct0;
    const int q = pos % kC0W, r = pos / kC0W;
    const int I = cy0 + r, J = cx0 + q;
    float* dst = s_c0 + pos * cp + o;
    if (I < 0 || I >= H2 || J < 0 || J >= W2) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = 0.0f;
      continue;
    }
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float* px = s_in + ((2 * r + kh) * kInW + (2 * q + kw)) * kCin;
        const float* pw = s_w0 + (kh * 3 + kw) * kCin * c0 + o;
#pragma unroll
        for (int c = 0; c < kCin; ++c) fma8(acc, px[c], load4(pw + c * c0), load4(pw + c * c0 + 4));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = silu(acc[j] + s_b0[o + j]);
  }
  __syncthreads();

  // conv1, one slice of c1s output channels at a time (one slice when all of
  // w1 fits): output (oy0+ty, ox0+tx) reads conv0 tile rows 2ty..2ty+2. One
  // work item: P positions (ty, tx + p * TW/P), 8 output channels; per input
  // channel, P conv0 loads and 2 float4 weight loads feed 8P FMAs.
  const int oct1 = c1s / 8;
  float* ob = out + static_cast<size_t>(b) * H4 * W4 * c1;
  for (int s0 = 0; s0 < c1; s0 += c1s) {
    if (s0 > 0) {
      __syncthreads();  // every thread is done with the previous slice
      stage_w1_slice(s_w1, w1, c0, c1, c1s, s0);
      __syncthreads();
    }
    for (int u = tid; u < TH * kPW * oct1; u += kThreads) {
      const int o = 8 * (u % oct1);
      const int pp = u / oct1;
      const int tx = pp % kPW, ty = pp / kPW;
      float acc[P][8];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[p][j] = 0.0f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float* pa = s_c0 + ((2 * ty + kh) * kC0W + (2 * tx + kw)) * cp;
          const float* pw = s_w1 + (kh * 3 + kw) * c0 * c1s + o;
#pragma unroll 4
          for (int ic = 0; ic < c0; ++ic) {
            const float4 wa = load4(pw + ic * c1s), wb = load4(pw + ic * c1s + 4);
#pragma unroll
            for (int p = 0; p < P; ++p) fma8(acc[p], pa[p * 2 * kPW * cp + ic], wa, wb);  // kPW outputs: 2*kPW columns
          }
        }
      }
      const int oy = oy0 + ty;
      if (oy >= H4) continue;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int ox = ox0 + tx + p * kPW;
        if (ox < W4) store_silu8(ob + (static_cast<size_t>(oy) * W4 + ox) * c1 + s0 + o, acc[p], s_b1 + s0 + o);
      }
    }
  }
}

template <typename T, int TH, int TW, int P>
int launch_plan(const void* x, const void* w0, const void* b0, const void* w1, const void* b1, void* out, int B,
                int H, int W, int c0, int c1, int c1s, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_kernel<T, TH, TW, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int H4 = H / 4, W4 = W / 4;
  dim3 grid((W4 + TW - 1) / TW, (H4 + TH - 1) / TH, B);
  stem_kernel<T, TH, TW, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<float*>(out), H, W, c0, c1, c1s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* w1, const void* b1, void* out,
           int B, int H, int W, int c0, int c1, void* stream) {
  const StemPlan p = stem_plan(c0, c1);
  const size_t smem = plan_floats(c0, c1, p) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimitBytes)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.pairs == 2) return launch_plan<T, 8, 16, 2>(x, w0, b0, w1, b1, out, B, H, W, c0, c1, p.c1s, smem, s);
  if (p.tw == 16) return launch_plan<T, 8, 16, 1>(x, w0, b0, w1, b1, out, B, H, W, c0, c1, p.c1s, smem, s);
  return launch_plan<T, 8, 8, 1>(x, w0, b0, w1, b1, out, B, H, W, c0, c1, p.c1s, smem, s);
}

}  // namespace

extern "C" {

// Shared memory one block needs, in floats (the wrapper checks it against the card's limit).
long long stem_smem_floats(int c0, int c1) { return plan_floats(c0, c1, stem_plan(c0, c1)); }

// The block's layout for these widths: {conv1 tile rows, tile cols, c1 slice, positions per work item}.
void stem_plan_of(int c0, int c1, int* plan) {
  const StemPlan p = stem_plan(c0, c1);
  plan[0] = p.th;
  plan[1] = p.tw;
  plan[2] = p.c1s;
  plan[3] = p.pairs;
}

int ymt_stem_u8(const void* x, const void* w0, const void* b0, const void* w1, const void* b1, void* out,
                int B, int H, int W, int c0, int c1, void* stream) {
  return launch<uint8_t>(x, w0, b0, w1, b1, out, B, H, W, c0, c1, stream);
}

int ymt_stem_f32(const void* x, const void* w0, const void* b0, const void* w1, const void* b1, void* out,
                 int B, int H, int W, int c0, int c1, void* stream) {
  return launch<float>(x, w0, b0, w1, b1, out, B, H, W, c0, c1, stream);
}

}  // extern "C"
