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
// What the design does about it: each block owns an 8x16 tile of conv1
// outputs. It stages the uint8 input tile with its halo (35x67x3) and both
// weight sets in shared memory, computes the 17x33xc0 conv0 tile (with the
// one-row/one-column halo conv1 needs) into shared memory, and only conv1's
// output goes to device memory. conv0 positions outside [0,H/2)x[0,W/2) are
// stored as 0: they are conv1's zero padding, not SiLU(b0). The halo costs
// 10% extra conv0 work. Each thread accumulates 8 output channels (conv1: of
// two positions) in registers from float4 weight loads, so one shared-memory
// load feeds 4-8 FMAs; the conv0 tile's odd per-position stride keeps the
// stride-2 reads free of bank conflicts. Plain fp32 FMAs on the CUDA cores;
// no tensor cores (fp32 has none but TF32), TMA or pipelining yet.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" long long stem_smem_floats(int c0, int c1);

namespace {

constexpr int kTH = 8;               // conv1 output rows per block
constexpr int kTW = 16;              // conv1 output cols per block
constexpr int kC0H = 2 * kTH + 1;    // conv0 rows per block (17)
constexpr int kC0W = 2 * kTW + 1;    // conv0 cols per block (33)
constexpr int kInH = 4 * kTH + 3;    // input rows per block (35)
constexpr int kInW = 4 * kTW + 3;    // input cols per block (67)
constexpr int kCin = 3;
constexpr int kThreads = 256;

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

// x [B,H,W,3]; w0 [3,3,3,c0] (kh,kw,cin,c0); w1 [3,3,c0,c1]; out [B,H/4,W/4,c1].
// c0 and c1 are multiples of 8: each thread computes 8 output channels at a
// time from float4 weight loads, so a shared-memory load feeds 4-8 FMAs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const float* __restrict__ w0, const float* __restrict__ b0,
            const float* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ out,
            int H, int W, int c0, int c1) {
  extern __shared__ __align__(16) float smem[];
  const int cp = c0 | 1;                       // odd per-position stride of the conv0 tile:
                                               // stride-2 position reads hit distinct banks
  float* s_w1 = smem;                          // 9 * c0 * c1, 16-byte aligned
  float* s_w0 = s_w1 + 9 * c0 * c1;            // 9 * kCin * c0
  float* s_b0 = s_w0 + 9 * kCin * c0;          // c0
  float* s_b1 = s_b0 + c0;                     // c1
  float* s_in = s_b1 + c1;                     // kInH * kInW * kCin
  float* s_c0 = s_in + kInH * kInW * kCin;     // kC0H * kC0W * cp

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTH;
  const int ox0 = blockIdx.x * kTW;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;

  for (int i = tid; i < 9 * c0 * c1; i += kThreads) s_w1[i] = w1[i];
  for (int i = tid; i < 9 * kCin * c0; i += kThreads) s_w0[i] = w0[i];
  for (int i = tid; i < c0; i += kThreads) s_b0[i] = b0[i];
  for (int i = tid; i < c1; i += kThreads) s_b1[i] = b1[i];

  // Input tile: image rows 4*oy0-3 .. 4*oy0+4*kTH-1, zero outside the image
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

  // conv1: output (oy0+ty, ox0+tx) reads conv0 tile rows 2ty..2ty+2.
  // One work item: positions (ty, tx) and (ty, tx + kTW/2), 8 output channels;
  // per input channel, 2 conv0 loads and 2 float4 weight loads feed 16 FMAs.
  const int oct1 = c1 / 8;
  float* ob = out + static_cast<size_t>(b) * H4 * W4 * c1;
  for (int u = tid; u < (kTH * kTW / 2) * oct1; u += kThreads) {
    const int o = 8 * (u % oct1);
    const int pp = u / oct1;
    const int tx = pp % (kTW / 2), ty = pp / (kTW / 2);
    float acc0[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float acc1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float* pa = s_c0 + ((2 * ty + kh) * kC0W + (2 * tx + kw)) * cp;
        const float* pb = pa + kTW * cp;  // the second position, kTW/2 outputs = kTW conv0 columns right
        const float* pw = s_w1 + (kh * 3 + kw) * c0 * c1 + o;
#pragma unroll 4
        for (int ic = 0; ic < c0; ++ic) {
          const float4 wa = load4(pw + ic * c1), wb = load4(pw + ic * c1 + 4);
          fma8(acc0, pa[ic], wa, wb);
          fma8(acc1, pb[ic], wa, wb);
        }
      }
    }
    const int oy = oy0 + ty, ox = ox0 + tx;
    if (oy >= H4) continue;
    float* dst = ob + (static_cast<size_t>(oy) * W4 + ox) * c1 + o;
    if (ox < W4) store_silu8(dst, acc0, s_b1 + o);
    if (ox + kTW / 2 < W4) store_silu8(dst + (kTW / 2) * c1, acc1, s_b1 + o);
  }
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* w1, const void* b1, void* out,
           int B, int H, int W, int c0, int c1, void* stream) {
  const size_t smem = stem_smem_floats(c0, c1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int H4 = H / 4, W4 = W / 4;
  dim3 grid((W4 + kTW - 1) / kTW, (H4 + kTH - 1) / kTH, B);
  stem_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<float*>(out), H, W, c0, c1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in floats (the wrapper checks it against the card's limit).
long long stem_smem_floats(int c0, int c1) {
  return 9LL * c0 * c1 + 9LL * kCin * c0 + c0 + c1 + static_cast<long long>(kInH) * kInW * kCin +
         static_cast<long long>(kC0H) * kC0W * (c0 | 1);
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
