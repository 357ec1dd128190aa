// Fused dense ES_MOE block: E depthwise-separable experts, their routed mix
// and the output norm, in one kernel.
//
// Replaces: yolo_master_tpu/ops/pallas_esmoe.py:fused_esmoe (the whole-plane
// Pallas kernel behind nn/moe/es_moe.py:PallasESMOE).
//
// Computes, for one image b, every pixel p and output channel o:
//   d_e[p,c] = sum over expert e's own k_e x k_e taps of x[p+t, c] * dw[e,t,c]
//              (SAME zero padding; the bank is centre-padded to kmax)
//   z_e[p,o] = sum_c d_e[p,c] * pw[e,c,o] + pb[e,o]          (expert BN folded)
//   y[p,o]   = sum_e w[b,e] * SiLU(z_e[p,o])
//   out[p,o] = SiLU(gamma[o] * y[p,o] + beta[o])              (norm BN folded)
// x is NHWC float32, out NHWC float32; w [B,E] comes from the routing MLP,
// which stays in PyTorch.
//
// What bounds it on the H100: operations. At yolo-master-n's four
// placements (C = O = 64/128/128/256 at 160/80/40/20 px, E = 3, k = 3/5/7)
// the block does ~1.0 G multiply-adds per image, 0.8 G of them pointwise,
// against ~22 MB of fp32 in and out: ~90 flops per byte, far above the fp32
// CUDA-core ridge (67 TFLOP/s over 3.35 TB/s = 20 flops per byte). Every
// product stays in fp32 on the CUDA cores (no TF32), so the result matches
// the plain fp32 version to rounding.
//
// What the design does about it: the TPU kernel holds a whole [H,W,C] plane
// in VMEM (up to 6.5 MB); a Hopper block has 227 KB. So one block owns one
// (image, 8x16-pixel tile, 64-output-channel slice) and walks the experts,
// and for each expert the input channels in chunks of 32:
//   1. the chunk's tile plus expert e's halo of (k_e-1)/2 pixels is copied to
//      shared memory with float4 loads, zeros outside the image (the SAME
//      padding), together with the 32x64 slice of pw_e;
//   2. each thread computes the depthwise taps of one channel along one tile
//      row (16 pixels) from a register window, k_e + 15 shared loads per
//      16 k_e multiply-adds, into a [128 px][32 ch] shared tile;
//   3. each thread accumulates a 4-pixel x 8-output block of the pointwise
//      product in registers (4 scalar + 2 float4 shared loads per 32 FMAs).
// After the last chunk of expert e, z_e + pb gets SiLU and is mixed into the
// register accumulator y with w[b,e]; the output norm and SiLU are applied on
// the store. Nothing but x (once per expert, mostly from L2), the weights and
// the output touch device memory. Tensor cores (TF32/bf16 wgmma) and a
// persistent, pipelined schedule are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kPix = kTileH * kTileW;  // 128 pixels per block
constexpr int kCC = 32;                // input channels per chunk
constexpr int kOT = 64;                // output channels per block
constexpr int kDStride = kCC + 1;      // padded pixel stride of the depthwise tile (no bank conflicts)
constexpr int kMaxExperts = 8;
constexpr int kMaxKernel = 15;

struct KernelSizes {
  int k[kMaxExperts];
};

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

// Output channel (within the block's 64) of a thread's j-th accumulator: two
// float4 runs, 4*og and 32 + 4*og, so that the 8 threads of a quarter warp read
// 32 consecutive floats of the pw tile per 128-bit load (no bank conflicts).
__device__ __forceinline__ int out_offset(int og, int j) { return 4 * og + (j & 3) + 32 * (j >> 2); }

// Depthwise taps of channel `c` (of the chunk) along tile row `row`, for a
// K x K expert: xs holds the chunk's tile with this expert's halo, `pitch`
// pixels per row; dwk points at tap (0, 0) of the expert's kernel in the
// centre-padded bank [kmax, kmax, C], channel `cg` of the whole tensor.
template <int K>
__device__ __forceinline__ void depthwise_row(const float* xs, int pitch, int row, int c, const float* dwk,
                                              int kmax, int C, int cg, float* ds) {
  float acc[kTileW];
#pragma unroll
  for (int j = 0; j < kTileW; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int dr = 0; dr < K; ++dr) {
    float v[kTileW + K - 1];
    const float* src = xs + (row + dr) * pitch * kCC + c;
#pragma unroll
    for (int j = 0; j < kTileW + K - 1; ++j) v[j] = src[j * kCC];
#pragma unroll
    for (int dc = 0; dc < K; ++dc) {
      const float wt = cg < C ? __ldg(dwk + (dr * kmax + dc) * C + cg) : 0.0f;
#pragma unroll
      for (int j = 0; j < kTileW; ++j) acc[j] = fmaf(v[j + dc], wt, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kTileW; ++j) ds[(row * kTileW + j) * kDStride + c] = acc[j];
}

__global__ void __launch_bounds__(kThreads)
fused_esmoe_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ dw,
                   const float* __restrict__ pw, const float* __restrict__ pb, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ out, int H, int W, int C, int O, int E,
                   int kmax, KernelSizes ks, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hmax = (kmax - 1) / 2;
  const int pitch = kTileW + 2 * hmax;  // pixels per row of the halo tile
  float* xs = smem;                                    // [kTileH + 2 hmax][pitch][kCC]
  float* ds = xs + (kTileH + 2 * hmax) * pitch * kCC;  // [kPix][kDStride]
  float* ps = ds + kPix * kDStride;                    // [kCC][kOT]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int o0 = blockIdx.y * kOT;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW;
  const float* xb = x + static_cast<size_t>(b) * H * W * C;

  const int og = tid & 7;     // pointwise: outputs o0 + out_offset(og, j), j < 8
  const int pg = tid >> 3;    // pointwise: tile pixels 4*pg .. +4
  const int dch = tid & 31;   // depthwise: chunk channel
  const int drow = tid >> 5;  // depthwise: tile row

  float y[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) y[i][j] = 0.0f;

  for (int e = 0; e < E; ++e) {
    const int k = ks.k[e];
    const int he = (k - 1) / 2;
    const int off = hmax - he;
    const float* dwk = dw + (static_cast<size_t>(e * kmax + off) * kmax + off) * C;
    const float* pwe = pw + static_cast<size_t>(e) * C * O;
    const int rows = kTileH + 2 * he, cols = kTileW + 2 * he;

    float z[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) z[i][j] = 0.0f;

    for (int c0 = 0; c0 < C; c0 += kCC) {
      __syncthreads();  // the previous chunk's readers are done with xs, ds and ps
      for (int q = tid; q < rows * cols * (kCC / 4); q += kThreads) {
        const int c4 = q % (kCC / 4);
        const int pix = q / (kCC / 4);
        const int r = pix / cols, cc = pix % cols;
        const int gy = ty0 - he + r, gx = tx0 - he + cc, gc = c0 + 4 * c4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
          v = __ldg(reinterpret_cast<const float4*>(xb + (static_cast<size_t>(gy) * W + gx) * C + gc));
        *reinterpret_cast<float4*>(xs + (r * pitch + cc) * kCC + 4 * c4) = v;
      }
      for (int q = tid; q < kCC * kOT / 4; q += kThreads) {
        const int cr = q / (kOT / 4), o4 = q % (kOT / 4);
        const int gc = c0 + cr, go = o0 + 4 * o4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (gc < C && go < O) v = __ldg(reinterpret_cast<const float4*>(pwe + static_cast<size_t>(gc) * O + go));
        *reinterpret_cast<float4*>(ps + cr * kOT + 4 * o4) = v;
      }
      __syncthreads();

      const int cg = c0 + dch;
      switch (k) {
        case 3: depthwise_row<3>(xs, pitch, drow, dch, dwk, kmax, C, cg, ds); break;
        case 5: depthwise_row<5>(xs, pitch, drow, dch, dwk, kmax, C, cg, ds); break;
        case 7: depthwise_row<7>(xs, pitch, drow, dch, dwk, kmax, C, cg, ds); break;
        case 9: depthwise_row<9>(xs, pitch, drow, dch, dwk, kmax, C, cg, ds); break;
        case 11: depthwise_row<11>(xs, pitch, drow, dch, dwk, kmax, C, cg, ds); break;
        case 13: depthwise_row<13>(xs, pitch, drow, dch, dwk, kmax, C, cg, ds); break;
        default: depthwise_row<15>(xs, pitch, drow, dch, dwk, kmax, C, cg, ds); break;
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < kCC; ++c) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ds[(4 * pg + i) * kDStride + c];
        const float4 b0 = *reinterpret_cast<const float4*>(ps + c * kOT + out_offset(og, 0));
        const float4 b1 = *reinterpret_cast<const float4*>(ps + c * kOT + out_offset(og, 4));
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) z[i][j] = fmaf(a[i], bv[j], z[i][j]);
      }
    }

    const float we = w[b * E + e];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + out_offset(og, j);
      const float bias = o < O ? pb[e * O + o] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i][j] = fmaf(we, silu(z[i][j] + bias), y[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = 4 * pg + i;
    const int py = ty0 + p / kTileW, px = tx0 + p % kTileW;
    if (py >= H || px >= W) continue;
    float* dst = out + ((static_cast<size_t>(b) * H + py) * W + px) * O;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + out_offset(og, 4 * h);
      if (o >= O) continue;  // O is a multiple of 4: a float4 is wholly in or out
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = silu(fmaf(gamma[o + j], y[i][4 * h + j], beta[o + j]));
      *reinterpret_cast<float4*>(dst + o) = make_float4(r[0], r[1], r[2], r[3]);
    }
  }
}

int smem_bytes(int kmax) {
  const int hmax = (kmax - 1) / 2;
  return static_cast<int>(sizeof(float)) *
         ((kTileH + 2 * hmax) * (kTileW + 2 * hmax) * kCC + kPix * kDStride + kCC * kOT);
}

}  // namespace

extern "C" {

// Shared memory one block needs for the largest kernel size kmax.
int esmoe_smem_bytes(int kmax) { return smem_bytes(kmax); }

int esmoe_max_experts() { return kMaxExperts; }

int esmoe_max_kernel() { return kMaxKernel; }

// x [B,H,W,C], w [B,E], dw [E,kmax,kmax,C], pw [E,C,O], pb [E,O], gamma [O],
// beta [O] -> out [B,H,W,O]; all float32, contiguous, 16-byte aligned, C and
// O multiples of 4, ks[e] odd in 3..15, E <= 8 (checked by the caller).
int ymt_fused_esmoe(const void* x, const void* w, const void* dw, const void* pw, const void* pb,
                    const void* gamma, const void* beta, void* out, int B, int H, int W, int C, int O, int E,
                    const int* ks, void* stream) {
  KernelSizes sizes{};
  int kmax = 1;
  for (int e = 0; e < E; ++e) {
    sizes.k[e] = ks[e];
    kmax = ks[e] > kmax ? ks[e] : kmax;
  }
  const int smem = smem_bytes(kmax);
  cudaError_t err = cudaFuncSetAttribute(fused_esmoe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_x * tiles_y, (O + kOT - 1) / kOT, B);
  fused_esmoe_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(dw),
      static_cast<const float*>(pw), static_cast<const float*>(pb), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(out), H, W, C, O, E, kmax, sizes, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
