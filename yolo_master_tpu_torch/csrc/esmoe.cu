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
// x and out are NHWC, both float32 (the fp32 path) or both bfloat16 (the
// bf16 path); the weights are float32 in both and the block computes in fp32,
// as the TPU kernel widens x and its weights. w [B,E] (float32) comes from the
// routing MLP, which stays in PyTorch.
//
// What bounds it on the H100: the depthwise stage's fp32 work on the CUDA
// cores, then bytes. At yolo-master-n's four placements (C = O = 64/128/128/256
// at 160/80/40/20 px, E = 3, k = 3/5/7) the block does ~1.0 G multiply-adds
// per image, 0.8 G of them in the pointwise product, against ~22 MB of fp32 in
// and out. The pointwise product runs on the tensor cores (495 TFLOP/s in
// TF32), where it costs less than moving the bytes; the depthwise taps, bias,
// SiLU, mix and norm stay on the CUDA cores (67 TFLOP/s) and are what is left.
//
// What the design does about it: the TPU kernel holds a whole [H,W,C] plane
// in VMEM (up to 6.5 MB); a Hopper block has 227 KB. So one block owns one
// (image, 8x16-pixel tile, 64-output-channel slice) and walks the experts,
// and for each expert the input channels in chunks of 32:
//   1. the chunk's tile plus expert e's halo of (k_e-1)/2 pixels arrives in
//      shared memory by cp.async of 4 channels (16 bytes of float32, 8 of
//      bfloat16, which stays bfloat16 there and is widened where the taps
//      read it), zero-filled outside the image (the SAME padding) and past C;
//      so do the expert's k_e x k_e taps for the
//      chunk and the [64 outputs][32 channels] chunk of pw_e, the latter from
//      a scratch bank that a small first kernel wrote transposed (TF32 wgmma
//      reads both operands K-major) and split in TF32 halves. All three are
//      requested while the previous chunk's wgmma runs;
//   2. each thread computes the depthwise taps of one channel along one tile
//      row (16 pixels) from a register window, k_e + 16 shared loads per
//      16 k_e multiply-adds, and writes them split in hi and lo into the two
//      [128 px][32 ch] swizzled tiles that wgmma reads as its A operand;
//   3. each of the two warpgroups computes its 64 pixels x 64 outputs of the
//      chunk's pointwise product by a split-TF32 product (mma_tf32.cuh), three
//      tensor-core passes into fragments that start from zero, and adds them
//      to z_e on the CUDA cores: the tensor cores round every accumulation
//      toward zero, and a short chain keeps that bias under fp32's own noise.
// After the last chunk of expert e, z_e + pb gets SiLU and is mixed into the
// fragment y with w[b,e]; the output norm and SiLU are applied on the store
// (rounded to nearest for a bfloat16 output).
// Nothing but x (once per expert, mostly from L2), the weights and the output
// touch device memory. Two blocks share an SM (128 registers, 110 KB of
// shared memory at k <= 7), so one block's depthwise stage can run on the CUDA
// cores while the other's product runs on the tensor cores.

#include <math.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups, 64 pixels of the tile each
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kPix = kTileH * kTileW;  // 128 pixels per block
constexpr int kCC = tf32::kTileK;      // input channels per chunk
constexpr int kOT = 64;                // output channels per block
constexpr int kMaxExperts = 8;
constexpr int kMaxKernel = 15;
constexpr int kATileFloats = kPix * kCC;  // depthwise output, hi or lo: [128 px][32 ch]
constexpr int kBTileFloats = kOT * kCC;   // pw chunk, hi or lo: [64 outputs][32 ch]
// shared memory in floats: A hi, A lo, two buffers of (B hi, B lo), then the taps and the halo tile
constexpr int kOperandFloats = 2 * kATileFloats + 4 * kBTileFloats;

struct KernelSizes {
  int k[kMaxExperts];
};

// 8-byte asynchronous copy to shared memory; zeros when !valid (src is not read).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}

// Four channels of x into the halo tile, in x's own type.
__device__ __forceinline__ void copy_x4(float* dst, const float* src, bool valid) { tf32::cp_async16(dst, src, valid); }
__device__ __forceinline__ void copy_x4(__nv_bfloat16* dst, const __nv_bfloat16* src, bool valid) {
  cp_async8(dst, src, valid);
}

// SiLU by the fast exponential and division (each within a few ulp): the block
// takes 128 of them per thread, as many instructions as its depthwise taps.
__device__ __forceinline__ float silu(float z) { return __fdividef(z, 1.0f + __expf(-z)); }

// Depthwise taps of channel `c` (of the chunk) along tile row `row`, for a
// K x K expert: xs holds the chunk's tile with this expert's halo, K - 1 + 16
// pixels per row; ws the expert's taps for the chunk, [K * K][32 channels]
// (zeros past C). The 16 sums are written split into the swizzled tiles a_hi
// and a_lo.
template <int K, typename T>
__device__ __forceinline__ void depthwise_row(const T* xs, const float* ws, int row, int c, float* a_hi,
                                              float* a_lo) {
  constexpr int pitch = kTileW + K - 1;
  float acc[kTileW];
#pragma unroll
  for (int j = 0; j < kTileW; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int dr = 0; dr < K; ++dr) {
    float v[kTileW + K - 1];
    const T* src = xs + (row + dr) * pitch * kCC + c;
#pragma unroll
    for (int j = 0; j < kTileW + K - 1; ++j) v[j] = tf32::to_float(src[j * kCC]);
#pragma unroll
    for (int dc = 0; dc < K; ++dc) {
      const float wt = ws[(dr * K + dc) * kCC + c];
#pragma unroll
      for (int j = 0; j < kTileW; ++j) acc[j] = fmaf(v[j + dc], wt, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kTileW; ++j) {
    uint32_t hi, lo;
    tf32::split(acc[j], hi, lo);
    const int at = tf32::swizzled(row * kTileW + j, c);
    a_hi[at] = __uint_as_float(hi);
    a_lo[at] = __uint_as_float(lo);
  }
}

// T: x's and out's type, float or __nv_bfloat16.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_esmoe_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ dw,
                   const float* __restrict__ pw_bank, const float* __restrict__ pb, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ out, int H, int W, int C, int O, int E,
                   int kmax, KernelSizes ks, int tiles_x, int cpad, int opad) {
  extern __shared__ unsigned char smem_raw[];
  float* a_hi = tf32::align_tile(smem_raw);  // [kPix][kCC]
  float* a_lo = a_hi + kATileFloats;         // [kPix][kCC]
  float* bs = a_lo + kATileFloats;           // [2 buffers][hi, lo][kOT][kCC]
  float* ws = bs + 4 * kBTileFloats;         // [k * k taps][kCC], k <= kmax
  T* xs = reinterpret_cast<T*>(ws + kmax * kmax * kCC);  // [kTileH + 2 he][kTileW + 2 he][kCC] of T,
                                                         // he <= (kmax - 1) / 2

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int o0 = blockIdx.y * kOT;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW;
  const T* xb = x + static_cast<size_t>(b) * H * W * C;
  const int hmax = (kmax - 1) / 2;

  const int group = tid >> 7, group_tid = tid & 127;  // pointwise: the warpgroup's 64 pixels
  const int kq = tid & 3;                             // pointwise: outputs o0 + 8 j + 2 kq + {0, 1}
  const int dch = tid & 31;                           // depthwise: chunk channel
  const int drow = tid >> 5;                          // depthwise: tile row
  const int nk = cpad / kCC;

  // The loads of a step (one expert, 32 input channels): its halo tile, its taps
  // and its pw chunk. Each thread copies one chunk of 4 channels of every 32nd
  // pixel, tap and pw row; the cursor walks the steps in the order of the
  // products, one step ahead.
  const int ld_row = tid >> 3, ld_c4 = 4 * (tid & 7);
  const int ld_b_dst = tf32::swizzled_chunk(ld_row, tid & 7);  // rows 32 apart share row % 8
  int ld_e = 0, ld_k = 0, ld_buf = 0;
  auto start_loads = [&]() {
    const int c0 = ld_k * kCC, gc = c0 + ld_c4;
    const bool c_in = gc < C;  // C is a multiple of 4: a chunk is wholly in or out
    const int k = ks.k[ld_e], he = (k - 1) / 2;
    const int cols = kTileW + 2 * he, npix = (kTileH + 2 * he) * cols;
    int r = ld_row >= cols ? 1 : 0, cc = ld_row >= cols ? ld_row - cols : ld_row;  // 18 <= cols <= 30
    for (int pix = ld_row; pix < npix; pix += 32) {
      const int gy = ty0 - he + r, gx = tx0 - he + cc;
      const bool valid = c_in && gy >= 0 && gy < H && gx >= 0 && gx < W;
      copy_x4(xs + pix * kCC + ld_c4, valid ? xb + (static_cast<size_t>(gy) * W + gx) * C + gc : xb, valid);
      cc += 32 - cols;  // 32 pixels on: one row down, and a second one past the row's end
      r += 1;
      if (cc >= cols) {
        cc -= cols;
        r += 1;
      }
    }
    const int off = hmax - he;
    for (int tap = ld_row; tap < k * k; tap += 32) {
      const int dr = tap / k, dc = tap - dr * k;
      tf32::cp_async16(ws + tap * kCC + ld_c4,
                       c_in ? dw + (static_cast<size_t>(ld_e * kmax + off + dr) * kmax + off + dc) * C + gc : dw, c_in);
    }
    float* dst = bs + ld_buf * 2 * kBTileFloats + ld_b_dst;
    const float* src = pw_bank + (static_cast<size_t>(ld_e) * 2 * opad + o0 + ld_row) * cpad + gc;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < kOT / 32; ++i)
        tf32::cp_async16(dst + half * kBTileFloats + i * 32 * kCC,
                         src + (static_cast<size_t>(half) * opad + i * 32) * cpad, true);
    ld_buf ^= 1;
    if (++ld_k == nk) {
      ld_k = 0;
      ++ld_e;
    }
  };

  float y[32], z[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) y[i] = z[i] = 0.0f;

  start_loads();
  tf32::cp_async_commit();
  int buf = 0;
  for (int e = 0; e < E; ++e) {
    const int k = ks.k[e];
    for (int kc = 0; kc < nk; ++kc) {
      tf32::cp_async_wait<0>();
      tf32::fence_proxy_async();
      __syncthreads();  // this step's halo tile, taps and pw chunk are visible to all

      switch (k) {
        case 3: depthwise_row<3>(xs, ws, drow, dch, a_hi, a_lo); break;
        case 5: depthwise_row<5>(xs, ws, drow, dch, a_hi, a_lo); break;
        case 7: depthwise_row<7>(xs, ws, drow, dch, a_hi, a_lo); break;
        case 9: depthwise_row<9>(xs, ws, drow, dch, a_hi, a_lo); break;
        case 11: depthwise_row<11>(xs, ws, drow, dch, a_hi, a_lo); break;
        case 13: depthwise_row<13>(xs, ws, drow, dch, a_hi, a_lo); break;
        default: depthwise_row<15>(xs, ws, drow, dch, a_hi, a_lo); break;
      }
      tf32::fence_proxy_async();
      __syncthreads();  // the A tiles are whole; everyone is done with the halo tile and the taps

      const float* b_hi = bs + buf * 2 * kBTileFloats;
      buf ^= 1;
      const uint64_t da_hi = tf32::tile_desc(a_hi + group * 64 * kCC);
      const uint64_t da_lo = tf32::tile_desc(a_lo + group * 64 * kCC);
      const uint64_t db_hi = tf32::tile_desc(b_hi), db_lo = tf32::tile_desc(b_hi + kBTileFloats);
      // The tensor cores round each accumulation toward zero, a bias that grows
      // with the length of the chain and coheres over pixels and layers. So the
      // chunk's product starts from zero in t, the small terms first (their
      // roundings are at 2^-11 of the magnitude), and joins z by an fp32 add.
      float t[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) t[i] = 0.0f;
      tf32::fence_registers(t);
      tf32::wgmma_fence();
#pragma unroll
      for (int s = 0; s < tf32::kStepsPerTile; ++s) {
        const uint64_t adv = s * tf32::kStepDescAdvance;
        tf32::wgmma_m64n64k8_ss(t, da_lo + adv, db_hi + adv);
        tf32::wgmma_m64n64k8_ss(t, da_hi + adv, db_lo + adv);
      }
#pragma unroll
      for (int s = 0; s < tf32::kStepsPerTile; ++s) {
        const uint64_t adv = s * tf32::kStepDescAdvance;
        tf32::wgmma_m64n64k8_ss(t, da_hi + adv, db_hi + adv);
      }
      tf32::wgmma_commit();
      // the next step's loads run beside the product: the halo tile and the taps are
      // free, and the other pw buffer's last reader (the step before) has been waited for
      if (ld_e < E) start_loads();
      tf32::cp_async_commit();
      tf32::wgmma_wait<0>();
      tf32::fence_registers(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) z[i] += t[i];
    }

    // expert e is complete: bias, SiLU, mix
    const float we = __ldg(w + b * E + e);
#pragma unroll
    for (int j = 0; j < kOT / 8; ++j) {
      const int o = o0 + 8 * j + 2 * kq;  // O is even: the pair o, o + 1 is wholly in or out
      const float bias0 = o < O ? __ldg(pb + e * O + o) : 0.0f, bias1 = o < O ? __ldg(pb + e * O + o + 1) : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[4 * j + i] = fmaf(we, silu(z[4 * j + i] + ((i & 1) ? bias1 : bias0)), y[4 * j + i]);
        z[4 * j + i] = 0.0f;
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = 64 * group + tf32::acc_row(group_tid, 2 * half);
    const int py = ty0 + p / kTileW, px = tx0 + p % kTileW;
    if (py >= H || px >= W) continue;
    T* dst = out + ((static_cast<size_t>(b) * H + py) * W + px) * O;
#pragma unroll
    for (int j = 0; j < kOT / 8; ++j) {
      const int o = o0 + 8 * j + 2 * kq;
      if (o >= O) continue;
      tf32::store_pair(dst + o, silu(fmaf(__ldg(gamma + o), y[4 * j + 2 * half], __ldg(beta + o))),
                       silu(fmaf(__ldg(gamma + o + 1), y[4 * j + 2 * half + 1], __ldg(beta + o + 1))));
    }
  }
}

int smem_bytes(int kmax) {
  const int hmax = (kmax - 1) / 2;
  return static_cast<int>(sizeof(float)) *
             (kOperandFloats + kmax * kmax * kCC + (kTileH + 2 * hmax) * (kTileW + 2 * hmax) * kCC) +
         1024;
}

// x [B,H,W,C], out [B,H,W,O] of T; w [B,E], dw [E,kmax,kmax,C], pw [E,C,O], pb [E,O], gamma [O],
// beta [O] float32; all contiguous, x, pw and out 16-byte aligned, C and O multiples of 4, ks[e]
// odd in 3..15, E <= 8 (checked by the caller). pw_bank: scratch of
// E * 2 * esmoe_bank_opad(O) * esmoe_bank_cpad(C) floats.
template <typename T>
int launch(const void* x, const void* w, const void* dw, const void* pw, const void* pb, const void* gamma,
           const void* beta, void* pw_bank, void* out, int B, int H, int W, int C, int O, int E, const int* ks,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  KernelSizes sizes{};
  int kmax = 1;
  for (int e = 0; e < E; ++e) {
    sizes.k[e] = ks[e];
    kmax = ks[e] > kmax ? ks[e] : kmax;
  }
  const int cpad = (C + kCC - 1) / kCC * kCC, opad = (O + kOT - 1) / kOT * kOT;
  tf32::split_bank_kernel<<<dim3(cpad / 32, opad / 32, E), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(pw), nullptr, nullptr, static_cast<float*>(pw_bank), C, O, E, 1, cpad, opad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = smem_bytes(kmax);
  auto kernel = fused_esmoe_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's L1 as shared memory, so that two blocks fit where their tiles allow
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_x * tiles_y, opad / kOT, B);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(dw),
      static_cast<const float*>(pw_bank), static_cast<const float*>(pb), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), H, W, C, O, E, kmax, sizes, tiles_x, cpad, opad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs for the largest kernel size kmax.
int esmoe_smem_bytes(int kmax) { return smem_bytes(kmax); }

int esmoe_max_experts() { return kMaxExperts; }

int esmoe_max_kernel() { return kMaxKernel; }

// Padded channel and output counts of the scratch bank.
int esmoe_bank_cpad(int C) { return (C + kCC - 1) / kCC * kCC; }
int esmoe_bank_opad(int O) { return (O + kOT - 1) / kOT * kOT; }

// float32 x and out (launch's comment gives the arguments).
int ymt_fused_esmoe(const void* x, const void* w, const void* dw, const void* pw, const void* pb,
                    const void* gamma, const void* beta, void* pw_bank, void* out, int B, int H, int W, int C, int O,
                    int E, const int* ks, void* stream) {
  return launch<float>(x, w, dw, pw, pb, gamma, beta, pw_bank, out, B, H, W, C, O, E, ks, stream);
}

// bfloat16 x and out.
int ymt_fused_esmoe_bf16(const void* x, const void* w, const void* dw, const void* pw, const void* pb,
                         const void* gamma, const void* beta, void* pw_bank, void* out, int B, int H, int W, int C,
                         int O, int E, const int* ks, void* stream) {
  return launch<__nv_bfloat16>(x, w, dw, pw, pb, gamma, beta, pw_bank, out, B, H, W, C, O, E, ks, stream);
}

}  // extern "C"
