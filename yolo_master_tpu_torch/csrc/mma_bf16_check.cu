// Self-check of mma_bf16.cuh: one warpgroup computes a [64, 32] x [32, 128]
// product on bf16 wgmma in the register form, in two ways, so that the split,
// the A fragment's layout, the swizzled bf16 tile, its descriptor and its
// 32-byte depth steps can be held against an fp64 product on their own, and so
// that the tensor cores' rounding of an accumulation can be read:
//
//   d_split [64, 128] = a @ b.T as stem.cu's bf16 forms compute it: per depth-16
//                       step one chain lo*hi + hi*lo + hi*hi from zero, the chains
//                       joined by fp32 adds on the CUDA cores
//   d_acc   [64, 128] = c + bf16(a) @ bf16(b).T in one pass, every step
//                       accumulated by the tensor cores onto c
//
// a [64, 32] and b [128, 32] are K-major, c [64, 128] row-major, all float32.
// Only the first `depth` columns of a and b (a multiple of 2) are read.

#include "mma_bf16.cuh"

namespace {

constexpr int kRowsA = 64, kRowsB = 128, kDepth = 32;

__global__ void __launch_bounds__(128)
split_product_check_bf16_kernel(const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ c,
                                float* __restrict__ d_split, float* __restrict__ d_acc, int depth) {
  extern __shared__ unsigned char smem_raw[];
  const int pad = (1024 - (static_cast<int>(__cvta_generic_to_shared(smem_raw)) & 1023)) & 1023;
  __nv_bfloat16* b_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw + pad);  // [128][64], columns 32-63 unread
  __nv_bfloat16* b_lo = b_hi + kRowsB * bf16x::kTileK;
  const int tid = threadIdx.x;

  for (int q = tid; q < kRowsB * kDepth / 2; q += 128) {
    const int n = q / (kDepth / 2), k = 2 * (q % (kDepth / 2));
    const float v0 = k < depth ? b[n * kDepth + k] : 0.0f, v1 = k + 1 < depth ? b[n * kDepth + k + 1] : 0.0f;
    uint32_t hi, lo;
    bf16x::split(v0, v1, hi, lo);
    *reinterpret_cast<uint32_t*>(b_hi + bf16x::swizzled(n, k)) = hi;
    *reinterpret_cast<uint32_t*>(b_lo + bf16x::swizzled(n, k)) = lo;
  }
  tf32::fence_proxy_async();
  __syncthreads();

  // A's fragments: step s, a[i] = row r0 + 8 (i & 1), columns 16 s + 8 (i >> 1) + 2 kq + {0, 1}
  const int r0 = tf32::acc_row(tid, 0), kq = tid & 3;
  uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1), k = 16 * s + 8 * (i >> 1) + 2 * kq;
      bf16x::split(k < depth ? a[row * kDepth + k] : 0.0f, k + 1 < depth ? a[row * kDepth + k + 1] : 0.0f,
                   a_hi[s][i], a_lo[s][i]);
    }
  const uint64_t d_hi = tf32::tile_desc(reinterpret_cast<const float*>(b_hi));
  const uint64_t d_lo = tf32::tile_desc(reinterpret_cast<const float*>(b_lo));

  float acc[64], t[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = t[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint64_t adv = s * tf32::kStepDescAdvance;
    tf32::fence_registers(t);
    tf32::wgmma_fence();
    bf16x::wgmma_rs<kRowsB>(t, a_lo[s], d_hi + adv, 0);
    bf16x::wgmma_rs<kRowsB>(t, a_hi[s], d_lo + adv, 1);
    bf16x::wgmma_rs<kRowsB>(t, a_hi[s], d_hi + adv, 1);
    tf32::wgmma_commit();
    tf32::wgmma_wait<0>();
    tf32::fence_registers(t);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += t[i];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tf32::acc_row(tid, i), col = tf32::acc_col(tid, j, i);
      d_split[row * kRowsB + col] = acc[4 * j + i];
      t[4 * j + i] = c[row * kRowsB + col];
    }

  tf32::fence_registers(t);
  tf32::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) bf16x::wgmma_rs<kRowsB>(t, a_hi[s], d_hi + s * tf32::kStepDescAdvance, 1);
  tf32::wgmma_commit();
  tf32::wgmma_wait<0>();
  tf32::fence_registers(t);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d_acc[tf32::acc_row(tid, i) * kRowsB + tf32::acc_col(tid, j, i)] = t[4 * j + i];
}

}  // namespace

extern "C" {

// a [64,32], b [128,32], c [64,128] -> d_split, d_acc [64,128]; float32, contiguous.
int ymt_split_product_check_bf16(const void* a, const void* b, const void* c, void* d_split, void* d_acc, int depth,
                                 void* stream) {
  const int smem = 2 * kRowsB * bf16x::kTileK * static_cast<int>(sizeof(__nv_bfloat16)) + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(split_product_check_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_product_check_bf16_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(d_split), static_cast<float*>(d_acc), depth);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
