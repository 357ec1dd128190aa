// Self-check of mma_tf32.cuh: one warpgroup computes a [64, 32] x [32, N]
// split-TF32 product in each of the two wgmma forms the kernels use, so that
// the split, the swizzled tile layout, the descriptor and its 32-byte depth
// steps, the zero-filling cp.async and the accumulator layout can be held
// against an fp64 product on their own (tests/test_torch_cuda.py).
//
//   d_ss [64, 64]  = a @ b[:64].T    A and B from shared memory (esmoe.cu's form)
//   d_rs [64, 128] = a @ b.T         A from registers (moe.cu's form)
// a [64, 32] and b [128, 32] are K-major, float32. Only the first `depth`
// columns (a multiple of 4) are read: the rest arrive as zeros from cp.async.

#include "mma_tf32.cuh"

namespace {

constexpr int kRowsA = 64, kRowsB = 128;

__global__ void __launch_bounds__(128)
split_product_check_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ d_ss,
                           float* __restrict__ d_rs, int depth) {
  extern __shared__ unsigned char smem_raw[];
  float* a_raw = tf32::align_tile(smem_raw);     // [64][32]
  float* a_hi = a_raw + kRowsA * tf32::kTileK;   // [64][32]
  float* a_lo = a_hi + kRowsA * tf32::kTileK;    // [64][32]
  float* b_raw = a_lo + kRowsA * tf32::kTileK;   // [128][32]
  float* b_hi = b_raw + kRowsB * tf32::kTileK;   // [128][32]
  float* b_lo = b_hi + kRowsB * tf32::kTileK;    // [128][32]
  const int tid = threadIdx.x;

  for (int q = tid; q < (kRowsA + kRowsB) * 8; q += 128) {
    const int row = q >> 3, chunk = q & 7;
    const bool valid = 4 * chunk < depth;
    if (row < kRowsA)
      tf32::cp_async16(a_raw + tf32::swizzled_chunk(row, chunk), a + row * tf32::kTileK + 4 * chunk, valid);
    else
      tf32::cp_async16(b_raw + tf32::swizzled_chunk(row - kRowsA, chunk),
                       b + (row - kRowsA) * tf32::kTileK + 4 * chunk, valid);
  }
  tf32::cp_async_commit();
  tf32::cp_async_wait<0>();
  __syncthreads();
  // the split keeps an element's place: the swizzle of raw, hi and lo tiles is the same
  for (int q = tid; q < (kRowsA + kRowsB) * tf32::kTileK; q += 128) {
    uint32_t hi, lo;
    if (q < kRowsA * tf32::kTileK) {
      tf32::split(a_raw[q], hi, lo);
      a_hi[q] = __uint_as_float(hi);
      a_lo[q] = __uint_as_float(lo);
    } else {
      const int p = q - kRowsA * tf32::kTileK;
      tf32::split(b_raw[p], hi, lo);
      b_hi[p] = __uint_as_float(hi);
      b_lo[p] = __uint_as_float(lo);
    }
  }
  tf32::fence_proxy_async();
  __syncthreads();

  float ss[32], rs[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) ss[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) rs[i] = 0.0f;

  const uint64_t da_hi = tf32::tile_desc(a_hi), da_lo = tf32::tile_desc(a_lo);
  const uint64_t db_hi = tf32::tile_desc(b_hi), db_lo = tf32::tile_desc(b_lo);
  tf32::wgmma_fence();
#pragma unroll
  for (int s = 0; s < tf32::kStepsPerTile; ++s) {
    const uint64_t adv = s * tf32::kStepDescAdvance;
    tf32::wgmma_m64n64k8_ss(ss, da_lo + adv, db_hi + adv);
    tf32::wgmma_m64n64k8_ss(ss, da_hi + adv, db_lo + adv);
    tf32::wgmma_m64n64k8_ss(ss, da_hi + adv, db_hi + adv);
  }
  tf32::wgmma_commit();
  tf32::wgmma_wait<0>();
  tf32::fence_registers(ss);

  uint32_t fa_hi[tf32::kStepsPerTile][4], fa_lo[tf32::kStepsPerTile][4];
  const int r0 = tf32::acc_row(tid, 0), kq = tid & 3;
#pragma unroll
  for (int s = 0; s < tf32::kStepsPerTile; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tf32::split(a_raw[tf32::swizzled(r0 + 8 * (i & 1), 8 * s + 4 * (i >> 1) + kq)], fa_hi[s][i], fa_lo[s][i]);
  tf32::wgmma_fence();
#pragma unroll
  for (int s = 0; s < tf32::kStepsPerTile; ++s) {
    const uint64_t adv = s * tf32::kStepDescAdvance;
    tf32::wgmma_m64n128k8_rs(rs, fa_lo[s], db_hi + adv);
    tf32::wgmma_m64n128k8_rs(rs, fa_hi[s], db_lo + adv);
    tf32::wgmma_m64n128k8_rs(rs, fa_hi[s], db_hi + adv);
  }
  tf32::wgmma_commit();
  tf32::wgmma_wait<0>();
  tf32::fence_registers(rs);

#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tf32::acc_row(tid, i), col = tf32::acc_col(tid, j, i);
      d_rs[row * kRowsB + col] = rs[4 * j + i];
      if (j < 8) d_ss[row * 64 + col] = ss[4 * j + i];
    }
}

}  // namespace

extern "C" {

// a [64,32], b [128,32] -> d_ss [64,64], d_rs [64,128]; float32, contiguous, 16-byte aligned.
int ymt_split_product_check(const void* a, const void* b, void* d_ss, void* d_rs, int depth, void* stream) {
  const int smem = (3 * kRowsA + 3 * kRowsB) * tf32::kTileK * static_cast<int>(sizeof(float)) + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(split_product_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_product_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(d_ss),
      static_cast<float*>(d_rs), depth);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
