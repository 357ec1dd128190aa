// Gathered expert matmul for sparse MoE dispatch:
//   out[b] = sum_k wts[b,k] * (x[b] @ w[idx[b,k]])
//
// Replaces: yolo_master_tpu/ops/pallas_moe.py:gathered_expert_matmul.
//
// x [B,N,C], w [E,C,O], idx [B,K] int32, wts [B,K] -> out [B,N,O], all float32
// and contiguous. Only the K selected experts' weights are read: the flops and
// the weight traffic scale with K, not with E (the point of the TPU kernel).
//
// What bounds it on the H100: operations. The function is linear in w, so
// mixing the K selected experts' weights first leaves one product per image:
// 2*N*C*O flops (plus 2*K*C*O for the mix). At the yolo-master-v0_1-n expert
// banks (N = 6400/1600/400 pixels, C = 128/128/256, O = 256/256/512, K = 2)
// that is 0.1-0.4 GFLOP against 4-10 MB of fp32 in and out: 25-50 flops per
// byte, above the fp32 CUDA-core ridge of 20 flops per byte (67 TFLOP/s over
// 3.35 TB/s). Every product stays in fp32 on the CUDA cores (no TF32).
//
// What the design does about it: the TPU kernel revisits one output block
// across a sequential k grid axis and accumulates in place. Hopper runs blocks
// in no order, so here each block owns one (b, 128-row N tile, 128-column O
// tile), reads its own idx/wts, and sums over k while it stages the weights:
// per 8-wide C chunk, the x tile (stored transposed) and the mixed tile
// sum_k wts[b,k] * w[idx[b,k]] are staged through shared memory, and the 8x8
// register tile per thread carries the sum over every C chunk. The output is
// written once, with no atomics, and each thread does 64 FMAs per 4 float4
// shared loads (the classic 128x128x8 SIMT tile), once per chunk whatever K
// is. Double buffering, TF32/bf16 wgmma and a persistent schedule are later
// work.
//
// Indices: a repeated expert in one row counts once per slot (each slot adds
// its own weighted copy to the mix); a slot with weight 0 adds 0 times its
// weights, as the TPU kernel adds 0 times its product. A slot whose index lies
// outside [0, E) is skipped: it adds nothing and no memory outside w is read.
// N need not be a multiple of the tile: the ragged rows are loaded as zeros
// and not stored.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows of x (tokens) per block
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 8;    // input channels per chunk

__global__ void __launch_bounds__(kThreads)
gathered_expert_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              const int* __restrict__ idx, const float* __restrict__ wts, float* __restrict__ out,
                              int N, int C, int O, int E, int K) {
  __shared__ __align__(16) float as[kBK][kBM];  // x tile, transposed: as[c][row]
  __shared__ __align__(16) float bs[kBK][kBN];  // mixed weight tile: bs[c][col]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;
  const int tx = tid % 16;  // output columns 4*tx .. +4 and 64 + 4*tx .. +4
  const int ty = tid / 16;  // output rows 4*ty .. +4 and 64 + 4*ty .. +4
  const float* xb = x + static_cast<size_t>(b) * N * C;

  // loaders: x rows tid/2, channels 4*(tid%2) .. +4; w row tid/32, columns 4*(tid%32) .. +4
  const int a_row = tid / 2, a_c = 4 * (tid % 2);
  const int b_row = tid / 32, b_col = 4 * (tid % 32);
  const bool a_in = n0 + a_row < N;
  const bool b_in = o0 + b_col < O;  // O is a multiple of 4: a float4 is wholly in or out

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int* idx_b = idx + static_cast<size_t>(b) * K;
  const float* wts_b = wts + static_cast<size_t>(b) * K;
  for (int c0 = 0; c0 < C; c0 += kBK) {
    float4 av = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (a_in && c0 + a_c < C)  // C is a multiple of 4
      av = __ldg(reinterpret_cast<const float4*>(xb + static_cast<size_t>(n0 + a_row) * C + c0 + a_c));
    float4 bv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // sum_k wts[b,k] * w[idx[b,k]] at this float4
    if (b_in && c0 + b_row < C) {
      for (int k = 0; k < K; ++k) {
        const int e = __ldg(idx_b + k);
        if (e < 0 || e >= E) continue;
        const float wk = __ldg(wts_b + k);
        const float4 v = __ldg(reinterpret_cast<const float4*>(w + (static_cast<size_t>(e) * C + c0 + b_row) * O +
                                                                o0 + b_col));
        bv = make_float4(fmaf(wk, v.x, bv.x), fmaf(wk, v.y, bv.y), fmaf(wk, v.z, bv.z), fmaf(wk, v.w, bv.w));
      }
    }
    __syncthreads();  // the previous chunk's readers are done
    as[a_c + 0][a_row] = av.x;
    as[a_c + 1][a_row] = av.y;
    as[a_c + 2][a_row] = av.z;
    as[a_c + 3][a_row] = av.w;
    *reinterpret_cast<float4*>(&bs[b_row][b_col]) = bv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = n0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= N) continue;
    float* dst = out + (static_cast<size_t>(b) * N + row) * O;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = o0 + 64 * h + 4 * tx;
      if (col >= O) continue;
      *reinterpret_cast<float4*>(dst + col) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

}  // namespace

extern "C" {

// x [B,N,C], w [E,C,O], idx [B,K] int32, wts [B,K] -> out [B,N,O]; float32,
// contiguous, 16-byte aligned, C and O multiples of 4 (checked by the caller).
int ymt_gathered_expert_matmul(const void* x, const void* w, const void* idx, const void* wts, void* out, int B,
                               int N, int C, int O, int E, int K, void* stream) {
  const dim3 grid((N + kBM - 1) / kBM, (O + kBN - 1) / kBN, B);
  gathered_expert_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const int*>(idx),
      static_cast<const float*>(wts), static_cast<float*>(out), N, C, O, E, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
