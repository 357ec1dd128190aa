// Gathered expert matmul for sparse MoE dispatch:
//   out[b] = sum_k wts[b,k] * (x[b] @ w[idx[b,k]])
//
// Replaces: yolo_master_tpu/ops/pallas_moe.py:gathered_expert_matmul.
//
// x [B,N,C], w [E,C,O], idx [B,K] int32, wts [B,K] -> out [B,N,O], all float32
// and contiguous. Only the K selected experts' weights are read: the flops and
// the weight traffic scale with K, not with E (the point of the TPU kernel).
//
// What bounds it on the H100: bytes. The function is linear in w, so mixing
// the K selected experts' weights first leaves one product per image, 2*N*C*O
// flops. At the yolo-master-v0_1-n expert banks (N = 6400/1600/400 pixels,
// C = 128/128/256, O = 256/256/512) that is 25-50 flops per byte of x and
// out: above the fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s = 20) and
// below the TF32 tensor-core one (495 TFLOP/s: 148, or 49 at three passes).
// So the product runs on the tensor cores, and the kernel is left with
// reading x once and writing out once.
//
// What the design does about it:
//  - fp32 accuracy on the tensor cores: a split-TF32 product (mma_tf32.cuh),
//    three wgmma passes per tile into one fp32 accumulator in registers. The
//    tensor cores round each accumulation toward zero, so the result sits a
//    few fp32 steps below the rounded-to-nearest sum (about 0.5 ulp for each
//    of the 3*C/8 instructions of a chain): measured within 1.1e-5 of the
//    plain version at C = 256, a tenth of the 1e-4 + 1e-4*|ref| it is held to.
//  - the mixed weights are made once per image, not once per block and chunk:
//    a small first kernel writes sum_k wts[b,k] * w[idx[b,k]] transposed
//    (wgmma reads TF32 operands K-major only) and split to a scratch bank
//    [B][hi,lo][O][C] that the caller allocates (4 MB at B = 16: it stays in
//    L2). A scratch bank, and not weights resident in a persistent block's
//    shared memory, because its chunks have one fixed size whatever C and O
//    are: every shape the function takes goes down the same path.
//  - persistent blocks (two per SM) walk over (b, 128-row, 128-column) output
//    tiles; x [128 rows, 32 channels] and the bank's hi and lo [128 columns,
//    32 channels] stream through a ring of two shared-memory stages filled by
//    16-byte cp.async, one __syncthreads() per 32 channels. The ring runs on
//    across tiles, so a tile's first loads overlap the tile before it, and
//    what a copy's address owes to the tile is worked out once per tile: at
//    32 channels a chunk, the instructions around the products cost as much
//    as the products.
//  - x is the A operand from registers: each thread loads its fragment of the
//    raw tile (swizzled, so without bank conflicts) and splits it there, so
//    that x is copied to shared memory as it lies.
//  - the output is written once from the accumulator fragments, 32-byte
//    segments per row, no atomics.
//
// Indices: a repeated expert in one row counts once per slot (each slot adds
// its own weighted copy to the mix); a slot with weight 0 adds 0 times its
// weights, as the TPU kernel adds 0 times its product. A slot whose index lies
// outside [0, E) is skipped: it adds nothing and no memory outside w is read.
// N, C and O need not be multiples of the tile: ragged rows, channels and
// columns are loaded as zeros and not stored.

#include "mma_tf32.cuh"

namespace {

constexpr int kWarpgroups = 2;             // each owns 64 rows of the tile
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRowsPerPass = kThreads / 8;  // rows of a tile that one round of 16-byte copies covers
constexpr int kBM = 64 * kWarpgroups;      // rows of x (tokens) per tile
constexpr int kBN = 128;                   // output columns per tile
constexpr int kBK = tf32::kTileK;
constexpr int kStages = 2;
constexpr int kBlocksPerSM = 2;
constexpr int kXTileFloats = kBM * kBK;    // x tile [kBM][32]
constexpr int kWTileFloats = kBN * kBK;    // bank tile, hi or lo, [kBN][32]
constexpr int kStageFloats = kXTileFloats + 2 * kWTileFloats;
constexpr int kSmemBytes = kStages * kStageFloats * static_cast<int>(sizeof(float)) + 1024;

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gathered_expert_matmul_kernel(const float* __restrict__ x, const float* __restrict__ bank, float* __restrict__ out,
                              int N, int C, int O, int cpad, int opad, int m_tiles, int o_tiles, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  float* smem = tf32::align_tile(smem_raw);

  const int tid = threadIdx.x;
  const int row0 = 64 * (tid >> 7) + tf32::acc_row(tid & 127, 0);  // this thread's first tile row
  const int kq = tid & 3;
  const int nk = cpad / kBK;

  // The loads run kStages - 1 chunks ahead of the products, on across tiles. Each
  // thread copies one 16-byte chunk (4 channels) of every 32nd row of the three
  // operand tiles; what depends on the tile alone is worked out once per tile.
  const int ld_row = tid >> 3, ld_chunk4 = 4 * (tid & 7);
  const int ld_dst = tf32::swizzled_chunk(ld_row, tid & 7);  // rows 32 apart share row % 8
  int ld_tile = blockIdx.x, ld_k = 0, ld_stage = 0;
  const float* ld_x = x;  // first row of x this thread copies, at its chunk of channel 0
  const float* ld_w = bank;  // first row of the bank's hi half this thread copies, likewise
  unsigned ld_rows = 0;      // bit i: row ld_row + 32 i of the tile lies inside N
  auto ld_set_tile = [&]() {
    const int ot = ld_tile % o_tiles, mt = (ld_tile / o_tiles) % m_tiles, b = ld_tile / (o_tiles * m_tiles);
    const int n0 = mt * kBM + ld_row;
    ld_x = x + (static_cast<size_t>(b) * N + n0) * C + ld_chunk4;
    ld_w = bank + (static_cast<size_t>(b) * 2 * opad + ot * kBN + ld_row) * cpad + ld_chunk4;
    ld_rows = 0;
#pragma unroll
    for (int i = 0; i < kBM / kRowsPerPass; ++i) ld_rows |= (n0 + kRowsPerPass * i < N ? 1u : 0u) << i;
  };
  auto start_loads = [&]() {
    float* dst = smem + ld_stage * kStageFloats + ld_dst;
    const int c0 = ld_k * kBK;
    const bool c_in = c0 + ld_chunk4 < C;  // C is a multiple of 4: a chunk is wholly in or out
#pragma unroll
    for (int i = 0; i < kBM / kRowsPerPass; ++i) {
      const bool valid = c_in && ((ld_rows >> i) & 1u);
      tf32::cp_async16(dst + i * kRowsPerPass * kBK,
                       valid ? ld_x + static_cast<size_t>(i) * kRowsPerPass * C + c0 : x, valid);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < kBN / kRowsPerPass; ++i)
        tf32::cp_async16(dst + kXTileFloats + half * kWTileFloats + i * kRowsPerPass * kBK,
                         ld_w + (static_cast<size_t>(half) * opad + i * kRowsPerPass) * cpad + c0, true);
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
    if (++ld_k == nk) {
      ld_k = 0;
      ld_tile += gridDim.x;
      if (ld_tile < tiles) ld_set_tile();
    }
  };
  ld_set_tile();  // the grid has no more blocks than tiles

  // offsets of this thread's A fragment in the swizzled x tile: chunk q of rows row0 and row0 + 8
  int a_off[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) a_off[q] = tf32::swizzled(row0, 4 * q + kq);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (ld_tile < tiles) start_loads();
    tf32::cp_async_commit();
  }
  int stage_at = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int k = 0; k < nk; ++k) {
      tf32::cp_async_wait<kStages - 2>();  // this thread's part of the chunk has landed
      tf32::fence_proxy_async();
      __syncthreads();  // the whole chunk is visible; everyone is done with the chunk before it
      if (ld_tile < tiles) start_loads();
      tf32::cp_async_commit();

      const float* stage = smem + stage_at * kStageFloats;
      stage_at = stage_at + 1 == kStages ? 0 : stage_at + 1;
      uint32_t a_hi[tf32::kStepsPerTile][4], a_lo[tf32::kStepsPerTile][4];
#pragma unroll
      for (int s = 0; s < tf32::kStepsPerTile; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tf32::split(stage[a_off[2 * s + (i >> 1)] + 8 * kBK * (i & 1)], a_hi[s][i], a_lo[s][i]);
      const uint64_t d_hi = tf32::tile_desc(stage + kXTileFloats);
      const uint64_t d_lo = tf32::tile_desc(stage + kXTileFloats + kWTileFloats);
      tf32::fence_registers(acc);
      tf32::wgmma_fence();
#pragma unroll
      for (int s = 0; s < tf32::kStepsPerTile; ++s) {
        const uint64_t adv = s * tf32::kStepDescAdvance;
        tf32::wgmma_m64n128k8_rs(acc, a_lo[s], d_hi + adv);
        tf32::wgmma_m64n128k8_rs(acc, a_hi[s], d_lo + adv);
        tf32::wgmma_m64n128k8_rs(acc, a_hi[s], d_hi + adv);
      }
      tf32::wgmma_commit();
      tf32::wgmma_wait<0>();
      tf32::fence_registers(acc);
    }

    // the tile is complete: store it and start the next from zero
    const int ot = tile % o_tiles, mt = (tile / o_tiles) % m_tiles, b = tile / (o_tiles * m_tiles);
    const int n = mt * kBM + row0;
    float* dst = out + (static_cast<size_t>(b) * N + n) * O + ot * kBN + 2 * kq;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (ot * kBN + 8 * j + 2 * kq < O) {  // O is even: a pair of columns is wholly in or out
        if (n < N) *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (n + 8 < N)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(8) * O + 8 * j) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] = 0.0f;
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || count <= 0)
      count = 132;
  }
  return count;
}

}  // namespace

extern "C" {

// Padded channel and column counts of the scratch bank.
int moe_bank_cpad(int C) { return (C + kBK - 1) / kBK * kBK; }
int moe_bank_opad(int O) { return (O + kBN - 1) / kBN * kBN; }

// x [B,N,C], w [E,C,O], idx [B,K] int32, wts [B,K] -> out [B,N,O]; float32,
// contiguous, 16-byte aligned, C and O multiples of 4 (checked by the caller).
// bank: scratch of B * 2 * moe_bank_opad(O) * moe_bank_cpad(C) floats.
int ymt_gathered_expert_matmul(const void* x, const void* w, const void* idx, const void* wts, void* bank, void* out,
                               int B, int N, int C, int O, int E, int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpad = moe_bank_cpad(C), opad = moe_bank_opad(O);
  tf32::split_bank_kernel<<<dim3(cpad / 32, opad / 32, B), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(w), static_cast<const int*>(idx), static_cast<const float*>(wts),
      static_cast<float*>(bank), C, O, E, K, cpad, opad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gathered_expert_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's L1 as shared memory, so that kBlocksPerSM blocks fit
  err = cudaFuncSetAttribute(gathered_expert_matmul_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (N + kBM - 1) / kBM, o_tiles = opad / kBN;
  const long long tiles = static_cast<long long>(B) * m_tiles * o_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < kBlocksPerSM * sm_count() ? tiles : kBlocksPerSM * sm_count());
  gathered_expert_matmul_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(bank), static_cast<float*>(out), N, C, O, cpad, opad,
      m_tiles, o_tiles, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
