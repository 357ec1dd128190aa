// Cluster-weighted NMS for a batch of images, as a sort, an IoU bitmask, a
// scan and a sum per cluster.
//
// Replaces: yolo_master_tpu/ops/pallas_nms.py:pallas_batched_cw_nms
// (_batched_cw_nms_kernel), the per-image math of ops/nms.py:_greedy_cw_nms.
//
// Semantics, step by step for up to max_det steps: the alive candidate with
// the highest score (ties to the lowest index, as jnp.argmax) seeds a
// cluster; stop if its score is <= 0. The cluster is every alive candidate
// (score > 0) whose IoU with the seed exceeds iou_thres, and the seed. Each
// member weighs
//   w = score * exp(-(1 - IoU)^2 / sigma)    (weighted_iou), or
//   w = score * IoU                          (otherwise),
// the step outputs the w-weighted mean of the members' boxes, the seed's
// score and index, and every member's alive score drops to 0. Slots after
// the stop stay zero / invalid, as the TPU kernel zero-fills.
//
// The seeds are greedy NMS's picks, so phases 1-3 are nms.cu's
// (nms_common.cuh): the sort, the IoU bitmask and the scan. A kept box's
// cluster is exactly the bits its mask row newly sets in the scan
// (row & ~removed): the alive candidates it overlaps by more than iou_thres.
// The scan records them per kept slot; phase 4 (cluster_fuse_kernel, one
// warp per slot) recomputes each member's IoU with its seed and its weight
// with the expressions the step loop used, and writes sums / max(sum w,
// 1e-9). Each lane sums its members in sorted order and the warp adds the 32
// partial sums by a tree.
//
// Membership is exact: IoU rounds as JAX's expression does (nms_common.cuh,
// built with -fmad=false), so seeds, scores and validity are bit-equal to the
// plain version's. The fused boxes are sums over the cluster in another order
// and with the card's expf, so they agree to rounding: a few ulp of the
// class-offset coordinates (up to 80 * 7680 = 6e5, where an fp32 ulp is 0.0625).
//
// What bounds it on the H100: latency, as for nms.cu; the design is nms.cu's,
// with the members' weights and sums done for all kept slots in parallel
// after the scan instead of inside a step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nms_common.cuh"

namespace {

using ymt_nms::u64;

constexpr int kSums = 5;        // sum w, sum w*x1, sum w*y1, sum w*x2, sum w*y2
constexpr int kFuseWarps = 4;   // kept slots per block in phase 4

// One warp per slot s of image b: the scan's kept boxes get their fused box,
// seed score, seed index and validity; the slots after them zeros.
__global__ void __launch_bounds__(32 * kFuseWarps)
cluster_fuse_kernel(const float4* __restrict__ sbox, const float* __restrict__ sscore,
                    const int32_t* __restrict__ order, const int32_t* __restrict__ count,
                    const u64* __restrict__ member, const int32_t* __restrict__ seedpos,
                    const int32_t* __restrict__ kept, int N, int W, int max_det, float sigma, int weighted_iou,
                    float* __restrict__ fused, float* __restrict__ fscore, int32_t* __restrict__ seed,
                    uint8_t* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kFuseWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (s >= max_det) return;
  const size_t o = static_cast<size_t>(b) * max_det + s;
  if (s >= kept[b]) {
    if (lane < 4) fused[4 * o + lane] = 0.0f;
    if (lane == 0) {
      fscore[o] = 0.0f;
      seed[o] = 0;
      valid[o] = 0;
    }
    return;
  }
  const size_t row = static_cast<size_t>(b) * N;
  const int i = seedpos[o];
  const float4 pk = sbox[row + i];
  const float parea = ymt_nms::box_area(pk.x, pk.y, pk.z, pk.w);
  const int nw = (count[b] + 63) >> 6;
  float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int w = i >> 6; w < nw; ++w) {
    u64 bits = member[o * W + w];
    if (w == (i >> 6)) bits |= 1ull << (i & 63);  // the seed is a member of its own cluster
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      if (!((bits >> t) & 1ull)) continue;
      const int j = 64 * w + t;
      const float4 c = sbox[row + j];
      const float sj = sscore[row + j];
      const float ov = ymt_nms::iou(c.x, c.y, c.z, c.w, ymt_nms::box_area(c.x, c.y, c.z, c.w), pk.x, pk.y, pk.z, pk.w,
                                    parea);
      float wt;
      if (weighted_iou) {
        const float d = __fsub_rn(1.0f, ov);
        wt = __fmul_rn(sj, expf(__fdiv_rn(-__fmul_rn(d, d), sigma)));
      } else {
        wt = __fmul_rn(sj, ov);
      }
      sums[0] += wt;
      sums[1] += c.x * wt;
      sums[2] += c.y * wt;
      sums[3] += c.z * wt;
      sums[4] += c.w * wt;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < kSums; ++q) sums[q] += __shfl_down_sync(0xffffffffu, sums[q], off);
  if (lane == 0) {
    const float denom = fmaxf(sums[0], 1e-9f);
#pragma unroll
    for (int q = 0; q < 4; ++q) fused[4 * o + q] = __fdiv_rn(sums[q + 1], denom);
    fscore[o] = sscore[row + i];
    seed[o] = order[row + i];
    valid[o] = 1;
  }
}

}  // namespace

extern "C" {

// Largest N: the sort's keys in one block's shared memory (as nms.cu).
int cw_nms_max_candidates(int max_smem_bytes) { return ymt_nms::max_candidates(max_smem_bytes); }

size_t cw_nms_scratch_bytes(int B, int N, int max_det) {
  return ymt_nms::scratch_layout(nullptr, B, N, max_det, true, nullptr);
}

// boxes [B,N,4] xyxy fp32 (class offset applied), scores [B,N] fp32 (invalid <= 0)
// -> fused [B,max_det,4] fp32, fscore [B,max_det] fp32, seed [B,max_det] int32,
//    valid [B,max_det] bool (one byte each).
int ymt_batched_cw_nms(const void* boxes, const void* scores, void* fused, void* fscore, void* seed, void* valid,
                       void* scratch, int B, int N, int max_det, float iou_thres, float sigma, int weighted_iou,
                       void* stream) {
  ymt_nms::Scratch s;
  ymt_nms::scratch_layout(scratch, B, N, max_det, true, &s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ymt_nms::launch_sort_and_mask(static_cast<const float*>(boxes), static_cast<const float*>(scores),
                                                  B, N, iou_thres, s, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = ymt_nms::launch_scan<true>(B, N, max_det, s, nullptr, nullptr, st)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid((max_det + kFuseWarps - 1) / kFuseWarps, B);
  cluster_fuse_kernel<<<grid, 32 * kFuseWarps, 0, st>>>(
      s.sbox, s.sscore, s.order, s.count, s.member, s.seedpos, s.kept, N, ymt_nms::mask_words(N), max_det, sigma,
      weighted_iou, static_cast<float*>(fused), static_cast<float*>(fscore), static_cast<int32_t*>(seed),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
