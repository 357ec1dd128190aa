// Cluster-weighted NMS for a batch of images, one thread block per image.
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
// Membership is exact: IoU rounds as JAX's expression does (nms_common.cuh,
// built with -fmad=false), so seeds, scores and validity are bit-equal to the
// plain version's. The fused boxes are sums over the cluster in another order
// and with the card's expf, so they agree to rounding: a few ulp of the
// class-offset coordinates (up to 80 * 7680 = 6e5, where an fp32 ulp is 0.0625).
//
// What bounds it on the H100: latency, as for nms.cu: up to max_det strictly
// sequential steps, each a block-wide argmax, one pass over the N candidates
// and a block-wide sum of five values (sum w and sum w * coordinate). The
// candidates (N = 4096 on the SAHI path: 96 KB) are read once.
//
// What the design does about it: nms.cu's design. The candidates stay in
// dynamic shared memory for the whole loop; each thread owns a fixed stride
// of them, so one pass computes the IoU, the weights and their partial sums,
// zeroes the members and scans for the next argmax. The five sums of step s
// ride in the same warp shuffles and the same two barriers as the argmax of
// step s + 1, so a step costs two barriers, as in nms.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nms_common.cuh"

namespace {

using ymt_nms::iou;
using ymt_nms::kNoIndex;
using ymt_nms::kThreads;
using ymt_nms::kWarps;
using ymt_nms::warp_argmax;

constexpr int kSums = 5;  // sum w, sum w*x1, sum w*y1, sum w*x2, sum w*y2

__device__ __forceinline__ void warp_sum(float (&s)[kSums]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < kSums; ++q) s[q] += __shfl_down_sync(0xffffffffu, s[q], off);
}

// boxes [B,N,4] xyxy fp32 (class offset applied), scores [B,N] fp32 (invalid <= 0)
// -> fused [B,max_det,4] fp32, fscore [B,max_det] fp32, seed [B,max_det] int32,
//    valid [B,max_det] bool (one byte each).
__global__ void __launch_bounds__(kThreads)
batched_cw_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, int N, int max_det,
                      float iou_thres, float sigma, int weighted_iou, float* __restrict__ fused,
                      float* __restrict__ fscore, int32_t* __restrict__ seed, uint8_t* __restrict__ valid) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + N;
  float* x2 = y1 + N;
  float* y2 = x2 + N;
  float* area = y2 + N;
  float* alive = area + N;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float red_s[kSums][kWarps];
  __shared__ float pick_v;
  __shared__ int pick_i;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* bb = boxes + static_cast<size_t>(b) * N * 4;
  const float* sb = scores + static_cast<size_t>(b) * N;
  float* fb = fused + static_cast<size_t>(b) * max_det * 4;
  float* fsb = fscore + static_cast<size_t>(b) * max_det;
  int32_t* seb = seed + static_cast<size_t>(b) * max_det;
  uint8_t* vb = valid + static_cast<size_t>(b) * max_det;

  for (int j = tid; j < N; j += kThreads) {
    const float a = bb[4 * j], c = bb[4 * j + 1], d = bb[4 * j + 2], e = bb[4 * j + 3];
    x1[j] = a;
    y1[j] = c;
    x2[j] = d;
    y2[j] = e;
    area[j] = ymt_nms::box_area(a, c, d, e);
    alive[j] = sb[j];
  }
  for (int s = tid; s < max_det; s += kThreads) {
    fb[4 * s] = fb[4 * s + 1] = fb[4 * s + 2] = fb[4 * s + 3] = 0.0f;
    fsb[s] = 0.0f;
    seb[s] = 0;
    vb[s] = 0;
  }
  __syncthreads();

  // Thread t owns candidates j = t, t + kThreads, ... (see nms.cu).
  float v = -INFINITY;
  int vi = kNoIndex;
  for (int j = tid; j < N; j += kThreads) {
    const float s = alive[j];
    if (s > v) {
      v = s;
      vi = j;
    }
  }
  float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int step = 0; step <= max_det; ++step) {
    // this step's argmax, and the sums of the previous step's cluster
    warp_argmax(v, vi);
    warp_sum(sums);
    if ((tid & 31) == 0) {
      red_v[tid >> 5] = v;
      red_i[tid >> 5] = vi;
#pragma unroll
      for (int q = 0; q < kSums; ++q) red_s[q][tid >> 5] = sums[q];
    }
    __syncthreads();
    if (tid < 32) {
      v = tid < kWarps ? red_v[tid] : -INFINITY;
      vi = tid < kWarps ? red_i[tid] : kNoIndex;
      warp_argmax(v, vi);
#pragma unroll
      for (int q = 0; q < kSums; ++q) sums[q] = tid < kWarps ? red_s[q][tid] : 0.0f;
      warp_sum(sums);
      if (tid == 0) {
        if (step > 0) {
          const float denom = fmaxf(sums[0], 1e-9f);
#pragma unroll
          for (int q = 0; q < 4; ++q) fb[4 * (step - 1) + q] = __fdiv_rn(sums[q + 1], denom);
        }
        pick_v = v;
        pick_i = vi;
      }
    }
    __syncthreads();
    if (step == max_det) break;
    const float best = pick_v;
    const int idx = pick_i;
    if (!(best > 0.0f)) break;  // same value in every thread: the block leaves together
    if (tid == 0) {
      fsb[step] = best;
      seb[step] = idx;
      vb[step] = 1;
    }
    const float bx1 = x1[idx], by1 = y1[idx], bx2 = x2[idx], by2 = y2[idx], barea = area[idx];
    v = -INFINITY;
    vi = kNoIndex;
#pragma unroll
    for (int q = 0; q < kSums; ++q) sums[q] = 0.0f;
    for (int j = tid; j < N; j += kThreads) {
      const float ov = iou(x1[j], y1[j], x2[j], y2[j], area[j], bx1, by1, bx2, by2, barea);
      float s = alive[j];
      if ((ov > iou_thres || j == idx) && s > 0.0f) {
        float wt;
        if (weighted_iou) {
          const float t = __fsub_rn(1.0f, ov);
          wt = __fmul_rn(s, expf(__fdiv_rn(-__fmul_rn(t, t), sigma)));
        } else {
          wt = __fmul_rn(s, ov);
        }
        sums[0] += wt;
        sums[1] += x1[j] * wt;
        sums[2] += y1[j] * wt;
        sums[3] += x2[j] * wt;
        sums[4] += y2[j] * wt;
        s = 0.0f;
        alive[j] = s;
      }
      if (s > v) {
        v = s;
        vi = j;
      }
    }
  }
}

}  // namespace

extern "C" {

// Largest N one block can hold: six fp32 arrays of N plus the static reduction scratch.
int cw_nms_max_candidates(int max_smem_bytes) {
  const int static_bytes = kWarps * (sizeof(float) + sizeof(int) + kSums * sizeof(float)) + sizeof(float) + sizeof(int);
  return (max_smem_bytes - static_bytes) / (6 * static_cast<int>(sizeof(float)));
}

int ymt_batched_cw_nms(const void* boxes, const void* scores, void* fused, void* fscore, void* seed, void* valid,
                       int B, int N, int max_det, float iou_thres, float sigma, int weighted_iou, void* stream) {
  const int smem = 6 * N * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(batched_cw_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  batched_cw_nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores), N, max_det, iou_thres, sigma,
      weighted_iou, static_cast<float*>(fused), static_cast<float*>(fscore), static_cast<int32_t*>(seed),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
