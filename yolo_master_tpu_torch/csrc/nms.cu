// Exact greedy NMS for a batch of images, one thread block per image.
//
// Replaces: yolo_master_tpu/ops/pallas_nms.py:pallas_batched_greedy_nms
// (_batched_nms_kernel), and pallas_greedy_nms (_nms_kernel), which computes
// the same keep set for one image and is this kernel at B=1.
//
// Semantics, step by step for up to max_det steps: pick the alive candidate
// with the highest score (ties go to the lowest index, as jnp.argmax does);
// stop if that score is <= 0; otherwise record it and zero the alive score of
// the pick and of every candidate whose IoU with it exceeds iou_thres.
// Slots after the stop stay index 0 / invalid, as the TPU kernel zero-fills.
//
// IoU rounds exactly as the JAX expression does (nms_common.cuh), so keep
// sets are bit-equal to JAX's, ties and boxes on the threshold included.
//
// What bounds it on the H100: latency, not bandwidth or FLOPs. A step is
// a block-wide argmax followed by a block-wide IoU update over N candidates,
// and the steps are strictly sequential (up to max_det = 300), so one
// image's time is max_det times the latency of two reductions' worth of
// barriers. The data (N = 2048: 48 KB) is read from device memory once.
//
// What the design does about it: the candidates' x1, y1, x2, y2, area and
// alive score stay in shared memory for the whole loop (dynamic shared
// memory, so N up to ~9600 fits in the 227 KB a block may use). Each thread
// owns a fixed stride of candidates, so a step is one pass over them (IoU
// update fused with the next argmax scan) and two barriers: the argmax
// carries (value, index) pairs through warp shuffles, then across the
// block's 8 warps through shared memory. Images run on separate SMs in
// parallel, and a block stops as soon as its own image is exhausted.

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

// boxes [B,N,4] xyxy fp32 (class offset applied), scores [B,N] fp32 (invalid <= 0)
// -> keep_idx [B,max_det] int32, keep_valid [B,max_det] bool (one byte each).
__global__ void __launch_bounds__(kThreads)
batched_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, int N, int max_det,
                   float iou_thres, int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_valid) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + N;
  float* x2 = y1 + N;
  float* y2 = x2 + N;
  float* area = y2 + N;
  float* alive = area + N;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float pick_v;
  __shared__ int pick_i;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* bb = boxes + static_cast<size_t>(b) * N * 4;
  const float* sb = scores + static_cast<size_t>(b) * N;
  int32_t* kib = keep_idx + static_cast<size_t>(b) * max_det;
  uint8_t* kvb = keep_valid + static_cast<size_t>(b) * max_det;

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
    kib[s] = 0;
    kvb[s] = 0;
  }
  __syncthreads();

  // Thread t owns candidates j = t, t + kThreads, ...: only it reads or writes
  // their alive scores, so each step's IoU update and the next step's argmax
  // scan are one pass, with no barrier between them. A thread scans
  // increasing indices with a strict '>' and keeps its lowest tied index;
  // every merge below prefers the lower index on equal values.
  float v = -INFINITY;
  int vi = kNoIndex;
  for (int j = tid; j < N; j += kThreads) {
    const float s = alive[j];
    if (s > v) {
      v = s;
      vi = j;
    }
  }
  for (int step = 0; step < max_det; ++step) {
    warp_argmax(v, vi);
    if ((tid & 31) == 0) {
      red_v[tid >> 5] = v;
      red_i[tid >> 5] = vi;
    }
    __syncthreads();
    if (tid < 32) {
      v = tid < kWarps ? red_v[tid] : -INFINITY;
      vi = tid < kWarps ? red_i[tid] : kNoIndex;
      warp_argmax(v, vi);
      if (tid == 0) {
        pick_v = v;
        pick_i = vi;
      }
    }
    __syncthreads();
    const float best = pick_v;
    const int idx = pick_i;
    if (!(best > 0.0f)) break;  // same value in every thread: the block leaves together
    if (tid == 0) {
      kib[step] = idx;
      kvb[step] = 1;
    }
    const float bx1 = x1[idx], by1 = y1[idx], bx2 = x2[idx], by2 = y2[idx], barea = area[idx];
    v = -INFINITY;
    vi = kNoIndex;
    for (int j = tid; j < N; j += kThreads) {
      const float ov = iou(x1[j], y1[j], x2[j], y2[j], area[j], bx1, by1, bx2, by2, barea);
      float s = alive[j];
      if (ov > iou_thres || j == idx) {
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
int nms_max_candidates(int max_smem_bytes) {
  const int static_bytes = kWarps * (sizeof(float) + sizeof(int)) + sizeof(float) + sizeof(int);
  return (max_smem_bytes - static_bytes) / (6 * static_cast<int>(sizeof(float)));
}

int ymt_batched_greedy_nms(const void* boxes, const void* scores, void* keep_idx, void* keep_valid, int B, int N,
                           int max_det, float iou_thres, void* stream) {
  const int smem = 6 * N * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(batched_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  batched_nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores), N, max_det, iou_thres,
      static_cast<int32_t*>(keep_idx), static_cast<uint8_t*>(keep_valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
