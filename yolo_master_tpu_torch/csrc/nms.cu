// Exact greedy NMS for a batch of images, as a sort, an IoU bitmask and a scan.
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
// The same keep set, in the same order, comes from a scan over the
// candidates sorted by (score descending, index ascending) that keeps each
// one no kept box overlaps by more than iou_thres (nms_common.cuh, which also
// says why the two agree bit for bit, ties and boxes on the threshold
// included).
//
// What bounds it on the H100: latency. Written as the TPU kernel's step loop,
// each of up to 300 dependent steps is a block-wide argmax and a pass over N
// (two barriers, ~2.2 us a step), on one SM per image. Here the work that
// does not depend on earlier picks runs in parallel across the card: the
// sort (one block per image), and all N^2/2 overlaps of the upper triangle
// (B * N/64 * N/64 / 2 blocks, ~34 M IoUs at B=16, N=2048, about 0.5 GFLOP).
// What stays sequential is the scan: one warp per image decides 64
// candidates at a time from registers and warp shuffles, with one round of
// loads (L2 hits: the 8 MB mask fits the 50 MB L2) per 64 candidates, and
// stops at max_det kept.
//
// Three kernels on the caller's stream; the scratch (sorted candidates,
// count, mask) is one device buffer the wrapper allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_common.cuh"

extern "C" {

// Largest N: the sort's keys in one block's shared memory.
int nms_max_candidates(int max_smem_bytes) { return ymt_nms::max_candidates(max_smem_bytes); }

size_t nms_scratch_bytes(int B, int N, int max_det) {
  return ymt_nms::scratch_layout(nullptr, B, N, max_det, false, nullptr);
}

// boxes [B,N,4] xyxy fp32 (class offset applied), scores [B,N] fp32 (invalid <= 0)
// -> keep_idx [B,max_det] int32, keep_valid [B,max_det] bool (one byte each).
int ymt_batched_greedy_nms(const void* boxes, const void* scores, void* keep_idx, void* keep_valid, void* scratch,
                           int B, int N, int max_det, float iou_thres, void* stream) {
  ymt_nms::Scratch s;
  ymt_nms::scratch_layout(scratch, B, N, max_det, false, &s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ymt_nms::launch_sort_and_mask(static_cast<const float*>(boxes), static_cast<const float*>(scores),
                                                  B, N, iou_thres, s, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(ymt_nms::launch_scan<false>(B, N, max_det, s, static_cast<int32_t*>(keep_idx),
                                                      static_cast<uint8_t*>(keep_valid), st));
}

}  // extern "C"
