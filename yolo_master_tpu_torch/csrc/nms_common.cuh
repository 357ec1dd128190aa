// Pieces shared by the greedy NMS kernels (nms.cu, cw_nms.cu), so that both
// pick candidates and measure overlap identically.
//
// Picks: a block-wide argmax over (value, index) pairs that prefers the lower
// index on equal values, as jnp.argmax does.
//
// IoU rounds exactly as the JAX expression does:
//   inter / (areas + barea - inter + 1e-7), evaluated left to right,
// with areas = max(x2-x1,0) * max(y2-y1,0). Every operation is written with
// the _rn intrinsics, which nvcc never contracts into an FMA, and the files
// are built with -fmad=false as well: a fused multiply-add would round
// differently and flip boxes that sit on the threshold.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ymt_nms {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ void take_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, v2, i2);
  }
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

// IoU of box (x1, y1, x2, y2) of area `area` with the pick (bx1, by1, bx2, by2) of area `barea`.
__device__ __forceinline__ float iou(float x1, float y1, float x2, float y2, float area, float bx1, float by1,
                                     float bx2, float by2, float barea) {
  const float iw = fmaxf(__fsub_rn(fminf(x2, bx2), fmaxf(x1, bx1)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(y2, by2), fmaxf(y1, by1)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(area, barea), inter), 1e-7f);
  return __fdiv_rn(inter, denom);
}

}  // namespace ymt_nms
