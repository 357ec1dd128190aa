// Pieces shared by the greedy NMS kernels (nms.cu, cw_nms.cu): both run the
// same three phases, so that they order candidates and measure overlap
// identically.
//
//  1. Order (sort_candidates_kernel, one block per image): the candidates
//     with score > 0, sorted in shared memory by (score descending, index
//     ascending) with a bitonic sort of 64-bit keys (the inverted score bits
//     above the index). It writes the sorted indices, boxes and scores and the
//     valid count.
//  2. Mask (iou_mask_kernel, one 64-thread block per image x 64-row block x
//     64-column block, upper triangle only): bit j of word c of row i is set
//     when the later-sorted box 64c+j overlaps the earlier box i by more than
//     iou_thres. Rows and columns past the valid count are never computed.
//  3. Scan (scan_kernel, one warp per image): walks the sorted candidates and
//     keeps each one no kept box removed, ORing its mask row into the removed
//     bitset, which the warp holds in registers (64 bits x 32 lanes x WPL).
//     A 64-candidate block is decided from its diagonal words with warp
//     shuffles; the kept rows' later words are then loaded together.
//
// Why this is exact: greedy NMS with the argmax's ties to the lower index
// picks the same boxes, in the same order, as a scan over a stable
// descending sort, and IoU is symmetric bit for bit (fminf, fmaxf and
// __fadd_rn commute), so the mask holds the same comparisons the greedy loop
// makes.
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
#include <stdint.h>

namespace ymt_nms {

using u64 = unsigned long long;

constexpr int kSortThreads = 1024;
constexpr int kMaskRows = 64;                                // rows and columns of one mask block
constexpr int kMaxWordsPerLane = 8;                          // the scan's bitset: 8 words x 32 lanes
constexpr int kMaxCandidates = 64 * 32 * kMaxWordsPerLane;   // 16384: also the largest sort that fits
constexpr u64 kInvalidKey = ~0ull;

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
  // disjoint boxes (most pairs: classes lie 7680 px apart) need no division:
  // 0 / denom is +0 for any denom >= 1e-7, +inf included, and NaN only for NaN
  if (inter == 0.0f && denom == denom) return 0.0f;
  return __fdiv_rn(inter, denom);
}

inline int mask_words(int n) { return (n + 63) / 64; }

inline int sort_size(int n) {  // the bitonic sort's power of two
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The largest N the sort's keys fit in max_smem_bytes of shared memory, and the scan's bitset holds.
inline int max_candidates(int max_smem_bytes) {
  int p = kMaxCandidates;
  while (p > 64 && static_cast<long long>(p) * sizeof(u64) + 16 > max_smem_bytes) p >>= 1;
  return p;
}

// Scratch the three phases share, carved from one device buffer the wrapper
// allocates (scratch_layout(nullptr, ...) gives its size in bytes).
struct Scratch {
  int32_t* order;   // [B, N] original index of each sorted candidate
  float4* sbox;     // [B, N] its box
  float* sscore;    // [B, N] its score
  int32_t* count;   // [B] candidates with score > 0
  u64* mask;        // [B, N, mask_words(N)] IoU bitmask rows
  u64* member;      // [B, max_det, mask_words(N)] each kept box's cluster (cluster-weighted NMS only)
  int32_t* seedpos; // [B, max_det] each kept box's sorted position (cluster-weighted NMS only)
  int32_t* kept;    // [B] kept boxes (cluster-weighted NMS only)
};

inline size_t scratch_layout(void* base, int B, int N, int max_det, bool clusters, Scratch* out) {
  char* p = static_cast<char*>(base);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* q = p ? p + off : nullptr;
    off += (bytes + 255) & ~static_cast<size_t>(255);
    return static_cast<void*>(q);
  };
  const size_t bn = static_cast<size_t>(B) * N, w = mask_words(N), bd = static_cast<size_t>(B) * max_det;
  Scratch s{};
  s.order = static_cast<int32_t*>(take(bn * sizeof(int32_t)));
  s.sbox = static_cast<float4*>(take(bn * sizeof(float4)));
  s.sscore = static_cast<float*>(take(bn * sizeof(float)));
  s.count = static_cast<int32_t*>(take(B * sizeof(int32_t)));
  s.mask = static_cast<u64*>(take(bn * w * sizeof(u64)));
  if (clusters) {
    s.member = static_cast<u64*>(take(bd * w * sizeof(u64)));
    s.seedpos = static_cast<int32_t*>(take(bd * sizeof(int32_t)));
    s.kept = static_cast<int32_t*>(take(B * sizeof(int32_t)));
  }
  if (out) *out = s;
  return off;
}

// Phase 1. boxes [B,N,4], scores [B,N]; P = sort_size(N) keys in dynamic shared memory.
__global__ void __launch_bounds__(kSortThreads)
sort_candidates_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, int N, int P,
                       int32_t* __restrict__ order, float4* __restrict__ sbox, float* __restrict__ sscore,
                       int32_t* __restrict__ count) {
  extern __shared__ u64 keys[];
  __shared__ int s_count;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* sb = scores + static_cast<size_t>(b) * N;
  if (tid == 0) s_count = 0;
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < P; i += kSortThreads) {
    u64 key = kInvalidKey;
    if (i < N) {
      const float s = sb[i];
      if (s > 0.0f) {  // positive floats order as their bits: inverted, they sort descending
        key = (static_cast<u64>(~__float_as_uint(s)) << 32) | static_cast<unsigned>(i);
        ++mine;
      }
    }
    keys[i] = key;
  }
  if (mine) atomicAdd(&s_count, mine);
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < P / 2; q += kSortThreads) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));  // i has bit j clear; its partner is i | j
        const u64 a = keys[i], c = keys[i | j];
        if ((a > c) == ((i & k) == 0)) {
          keys[i] = c;
          keys[i | j] = a;
        }
      }
      __syncthreads();
    }
  }
  const int cnt = s_count;
  const size_t row = static_cast<size_t>(b) * N;
  for (int i = tid; i < cnt; i += kSortThreads) {
    const int idx = static_cast<int>(keys[i] & 0xffffffffu);
    const float* bx = boxes + (row + idx) * 4;
    order[row + i] = idx;
    sbox[row + i] = make_float4(bx[0], bx[1], bx[2], bx[3]);
    sscore[row + i] = sb[idx];
  }
  if (tid == 0) count[b] = cnt;
}

// Phase 2. Grid (W, W, B), kMaskRows threads: thread t of block (c, r) owns row 64r+t.
__global__ void __launch_bounds__(kMaskRows)
iou_mask_kernel(const float4* __restrict__ sbox, const int32_t* __restrict__ count, int N, int W, float iou_thres,
                u64* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  const int cnt = count[b];
  if (cb * kMaskRows >= cnt) return;  // columns past the valid count (rows too: rb <= cb)
  __shared__ float cx1[kMaskRows], cy1[kMaskRows], cx2[kMaskRows], cy2[kMaskRows], carea[kMaskRows];
  const int t = threadIdx.x;
  const float4* bb = sbox + static_cast<size_t>(b) * N;
  const int j = cb * kMaskRows + t;
  if (j < cnt) {
    const float4 v = bb[j];
    cx1[t] = v.x;
    cy1[t] = v.y;
    cx2[t] = v.z;
    cy2[t] = v.w;
    carea[t] = box_area(v.x, v.y, v.z, v.w);
  }
  __syncthreads();
  const int i = rb * kMaskRows + t;
  if (i >= cnt) return;
  const float4 p = bb[i];
  const float parea = box_area(p.x, p.y, p.z, p.w);
  const int jn = min(kMaskRows, cnt - cb * kMaskRows);
  u64 bits = 0;
  for (int jj = (cb == rb) ? t + 1 : 0; jj < jn; ++jj) {
    // the later-sorted box is the candidate, the earlier one the pick, as in the greedy loop
    if (iou(cx1[jj], cy1[jj], cx2[jj], cy2[jj], carea[jj], p.x, p.y, p.z, p.w, parea) > iou_thres)
      bits |= 1ull << jj;
  }
  mask[(static_cast<size_t>(b) * N + i) * W + cb] = bits;
}

// Phase 3, one warp per image. Without CLUSTERS it writes keep_idx/keep_valid
// [B, max_det] (zero-filled after the last kept box); with CLUSTERS, for each
// kept box its sorted position and its cluster: the bits its mask row newly
// sets (row & ~removed) in words [its own, count's last), and the kept count.
template <int WPL, bool CLUSTERS>
__global__ void __launch_bounds__(32)
scan_kernel(const int32_t* __restrict__ order, const int32_t* __restrict__ count, const u64* __restrict__ mask,
            int N, int W, int max_det, int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_valid,
            u64* __restrict__ member, int32_t* __restrict__ seedpos, int32_t* __restrict__ kept_out) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kBatch = WPL >= 16 ? 1 : 16 / WPL;  // kept rows whose words are loaded together
  const int b = blockIdx.x, lane = threadIdx.x;
  const int cnt = count[b], nw = (cnt + 63) >> 6;
  const u64* mb = mask + static_cast<size_t>(b) * N * W;
  const int32_t* ob = order + static_cast<size_t>(b) * N;
  const size_t slot0 = static_cast<size_t>(b) * max_det;
  u64 rem[WPL];  // word k * 32 + lane of the removed bitset
#pragma unroll
  for (int k = 0; k < WPL; ++k) rem[k] = 0;
  // this lane's rows of block w: their diagonal mask words and original indices
  auto diag = [&](int w, int h) {
    const int r = 64 * w + 32 * h + lane;
    return r < cnt ? mb[static_cast<size_t>(r) * W + w] : 0ull;
  };
  auto orig = [&](int w, int h) {
    const int r = 64 * w + 32 * h + lane;
    return r < cnt ? ob[r] : 0;
  };
  u64 d0 = diag(0, 0), d1 = diag(0, 1);
  int o0 = orig(0, 0), o1 = orig(0, 1);
  int kept = 0;
  for (int w = 0; w < nw && kept < max_det; ++w) {
    u64 mine = 0;
#pragma unroll
    for (int k = 0; k < WPL; ++k)
      if (k == (w >> 5)) mine = rem[k];
    u64 cur = __shfl_sync(kFull, mine, w & 31);
    const int rows = min(64, cnt - 64 * w);
    const int base = kept;
    u64 keepm = 0, new0 = 0, new1 = 0;
    for (int t = 0; t < rows; ++t) {  // cur is the same in every lane
      if ((cur >> t) & 1ull) continue;
      keepm |= 1ull << t;
      const u64 d = __shfl_sync(kFull, t < 32 ? d0 : d1, t & 31);
      if (CLUSTERS && lane == (t & 31)) {  // the members this kept row adds within the block
        if (t < 32)
          new0 = d & ~cur;
        else
          new1 = d & ~cur;
      }
      cur |= d;
      if (++kept == max_det) break;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      if (!((keepm >> t) & 1ull)) continue;
      const size_t slot = slot0 + base + __popcll(keepm & ((1ull << t) - 1ull));
      if (CLUSTERS) {
        seedpos[slot] = 64 * w + t;
        member[slot * W + w] = h ? new1 : new0;
      } else {
        keep_idx[slot] = h ? o1 : o0;
        keep_valid[slot] = 1;
      }
    }
    if (!CLUSTERS && kept == max_det) break;
    // the next block's words and indices, in flight while this block's rows are ORed in
    d0 = diag(w + 1, 0);
    d1 = diag(w + 1, 1);
    if (!CLUSTERS) {
      o0 = orig(w + 1, 0);
      o1 = orig(w + 1, 1);
    }
    // the kept rows' later words, kBatch rows' loads in flight together, ORed in sorted order
    u64 todo = keepm;
    int rank = 0;
    while (todo) {
      int ts[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        ts[q] = todo ? __ffsll(static_cast<long long>(todo)) - 1 : -1;
        todo &= todo - 1ull;
      }
      u64 v[kBatch][WPL];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
          const int ww = k * 32 + lane;
          v[q][k] = (ts[q] >= 0 && ww > w && ww < nw) ? mb[static_cast<size_t>(64 * w + ts[q]) * W + ww] : 0ull;
        }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
          const int ww = k * 32 + lane;
          if (CLUSTERS && ts[q] >= 0 && ww > w && ww < nw)
            member[(slot0 + base + rank + q) * W + ww] = v[q][k] & ~rem[k];
          rem[k] |= v[q][k];
        }
      }
      rank += kBatch;
    }
  }
  if (CLUSTERS) {
    if (lane == 0) kept_out[b] = kept;
  } else {
    for (int s = kept + lane; s < max_det; s += 32) {
      keep_idx[slot0 + s] = 0;
      keep_valid[slot0 + s] = 0;
    }
  }
}

// Phases 1 and 2 for boxes [B,N,4] and scores [B,N] into `s`.
inline cudaError_t launch_sort_and_mask(const float* boxes, const float* scores, int B, int N, float iou_thres,
                                        const Scratch& s, cudaStream_t stream) {
  const int P = sort_size(N);
  const int smem = P * static_cast<int>(sizeof(u64));
  cudaError_t err = cudaFuncSetAttribute(sort_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sort_candidates_kernel<<<B, kSortThreads, smem, stream>>>(boxes, scores, N, P, s.order, s.sbox, s.sscore, s.count);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int W = mask_words(N);
  iou_mask_kernel<<<dim3(W, W, B), kMaskRows, 0, stream>>>(s.sbox, s.count, N, W, iou_thres, s.mask);
  return cudaGetLastError();
}

// Phase 3 with the bitset's words per lane fitted to N.
template <bool CLUSTERS>
cudaError_t launch_scan(int B, int N, int max_det, const Scratch& s, int32_t* keep_idx, uint8_t* keep_valid,
                        cudaStream_t stream) {
  const int W = mask_words(N);
  const int wpl = (W + 31) / 32;
  auto go = [&](auto kernel) {
    kernel<<<B, 32, 0, stream>>>(s.order, s.count, s.mask, N, W, max_det, keep_idx, keep_valid, s.member, s.seedpos,
                                 s.kept);
    return cudaGetLastError();
  };
  if (wpl <= 1) return go(scan_kernel<1, CLUSTERS>);
  if (wpl <= 2) return go(scan_kernel<2, CLUSTERS>);
  if (wpl <= 4) return go(scan_kernel<4, CLUSTERS>);
  if (wpl <= kMaxWordsPerLane) return go(scan_kernel<kMaxWordsPerLane, CLUSTERS>);
  return cudaErrorInvalidValue;
}

}  // namespace ymt_nms
