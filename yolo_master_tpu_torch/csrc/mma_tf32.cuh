// Split-TF32 matrix products on Hopper's tensor cores, shared by moe.cu,
// esmoe.cu, stem.cu and c3k2.cu.
//
// A TF32 operand keeps 10 mantissa bits, so one tensor-core pass holds about
// three decimal digits. The kernels keep fp32 accuracy by splitting every
// operand in two TF32 halves,
//   x = hi + lo,  hi = tf32(x),  lo = tf32(x - hi)   (x - hi is exact in fp32)
// and summing three products into one fp32 accumulator, small terms first:
//   a * b ~= lo_a * hi_b + hi_a * lo_b + hi_a * hi_b
// The dropped lo_a * lo_b term and the rounding of lo are about 2^-22 of
// |a| * |b|, fp32's own rounding step.
//
// The products are warpgroup instructions (wgmma.mma_async, 128 threads, a
// 64-row tile, depth 8 = 32 bytes of TF32). TF32 wgmma reads both operands
// K-major (the depth contiguous), so a weight matrix stored [C, O] is staged
// transposed, [O, C]. Operand tiles in shared memory are [rows][32] floats,
// 128 bytes a row, with the 128-byte swizzle (16-byte chunk index XOR row % 8);
// a tile starts at a multiple of 1024 bytes. The depth-8 steps of a 32-wide tile
// are reached by advancing the descriptor's address by 32 bytes.
//
// Here: the split (and a cheaper form of it for finite values), the swizzled offset, the shared-memory matrix descriptor,
// wgmma in the two forms the kernels use (A and B from shared memory, N = 64;
// A from registers, N = 8 to 128) with its fence / commit / wait, a 16-byte
// cp.async with zero fill, the kernel that writes a weight bank transposed
// and split to scratch, and the loads and stores of a kernel's I/O type
// (uint8, float or bfloat16, widened to and rounded from fp32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

constexpr int kTileK = 32;                    // floats per tile row: one 128-byte swizzle row
constexpr int kStepsPerTile = kTileK / 8;     // depth-8 wgmma steps per tile
constexpr int kStepDescAdvance = 32 >> 4;     // 32 bytes, in the descriptor's 16-byte units

__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

// x = hi + lo with both halves TF32 (as fp32 bit patterns).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// The split by integer arithmetic on the bits, for finite x: adding half a TF32 step to the bit
// pattern and clearing the 13 dropped bits rounds the magnitude to nearest, ties away from zero, as
// cvt.rna.tf32.f32 does (which ptxas expands to about four instructions with an infinity test), in
// two. Bit for bit the split above for every finite x (ops/_tf32.py:round_tf32 is the same rounding).
__device__ __forceinline__ uint32_t round_tf32_finite(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split_finite(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32_finite(x);
  lo = round_tf32_finite(x - __uint_as_float(hi));
}

// Offset in floats of element (row, col) of a swizzled [rows][32] tile.
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * kTileK + ((((col >> 2) ^ (row & 7)) << 2) | (col & 3));
}

// Offset in floats of the 16-byte chunk `chunk` (0..7) of `row`.
__device__ __forceinline__ int swizzled_chunk(int row, int chunk) {
  return row * kTileK + ((chunk ^ (row & 7)) << 2);
}

// First 1024-byte boundary at or after p (dynamic shared memory promises 16).
__device__ __forceinline__ float* align_tile(void* p) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// Matrix descriptor of a K-major, 128-byte-swizzled tile: address / 16 in bits
// 0-13, the leading offset (unused in this layout) 1 in bits 16-29, the stride
// between 8-row groups (1024 bytes) / 16 in bits 32-45, swizzle mode 1 in bits 62-63.
__device__ __forceinline__ uint64_t tile_desc(const float* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// 16-byte asynchronous copy to shared memory; zeros when !valid (src is not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes shared-memory writes of this thread visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define TF32_ACC8(d, i)                                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])

// d[64 x 64] += A[64 x 8] * B[64 x 8]^T, both from shared memory. Thread t of
// the warpgroup holds d[4j + {0,1}] = (row 16*(t/32) + (t%32)/4, cols 8j + 2*(t%4) + {0,1})
// and d[4j + {2,3}] the same columns eight rows below.
__device__ __forceinline__ void wgmma_m64n64k8_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : TF32_ACC8(d, 0), TF32_ACC8(d, 8), TF32_ACC8(d, 16), TF32_ACC8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 128] += A[64 x 8] * B[128 x 8]^T, A from registers: thread t holds
// a[0] = (row 16*(t/32) + (t%32)/4, col t%4), a[1] eight rows below, a[2] and
// a[3] the same rows four columns on. d as above, j < 16.
__device__ __forceinline__ void wgmma_m64n128k8_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : TF32_ACC8(d, 0), TF32_ACC8(d, 8), TF32_ACC8(d, 16), TF32_ACC8(d, 24), TF32_ACC8(d, 32), TF32_ACC8(d, 40),
        TF32_ACC8(d, 48), TF32_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The register form at the narrower widths the stem and C3k2 kernels use (N = 8,
// 16, 32, 64, 96): A and d laid out as in wgmma_m64n128k8_rs, j < N / 8.
__device__ __forceinline__ void wgmma_m64n8k8_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n16k8_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : TF32_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k8_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : TF32_ACC8(d, 0), TF32_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k8_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : TF32_ACC8(d, 0), TF32_ACC8(d, 8), TF32_ACC8(d, 16), TF32_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n96k8_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      : TF32_ACC8(d, 0), TF32_ACC8(d, 8), TF32_ACC8(d, 16), TF32_ACC8(d, 24), TF32_ACC8(d, 32), TF32_ACC8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef TF32_ACC8

// The register form by width N (8, 16, 32, 64, 96 or 128).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 8) wgmma_m64n8k8_rs(d, a, desc_b);
  else if constexpr (N == 16) wgmma_m64n16k8_rs(d, a, desc_b);
  else if constexpr (N == 32) wgmma_m64n32k8_rs(d, a, desc_b);
  else if constexpr (N == 64) wgmma_m64n64k8_rs(d, a, desc_b);
  else if constexpr (N == 96) wgmma_m64n96k8_rs(d, a, desc_b);
  else {
    static_assert(N == 128, "wgmma_rs: N must be 8, 16, 32, 64, 96 or 128");
    wgmma_m64n128k8_rs(d, a, desc_b);
  }
}

// Keeps the compiler from moving uses of wgmma's registers across a wait.
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Row and column (within the warpgroup's 64-row tile) of accumulator d[4j + i].
__device__ __forceinline__ int acc_row(int tid_in_group, int i) {
  return 16 * (tid_in_group >> 5) + ((tid_in_group & 31) >> 2) + ((i & 2) << 2);
}
__device__ __forceinline__ int acc_col(int tid_in_group, int j, int i) { return 8 * j + 2 * (tid_in_group & 3) + (i & 1); }

// Writes a weight bank transposed and split, for wgmma's K-major B operand:
//   bank[g][0 = hi, 1 = lo][o][c] = split(sum_k wts[g,k] * w[idx[g,k]][c][o])
// for o < opad, c < cpad, zeros outside [C, O]. With idx == nullptr group g is
// w[g] itself. A slot whose index lies outside [0, E) adds nothing.
// Grid (cpad/32, opad/32, groups), block (32, 8).
static __global__ void __launch_bounds__(256)
split_bank_kernel(const float* __restrict__ w, const int* __restrict__ idx, const float* __restrict__ wts,
                  float* __restrict__ bank, int C, int O, int E, int K, int cpad, int opad) {
  __shared__ float tile[32][33];
  const int g = blockIdx.z, c0 = blockIdx.x * 32, o0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, o = o0 + tx;
    float v = 0.0f;
    if (c < C && o < O) {
      if (idx == nullptr) {
        v = __ldg(w + (static_cast<size_t>(g) * C + c) * O + o);
      } else {
        for (int k = 0; k < K; ++k) {
          const int e = __ldg(idx + g * K + k);
          if (e < 0 || e >= E) continue;
          v = fmaf(__ldg(wts + g * K + k), __ldg(w + (static_cast<size_t>(e) * C + c) * O + o), v);
        }
      }
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int o = o0 + i, c = c0 + tx;
    uint32_t hi, lo;
    split(tile[tx][i], hi, lo);
    float* dst = bank + (static_cast<size_t>(g) * 2 * opad + o) * cpad + c;
    dst[0] = __uint_as_float(hi);
    dst[static_cast<size_t>(opad) * cpad] = __uint_as_float(lo);
  }
}

// An input element as fp32 (exact for each type).
__device__ __forceinline__ float to_float(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Two adjacent outputs in the output's type; bfloat16 rounded to nearest even, as PyTorch's cast.
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

}  // namespace tf32
