// Split-bf16 matrix products on Hopper's tensor cores, for stem.cu's bf16 forms.
//
// A bf16 operand keeps 8 significant bits, so one tensor-core pass holds about
// two decimal digits: too few for the stem's bf16 gate (chip_smoke.py's
// bf16_rounding_apart), which one pass fails on about 40% of the outputs. The
// kernels keep the products at about 2^-16 of |a||b| by splitting each operand in
// two bf16 halves,
//   x = hi + lo,  hi = bf16(x),  lo = bf16(x - hi)   (round to nearest even; x - hi is exact in fp32)
// and summing three products in fp32, small terms first:
//   a * b ~= lo_a * hi_b + hi_a * lo_b + hi_a * hi_b
// The dropped lo_a * lo_b term and the rounding of lo are each about 2^-16 of
// |a| * |b|. A value that is exact in bf16 (a uint8 pixel, a bf16 input) needs
// no split: two passes against the other operand's halves. bf16 wgmma runs at
// twice the TF32 rate (989 against 495 TFLOP/s dense) and its operands take half
// the bytes, so three bf16 passes cost about what 1.5 TF32 passes do.
//
// The products are warpgroup instructions (wgmma.mma_async m64nNk16, 128
// threads, a 64-row tile, depth 16 = 32 bytes of bf16) in the register form:
// thread t holds A as four registers of two bf16 each, the lower column in the
// low half: a[0] = (row 16*(t/32) + (t%32)/4, columns 2*(t%4) + {0,1}), a[1] the
// same columns eight rows below, a[2] and a[3] the same rows eight columns on.
// B is read K-major from shared memory in the tiles mma_tf32.cuh describes
// ([rows][128 bytes], 128-byte swizzle, 1024-byte aligned; tf32::tile_desc): a
// row holds 64 bf16, and a depth-16 step advances the descriptor by 32 bytes
// (tf32::kStepDescAdvance). The accumulator's layout is TF32's (tf32::acc_row).
// scale_d = 0 starts a chain from zero: d = A * B, d's old values unread.

#pragma once

#include "mma_tf32.cuh"

namespace bf16x {

constexpr int kTileK = 64;  // bf16 per tile row: one 128-byte swizzle row

// Two floats -> a bf16 pair (rounded to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack(float a, float b) {
  uint32_t v;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(v) : "f"(b), "f"(a));  // the first source goes to the high half
  return v;
}

// The low and high bf16 of a pair, as fp32 (exact).
__device__ __forceinline__ float low(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float high(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// (a, b) = hi + lo, pair by pair.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack(a, b);
  lo = pack(a - low(hi), b - high(hi));
}

// Offset in bf16 of element (row, col) of a swizzled [rows][64] tile.
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * kTileK + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

#define BF16_ACC8(d, i)                                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])

// d[64 x N] (+)= A[64 x 16] * B[N x 16]^T, A from registers, B K-major from shared memory; d as
// tf32::wgmma_m64n128k8_rs lays it out, j < N / 8. scale_d = 0: d = A * B.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : BF16_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : BF16_ACC8(d, 0), BF16_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : BF16_ACC8(d, 0), BF16_ACC8(d, 8), BF16_ACC8(d, 16), BF16_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : BF16_ACC8(d, 0), BF16_ACC8(d, 8), BF16_ACC8(d, 16), BF16_ACC8(d, 24), BF16_ACC8(d, 32), BF16_ACC8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : BF16_ACC8(d, 0), BF16_ACC8(d, 8), BF16_ACC8(d, 16), BF16_ACC8(d, 24), BF16_ACC8(d, 32), BF16_ACC8(d, 40),
        BF16_ACC8(d, 48), BF16_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


#undef BF16_ACC8

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  if constexpr (N == 16) wgmma_m64n16k16_rs(d, a, desc_b, scale_d);
  else if constexpr (N == 32) wgmma_m64n32k16_rs(d, a, desc_b, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16_rs(d, a, desc_b, scale_d);
  else if constexpr (N == 96) wgmma_m64n96k16_rs(d, a, desc_b, scale_d);
  else {
    static_assert(N == 128, "bf16x::wgmma_rs: N must be 16, 32, 64, 96 or 128");
    wgmma_m64n128k16_rs(d, a, desc_b, scale_d);
  }
}

}  // namespace bf16x
