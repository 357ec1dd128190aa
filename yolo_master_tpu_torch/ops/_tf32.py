"""The arithmetic of the split-TF32 product that ``csrc/mma_tf32.cuh`` runs on
the tensor cores, in plain PyTorch, for the tests.

TF32 keeps 10 explicit mantissa bits of a float32. The kernels split every
operand as ``x = hi + lo`` with both halves TF32 and sum three tensor-core
products in float32, ``a @ b ~= lo_a @ hi_b + hi_a @ lo_b + hi_a @ hi_b``,
which holds float32 accuracy; one TF32 pass alone keeps about three decimal
digits. Nothing on a model path calls this module.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check, load_library, stream_ptr

_DROPPED_BITS = 13  # float32's 23 mantissa bits less TF32's 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero, as ``cvt.rna.tf32.f32``),
    by integer arithmetic on the bits; finite inputs."""
    bits = x.contiguous().view(torch.int32)
    # the sign lives in the top bit, so adding half a step to the bit pattern rounds the magnitude
    rounded = (bits + (1 << (_DROPPED_BITS - 1))) & ~((1 << _DROPPED_BITS) - 1)
    return rounded.view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x float32 -> (hi, lo), both TF32 values stored as float32, with hi + lo ~= x to 2^-21 |x|."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def matmul_tf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: operands rounded to TF32, products summed in float32."""
    return round_tf32(a) @ round_tf32(b)


def matmul_split_tf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The three-term split product, small terms first, summed in float32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("mma_tf32_check")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ymt_split_product_check.argtypes = [ptr] * 4 + [i32, ptr]
    lib.ymt_split_product_check.restype = i32
    return lib


def split_product_check(a: torch.Tensor, b: torch.Tensor, depth: int = 32):
    """The header's self-check on the card: a [64,32], b [128,32] (both K-major,
    float32, CUDA) -> (a @ b[:64].T by the shared-memory form, a @ b.T by the
    register form), reading only the first ``depth`` columns of both."""
    if a.device.type != "cuda" or tuple(a.shape) != (64, 32) or tuple(b.shape) != (128, 32):
        raise ValueError(f"split_product_check: CUDA a [64,32], b [128,32]; got {a.device}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if depth % 4 or not 0 <= depth <= 32:
        raise ValueError(f"split_product_check: depth must be a multiple of 4 in 0..32, got {depth}")
    a, b = a.float().contiguous(), b.float().contiguous()
    d_ss = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    d_rs = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    check(_lib().ymt_split_product_check(a.data_ptr(), b.data_ptr(), d_ss.data_ptr(), d_rs.data_ptr(), depth,
                                         stream_ptr(a.device)), "split-TF32 self-check kernel")
    return d_ss, d_rs
