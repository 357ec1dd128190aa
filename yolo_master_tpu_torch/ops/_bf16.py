"""The arithmetic of the split-bf16 product that ``csrc/mma_bf16.cuh`` runs on
the tensor cores (the stem kernel's bf16 forms), in plain PyTorch, for the
tests; and the gate a kernel's bf16 output is held to.

bf16 keeps 8 significant bits of a float32. The kernels split an operand as
``x = hi + lo`` with both halves bf16 (rounded to nearest even) and sum three
tensor-core products in float32, ``a @ b ~= lo_a @ hi_b + hi_a @ lo_b + hi_a @ hi_b``,
which holds each term to about 2^-16; one bf16 pass alone keeps 2^-8. An
operand that is exact in bf16 (uint8 pixels, bf16 input) needs no split. Nothing
on a model path calls this module.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check, load_library, stream_ptr


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 value (ties to even, as ``cvt.rn.bf16x2.f32``), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor):
    """x float32 -> (hi, lo), both bf16 values stored as float32, with hi + lo ~= x to 2^-16 |x|."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def matmul_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 pass: operands rounded to bf16, products summed in float32."""
    return round_bf16(a) @ round_bf16(b)


def matmul_split_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The three-term split product, small terms first, summed in float32."""
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each element of t (8 significant bits)."""
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), torch.frexp(t.float().abs()).exponent - 8)


def bf16_rounding_apart(out: torch.Tensor, ref: torch.Tensor):
    """A bf16 result against a reference rounded once to bf16 from an fp32 result
    that the fp32 gate holds within 1e-4 + 1e-4*|ref|: (every pair within 1 bf16
    ulp of |ref| plus that gate, the share of outputs that differ at all). The
    gate: the first true and the share at most 1% (a wrong rounding mode, or
    products one bf16 pass deep, move far more)."""
    err = (out.float() - ref.float()).abs()
    within = bool((err <= bf16_ulp(ref) + 1e-4 + 1e-4 * ref.float().abs()).all())
    return within, (err > 0).float().mean().item()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("mma_bf16_check")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ymt_split_product_check_bf16.argtypes = [ptr] * 5 + [i32, ptr]
    lib.ymt_split_product_check_bf16.restype = i32
    return lib


def split_product_check_bf16(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, depth: int = 32):
    """The header's self-check on the card: a [64,32], b [128,32] (both K-major),
    c [64,128], float32, CUDA -> (a @ b.T as the stem's bf16 forms compute it,
    c + bf16(a) @ bf16(b).T accumulated by the tensor cores onto c), reading only
    the first ``depth`` columns of a and b."""
    if a.device.type != "cuda" or tuple(a.shape) != (64, 32) or tuple(b.shape) != (128, 32) \
            or tuple(c.shape) != (64, 128):
        raise ValueError(f"split_product_check_bf16: CUDA a [64,32], b [128,32], c [64,128]; got {a.device}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    if depth % 2 or not 0 <= depth <= 32:
        raise ValueError(f"split_product_check_bf16: depth must be even, in 0..32, got {depth}")
    a, b, c = (t.float().contiguous() for t in (a, b, c))
    d_split = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    d_acc = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    check(_lib().ymt_split_product_check_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(), d_split.data_ptr(),
                                              d_acc.data_ptr(), depth, stream_ptr(a.device)),
          "split-bf16 self-check kernel")
    return d_split, d_acc
