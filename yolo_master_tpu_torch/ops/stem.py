"""Fused stem: conv0 (3->c0, k3 s2 p1) + SiLU, conv1 (c0->c1, k3 s2 p1) + SiLU.

Counterpart of ``yolo_master_tpu/ops/pallas_stem.py:fused_stem``. The TPU
kernel reads a space-to-depth(4) blob; the CUDA kernel (``csrc/stem.cu``) reads
the letterboxed image as it is, NHWC, uint8 (the main path) or float32.

Weights are OIHW with BatchNorm folded into the biases, and for uint8 input
the /255 folded into ``w0`` (``utils/fuse.py:fused_stem_fuse``). The kernel
reads them in HWIO memory order: :func:`stem_weight_layout` makes that copy
once, as an OIHW view, and the wrapper only checks it. The output is float32
NHWC ``[B, H/4, W/4, c1]``, whose ``permute(0, 3, 1, 2)`` is the channels_last
NCHW tensor the trunk consumes.

The kernel takes every stem width of the port's YAMLs (c0/c1 = 16/32 at scale
n, 32/64 at s, 64/128 at m and l, 96/192 at x): wide stems stage conv1's
weights in output-channel slices over a smaller tile (:func:`stem_plan`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import SMEM_LIMIT_BYTES, check, load_library, stream_ptr


def fused_stem_plain(x: torch.Tensor, w0, b0, w1, b1) -> torch.Tensor:
    """The plain PyTorch version: two ``F.conv2d`` with bias + SiLU, in the weights' dtype."""
    xf = x.permute(0, 3, 1, 2).to(w0.dtype)
    y = F.silu(F.conv2d(xf, w0, b0, stride=2, padding=1))
    y = F.silu(F.conv2d(y, w1, b1, stride=2, padding=1))
    return y.permute(0, 2, 3, 1)


def stem_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """A copy of OIHW weights ``w`` in HWIO memory order (output channel fastest),
    returned as an OIHW view: the layout :func:`fused_stem` hands to the kernel."""
    return w.detach().permute(2, 3, 1, 0).clone(memory_format=torch.contiguous_format).permute(3, 2, 0, 1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("stem")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ymt_stem_u8, lib.ymt_stem_f32):
        fn.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        fn.restype = i32
    lib.stem_smem_floats.argtypes = [i32, i32]
    lib.stem_smem_floats.restype = ctypes.c_longlong
    lib.stem_plan_of.argtypes = [i32, i32, ptr]
    lib.stem_plan_of.restype = None
    return lib


@functools.cache
def stem_plan(c0: int, c1: int) -> dict:
    """The kernel's block layout for these widths, as ``csrc/stem.cu:stem_plan``
    chooses it: conv1 tile rows and columns, the slice of conv1's output
    channels staged at a time, positions per thread, and shared memory in bytes."""
    lib = _lib()
    plan = (ctypes.c_int * 4)()
    lib.stem_plan_of(c0, c1, plan)
    return {"tile": (plan[0], plan[1]), "c1_slice": plan[2], "positions": plan[3],
            "smem_bytes": lib.stem_smem_floats(c0, c1) * 4}


def fused_stem(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
               b1: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, 3] uint8 or float32 NHWC (H, W multiples of 4); w0 [c0, 3, 3, 3],
    b0 [c0], w1 [c1, c0, 3, 3], b1 [c1] float32 -> float32 [B, H/4, W/4, c1].
    On the card w0 and w1 must be in :func:`stem_weight_layout`.

    A CPU tensor takes :func:`fused_stem_plain`; a CUDA tensor launches the kernel.
    """
    if x.device.type == "cpu":
        return fused_stem_plain(x, w0, b0, w1, b1)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem: unsupported device {x.device}")
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"fused_stem: x must be [B, H, W, 3], got {tuple(x.shape)}")
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"fused_stem: x must be uint8 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_stem: x must be a contiguous NHWC tensor")
    B, H, W, _ = x.shape
    if H % 4 or W % 4:
        raise ValueError(f"fused_stem: H and W must be multiples of 4, got {H}x{W}")
    c0, c1 = w0.shape[0], w1.shape[0]
    if c0 % 8 or c1 % 8:
        raise ValueError(f"fused_stem: the kernel needs c0 and c1 to be multiples of 8, got {c0}, {c1}")
    for name, t, shape in (("w0", w0, (c0, 3, 3, 3)), ("b0", b0, (c0,)),
                           ("w1", w1, (c1, c0, 3, 3)), ("b1", b1, (c1,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"fused_stem: {name} must be float32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("w0", w0.permute(2, 3, 1, 0)), ("w1", w1.permute(2, 3, 1, 0)), ("b0", b0), ("b1", b1)):
        if not t.is_contiguous():
            raise ValueError(f"fused_stem: {name} is not in the kernel's layout (see stem_weight_layout)")
    if stem_plan(c0, c1)["smem_bytes"] > SMEM_LIMIT_BYTES:  # no YAML the port holds gives such widths
        raise NotImplementedError(f"fused_stem: widths c0={c0}, c1={c1} exceed one block's shared memory")
    out = torch.empty((B, H // 4, W // 4, c1), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = _lib()
    fn = lib.ymt_stem_u8 if x.dtype == torch.uint8 else lib.ymt_stem_f32
    check(fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
             B, H, W, c0, c1, stream_ptr(x.device)), "stem kernel")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
