"""Fused stem: conv0 (3->c0, k3 s2 p1) + SiLU, conv1 (c0->c1, k3 s2 p1) + SiLU.

Counterpart of ``yolo_master_tpu/ops/pallas_stem.py:fused_stem``. The TPU
kernel reads a space-to-depth(4) blob; the CUDA kernels (``csrc/stem.cu``) read
the letterboxed image as it is, NHWC, uint8 (the main path), float32 or
bfloat16. They write float32, or bfloat16 for the bf16 path (uint8 or
bfloat16 in), as the TPU kernel writes the input's dtype.

Weights are OIHW with BatchNorm folded into the biases, and for uint8 input
the /255 folded into ``w0`` (``utils/fuse.py:fused_stem_fuse``), float32 in
either dtype. The kernels read them in HWIO memory order:
:func:`stem_weight_layout` makes that copy once, as an OIHW view, and the
wrapper only checks it. The output is NHWC ``[B, H/4, W/4, c1]``, whose
``permute(0, 3, 1, 2)`` is the channels_last NCHW tensor the trunk consumes.

Both kernels run the two convs as implicit GEMMs on the tensor cores, with
bias, SiLU and conv1's zero border on the CUDA cores: the fp32 forms with
split-TF32 ``wgmma`` products at fp32 accuracy, the bf16 forms with split-bf16
``wgmma`` products (each operand that is not exact in bf16 split into bf16 hi
and lo, three passes; ``ops/_bf16.py`` mirrors the arithmetic) summed in fp32.
Each reads w1 from a scratch bank, transposed, split and zero-padded, that a
small kernel writes once per w1 and form (:func:`stem_bank`, counted in
``fused_stem.bank_launches``); each call launches the stem kernel alone
(``fused_stem.launches``). They take every stem width of the port's YAMLs
(c0/c1 = 16/32 at scale n, 32/64 at s, 64/128 at m and l, 96/192 at x), with
a block layout chosen by width and form (:func:`stem_plan`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ._build import SMEM_LIMIT_BYTES, check, load_library, stream_ptr


def _out_dtype(x: torch.Tensor, w0: torch.Tensor, out_dtype) -> torch.dtype:
    """The output's dtype: ``out_dtype`` if given, else bfloat16 for bfloat16 x and w0's dtype for any other x."""
    return out_dtype or (x.dtype if x.dtype == torch.bfloat16 else w0.dtype)


def fused_stem_plain(x: torch.Tensor, w0, b0, w1, b1, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version: two ``F.conv2d`` with bias + SiLU, in the weights' dtype,
    rounded once to the output's dtype at the end (as the kernel stores it)."""
    xf = x.permute(0, 3, 1, 2).to(w0.dtype)
    y = F.silu(F.conv2d(xf, w0, b0, stride=2, padding=1))
    y = F.silu(F.conv2d(y, w1, b1, stride=2, padding=1))
    return y.permute(0, 2, 3, 1).to(_out_dtype(x, w0, out_dtype))


def stem_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """A copy of OIHW weights ``w`` in HWIO memory order (output channel fastest),
    returned as an OIHW view: the layout :func:`fused_stem` hands to the kernel."""
    return w.detach().permute(2, 3, 1, 0).clone(memory_format=torch.contiguous_format).permute(3, 2, 0, 1)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a built ``stem.cu``'s entry points."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ENTRY_POINTS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        fn.restype = i32
    for fn in (lib.ymt_stem_bank, lib.ymt_stem_bank_bf16):
        fn.argtypes = [ptr, ptr, i32, i32, ptr]
        fn.restype = i32
    for fn in (lib.stem_smem_bytes, lib.stem_bank_floats, lib.stem_bf16_smem_bytes, lib.stem_bank_bf16_bytes):
        fn.argtypes = [i32, i32]
        fn.restype = ctypes.c_longlong
    for fn in (lib.stem_plan_of, lib.stem_bf16_plan_of):
        fn.argtypes = [i32, i32, ptr]
        fn.restype = None
    return lib


# (input dtype, output dtype) -> stem.cu's entry point
ENTRY_POINTS = {(torch.uint8, torch.float32): "ymt_stem_u8", (torch.float32, torch.float32): "ymt_stem_f32",
                (torch.uint8, torch.bfloat16): "ymt_stem_u8_bf16", (torch.bfloat16, torch.bfloat16): "ymt_stem_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(load_library("stem"))


@functools.cache
def stem_plan(c0: int, c1: int, out_dtype: torch.dtype = torch.float32) -> dict:
    """The block layout of the kernel that writes ``out_dtype`` for these widths,
    as ``csrc/stem.cu`` holds it (``kPlans`` for float32, ``kBf16Plans`` for
    bfloat16): conv1 tile rows and columns, conv1 output channels per
    warpgroup, warpgroups per 64 pixels, stages of the weight ring, shared
    memory in bytes (-1 where no plan takes the widths) and the scratch
    bank's size (``bank_floats`` of float32 for the fp32 forms, ``bank_bytes``
    of bfloat16 for the bf16 forms)."""
    lib = _lib()
    plan = (ctypes.c_int * 5)()
    bf16 = out_dtype == torch.bfloat16
    (lib.stem_bf16_plan_of if bf16 else lib.stem_plan_of)(c0, c1, plan)
    out = {"tile": (plan[0], plan[1]), "c1_per_warpgroup": plan[2], "warpgroups_per_64_pixels": plan[3],
           "stages": plan[4], "smem_bytes": (lib.stem_bf16_smem_bytes if bf16 else lib.stem_smem_bytes)(c0, c1)}
    if bf16:
        return {**out, "bank_bytes": lib.stem_bank_bf16_bytes(c0, c1)}
    return {**out, "bank_floats": lib.stem_bank_floats(c0, c1)}


# w1's base tensor -> {bank form: ((address, version counter, c0, c1), bank)}: dropped with the tensor
_banks = WeakIdKeyDictionary()


def stem_bank(w1: torch.Tensor, c0: int, c1: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The scratch bank the kernel that writes ``out_dtype`` reads w1 from (w1
    in :func:`stem_weight_layout`, on the card): float32 hi/lo TF32 halves for
    the fp32 forms (``stem_bank_kernel``), bfloat16 hi/lo halves for the bf16
    forms (``stem_bank_bf16_kernel``). Written at the first call, then kept
    beside w1's base tensor, one bank per form, while w1's address and version
    counter stay the same, as ``nn/moe/dispatch.py:expert_bank`` keeps the
    expert banks. ``.to()``, ``load_state_dict`` and other in-place writes
    rebuild it; a write through ``.data`` is not seen. An inference tensor has
    no version counter: its bank is written at every call."""
    bf16 = out_dtype == torch.bfloat16
    owner = w1 if w1._base is None else w1._base
    key = None if w1.is_inference() else (w1.data_ptr(), w1._version, c0, c1)
    banks = _banks.setdefault(owner, {})
    cached = banks.get(bf16)
    if key is None or cached is None or cached[0] != key:
        plan = stem_plan(c0, c1, out_dtype)
        if bf16:
            bank = torch.empty(plan["bank_bytes"] // 2, dtype=torch.bfloat16, device=w1.device)
            entry, what = _lib().ymt_stem_bank_bf16, "stem bf16 weight-bank kernel"
        else:
            bank = torch.empty(plan["bank_floats"], dtype=torch.float32, device=w1.device)
            entry, what = _lib().ymt_stem_bank, "stem weight-bank kernel"
        check(entry(w1.data_ptr(), bank.data_ptr(), c0, c1, stream_ptr(w1.device)), what)
        fused_stem.bank_launches += 1
        cached = banks[bf16] = (key, bank)
    return cached[1]


def fused_stem(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """x [B, H, W, 3] uint8, float32 or bfloat16 NHWC (H, W multiples of 4);
    w0 [c0, 3, 3, 3], b0 [c0], w1 [c1, c0, 3, 3], b1 [c1] float32 ->
    [B, H/4, W/4, c1] in ``out_dtype`` (default: bfloat16 for bfloat16 x, else
    float32). The kernel takes uint8 -> float32 or bfloat16, float32 ->
    float32 and bfloat16 -> bfloat16. On the card w0 and w1 must be in
    :func:`stem_weight_layout`.

    A CPU tensor takes :func:`fused_stem_plain`; a CUDA tensor launches the kernel.
    """
    if x.device.type == "cpu":
        return fused_stem_plain(x, w0, b0, w1, b1, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem: unsupported device {x.device}")
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"fused_stem: x must be [B, H, W, 3], got {tuple(x.shape)}")
    out_dtype = _out_dtype(x, w0, out_dtype)
    entry = ENTRY_POINTS.get((x.dtype, out_dtype))
    if entry is None:
        raise TypeError(f"fused_stem: the kernel takes {x.dtype} -> {out_dtype} in none of its forms "
                        f"{[f'{a} -> {b}' for a, b in ENTRY_POINTS]}")
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
    plan = stem_plan(c0, c1, out_dtype)
    if not 0 < plan["smem_bytes"] <= SMEM_LIMIT_BYTES:  # no YAML the port holds gives such widths
        raise NotImplementedError(f"fused_stem: no block layout of the kernel takes widths c0={c0}, c1={c1}")
    out = torch.empty((B, H // 4, W // 4, c1), dtype=out_dtype, device=x.device)
    if B == 0:
        return out
    bank = stem_bank(w1, c0, c1, out_dtype)
    check(getattr(_lib(), entry)(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), bank.data_ptr(), b1.data_ptr(),
                                 out.data_ptr(), B, H, W, c0, c1, stream_ptr(x.device)), "stem kernel")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
fused_stem.bank_launches = 0
