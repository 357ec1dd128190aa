"""Whole-block C3k2 in one kernel (counterpart of ``yolo_master_tpu/ops/pallas_c3k2.py``).

    y   = SiLU(x @ Wcv1 + b)                      1x1, y = [y_a, y_b]
    h   = y_b
    for each bottleneck:  h = h + SiLU(conv3x3(SiLU(conv3x3(h) + b1)) + b2)
    out = SiLU([y_a, y_b, h_1 .. h_n] @ Wcv2 + b)

:func:`prepare_c3k2_weights` turns a port :class:`~..nn.layers.C3k2` block
into the JAX package's weight dict (same names, shapes and layout);
:func:`fused_c3k2` runs the block on it, with the CUDA kernel ``csrc/c3k2.cu``
on a CUDA tensor and :func:`fused_c3k2_plain` on a CPU tensor. One kernel
stands for both ``pallas_c3k2`` and ``pallas_c3k2_cf``: they differ only in
the TPU's lane layout. Tensors are NHWC, as in the JAX package.

The kernel runs each of the block's convs (cv1, the bottlenecks' 3x3 convs,
cv2 over the concat) as an implicit GEMM on the tensor cores, a split-TF32
``wgmma`` product at fp32 accuracy in 16-deep chains joined in fp32. It reads
the weights from a bank that :func:`c3k2_bank` builds in plain PyTorch once per
weight set and keeps (counted in ``fused_c3k2.bank_builds``): each stage's
[K, N] matrix (:func:`c3k2_stage_weights`) transposed K-major, each 8 K-rows in
the order of ``BANK_K_ORDER``, split hi/lo and zero-padded to 32-deep tiles, in
slabs of :func:`slab_width` output channels (:func:`c3k2_stage_bank`). C1, c,
cb and C2 must be multiples of 8.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.weak import WeakIdKeyDictionary

from ..nn.layers import Bottleneck, fold_bn
from ._build import SMEM_LIMIT_BYTES, check, load_library, stream_ptr
from ._tf32 import split_tf32

TILE_K = 32  # K rows per bank tile: one 128-byte swizzle row of floats (csrc/mma_tf32.cuh:kTileK)
# Bank column q of each group of 8 holds K row 8g + BANK_K_ORDER[q]: a thread's fragment columns kq
# and kq + 4 then hold channels 2kq and 2kq + 1, which one 8-byte load brings.
BANK_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _folded(conv) -> tuple:
    """(w OIHW, b) of a port Conv, its BN folded here if ``fuse_bn`` has not yet."""
    if isinstance(conv.bn, nn.BatchNorm2d):
        return fold_bn(conv.conv.weight, conv.conv.bias, conv.bn)
    return conv.conv.weight, conv.conv.bias


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW -> [kh*kw, I, O] (the JAX package's HWIO, taps flattened)."""
    return w.permute(2, 3, 1, 0).reshape(w.shape[2] * w.shape[3], w.shape[1], w.shape[0])


@torch.no_grad()
def prepare_c3k2_weights(block) -> Dict[str, torch.Tensor]:
    """A port C3k2 block (BN folded, or folded here) -> the dict of
    ``pallas_c3k2.py:prepare_c3k2_weights``, float32 on the block's device:
    ``cv1_w [C1,2c]``, ``cv1_b``, per bottleneck i ``m{i}_w1 [9,2c,cb]`` (zero
    rows outside its input segment), ``m{i}_b1``, ``m{i}_w2 [9,cb,c]``,
    ``m{i}_b2``, ``m{i}_sel [2c,c]``, ``cv2_y [2c,C2]``, ``cv2_m{i} [2c,C2]``
    (zero rows c..2c) and ``cv2_b``.

    The kernel computes only plain Bottleneck inner blocks with their shortcut
    (it always adds it, ``pallas_c3k2.py:139-142``). So this raises
    ``NotImplementedError`` for a ``c3k=True`` block (C3k inner blocks) and for
    Bottlenecks without the shortcut, where the JAX function computes a wrong
    answer without saying so.
    """
    if not all(isinstance(m, Bottleneck) for m in block.m):
        raise NotImplementedError("fused C3k2 takes only Bottleneck inner blocks (c3k=False), "
                                  "as pallas_c3k2 computes them")
    for m in block.m:
        if not m.add:
            raise NotImplementedError("fused C3k2 always adds the Bottleneck shortcut; this block has none")
        for conv in (m.cv1.conv, m.cv2.conv):
            if conv.kernel_size != (3, 3) or conv.groups != 1 or conv.stride != (1, 1) or conv.dilation != (1, 1):
                raise NotImplementedError(f"fused C3k2 takes dense stride-1 3x3 Bottleneck convs, got {conv}")
    c, n = block.c, len(block.m)
    out = {}
    w1, b1 = _folded(block.cv1)
    out["cv1_w"] = _hwio(w1)[0].float()
    out["cv1_b"] = b1.float()
    for i, m in enumerate(block.m):
        wa, ba = _folded(m.cv1)
        wz, bz = _folded(m.cv2)
        cb = wa.shape[0]
        lo = c if i == 0 else 0  # bottleneck 0 reads y_b (lanes c:2c), later ones h (lanes 0:c)
        wa_full = wa.new_zeros(9, 2 * c, cb)
        wa_full[:, lo:lo + c] = _hwio(wa)
        out[f"m{i}_w1"] = wa_full.float()
        out[f"m{i}_b1"] = ba.float()
        out[f"m{i}_w2"] = _hwio(wz).float()
        out[f"m{i}_b2"] = bz.float()
        sel = wa.new_zeros(2 * c, c)
        sel[lo:lo + c] = torch.eye(c, dtype=sel.dtype, device=sel.device)
        out[f"m{i}_sel"] = sel.float()
    w2, b2 = _folded(block.cv2)
    w2 = _hwio(w2)[0]  # [(2+n)c, C2]
    out["cv2_y"] = w2[:2 * c].float()
    for i in range(n):
        pad = w2.new_zeros(2 * c, w2.shape[1])
        pad[:c] = w2[(2 + i) * c:(3 + i) * c]
        out[f"cv2_m{i}"] = pad.float()
    out["cv2_b"] = b2.float()
    return {k: v.detach().contiguous() for k, v in out.items()}


def _conv3x3(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC h, [9, I, O] taps -> NHWC, SAME zero padding."""
    wt = w.reshape(3, 3, w.shape[1], w.shape[2]).permute(3, 2, 0, 1)
    return F.conv2d(h.permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1)


def fused_c3k2_plain(x: torch.Tensor, weights: Dict[str, torch.Tensor], c: int, n: int) -> torch.Tensor:
    """The plain PyTorch version, step for step the JAX kernel's arithmetic
    (full-width h, selector matmuls and per-segment cv2 row blocks)."""
    w = weights
    x = x.float()
    y = F.silu(x @ w["cv1_w"] + w["cv1_b"])  # [B,H,W,2c]
    h = y
    acc = y @ w["cv2_y"]
    for i in range(n):
        a = F.silu(_conv3x3(h, w[f"m{i}_w1"]) + w[f"m{i}_b1"])
        z = F.silu(_conv3x3(a, w[f"m{i}_w2"]) + w[f"m{i}_b2"])
        hseg = h @ w[f"m{i}_sel"] + z
        h = torch.cat([hseg, torch.zeros_like(hseg)], -1)
        acc = acc + h @ w[f"cv2_m{i}"]
    return F.silu(acc + w["cv2_b"])


def slab_width(n: int) -> int:
    """Output channels per bank slab for a stage of ``n`` (a multiple of 8), as ``csrc/c3k2.cu:slab_width``."""
    return 32 if n % 32 == 0 else 16 if n % 16 == 0 else 8


def c3k2_stage_weights(weights: Dict[str, torch.Tensor], c: int, n: int) -> list:
    """Each conv stage's weights as one [K, N] matrix, in the kernel's order: cv1's y_b
    (``cv1_w[:, c:]``) and y_a (``cv1_w[:, :c]``), per bottleneck its 3x3 convs with K
    tap-major (the live rows of ``m{i}_w1``, then ``m{i}_w2``), and cv2 over the
    concat [y_a, y_b, h_1 .. h_n] (``cv2_y`` and the live rows of each ``cv2_m{i}``)."""
    w = weights
    mats = [w["cv1_w"][:, c:], w["cv1_w"][:, :c]]
    for i in range(n):
        lo = c if i == 0 else 0
        w1 = w[f"m{i}_w1"][:, lo:lo + c]
        mats += [w1.reshape(9 * c, w1.shape[2]), w[f"m{i}_w2"].reshape(-1, c)]
    mats.append(torch.cat([w["cv2_y"]] + [w[f"cv2_m{i}"][:c] for i in range(n)]))
    return mats


def c3k2_stage_bank(w: torch.Tensor) -> torch.Tensor:
    """One stage's [K, N] weights -> its bank ``[N / slab_width, ceil(K / 32), 2 (hi, lo), slab_width, 32]``:
    transposed K-major, K rows in ``BANK_K_ORDER`` within each 8, zeros past K, split hi/lo (each
    32-deep k-tile holds hi's rows, then lo's)."""
    k, o = w.shape
    nw, kp = slab_width(o), -(-k // TILE_K) * TILE_K
    order = torch.tensor(BANK_K_ORDER, device=w.device)
    rows = (torch.arange(0, kp, 8, device=w.device)[:, None] + order).reshape(-1)
    padded = torch.zeros(kp, o, dtype=torch.float32, device=w.device)
    padded[:k] = w
    t = padded[rows].T.reshape(o // nw, nw, kp // TILE_K, TILE_K).permute(0, 2, 1, 3)
    return torch.stack(split_tf32(t.contiguous()), 2).contiguous()


def build_c3k2_bank(weights: Dict[str, torch.Tensor], c: int, n: int) -> torch.Tensor:
    """The kernel's weight bank, flat: every stage's :func:`c3k2_stage_bank` in order."""
    return torch.cat([c3k2_stage_bank(w).reshape(-1) for w in c3k2_stage_weights(weights, c, n)])


# cv1_w's base tensor -> (key, bank): dropped with the tensor
_banks = WeakIdKeyDictionary()
_BANK_NAMES = ("cv1_w", "m{i}_w1", "m{i}_w2", "cv2_y", "cv2_m{i}")


@torch.no_grad()
def c3k2_bank(weights: Dict[str, torch.Tensor], c: int, n: int) -> torch.Tensor:
    """:func:`build_c3k2_bank`, built at the first call and then kept beside
    ``cv1_w``'s base tensor while every weight matrix's address and version
    counter stay the same, as ``ops/stem.py:stem_bank`` keeps the stem's.
    An in-place write or a new tensor in the dict rebuilds it; a write through
    ``.data`` is not seen. Inference tensors have no version counter: their
    bank is built at every call."""
    mats = [weights[name.format(i=i)] for name in _BANK_NAMES for i in range(n if "{i}" in name else 1)]
    owner = mats[0] if mats[0]._base is None else mats[0]._base
    key = None if any(t.is_inference() for t in mats) else (tuple((t.data_ptr(), t._version) for t in mats), c, n)
    cached = _banks.get(owner)
    if key is None or cached is None or cached[0] != key:
        cached = _banks[owner] = (key, build_c3k2_bank(weights, c, n))
        fused_c3k2.bank_builds += 1
    return cached[1]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("c3k2")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ymt_c3k2.argtypes = [ptr, ptr, ptr, ctypes.POINTER(ptr)] + [i32] * 8 + [ptr]
    lib.ymt_c3k2.restype = i32
    lib.c3k2_smem_bytes.argtypes = [i32] * 5
    lib.c3k2_smem_bytes.restype = i32
    lib.c3k2_bank_floats.argtypes = [i32] * 5
    lib.c3k2_bank_floats.restype = ctypes.c_longlong
    lib.c3k2_max_bottlenecks.argtypes = []
    lib.c3k2_max_bottlenecks.restype = i32
    return lib


def _biases(weights, n: int) -> list:
    """The biases in the kernel's order (``csrc/c3k2.cu:ymt_c3k2``)."""
    names = ["cv1_b"] + [f"m{i}_b{j}" for i in range(n) for j in (1, 2)] + ["cv2_b"]
    return [weights[k] for k in names]


def _check_args(x, weights, c, n):
    if x.dim() != 4:
        raise ValueError(f"fused_c3k2: x must be [B, H, W, C], got {tuple(x.shape)}")
    c1 = x.shape[3]
    cb = weights["m0_b1"].shape[0] if n >= 1 else 0
    c2 = weights["cv2_b"].shape[0]
    lib = _lib()
    if not 1 <= n <= lib.c3k2_max_bottlenecks():
        raise NotImplementedError(f"fused_c3k2: the kernel takes 1..{lib.c3k2_max_bottlenecks()} bottlenecks, got {n}")
    if c1 % 8 or c % 8 or cb % 8 or c2 % 8:
        raise NotImplementedError(f"fused_c3k2: the kernel needs C1, c, cb and C2 to be multiples of 8 (the depth "
                                  f"of a tensor-core step), got {c1}, {c}, {cb}, {c2}")
    if lib.c3k2_smem_bytes(c1, c, cb, c2, n) > SMEM_LIMIT_BYTES:
        raise NotImplementedError(f"fused_c3k2: C1={c1}, c={c}, cb={cb}, C2={c2}, n={n} need "
                                  f"{lib.c3k2_smem_bytes(c1, c, cb, c2, n)} bytes of shared memory, more than one "
                                  f"block's {SMEM_LIMIT_BYTES}")
    shapes = {"cv1_w": (c1, 2 * c), "cv1_b": (2 * c,), "cv2_y": (2 * c, c2), "cv2_b": (c2,)}
    for i in range(n):
        shapes.update({f"m{i}_w1": (9, 2 * c, cb), f"m{i}_b1": (cb,), f"m{i}_w2": (9, cb, c), f"m{i}_b2": (c,),
                       f"cv2_m{i}": (2 * c, c2)})
    for name, shape in shapes.items():
        t = weights[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_c3k2: {name} must be {shape}, got {tuple(t.shape)}")
    for name, t in [("x", x)] + [(k, weights[k]) for k in shapes]:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_c3k2: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_c3k2: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_c3k2: {name} must be contiguous (x: a channels_last NCHW map viewed as NHWC)")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_c3k2: {name} must be 16-byte aligned for the kernel's float4 loads")


def fused_c3k2(x: torch.Tensor, weights: Dict[str, torch.Tensor], c: int, n: int) -> torch.Tensor:
    """x [B,H,W,C1] NHWC, ``weights`` from :func:`prepare_c3k2_weights`, hidden
    width ``c`` and ``n`` bottlenecks -> [B,H,W,C2] float32 NHWC.

    A CPU tensor takes :func:`fused_c3k2_plain`; a CUDA tensor launches the kernel
    (after :func:`c3k2_bank` at a weight set's first call).
    """
    if x.device.type == "cpu":
        return fused_c3k2_plain(x, weights, c, n)
    if x.device.type != "cuda":
        raise ValueError(f"fused_c3k2: unsupported device {x.device}")
    _check_args(x, weights, c, n)
    b, h, w, c1 = x.shape
    cb, c2 = weights["m0_b1"].shape[0], weights["cv2_b"].shape[0]
    out = torch.empty((b, h, w, c2), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    bank = c3k2_bank(weights, c, n)
    if bank.numel() != _lib().c3k2_bank_floats(c1, c, cb, c2, n):  # the two sides' layouts disagree
        raise RuntimeError(f"fused_c3k2: the bank holds {bank.numel()} floats, the kernel reads "
                           f"{_lib().c3k2_bank_floats(c1, c, cb, c2, n)}")
    ptrs = (ctypes.c_void_p * (2 + 2 * n))(*[t.data_ptr() for t in _biases(weights, n)])
    check(_lib().ymt_c3k2(x.data_ptr(), out.data_ptr(), bank.data_ptr(), ptrs, b, h, w, c1, c, cb, c2, n,
                          stream_ptr(x.device)), "c3k2 kernel")
    fused_c3k2.launches += 1
    return out


fused_c3k2.launches = 0
fused_c3k2.bank_builds = 0
