"""Fused dense ES_MOE block (counterpart of ``yolo_master_tpu/ops/pallas_esmoe.py``).

    w   = softmax(MLP(GAP(x)))                      # [B, E], computed outside
    y_e = SiLU(pw_e(dw_e(x)) + pb_e)                # expert BN folded into pw_e, pb_e
    out = SiLU(gamma * sum_e w[b,e] * y_e + beta)   # output-norm BN folded

:func:`pack_esmoe_params` stacks an :class:`~..nn.moe.es_moe.ES_MOE` block's
experts into the JAX package's banks and layout; :func:`fused_esmoe` runs the
block on them, with the CUDA kernel ``csrc/esmoe.cu`` (depthwise taps on the
CUDA cores, the pointwise product as a split-TF32 product on the tensor cores,
fp32 accuracy) on a CUDA tensor and :func:`fused_esmoe_plain` on a CPU tensor.
Tensors are NHWC, as in the JAX package: the port's channels_last NCHW feature
maps are NHWC in memory, so ``x.permute(0, 2, 3, 1)`` hands the kernel its
layout without a copy. x and the output are float32 or, on the bf16 path,
bfloat16; the routing weights and the banks are float32 in both, and the
block computes in fp32, as the TPU kernel does (``pallas_esmoe.py:116-122``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..nn.layers import fold_bn
from ._build import SMEM_LIMIT_BYTES, check, load_library, stream_ptr


@torch.no_grad()
def pack_esmoe_params(block):
    """A (raw or ``fuse_bn``-folded) ES_MOE block -> (dw [E,kmax,kmax,C], pw [E,C,O],
    pb [E,O], gamma [O], beta [O], ks), float32 on the block's device.

    The 3/5/7 depthwise kernels are centre-padded to kmax; each expert's BN
    is folded into its pointwise weights and bias, and the output norm's BN
    (``norm.0``) into gamma and beta.
    """
    ks = tuple(e.conv.depthwise.kernel_size[0] for e in block.experts)
    kmax = max(ks)
    dws, pws, pbs = [], [], []
    for expert, k in zip(block.experts, ks):
        conv = expert.conv
        pad = (kmax - k) // 2
        d = conv.depthwise.weight[:, 0].permute(1, 2, 0).float()  # [k, k, C]
        dws.append(F.pad(d, (0, 0, pad, pad, pad, pad)))
        if isinstance(conv.bn, torch.nn.BatchNorm2d):
            w, b = fold_bn(conv.pointwise.weight, None, conv.bn)
        else:  # folded by fuse_bn
            w, b = conv.pointwise.weight, conv.pointwise.bias
        pws.append(w[:, :, 0, 0].t().float())  # [C, O]
        pbs.append(b.float())
    bn = block.norm[0]
    gamma = (bn.weight / torch.sqrt(bn.running_var + bn.eps)).float()
    beta = (bn.bias - bn.running_mean * gamma).float()
    return torch.stack(dws), torch.stack(pws), torch.stack(pbs), gamma, beta, ks


def fused_esmoe_plain(x, w, dw, pw, pb, gamma, beta, ks) -> torch.Tensor:
    """The plain PyTorch version: x [B,H,W,C], w [B,E] -> [B,H,W,O] in x's dtype,
    computed in fp32 and rounded once at the end, each expert using only its own
    k_e x k_e taps of the centre-padded bank."""
    kmax, c = dw.shape[1], dw.shape[3]
    xc = x.permute(0, 3, 1, 2).float()
    mix = None
    for e, k in enumerate(ks):
        off = (kmax - k) // 2
        taps = dw[e, off:off + k, off:off + k].permute(2, 0, 1)[:, None]  # [C, 1, k, k]
        d = F.conv2d(xc, taps, padding=(k - 1) // 2, groups=c).permute(0, 2, 3, 1)
        z = F.silu(d @ pw[e] + pb[e])
        term = z * w[:, e, None, None, None]
        mix = term if mix is None else mix + term
    return F.silu(mix * gamma + beta).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("esmoe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ymt_fused_esmoe, lib.ymt_fused_esmoe_bf16):
        fn.argtypes = [ptr] * 9 + [i32] * 6 + [ctypes.POINTER(i32), ptr]
        fn.restype = i32
    for fn in (lib.esmoe_smem_bytes, lib.esmoe_max_experts, lib.esmoe_max_kernel, lib.esmoe_bank_cpad,
               lib.esmoe_bank_opad):
        fn.restype = i32
    for fn in (lib.esmoe_smem_bytes, lib.esmoe_bank_cpad, lib.esmoe_bank_opad):
        fn.argtypes = [i32]
    lib.esmoe_max_experts.argtypes = []
    lib.esmoe_max_kernel.argtypes = []
    return lib


@functools.cache
def _supported(ks: tuple) -> bool:
    """Whether the kernel takes these expert kernel sizes: E <= its maximum, odd
    sizes in 3..its maximum, and the halo tile in one block's shared memory."""
    lib = _lib()
    return (1 <= len(ks) <= lib.esmoe_max_experts()
            and all(k % 2 == 1 and 3 <= k <= lib.esmoe_max_kernel() for k in ks)
            and lib.esmoe_smem_bytes(max(ks)) <= SMEM_LIMIT_BYTES)


@functools.cache
def _bank_shape(c: int, o: int) -> tuple:
    """Padded (O, C) of the scratch bank the kernel transposes and splits pw into."""
    lib = _lib()
    return lib.esmoe_bank_opad(o), lib.esmoe_bank_cpad(c)


def _check_args(x, w, dw, pw, pb, gamma, beta, ks):
    if x.dim() != 4:
        raise ValueError(f"fused_esmoe: x must be [B, H, W, C], got {tuple(x.shape)}")
    b, _, _, c = x.shape
    e, o = pw.shape[0], pw.shape[2]
    if len(ks) != e or not _supported(ks):
        raise NotImplementedError(f"fused_esmoe: the kernel does not take E={e} experts of sizes {ks}")
    if c % 4 or o % 4:
        raise NotImplementedError(f"fused_esmoe: the kernel needs C and O to be multiples of 4, got {c}, {o}")
    kmax = max(ks)
    for name, t, shape in (("w", w, (b, e)), ("dw", dw, (e, kmax, kmax, c)), ("pw", pw, (e, c, o)),
                           ("pb", pb, (e, o)), ("gamma", gamma, (o,)), ("beta", beta, (o,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_esmoe: {name} must be {shape}, got {tuple(t.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_esmoe: x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("w", w), ("dw", dw), ("pw", pw), ("pb", pb), ("gamma", gamma), ("beta", beta)):
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"fused_esmoe: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_esmoe: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_esmoe: {name} must be contiguous "
                             f"(x: a channels_last NCHW map viewed as NHWC)")
    for name, t in (("x", x), ("dw", dw), ("pw", pw)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_esmoe: {name} must be 16-byte aligned for the kernel's 16-byte copies")


def fused_esmoe(x: torch.Tensor, w: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, pb: torch.Tensor,
                gamma: torch.Tensor, beta: torch.Tensor, ks) -> torch.Tensor:
    """x [B,H,W,C] NHWC float32 or bfloat16, w [B,E] float32 routing weights, float32
    banks from :func:`pack_esmoe_params` -> [B,H,W,O] NHWC in x's dtype.

    A CPU tensor takes :func:`fused_esmoe_plain`; a CUDA tensor launches the kernel.
    """
    ks = tuple(int(k) for k in ks)
    if x.device.type == "cpu":
        return fused_esmoe_plain(x, w, dw, pw, pb, gamma, beta, ks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_esmoe: unsupported device {x.device}")
    _check_args(x, w, dw, pw, pb, gamma, beta, ks)
    b, h, wd, c = x.shape
    e, o = pw.shape[0], pw.shape[2]
    out = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ks_arr = (ctypes.c_int * e)(*ks)
    # scratch for the pointwise weights, transposed and split in TF32 halves: [E, hi/lo, O, C] padded
    pw_bank = torch.empty((e, 2, *_bank_shape(c, o)), dtype=torch.float32, device=x.device)
    fn = _lib().ymt_fused_esmoe if x.dtype == torch.float32 else _lib().ymt_fused_esmoe_bf16
    check(fn(x.data_ptr(), w.data_ptr(), dw.data_ptr(), pw.data_ptr(), pb.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), pw_bank.data_ptr(), out.data_ptr(), b, h, wd, c, o, e, ks_arr, stream_ptr(x.device)),
          "esmoe kernel")
    fused_esmoe.launches += 1
    return out


fused_esmoe.launches = 0
