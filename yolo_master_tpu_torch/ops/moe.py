"""Gathered expert matmul for sparse MoE dispatch (counterpart of
``yolo_master_tpu/ops/pallas_moe.py``).

    out[b] = sum_k wts[b,k] * (x[b] @ w[idx[b,k]])

:func:`gathered_expert_matmul` reads only the K selected experts' weights:
with the CUDA kernel ``csrc/moe.cu`` (a split-TF32 product on the tensor
cores, fp32 accuracy) on a CUDA tensor, with :func:`dense_expert_matmul` (all
E experts, then a gather) on a CPU tensor.
The TPU kernel's ``tile_n`` and ``interpret`` knobs have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check, load_library, stream_ptr


def dense_expert_matmul(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """The plain version: every expert on every sample, then gather and weighted sum.

    A slot whose index lies outside [0, E) adds nothing, as in the kernel.
    """
    e = w.shape[0]
    valid = (idx >= 0) & (idx < e)
    all_out = torch.einsum("bnc,eco->beno", x.float(), w.float())  # [B, E, N, O]
    sel = all_out[torch.arange(x.shape[0], device=x.device)[:, None], idx.long().clamp(0, e - 1)]  # [B, K, N, O]
    return (sel * (wts.float() * valid)[:, :, None, None]).sum(1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("moe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ymt_gathered_expert_matmul.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.ymt_gathered_expert_matmul.restype = i32
    for fn in (lib.moe_bank_cpad, lib.moe_bank_opad):
        fn.argtypes, fn.restype = [i32], i32
    return lib


@functools.cache
def _bank_shape(c: int, o: int) -> tuple:
    """Padded (O, C) of the scratch bank the kernel mixes the selected weights into."""
    lib = _lib()
    return lib.moe_bank_opad(o), lib.moe_bank_cpad(c)


def _check_args(x, w, idx, wts):
    if x.dim() != 3 or w.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"gathered_expert_matmul: x [B,N,C], w [E,C,O], idx [B,K]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(idx.shape)}")
    b, _, c = x.shape
    if w.shape[1] != c or idx.shape[0] != b or tuple(wts.shape) != tuple(idx.shape):
        raise ValueError(f"gathered_expert_matmul: shapes disagree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"idx {tuple(idx.shape)}, wts {tuple(wts.shape)}")
    if c % 4 or w.shape[2] % 4:
        raise NotImplementedError(f"gathered_expert_matmul: the kernel needs C and O to be multiples of 4, "
                                  f"got {c}, {w.shape[2]}")
    for name, t, dtype in (("x", x, torch.float32), ("w", w, torch.float32), ("idx", idx, torch.int32),
                           ("wts", wts, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"gathered_expert_matmul: {name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"gathered_expert_matmul: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"gathered_expert_matmul: {name} must be contiguous")
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"gathered_expert_matmul: {name} must be 16-byte aligned for the kernel's 16-byte copies")


def gathered_expert_matmul(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """x [B,N,C], w [E,C,O], idx [B,K] int32, wts [B,K] float32 -> [B,N,O] float32,
    ``out[b] = sum_k wts[b,k] * (x[b] @ w[idx[b,k]])`` with fp32 accumulation.

    A CPU tensor takes :func:`dense_expert_matmul`; a CUDA tensor launches the
    kernel (float32 only). A repeated index counts once per slot.
    """
    if x.device.type == "cpu":
        return dense_expert_matmul(x, w, idx, wts)
    if x.device.type != "cuda":
        raise ValueError(f"gathered_expert_matmul: unsupported device {x.device}")
    _check_args(x, w, idx, wts)
    b, n, c = x.shape
    e, _, o = w.shape
    if b * n * o == 0 or c == 0 or idx.shape[1] == 0:  # nothing to multiply: an empty or all-zero result
        return torch.zeros((b, n, o), dtype=torch.float32, device=x.device)
    out = torch.empty((b, n, o), dtype=torch.float32, device=x.device)
    # scratch for the mixed weights of each image, transposed and split in TF32 halves: [B, hi/lo, O, C] padded
    bank = torch.empty((b, 2, *_bank_shape(c, o)), dtype=torch.float32, device=x.device)
    check(_lib().ymt_gathered_expert_matmul(x.data_ptr(), w.data_ptr(), idx.data_ptr(), wts.data_ptr(), bank.data_ptr(),
                                            out.data_ptr(), b, n, c, o, e, idx.shape[1], stream_ptr(x.device)),
          "gathered expert matmul kernel")
    gathered_expert_matmul.launches += 1
    return out


gathered_expert_matmul.launches = 0
