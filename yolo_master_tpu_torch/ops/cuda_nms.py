"""Exact batched greedy NMS and cluster-weighted NMS over fixed-size candidate sets.

Counterpart of ``yolo_master_tpu/ops/pallas_nms.py``: ``pallas_batched_greedy_nms``
becomes :func:`batched_greedy_nms` (CUDA ``csrc/nms.cu``), the single-image
``pallas_greedy_nms`` becomes :func:`greedy_nms`, the same kernel at B=1, and
``pallas_batched_cw_nms`` becomes :func:`batched_cw_nms` (``csrc/cw_nms.cu``).
:func:`batched_greedy_nms_plain` and :func:`batched_cw_nms_plain` are the plain
PyTorch versions (the ``lax.scan`` loops of ``ops/nms.py:_greedy_nms`` and
``_greedy_cw_nms``, batched).

The CUDA versions do not step: they sort each image's candidates by (score
descending, index ascending), compute the IoU bitmask of every earlier/later
pair, and scan the sorted candidates once with the removed set in a warp's
registers (``csrc/nms_common.cuh``); CW-NMS then sums each kept box's cluster.
One wrapper call launches three or four kernels and counts one launch; their
scratch is one ``torch.empty`` buffer on the caller's device.

Picks are exact: the same candidates, in the same order, as the JAX package,
ties included (the lowest index wins, as ``jnp.argmax``). Slots after an image
is exhausted hold zeros and ``valid=False``, as the TPU kernels zero-fill.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import SMEM_LIMIT_BYTES, check, load_library, stream_ptr


def _check_candidates(fn: str, boxes: torch.Tensor, scores: torch.Tensor, max_candidates: int) -> None:
    if scores.dim() != 2 or tuple(boxes.shape) != (*scores.shape, 4):
        raise ValueError(f"{fn}: need boxes [B,N,4] and scores [B,N], "
                         f"got {tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"{fn}: float32 inputs required, got {boxes.dtype}, {scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"{fn}: boxes and scores on different devices")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError(f"{fn}: boxes and scores must be contiguous")
    if scores.shape[1] > max_candidates:
        raise ValueError(f"{fn}: {scores.shape[1]} candidates exceed one block's shared memory "
                         f"(max {max_candidates})")


def batched_greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int):
    """boxes [B, N, 4] xyxy (class offset applied), scores [B, N] (invalid <= 0)
    -> keep_idx [B, max_det] int32, keep_valid [B, max_det] bool."""
    b, n = scores.shape
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    areas = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    alive = scores.float().clone()
    keep_idx = torch.zeros((b, max_det), dtype=torch.int32, device=scores.device)
    keep_valid = torch.zeros((b, max_det), dtype=torch.bool, device=scores.device)
    rows = torch.arange(b, device=scores.device)
    lane = torch.arange(n, device=scores.device)[None]
    for i in range(max_det):
        idx = alive.argmax(1)  # first maximal index, as jnp.argmax
        valid = alive[rows, idx] > 0.0
        if not bool(valid.any()):
            break  # scores only ever drop to 0, so every later step is invalid too
        sel = lambda t: t[rows, idx][:, None]  # noqa: E731
        bx1, by1, bx2, by2, barea = sel(x1), sel(y1), sel(x2), sel(y2), sel(areas)
        iw = (torch.minimum(x2, bx2) - torch.maximum(x1, bx1)).clamp_min(0.0)
        ih = (torch.minimum(y2, by2) - torch.maximum(y1, by1)).clamp_min(0.0)
        inter = iw * ih
        iou = inter / (areas + barea - inter + 1e-7)
        suppress = (iou > iou_thres) | (lane == idx[:, None])
        alive = torch.where(valid[:, None] & suppress, 0.0, alive)
        keep_idx[:, i] = torch.where(valid, idx, 0).to(torch.int32)
        keep_valid[:, i] = valid
    return keep_idx, keep_valid


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("nms", ("-fmad=false",))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ymt_batched_greedy_nms.argtypes = [ptr] * 5 + [i32] * 3 + [ctypes.c_float, ptr]
    lib.ymt_batched_greedy_nms.restype = i32
    lib.nms_max_candidates.argtypes = [i32]
    lib.nms_max_candidates.restype = i32
    lib.nms_scratch_bytes.argtypes = [i32] * 3
    lib.nms_scratch_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _max_candidates() -> int:
    """The largest N whose sort keys fit one block's shared memory."""
    return _lib().nms_max_candidates(SMEM_LIMIT_BYTES)


def batched_greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int):
    """Exact greedy NMS per image: boxes [B, N, 4] float32 xyxy, scores [B, N]
    float32 -> keep_idx [B, max_det] int32, keep_valid [B, max_det] bool.

    A CPU tensor takes :func:`batched_greedy_nms_plain`; a CUDA tensor launches the kernel.
    """
    if scores.device.type == "cpu":
        return batched_greedy_nms_plain(boxes, scores, iou_thres, max_det)
    if scores.device.type != "cuda":
        raise ValueError(f"batched_greedy_nms: unsupported device {scores.device}")
    _check_candidates("batched_greedy_nms", boxes, scores, _max_candidates())
    b, n = scores.shape
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=scores.device)
    keep_valid = torch.empty((b, max_det), dtype=torch.bool, device=scores.device)
    if b == 0 or max_det == 0:
        return keep_idx.zero_(), keep_valid.zero_()
    lib = _lib()
    scratch = torch.empty(lib.nms_scratch_bytes(b, n, max_det), dtype=torch.uint8, device=scores.device)
    check(lib.ymt_batched_greedy_nms(boxes.data_ptr(), scores.data_ptr(), keep_idx.data_ptr(),
                                     keep_valid.data_ptr(), scratch.data_ptr(), b, n, max_det, float(iou_thres),
                                     stream_ptr(scores.device)), "nms kernel")
    batched_greedy_nms.launches += 1
    return keep_idx, keep_valid


batched_greedy_nms.launches = 0


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int):
    """Single image: boxes [N, 4], scores [N] -> keep_idx [max_det], keep_valid [max_det]."""
    keep_idx, keep_valid = batched_greedy_nms(boxes[None].contiguous(), scores[None].contiguous(),
                                              iou_thres, max_det)
    return keep_idx[0], keep_valid[0]


def batched_cw_nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int,
                         sigma: float = 0.1, weighted_iou: bool = True):
    """boxes [B, N, 4] xyxy (class offset applied), scores [B, N] (invalid <= 0) ->
    fused boxes [B, max_det, 4], scores [B, max_det], seed index [B, max_det]
    int32, valid [B, max_det] bool."""
    b, n = scores.shape
    bf = boxes.float()
    x1, y1, x2, y2 = bf.unbind(-1)
    areas = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    alive = scores.float().clone()
    dev = scores.device
    fused = torch.zeros((b, max_det, 4), dtype=torch.float32, device=dev)
    fscore = torch.zeros((b, max_det), dtype=torch.float32, device=dev)
    seed = torch.zeros((b, max_det), dtype=torch.int32, device=dev)
    valid_out = torch.zeros((b, max_det), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    lane = torch.arange(n, device=dev)[None]
    for i in range(max_det):
        idx = alive.argmax(1)  # first maximal index, as jnp.argmax
        best = alive[rows, idx]
        valid = best > 0.0
        if not bool(valid.any()):
            break  # scores only ever drop to 0, so every later step is invalid too
        sel = lambda t: t[rows, idx][:, None]  # noqa: E731
        bx1, by1, bx2, by2, barea = sel(x1), sel(y1), sel(x2), sel(y2), sel(areas)
        iw = (torch.minimum(x2, bx2) - torch.maximum(x1, bx1)).clamp_min(0.0)
        ih = (torch.minimum(y2, by2) - torch.maximum(y1, by1)).clamp_min(0.0)
        inter = iw * ih
        iou = inter / (areas + barea - inter + 1e-7)
        member = ((iou > iou_thres) | (lane == idx[:, None])) & (alive > 0.0)
        if weighted_iou:
            w = alive * torch.exp(-((1.0 - iou) ** 2) / sigma) * member
        else:
            w = alive * iou * member
        denom = w.sum(1).clamp_min(1e-9)
        fused[:, i] = torch.where(valid[:, None], (bf * w[..., None]).sum(1) / denom[:, None], 0.0)
        fscore[:, i] = torch.where(valid, best, 0.0)
        seed[:, i] = torch.where(valid, idx, 0).to(torch.int32)
        valid_out[:, i] = valid
        alive = torch.where(valid[:, None] & member, 0.0, alive)
    return fused, fscore, seed, valid_out


@functools.cache
def _cw_lib() -> ctypes.CDLL:
    lib = load_library("cw_nms", ("-fmad=false",))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ymt_batched_cw_nms.argtypes = [ptr] * 7 + [i32] * 3 + [f32, f32, i32, ptr]
    lib.ymt_batched_cw_nms.restype = i32
    lib.cw_nms_max_candidates.argtypes = [i32]
    lib.cw_nms_max_candidates.restype = i32
    lib.cw_nms_scratch_bytes.argtypes = [i32] * 3
    lib.cw_nms_scratch_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _cw_max_candidates() -> int:
    return _cw_lib().cw_nms_max_candidates(SMEM_LIMIT_BYTES)


def batched_cw_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int,
                   sigma: float = 0.1, weighted_iou: bool = True):
    """Cluster-weighted NMS per image: boxes [B, N, 4] float32 xyxy, scores [B, N]
    float32 -> fused boxes [B, max_det, 4], scores [B, max_det], seed index
    [B, max_det] int32, valid [B, max_det] bool.

    A CPU tensor takes :func:`batched_cw_nms_plain`; a CUDA tensor launches the kernel.
    """
    if scores.device.type == "cpu":
        return batched_cw_nms_plain(boxes, scores, iou_thres, max_det, sigma, weighted_iou)
    if scores.device.type != "cuda":
        raise ValueError(f"batched_cw_nms: unsupported device {scores.device}")
    _check_candidates("batched_cw_nms", boxes, scores, _cw_max_candidates())
    b, n = scores.shape
    dev = scores.device
    fused = torch.empty((b, max_det, 4), dtype=torch.float32, device=dev)
    fscore = torch.empty((b, max_det), dtype=torch.float32, device=dev)
    seed = torch.empty((b, max_det), dtype=torch.int32, device=dev)
    valid = torch.empty((b, max_det), dtype=torch.bool, device=dev)
    if b == 0 or max_det == 0:
        return fused.zero_(), fscore.zero_(), seed.zero_(), valid.zero_()
    lib = _cw_lib()
    scratch = torch.empty(lib.cw_nms_scratch_bytes(b, n, max_det), dtype=torch.uint8, device=dev)
    check(lib.ymt_batched_cw_nms(boxes.data_ptr(), scores.data_ptr(), fused.data_ptr(), fscore.data_ptr(),
                                 seed.data_ptr(), valid.data_ptr(), scratch.data_ptr(), b, n, max_det,
                                 float(iou_thres), float(sigma), int(bool(weighted_iou)), stream_ptr(dev)),
          "cw nms kernel")
    batched_cw_nms.launches += 1
    return fused, fscore, seed, valid


batched_cw_nms.launches = 0
