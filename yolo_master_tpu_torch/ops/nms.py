"""Fixed-shape batched NMS (counterpart of ``yolo_master_tpu/ops/nms.py``).

Same recast as the JAX package: select the top ``max_nms`` candidates per
image (scores below ``conf_thres`` become 0), then run exact greedy NMS for
``max_det`` steps with the class-offset trick. Outputs are fixed-shape, with a
validity mask. The greedy loop is :func:`.cuda_nms.batched_greedy_nms`: the
CUDA kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor.
:func:`cluster_weighted_nms` fuses each greedy cluster into one
score-weighted box instead (:func:`.cuda_nms.batched_cw_nms`).
:func:`rotated_non_max_suppression` is the OBB head's fast-NMS over a dense
probIoU matrix, plain PyTorch in both packages (no Pallas kernel computes it).

Top-k selection uses a stable descending sort, so tied scores keep the lower
index first, as ``jax.lax.top_k`` does (``torch.topk`` promises no tie order).
"""

from __future__ import annotations

from typing import Optional

import torch

from .boxes import xywh2xyxy
from .cuda_nms import batched_cw_nms, batched_greedy_nms
from .rotated import probiou

MAX_WH = 7680.0  # class-offset magnitude


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis; ties keep the lower index first."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, N, C], idx [B, K] -> [B, K, C]."""
    return t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))


def _prep_candidates(pred: torch.Tensor, nc: int, conf_thres: float, max_nms: int, multi_label: bool,
                     class_mask: Optional[torch.Tensor], scores_are_logits: bool):
    """pred [B, A, 4+nc+extra] xywh -> top-``max_nms`` candidates per image:
    boxes [B, k, 4] xyxy, scores [B, k] fp32 (0 below conf), classes [B, k] fp32, extra [B, k, E]."""
    a = pred.shape[1]
    boxes = xywh2xyxy(pred[..., :4])
    cls_scores = pred[..., 4: 4 + nc]
    if class_mask is not None:
        if scores_are_logits:
            # a zeroed logit would sigmoid to 0.5; excluded classes are -inf in logit space
            cls_scores = torch.where(class_mask[None, None] > 0, cls_scores, torch.full_like(cls_scores, -1e9))
        else:
            cls_scores = cls_scores * class_mask[None, None]
    if multi_label and nc > 1:
        flat = cls_scores.reshape(pred.shape[0], -1)
        k = min(max_nms, flat.shape[1])
        scores, flat_idx = stable_topk(flat, k)
        anchor_idx = flat_idx // nc
        cls_idx = (flat_idx % nc).float()
    else:
        k = min(max_nms, a)
        scores, anchor_idx = stable_topk(cls_scores.max(-1).values, k)
        cls_idx = _gather_rows(cls_scores, anchor_idx).argmax(-1).float()
    cboxes = _gather_rows(boxes, anchor_idx)
    cextra = _gather_rows(pred[..., 4 + nc:], anchor_idx)
    if scores_are_logits:
        scores = torch.sigmoid(scores.float())
    scores = torch.where(scores > conf_thres, scores, 0.0).float()
    return cboxes, scores, cls_idx, cextra


def non_max_suppression(prediction: torch.Tensor, nc: int, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        max_det: int = 300, max_nms: int = 30000, agnostic: bool = False,
                        multi_label: bool = False, class_mask: Optional[torch.Tensor] = None,
                        scores_are_logits: bool = False) -> dict:
    """Batched fixed-shape NMS.

    prediction [B, A, 4+nc+extra]: xywh boxes in input pixels, then class
    scores (probabilities, or logits with ``scores_are_logits``), then extra
    columns. Returns boxes [B, max_det, 4] xyxy, scores [B, max_det],
    classes [B, max_det] (-1 where invalid), valid [B, max_det] bool,
    extra [B, max_det, extra].
    """
    cboxes, scores, cls_idx, cextra = _prep_candidates(
        prediction, nc, conf_thres, max_nms, multi_label, class_mask, scores_are_logits)
    offset = 0.0 if agnostic else cls_idx[..., None] * MAX_WH
    keep_idx, keep_valid = batched_greedy_nms((cboxes + offset).float().contiguous(), scores.contiguous(),
                                              iou_thres, max_det)
    keep = keep_idx.long()
    vf = keep_valid.to(cboxes.dtype)
    return {
        "boxes": _gather_rows(cboxes, keep) * vf[..., None],
        "scores": scores.gather(1, keep) * keep_valid,
        "classes": torch.where(keep_valid, cls_idx.gather(1, keep), -1.0),
        "valid": keep_valid,
        "extra": _gather_rows(cextra, keep) * vf[..., None] if cextra.shape[-1] else cextra[:, :max_det],
    }


def cluster_weighted_nms(prediction: torch.Tensor, nc: int, conf_thres: float = 0.25, iou_thres: float = 0.45,
                         max_det: int = 300, max_nms: int = 2048, agnostic: bool = False, sigma: float = 0.1,
                         weighted_iou: bool = True) -> dict:
    """Batched cluster-weighted NMS over decoded predictions [B, A, 4+nc] (xywh
    boxes, class probabilities).

    Each greedy cluster (the top candidate and every alive candidate of the
    same class with IoU > ``iou_thres``) becomes one box, the mean of its
    members weighted by score * exp(-(1 - IoU)^2 / ``sigma``) (score * IoU
    without ``weighted_iou``). Returns boxes [B, max_det, 4] xyxy, scores
    [B, max_det] (the seeds' scores), classes [B, max_det] (-1 where
    invalid), valid [B, max_det] bool.
    """
    cboxes, scores, cls_idx, _ = _prep_candidates(prediction[..., :4 + nc], nc, conf_thres, max_nms, False, None,
                                                  False)
    offset = 0.0 if agnostic else cls_idx[..., None] * MAX_WH
    fused, fscores, seed, valid = batched_cw_nms((cboxes + offset).float().contiguous(), scores.contiguous(),
                                                 iou_thres, max_det, sigma, weighted_iou)
    out_cls = torch.where(valid, cls_idx.gather(1, seed.long()), -1.0)
    if not agnostic:
        fused = fused - out_cls[..., None] * MAX_WH * valid[..., None]
    return {"boxes": fused * valid[..., None], "scores": fscores * valid, "classes": out_cls, "valid": valid}


def _fast_nms_keep(rboxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, iou_thres: float,
                   max_det: int, agnostic: bool):
    """One image's fast-NMS: candidates [k, 5] xywhr, scores [k] (0 below conf),
    classes [k] -> (indices [max_det] int32, valid [max_det] bool), best first."""
    off = 0.0 if agnostic else classes[:, None] * MAX_WH  # the class offset moves the centre only
    b = torch.cat([rboxes[:, :2] + off, rboxes[:, 2:]], -1)
    order = torch.argsort(-scores, stable=True)
    bs = b[order]
    ious = probiou(bs[:, None, :], bs[None, :, :]).triu(1)  # row i suppresses the lower-scored columns j > i
    keep = ((ious >= iou_thres).sum(0) == 0) & (scores[order] > 0.0)
    kept = torch.where(keep, scores[order], -1.0)
    if kept.shape[0] < max_det:
        pad = max_det - kept.shape[0]
        kept = torch.cat([kept, kept.new_full((pad,), -1.0)])
        order = torch.cat([order, order.new_zeros(pad)])
    vals, pick = stable_topk(kept, max_det)
    return order[pick].to(torch.int32), vals > 0.0


def rotated_non_max_suppression(prediction: torch.Tensor, nc: int, conf_thres: float = 0.25,
                                iou_thres: float = 0.45, max_det: int = 300, max_nms: int = 2048,
                                agnostic: bool = False, multi_label: bool = False) -> dict:
    """Batched rotated-box NMS, the reference's rotated branch: the class offset
    goes on the box centre, and a candidate is dropped if any higher-scored
    candidate overlaps it with probIoU >= ``iou_thres``, whether or not that one
    survives (Fast-NMS).

    prediction [B, A, 4+nc+1]: xywh in input pixels, class scores, angle
    (radians). Candidates are the top ``max_nms`` anchors by best class score,
    or with ``multi_label`` (nc > 1) the top ``max_nms`` (anchor, class) pairs;
    ties keep the lower index first. The probIoU matrix is [k, k] fp32, one
    image at a time. Returns rboxes [B, max_det, 5] (xywhr), scores
    [B, max_det], classes [B, max_det] (-1 where invalid), valid [B, max_det].
    """
    b = prediction.shape[0]
    cls_scores, angle = prediction[..., 4: 4 + nc], prediction[..., -1:]
    if multi_label and nc > 1:
        k = min(max_nms, cls_scores.shape[1] * nc)
        scores, flat_idx = stable_topk(cls_scores.reshape(b, -1), k)
        anchor_idx = flat_idx // nc
        cls_idx = (flat_idx % nc).float()
    else:
        k = min(max_nms, prediction.shape[1])
        scores, anchor_idx = stable_topk(cls_scores.max(-1).values, k)
        cls_idx = _gather_rows(cls_scores, anchor_idx).argmax(-1).float()
    rboxes = _gather_rows(torch.cat([prediction[..., :4], angle], -1), anchor_idx)
    scores = torch.where(scores > conf_thres, scores, 0.0).float()
    keeps = [_fast_nms_keep(rboxes[i], scores[i], cls_idx[i], iou_thres, max_det, agnostic) for i in range(b)]
    keep = torch.stack([k_ for k_, _ in keeps]).long()
    valid = torch.stack([v for _, v in keeps])
    return {
        "rboxes": _gather_rows(rboxes, keep) * valid[..., None],
        "scores": scores.gather(1, keep) * valid,
        "classes": torch.where(valid, cls_idx.gather(1, keep), -1.0),
        "valid": valid,
    }
