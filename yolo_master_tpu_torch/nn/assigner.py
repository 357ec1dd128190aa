"""Task-aligned assigner (counterpart of ``yolo_master_tpu/nn/assigner.py``).

Static shapes, as in the JAX package: ground truth comes padded to [B, M] with
a validity mask, and every step is a masked dense op over [B, M, A] (batch,
GT slots, anchors).

  * GTs narrower or shorter than the smallest stride are widened to the
    middle stride before the anchor-centre-in-box test;
  * align = cls_score^alpha * CIoU^beta over the candidates;
  * the top-k anchors of each GT by align, ties to the lower anchor index
    (``jax.lax.top_k``'s order: most align entries are exactly 0, so ties
    decide which zero-align candidates a GT with fewer than k of them keeps);
  * an anchor claimed by several GTs goes to the GT of largest overlap;
  * target scores scaled by each GT's best overlap over its best align.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou
from ..ops.nms import stable_topk


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # [B, A] int64
    target_bboxes: torch.Tensor  # [B, A, 4] xyxy, the inputs' units
    target_scores: torch.Tensor  # [B, A, nc] float
    fg_mask: torch.Tensor  # [B, A] bool
    target_gt_idx: torch.Tensor  # [B, A] int64


def _candidates_in_gts(anchors, gt_bboxes, mask_gt, min_stride, stride_val, eps=1e-9):
    """[B, M, A] bool: anchor centres strictly inside the (widened) GT boxes."""
    ctr = (gt_bboxes[..., :2] + gt_bboxes[..., 2:4]) / 2
    wh = gt_bboxes[..., 2:4] - gt_bboxes[..., :2]
    small = (wh < min_stride) & mask_gt[..., None]
    wh = torch.where(small, torch.full_like(wh, float(stride_val)), wh)
    lt, rb = ctr - wh / 2, ctr + wh / 2  # [B, M, 2]
    a = anchors[None, None]  # [1, 1, A, 2]
    inside = (a - lt[:, :, None] > eps) & (rb[:, :, None] - a > eps)
    return inside.all(-1)


def _topk_count(topk_idx: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """[B, M, A] int: how often each anchor appears in the top-k list [B, M, k]."""
    count = torch.zeros(*topk_idx.shape[:-1], num_anchors, dtype=torch.int32, device=topk_idx.device)
    return count.scatter_add_(-1, topk_idx, torch.ones_like(topk_idx, dtype=torch.int32))


@torch.no_grad()
def task_aligned_assign(pd_scores: torch.Tensor, pd_bboxes: torch.Tensor, anchors: torch.Tensor,
                        gt_labels: torch.Tensor, gt_bboxes: torch.Tensor, mask_gt: torch.Tensor, num_classes: int,
                        topk: int = 10, alpha: float = 0.5, beta: float = 6.0, strides: Sequence[int] = (8, 16, 32),
                        eps: float = 1e-9) -> AssignResult:
    """pd_scores [B, A, nc] sigmoid probabilities, pd_bboxes [B, A, 4] xyxy px,
    anchors [A, 2] px, gt_labels [B, M], gt_bboxes [B, M, 4] xyxy px, mask_gt [B, M] bool."""
    num_anchors = pd_scores.shape[1]
    stride_val = strides[1] if len(strides) > 1 else strides[0]
    mask_gt = mask_gt.bool()
    mask_in = _candidates_in_gts(anchors, gt_bboxes, mask_gt, strides[0], stride_val, eps) & mask_gt[:, :, None]

    # each GT's class score at every anchor
    labels = gt_labels.long().clamp(0, num_classes - 1)  # [B, M]
    bbox_scores = pd_scores.transpose(1, 2).gather(1, labels[:, :, None].expand(-1, -1, num_anchors))  # [B, M, A]
    bbox_scores = torch.where(mask_in, bbox_scores, torch.zeros((), dtype=pd_scores.dtype, device=pd_scores.device))

    overlaps = bbox_iou(gt_bboxes[:, :, None, :].to(pd_bboxes.dtype), pd_bboxes[:, None, :, :], xywh=False, CIoU=True)
    overlaps = torch.where(mask_in, overlaps, torch.zeros_like(overlaps)).clamp_min(0.0)  # [B, M, A]

    align = bbox_scores.float() ** alpha * overlaps.float() ** beta

    # top-k anchors per GT, the lower index first among ties
    mask_topk = _topk_count(stable_topk(align, topk)[1], num_anchors) == 1
    mask_pos = (mask_topk & mask_in).float() * mask_gt.float()[:, :, None]

    # an anchor claimed by several GTs keeps the GT of largest overlap; torch.argmax,
    # as jnp.argmax, returns the first of equal maxima
    multi = (mask_pos.sum(1) > 1)[:, None, :]  # [B, 1, A]
    is_max = F.one_hot(overlaps.argmax(1), gt_bboxes.shape[1]).transpose(1, 2).float()  # [B, M, A]
    mask_pos = torch.where(multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(1) > 0  # [B, A]
    target_gt_idx = mask_pos.argmax(1)  # [B, A]; the first GT where none (the anchor is background)

    target_labels = labels.gather(1, target_gt_idx)  # [B, A]
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(-1, -1, 4))  # [B, A, 4]
    target_scores = F.one_hot(target_labels, num_classes).float() * fg_mask[..., None]

    # scale by each GT's best overlap over its best align
    align = align * mask_pos
    pos_align = align.amax(-1, keepdim=True)  # [B, M, 1]
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align * pos_overlap / (pos_align + eps)).amax(1)  # [B, A]
    target_scores = target_scores * norm[..., None]
    return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx)
