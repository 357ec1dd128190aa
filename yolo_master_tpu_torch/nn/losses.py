"""The v8 detection loss (counterpart of ``yolo_master_tpu/nn/losses.py``):
task-aligned assignment, BCE on the class logits, CIoU and DFL (L1 on the
distances at reg_max 1) on the foreground anchors, an end2end head's one2one
branch at top-1 assignment, and the mixture aux loss on top.

Static shapes, as in the JAX package: ground truth comes padded to [B, M]
with a validity mask, and the foreground terms are masked, not gathered.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..ops.anchors import bbox2dist, dfl_decode, dist2bbox, make_anchors
from ..ops.boxes import bbox_iou
from .assigner import task_aligned_assign


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor
    aux: torch.Tensor


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits, in fp32."""
    logits = logits.float()
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss: pred_dist [..., 4, reg_max] logits, target [..., 4]
    continuous ltrb -> [...], the mean over the four sides. The two bins that
    bracket the target are gathered (the JAX package selects them with an iota
    compare, the same numbers). A NaN target gives a NaN loss, as in JAX: its
    bin indices are clamped into range, so the gather never reads out of bounds."""
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.floor().long().clamp(0, reg_max - 2)
    tr = tl + 1
    wl = tr.float() - target
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist.float(), -1)
    lp_l = logp.gather(-1, tl[..., None])[..., 0]
    lp_r = logp.gather(-1, tr[..., None])[..., 0]
    return (-(lp_l * wl + lp_r * wr)).mean(-1)


def detection_loss(preds: Dict[str, torch.Tensor], hw_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                   gt_bboxes: torch.Tensor, gt_classes: torch.Tensor, gt_mask: torch.Tensor, nc: int,
                   reg_max: int = 16, box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5,
                   tal_topk: int = 10) -> LossBreakdown:
    """The v8 loss of one head branch, ``preds`` {"boxes": [B, A, 4*reg_max],
    "scores": [B, A, nc]}, against GT boxes [B, M, 4] xyxy in input pixels.
    Each component is scaled by its gain and by the batch size B."""
    pred_dist, pred_scores = preds["boxes"], preds["scores"]
    b, a = pred_scores.shape[:2]
    anchors, stride_t = make_anchors(hw_shapes, strides, pred_scores.device)  # grid units, [A, 1]

    pred_ltrb = dfl_decode(pred_dist, reg_max)  # [B, A, 4] grid units
    pred_bboxes = dist2bbox(pred_ltrb, anchors[None], xywh=False)

    # the assigner sees detached fp32 inputs, whatever the training dtype
    assign = task_aligned_assign(torch.sigmoid(pred_scores.detach().float()),
                                 pred_bboxes.detach().float() * stride_t[None], anchors * stride_t,
                                 gt_classes, gt_bboxes, gt_mask, num_classes=nc, topk=tal_topk, strides=strides)
    target_scores_sum = assign.target_scores.sum().clamp_min(1.0)

    loss_cls = bce_with_logits(pred_scores, assign.target_scores).sum() / target_scores_sum

    fg = assign.fg_mask.float()  # [B, A]
    weight = assign.target_scores.sum(-1) * fg
    target_grid = assign.target_bboxes / stride_t[None]
    iou = bbox_iou(pred_bboxes, target_grid, xywh=False, CIoU=True)
    loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum

    if reg_max > 1:
        target_ltrb = bbox2dist(anchors[None], target_grid, reg_max - 1)
        dl = dfl_loss(pred_dist.reshape(b, a, 4, reg_max), target_ltrb, reg_max)
    else:  # no DFL bins: L1 on the ltrb distances, normalised by the input size
        h0, w0 = hw_shapes[0]
        imgw, imgh = float(w0 * strides[0]), float(h0 * strides[0])
        norm = torch.tensor([imgw, imgh, imgw, imgh], dtype=torch.float32, device=pred_scores.device)
        target_ltrb = bbox2dist(anchors[None], target_grid) * stride_t[None] / norm
        dl = (pred_ltrb.float() * stride_t[None] / norm - target_ltrb).abs().mean(-1)
    loss_dfl = (dl * weight).sum() / target_scores_sum

    loss_box = loss_box * box_gain * b
    loss_cls = loss_cls * cls_gain * b
    loss_dfl = loss_dfl * dfl_gain * b
    return LossBreakdown(loss_box + loss_cls + loss_dfl, loss_box, loss_cls, loss_dfl,
                         torch.zeros((), device=pred_scores.device))


def composite_loss(preds: Dict, hw_shapes, strides, gt_bboxes, gt_classes, gt_mask, nc: int,
                   aux_total: torch.Tensor, reg_max: int = 16, box_gain: float = 7.5, cls_gain: float = 0.5,
                   dfl_gain: float = 1.5, moe_gain: float = 0.01, end2end: bool = False) -> LossBreakdown:
    """The one2many branch's detection loss (top-10 assignment) plus ``moe_gain * aux_total``.

    ``end2end`` (an NMS-free head whose ``preds`` hold ``"one2one"``): the
    dual-assignment loss, the one2one branch's detection loss at top-1
    assignment added with the same gains; box, cls and dfl (L1 at reg_max 1)
    are each the sum of the two branches', and the aux is added once."""
    kw = dict(nc=nc, reg_max=reg_max, box_gain=box_gain, cls_gain=cls_gain, dfl_gain=dfl_gain)
    lb = detection_loss(preds["one2many"], hw_shapes, strides, gt_bboxes, gt_classes, gt_mask, tal_topk=10, **kw)
    if end2end and "one2one" in preds:
        lb2 = detection_loss(preds["one2one"], hw_shapes, strides, gt_bboxes, gt_classes, gt_mask, tal_topk=1, **kw)
        lb = LossBreakdown(lb.total + lb2.total, lb.box + lb2.box, lb.cls + lb2.cls, lb.dfl + lb2.dfl, lb.aux)
    aux = moe_gain * aux_total
    return LossBreakdown(lb.total + aux, lb.box, lb.cls, lb.dfl, aux)
