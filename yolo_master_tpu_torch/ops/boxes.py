"""Box ops (counterpart of ``yolo_master_tpu/ops/boxes.py``), last-axis layouts."""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """center-xywh -> xyxy; columns after the first four pass through."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half, x[..., 4:]], -1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False,  # noqa: N803
             DIoU: bool = False, CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:  # noqa: N803
    """Elementwise (broadcasting) IoU of boxes on the last axis, with the GIoU,
    DIoU or CIoU penalty. CIoU's ``alpha`` carries no gradient."""
    if xywh:
        (x1, y1, w1, h1), (x2, y2, w2, h2) = box1.unbind(-1), box2.unbind(-1)
        b1x1, b1x2, b1y1, b1y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2x1, b2x2, b2y1, b2y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        (b1x1, b1y1, b1x2, b1y2), (b2x1, b2y1, b2x2, b2y2) = box1.unbind(-1), box2.unbind(-1)
        w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
        w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp_min(0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp_min(0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # convex width
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)  # convex height
    if CIoU or DIoU:
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
        if CIoU:
            v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
            alpha = (v / (v - iou + (1 + eps))).detach()
            return iou - (rho2 / c2 + v * alpha)
        return iou - rho2 / c2
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area
