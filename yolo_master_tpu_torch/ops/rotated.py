"""Rotated-box (OBB) geometry (counterpart of ``yolo_master_tpu/ops/rotated.py``):
probIoU and the rbox transforms.

Format everywhere: xywhr (centre, size, radians), last-axis layout.
"""

from __future__ import annotations

import torch


def _covariance(boxes: torch.Tensor, floor: float = 0.0):
    """Gaussian-bbox covariance components (a, c; c, b) from xywhr."""
    a = boxes[..., 2] ** 2 / 12 + floor
    b = boxes[..., 3] ** 2 / 12 + floor
    r = boxes[..., 4]
    cos, sin = torch.cos(r), torch.sin(r)
    cos2, sin2 = cos ** 2, sin ** 2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = 1e-7, floor: float = 0.0) -> torch.Tensor:
    """Probabilistic IoU of rotated boxes (1 - the Hellinger distance of their
    Gaussians, through the Bhattacharyya distance), elementwise with broadcasting."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _covariance(obb1, floor)
    a2, b2, c2 = _covariance(obb2, floor)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    det1 = (a1 * b1 - c1 ** 2).clamp(min=0)
    det2 = (a2 * b2 - c2 ** 2).clamp(min=0)
    t3 = torch.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2) / (4 * torch.sqrt(det1 * det2) + eps) + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return 1 - hd


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """ltrb distances [..., 4] + angle [..., 1] about anchor points [..., 2] ->
    rotated boxes xywh [..., 4] (the angle is not appended)."""
    lt, rb = pred_dist.chunk(2, -1)
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    xf, yf = ((rb - lt) / 2).chunk(2, -1)
    x = xf * cos - yf * sin
    y = xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], -1) + anchor_points, lt + rb], -1)


def xywhr2xyxyxyxy(boxes: torch.Tensor) -> torch.Tensor:
    """xywhr [..., 5] -> the four corner points [..., 4, 2]."""
    ctr = boxes[..., :2]
    w, h, r = boxes[..., 2:3], boxes[..., 3:4], boxes[..., 4:5]
    cos, sin = torch.cos(r), torch.sin(r)
    vec1 = torch.cat([w / 2 * cos, w / 2 * sin], -1)
    vec2 = torch.cat([-h / 2 * sin, h / 2 * cos], -1)
    return torch.stack([ctr + vec1 + vec2, ctr + vec1 - vec2, ctr - vec1 - vec2, ctr - vec1 + vec2], -2)

