"""Grid anchors and DFL box decode (counterpart of ``yolo_master_tpu/ops/anchors.py``).

Layout: anchors-last, anchor points [A, 2], boxes [..., A, 4].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(hw_shapes: Sequence[Tuple[int, int]], strides: Sequence[int], device,
                 grid_cell_offset: float = 0.5):
    """Anchor centres per level: points [A, 2] (x, y in grid units), strides [A, 1]."""
    points, stride_list = [], []
    for (h, w), s in zip(hw_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        stride_list.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(points, 0), torch.cat(stride_list, 0)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """ltrb distances -> boxes (xywh or xyxy), last-axis layout."""
    lt, rb = distance.chunk(2, -1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)
    return torch.cat([x1y1, x2y2], -1)


def dfl_decode(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Expectation over the softmax of each side's ``reg_max`` bins.

    box_logits [..., A, 4*reg_max], grouped (4, reg_max) along the last axis
    -> [..., A, 4] distances in grid units.
    """
    if reg_max <= 1:
        return box_logits
    x = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    x = torch.softmax(x.float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (x @ proj).to(box_logits.dtype)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max=None) -> torch.Tensor:
    """xyxy boxes -> ltrb distances from the anchor points, clamped to [0, reg_max - 0.01]
    when ``reg_max`` is given (the inverse of :func:`dist2bbox` with ``xywh=False``)."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1)
    if reg_max is not None:
        dist = dist.clamp(0, reg_max - 0.01)
    return dist
