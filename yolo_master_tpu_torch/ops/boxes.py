"""Box ops (counterpart of ``yolo_master_tpu/ops/boxes.py``), last-axis layouts."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """center-xywh -> xyxy; columns after the first four pass through."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half, x[..., 4:]], -1)
