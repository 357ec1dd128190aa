"""Detection head (counterpart of ``yolo_master_tpu/nn/heads.py:Detect``).

Per level, a box branch (``cv2``) gives 4*reg_max DFL logits and a class branch
(``cv3``) gives nc logits. :meth:`Detect.forward` returns them anchors-last,
``[B, A, C]`` as in the JAX package, A running over levels, then rows, then
columns, for :meth:`Detect.decode` (every anchor) or :meth:`Detect.decode_topk`
(the predict path: the top-k anchors only). In train mode it returns the JAX
package's training dict, ``{"one2many": {"boxes", "scores"}, "hw_shapes"}``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.anchors import dfl_decode, dist2bbox, make_anchors
from ..ops.nms import stable_topk
from .layers import Conv, Conv2d, DWConv


def _head_out(c1: int, c2: int) -> Conv2d:
    """Final 1x1 conv with bias, in the input's dtype (JAX: ``heads.py:234``)."""
    return Conv2d(c1, c2, 1)


class Detect(nn.Module):
    """Anchor-free detection head with DFL box regression."""

    def __init__(self, nc: int = 80, reg_max: int = 16, end2end: bool = False, ch: Sequence[int] = (),
                 legacy: bool = False):
        super().__init__()
        if end2end:
            raise NotImplementedError("Detect(end2end=True) is not ported yet "
                                      "(ROADMAP.md §1.F item 15, every YAML in cfg/models)")
        self.nc = nc
        self.nl = len(ch)
        self.reg_max = reg_max
        self.strides: Tuple[int, ...] = ()
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), _head_out(c2, 4 * reg_max))
                                 for x in ch)
        if legacy:
            self.cv3 = nn.ModuleList(nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), _head_out(c3, nc)) for x in ch)
        else:
            self.cv3 = nn.ModuleList(
                nn.Sequential(nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                              nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                              _head_out(c3, nc))
                for x in ch)

    def set_strides(self, strides: Sequence[int]):
        self.strides = tuple(int(s) for s in strides)

    @torch.no_grad()
    def bias_init(self):
        """Box bias 2.0, class bias log(5 / nc / (640 / stride)^2). Needs strides."""
        for i, s in enumerate(self.strides or (8, 16, 32)):
            self.cv2[i][-1].bias.fill_(2.0)
            self.cv3[i][-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def forward(self, feats: List[torch.Tensor]) -> dict:
        """Per-level NCHW maps -> {"boxes": [B, A, 4*reg_max], "scores": [B, A, nc] logits, "hw_shapes"};
        in train mode {"one2many": {"boxes", "scores"}, "hw_shapes"}."""
        boxes, scores = [], []
        for i, f in enumerate(feats):  # NCHW -> NHWC, then (rows, columns) flattened as JAX's NHWC reshape
            boxes.append(self.cv2[i](f).permute(0, 2, 3, 1).flatten(1, 2))
            scores.append(self.cv3[i](f).permute(0, 2, 3, 1).flatten(1, 2))
        hw_shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        branch = {"boxes": torch.cat(boxes, 1), "scores": torch.cat(scores, 1)}
        if self.training:
            return {"one2many": branch, "hw_shapes": hw_shapes}
        return {**branch, "hw_shapes": hw_shapes}

    def decode(self, preds: dict, raw_scores: bool = False) -> torch.Tensor:
        """DFL decode + anchor offset + stride scale -> [B, A, 4+nc]: xywh boxes in
        input pixels, then sigmoid class scores (class logits with ``raw_scores``)."""
        anchors, strides = make_anchors(preds["hw_shapes"], self.strides, preds["boxes"].device)
        dist = dfl_decode(preds["boxes"].float(), self.reg_max)
        dbox = dist2bbox(dist, anchors[None], xywh=True) * strides[None]
        scores = preds["scores"].float()
        if not raw_scores:
            scores = torch.sigmoid(scores)
        return torch.cat([dbox, scores], -1)

    def decode_topk(self, preds: dict, k: int = 1024) -> torch.Tensor:
        """Select the top-k anchors by max class logit, then DFL-decode only those:
        [B, k, 4+nc] with xywh px boxes and raw class LOGITS (for NMS with
        ``scores_are_logits=True``). Ties keep the lower anchor index first."""
        anchors, strides = make_anchors(preds["hw_shapes"], self.strides, preds["boxes"].device)
        logits = preds["scores"].float()
        k = min(k, logits.shape[1])
        _, idx = stable_topk(logits.max(-1).values, k)  # [B, k]
        box_logits = preds["boxes"].float().gather(1, idx[..., None].expand(-1, -1, preds["boxes"].shape[-1]))
        sel_logits = logits.gather(1, idx[..., None].expand(-1, -1, logits.shape[-1]))
        dist = dfl_decode(box_logits, self.reg_max)
        dbox = dist2bbox(dist, anchors[idx], xywh=True) * strides[idx]
        return torch.cat([dbox, sel_logits], -1)
