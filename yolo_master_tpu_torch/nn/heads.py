"""Detection head (counterpart of ``yolo_master_tpu/nn/heads.py:Detect``).

Per level, a box branch (``cv2``) gives 4*reg_max DFL logits and a class branch
(``cv3``) gives nc logits. :meth:`Detect.forward` returns them anchors-last,
``[B, A, C]`` as in the JAX package, A running over levels, then rows, then
columns, for :meth:`Detect.decode` (every anchor) or :meth:`Detect.decode_topk`
(the predict path: the top-k anchors only). In train mode it returns the JAX
package's training dict, ``{"one2many": {"boxes", "scores"}, "hw_shapes"}``.

An end2end (NMS-free) head also has the one2one branches (``one2one_cv2``,
``one2one_cv3``), which read the features detached; its train dict adds
``"one2one"``, and in eval it returns the one2one branch alone (the one2many
branch is dead there; XLA drops it from the JAX package's jitted eval). Its
decode gives xyxy boxes, and :meth:`Detect.postprocess_end2end` takes the
place of NMS.
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
    """Anchor-free detection head with DFL box regression (none at ``reg_max`` 1)."""

    def __init__(self, nc: int = 80, reg_max: int = 16, end2end: bool = False, ch: Sequence[int] = (),
                 legacy: bool = False):
        super().__init__()
        self.nc = nc
        self.nl = len(ch)
        self.reg_max = reg_max
        self.end2end = end2end
        self.strides: Tuple[int, ...] = ()
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))

        def box(x):
            return nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), _head_out(c2, 4 * reg_max))

        def cls(x):
            if legacy:
                return nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), _head_out(c3, nc))
            return nn.Sequential(nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                                 nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)), _head_out(c3, nc))

        self.cv2 = nn.ModuleList(box(x) for x in ch)
        self.cv3 = nn.ModuleList(cls(x) for x in ch)
        if end2end:
            self.one2one_cv2 = nn.ModuleList(box(x) for x in ch)
            self.one2one_cv3 = nn.ModuleList(cls(x) for x in ch)

    def set_strides(self, strides: Sequence[int]):
        self.strides = tuple(int(s) for s in strides)

    @torch.no_grad()
    def bias_init(self):
        """Box bias 2.0, class bias log(5 / nc / (640 / stride)^2). Needs strides."""
        pairs = [(self.cv2, self.cv3)] + ([(self.one2one_cv2, self.one2one_cv3)] if self.end2end else [])
        for cv2, cv3 in pairs:
            for i, s in enumerate(self.strides or (8, 16, 32)):
                cv2[i][-1].bias.fill_(2.0)
                cv3[i][-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    @staticmethod
    def _branch(cv2, cv3, feats) -> dict:
        boxes, scores = [], []
        for i, f in enumerate(feats):  # NCHW -> NHWC, then (rows, columns) flattened as JAX's NHWC reshape
            boxes.append(cv2[i](f).permute(0, 2, 3, 1).flatten(1, 2))
            scores.append(cv3[i](f).permute(0, 2, 3, 1).flatten(1, 2))
        return {"boxes": torch.cat(boxes, 1), "scores": torch.cat(scores, 1)}

    def forward(self, feats: List[torch.Tensor]) -> dict:
        """Per-level NCHW maps -> {"boxes": [B, A, 4*reg_max], "scores": [B, A, nc] logits, "hw_shapes"}
        (an end2end head's one2one branch); in train mode {"one2many": {"boxes", "scores"},
        ("one2one": {...} on the detached maps,) "hw_shapes"}."""
        hw_shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        if not self.training:
            if self.end2end:
                return {**self._branch(self.one2one_cv2, self.one2one_cv3, feats), "hw_shapes": hw_shapes}
            return {**self._branch(self.cv2, self.cv3, feats), "hw_shapes": hw_shapes}
        out = {"one2many": self._branch(self.cv2, self.cv3, feats), "hw_shapes": hw_shapes}
        if self.end2end:
            out["one2one"] = self._branch(self.one2one_cv2, self.one2one_cv3, [f.detach() for f in feats])
        return out

    def decode(self, preds: dict, raw_scores: bool = False) -> torch.Tensor:
        """DFL decode + anchor offset + stride scale -> [B, A, 4+nc]: xywh boxes (xyxy
        for an end2end head) in input pixels, then sigmoid class scores (class
        logits with ``raw_scores``)."""
        anchors, strides = make_anchors(preds["hw_shapes"], self.strides, preds["boxes"].device)
        dist = dfl_decode(preds["boxes"].float(), self.reg_max)
        dbox = dist2bbox(dist, anchors[None], xywh=not self.end2end) * strides[None]
        scores = preds["scores"].float()
        if not raw_scores:
            scores = torch.sigmoid(scores)
        return torch.cat([dbox, scores], -1)

    def decode_topk(self, preds: dict, k: int = 1024) -> torch.Tensor:
        """Select the top-k anchors by max class logit, then DFL-decode only those:
        [B, k, 4+nc] with xywh px boxes (xyxy for an end2end head) and raw class
        LOGITS (for NMS with ``scores_are_logits=True``). Ties keep the lower
        anchor index first."""
        anchors, strides = make_anchors(preds["hw_shapes"], self.strides, preds["boxes"].device)
        logits = preds["scores"].float()
        k = min(k, logits.shape[1])
        _, idx = stable_topk(logits.max(-1).values, k)  # [B, k]
        box_logits = preds["boxes"].float().gather(1, idx[..., None].expand(-1, -1, preds["boxes"].shape[-1]))
        sel_logits = logits.gather(1, idx[..., None].expand(-1, -1, logits.shape[-1]))
        dist = dfl_decode(box_logits, self.reg_max)
        dbox = dist2bbox(dist, anchors[idx], xywh=not self.end2end) * strides[idx]
        return torch.cat([dbox, sel_logits], -1)

    @staticmethod
    def postprocess_end2end(decoded: torch.Tensor, max_det: int = 300) -> torch.Tensor:
        """The NMS-free head's selection: decoded [B, A, 4+nc] (xyxy boxes,
        scores) -> [B, k, 6] (box, score, class), k = min(max_det, A): the k
        anchors of the best class score, then the k best (anchor, class) pairs
        among them, best first. Ties keep the lower index first, as
        ``jax.lax.top_k``."""
        boxes, scores = decoded[..., :4], decoded[..., 4:]
        b, a, nc = scores.shape
        k = min(max_det, a)
        _, top_idx = stable_topk(scores.max(-1).values, k)  # [B, k]
        sel = scores.gather(1, top_idx[..., None].expand(-1, -1, nc))
        final, flat_idx = stable_topk(sel.reshape(b, -1), k)
        anchor = top_idx.gather(1, flat_idx // nc)
        cls = (flat_idx % nc).to(decoded.dtype)
        sel_boxes = boxes.gather(1, anchor[..., None].expand(-1, -1, 4))
        return torch.cat([sel_boxes, final[..., None], cls[..., None]], -1)
