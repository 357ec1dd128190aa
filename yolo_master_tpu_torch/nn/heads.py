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

The task heads (JAX ``heads.py:214-451``) add one branch per level, ``cv4``
(``one2one_cv4`` too on an end2end head), whose output joins each branch's
dict: :class:`Segment` its mask coefficients (and the :class:`Proto` masks
at the top level), :class:`Pose` its raw keypoints, :class:`OBB` its angle.
:class:`Classify` is a head of its own: conv, global average pool, linear,
softmax in eval.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.anchors import dfl_decode, dist2bbox, make_anchors
from ..ops.nms import stable_topk
from ..ops.rotated import dist2rbox
from .layers import Conv, Conv2d, DWConv, Linear


def _head_out(c1: int, c2: int) -> Conv2d:
    """Final 1x1 conv with bias, in the input's dtype (JAX: ``heads.py:234``)."""
    return Conv2d(c1, c2, 1)


def _levels(branch: nn.ModuleList, feats) -> torch.Tensor:
    """A per-level branch over NCHW maps -> [B, A, C]: each map NCHW -> NHWC, then
    (rows, columns) flattened as JAX's NHWC reshape, the levels concatenated."""
    return torch.cat([m(f).permute(0, 2, 3, 1).flatten(1, 2) for m, f in zip(branch, feats)], 1)


def _extra_branch(ch, c4: int, out: int) -> nn.ModuleList:
    """Per-level 2-conv + 1x1 branch of Segment, Pose and OBB (``cv4``; JAX ``_ExtraBranch``)."""
    return nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), _head_out(c4, out)) for x in ch)


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
        return {"boxes": _levels(cv2, feats), "scores": _levels(cv3, feats)}

    extra_key = None  # a task head's third output per anchor (its ``cv4`` branch)

    def _add_extra_branch(self, ch, c4: int, out: int) -> None:
        """A task head's ``cv4`` (and ``one2one_cv4`` on an end2end head): ``out`` values per anchor."""
        self.cv4 = _extra_branch(ch, c4, out)
        if self.end2end:
            self.one2one_cv4 = _extra_branch(ch, c4, out)

    def _outputs(self, feats, one2one: bool = False) -> dict:
        """One branch's outputs over every level, anchors-last: the one2one branch's with ``one2one``."""
        pre = "one2one_" if one2one else ""
        out = self._branch(getattr(self, pre + "cv2"), getattr(self, pre + "cv3"), feats)
        if self.extra_key:
            out[self.extra_key] = _levels(getattr(self, pre + "cv4"), feats)
        return out

    def forward(self, feats: List[torch.Tensor]) -> dict:
        """Per-level NCHW maps -> {"boxes": [B, A, 4*reg_max], "scores": [B, A, nc] logits, "hw_shapes"}
        (an end2end head's one2one branch); in train mode {"one2many": {"boxes", "scores"},
        ("one2one": {...} on the detached maps,) "hw_shapes"}."""
        hw_shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        if not self.training:
            return {**self._outputs(feats, one2one=self.end2end), "hw_shapes": hw_shapes}
        out = {"one2many": self._outputs(feats), "hw_shapes": hw_shapes}
        if self.end2end:
            out["one2one"] = self._outputs([f.detach() for f in feats], one2one=True)
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


class Segment(Detect):
    """Instance segmentation head: Detect + ``nm`` mask coefficients per anchor
    (``cv4``) + :class:`Proto`'s ``nm`` prototype masks at P3's stride / 2."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, reg_max: int = 16, end2end: bool = False,
                 ch: Sequence[int] = (), legacy: bool = False):
        super().__init__(nc, reg_max, end2end, ch, legacy)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        self._add_extra_branch(ch, max(ch[0] // 4, nm), nm)

    extra_key = "mask_coefficient"

    def forward(self, feats: List[torch.Tensor]) -> dict:
        """Detect's dict with "mask_coefficient" [B, A, nm] in each branch and
        "proto" [B, nm, 2*H3, 2*W3] (NCHW, from the P3 map) at the top level."""
        return {**super().forward(feats), "proto": self.proto(feats[0])}

    def decode(self, preds: dict, raw_scores: bool = False) -> torch.Tensor:
        """[B, A, 4+nc+nm]: Detect's decode, then the mask coefficients."""
        base = super().decode(preds, raw_scores)
        return torch.cat([base, preds["mask_coefficient"].to(base.dtype)], -1)


class Pose(Detect):
    """Keypoint head: Detect + ``kpt_shape[0] * kpt_shape[1]`` keypoint values per anchor (``cv4``)."""

    def __init__(self, nc: int = 80, kpt_shape=(17, 3), reg_max: int = 16, end2end: bool = False,
                 ch: Sequence[int] = (), legacy: bool = False):
        super().__init__(nc, reg_max, end2end, ch, legacy)
        self.kpt_shape = tuple(kpt_shape)
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        self._add_extra_branch(ch, max(ch[0] // 4, self.nk), self.nk)

    extra_key = "kpts"

    def kpts_decode(self, kpts: torch.Tensor, hw_shapes) -> torch.Tensor:
        """[B, A, nk] raw -> keypoints in input pixels: xy*2 + anchor - 0.5, times
        the stride; a third value per keypoint is a visibility, sigmoid in fp32."""
        anchors, strides = make_anchors(hw_shapes, self.strides, kpts.device)
        b, a = kpts.shape[:2]
        nkpt, ndim = self.kpt_shape
        y = kpts.reshape(b, a, nkpt, ndim)
        xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * strides[None, :, None, :]
        if ndim == 3:
            y = torch.cat([xy, torch.sigmoid(y[..., 2:3].float()).to(y.dtype)], -1)
        else:
            y = xy
        return y.reshape(b, a, self.nk)

    def decode(self, preds: dict, raw_scores: bool = False) -> torch.Tensor:
        """[B, A, 4+nc+nk]: Detect's decode, then the decoded keypoints."""
        base = super().decode(preds, raw_scores)
        return torch.cat([base, self.kpts_decode(preds["kpts"], preds["hw_shapes"]).to(base.dtype)], -1)


class OBB(Detect):
    """Oriented-box head: Detect + ``ne`` angle logits per anchor (``cv4``); the
    angle is (sigmoid - 0.25) * pi in fp32, in [-pi/4, 3pi/4)."""

    def __init__(self, nc: int = 80, ne: int = 1, reg_max: int = 16, end2end: bool = False,
                 ch: Sequence[int] = (), legacy: bool = False):
        super().__init__(nc, reg_max, end2end, ch, legacy)
        self.ne = ne
        self._add_extra_branch(ch, max(ch[0] // 4, ne), ne)

    extra_key = "angle"

    def _outputs(self, feats, one2one: bool = False) -> dict:
        out = super()._outputs(feats, one2one)
        out["angle"] = (torch.sigmoid(out["angle"].float()) - 0.25) * math.pi
        return out

    def decode(self, preds: dict, raw_scores: bool = False) -> torch.Tensor:
        """[B, A, 4+nc+ne]: rotated boxes xywh in input pixels (``dist2rbox``), the
        class scores (sigmoid; logits with ``raw_scores``), then the angle (radians)."""
        anchors, strides = make_anchors(preds["hw_shapes"], self.strides, preds["boxes"].device)
        dist = dfl_decode(preds["boxes"].float(), self.reg_max)
        angle = preds["angle"].float()
        rbox = dist2rbox(dist, angle, anchors[None]) * strides[None]
        scores = preds["scores"].float()
        if not raw_scores:
            scores = torch.sigmoid(scores)
        return torch.cat([rbox, scores, angle], -1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (weight [cin, cout, kh, kw]) in its input's dtype,
    as :class:`~.layers.Conv2d`."""

    def forward(self, x):
        b = self.bias
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None if b is None else b.to(x.dtype), self.stride)


class Proto(nn.Module):
    """Mask prototypes: Conv 3x3 -> 2x2 stride-2 transposed conv (``upsample``)
    -> Conv 3x3 -> Conv 1x1 to ``c2`` masks. The JAX package stores the
    transposed conv's kernel as [2, 2, cout, cin] (``ConvTranspose2x``);
    ``state_dict_from_jax`` turns it into PyTorch's [cin, cout, 2, 2]."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class Classify(nn.Module):
    """Classification head: Conv to 1280 channels, global average pool, Linear
    to ``c2`` classes; logits in train mode, softmax probabilities in eval."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g=1):
        super().__init__()
        c_ = 1280
        self.conv = Conv(c1, c_, k, s, p, g)
        self.linear = Linear(c_, c2)

    def forward(self, x):
        if isinstance(x, list):
            x = torch.cat(x, 1)
        logits = self.linear(self.conv(x).mean((2, 3)))
        return logits if self.training else torch.softmax(logits, -1)
