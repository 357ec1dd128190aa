"""ES-MoE experts (counterpart of ``yolo_master_tpu/nn/moe/experts.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import BN_EPS, BN_MOMENTUM, fold_bn


class DepthwiseSeparableConv(nn.Module):
    """depthwise conv (k) -> pointwise conv (1x1) -> BN -> SiLU; after :meth:`fuse`
    the BN is folded into the pointwise conv's bias."""

    def __init__(self, c1: int, c2: int, k: int, s: int = 1):
        super().__init__()
        self.depthwise = nn.Conv2d(c1, c1, k, s, (k - 1) // 2, groups=c1, bias=False)
        self.pointwise = nn.Conv2d(c1, c2, 1, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU()

    def forward(self, x):
        return self.act(self.bn(self.pointwise(self.depthwise(x))))

    @torch.no_grad()
    def fuse(self):
        if isinstance(self.bn, nn.Identity):
            return
        w, b = fold_bn(self.pointwise.weight, None, self.bn)
        pw = nn.Conv2d(self.pointwise.in_channels, self.pointwise.out_channels, 1, bias=True,
                       device=w.device, dtype=w.dtype)
        pw.weight.copy_(w)
        pw.bias.copy_(b)
        self.pointwise = pw
        self.bn = nn.Identity()


class EfficientExpertGroup(nn.Module):
    """One expert: one depthwise-separable conv."""

    def __init__(self, c1: int, c2: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.conv = DepthwiseSeparableConv(c1, c2, kernel_size, stride)

    def forward(self, x):
        return self.conv(x)
