"""ES-MoE experts (counterpart of ``yolo_master_tpu/nn/moe/experts.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BN_EPS, BN_MOMENTUM, BatchNorm2d, Conv2d, bn_scale_shift, fold_bn


class DepthwiseSeparableConv(nn.Module):
    """depthwise conv (k) -> pointwise conv (1x1) -> BN -> SiLU; after :meth:`fuse`
    the BN is folded into the pointwise conv's bias. Both convs run in the
    input's dtype (:class:`~..layers.Conv2d`), as JAX's expert does."""

    def __init__(self, c1: int, c2: int, k: int, s: int = 1):
        super().__init__()
        self.depthwise = Conv2d(c1, c1, k, s, (k - 1) // 2, groups=c1, bias=False)
        self.pointwise = Conv2d(c1, c2, 1, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU()

    def forward(self, x):
        return self.act(self.bn(self.pointwise(self.depthwise(x))))

    def forward_gathered(self, sel, x):
        """Expert (b, k) on sample b, for gathered banks ``sel`` [B, K, ...]
        (``nn/moe/dispatch.py``): x [B, C, H, W] -> [B, K, O, H', W']."""
        dw = sel["depthwise.weight"].to(x.dtype)  # [B, K, C, 1, k, k], centre-padded
        b, kk, c, _, k, _ = dw.shape
        xr = x.unsqueeze(1).expand(b, kk, *x.shape[1:]).reshape(1, b * kk * c, *x.shape[2:])
        d = F.conv2d(xr, dw.reshape(b * kk * c, 1, k, k), stride=self.depthwise.stride, padding=(k - 1) // 2,
                     groups=b * kk * c)
        hw = d.shape[2:]
        pw = sel["pointwise.weight"].flatten(3).to(x.dtype)  # [B, K, O, C]
        y = torch.bmm(pw.flatten(0, 1), d.reshape(b * kk, c, -1))  # [B*K, O, H'W']
        if "pointwise.bias" in sel:  # BN folded by fuse()
            y = y + sel["pointwise.bias"].flatten(0, 1)[..., None].to(y.dtype)
        else:
            mean, var, scale, shift = (sel[f"bn.{n}"].flatten(0, 1)[..., None]
                                       for n in ("running_mean", "running_var", "weight", "bias"))
            if y.dtype == var.dtype:
                y = (y - mean) / torch.sqrt(var + self.bn.eps) * scale + shift
            else:  # a bf16 copy: folded in fp32, one multiply-add in y's dtype (BatchNorm2d)
                scale, shift = bn_scale_shift(mean, var, scale, shift, self.bn.eps)
                y = y * scale.to(y.dtype) + shift.to(y.dtype)
        return F.silu(y).reshape(b, kk, -1, *hw)

    @torch.no_grad()
    def fuse(self):
        if isinstance(self.bn, nn.Identity):
            return
        w, b = fold_bn(self.pointwise.weight, None, self.bn)
        pw = Conv2d(self.pointwise.in_channels, self.pointwise.out_channels, 1, bias=True, device=w.device,
                    dtype=w.dtype)
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

    def forward_gathered(self, sel, x):
        return self.conv.forward_gathered({k[len("conv."):]: v for k, v in sel.items()}, x)
