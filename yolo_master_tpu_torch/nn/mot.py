"""Mixture-of-Transformers (counterpart of ``yolo_master_tpu/nn/mot.py``): a
soft top-k router over three whole transformer experts, a local-conv one, a
(shifted) window one and a deformable one; ``C2fMoT`` stacks such blocks in a
C2f. yolo26-master-moa-mot's P4 and P5 blocks.

As in the JAX package every expert runs, and the router's weights mix them:
the softmax probabilities where they reach the k-th largest (``probs >=
kth``: ties keep more than k experts, as at the zero-initialised init, where
all three tie), renormalised. The window expert pads its map with zeros to the
window multiple after its LayerNorm (no mask on the pad) and rolls it by half a
window when shifted; the deformable expert samples V bilinearly at
``tanh``-bounded offsets of up to half the map, with JAX's explicit gather:
corners off the map read 0 (``bilinear_sample``). Activations are NCHW in
``torch.channels_last`` memory; the experts work on their NHWC views.

In training (``self.training``; ``utils/weights.py:calibrate_bn``'s pass sets
it off on these modules alone, which then run their eval form) the router lifts
every expert's weight to an exploration floor, ``w = (1 - eps) * w + eps / E``
after the top-k mask (eps 0.02, clamped to [0, 0.2]), and ``MoTBlock``
publishes its aux loss as ``aux_record`` (family ``mot``):
``balance_coeff * E * sum(importance^2) + z_coeff * mean(logsumexp(logits)^2)``,
where the importance is the mean of the probabilities (not of the masked
weights), and the usage it reports is that importance."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .layers import Conv, GroupNorm, LayerNorm, Linear, PlainConv, attend
from .mixture_loss import AuxRecord
from .moa import nchw, nhwc, pad_hw, window_partition, window_reverse


def _ffn(dim: int, hidden: int) -> nn.Sequential:
    """Linear -> GELU (tanh form, ``jax.nn.gelu``'s default) -> Linear, at the
    reference's indices 0 and 3 (its Dropout sits at 2)."""
    return nn.Sequential(Linear(dim, hidden), nn.GELU(approximate="tanh"), nn.Identity(), Linear(hidden, dim))


def _layer_scale(dim: int) -> nn.Parameter:
    return nn.Parameter(torch.full((dim,), 0.1))


class LocalConvTransformerExpert(nn.Module):
    """GroupNorm -> depthwise mix -> QKV, attention over every pixel with a 7x7
    depthwise positional conv on V; then a GLU FFN (sigmoid gate in fp32)."""

    def __init__(self, dim, num_heads, mlp_ratio=2.0, dropout=0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.nh, self.hd = num_heads, dim // num_heads
        self.scale = self.hd ** -0.5
        self.dw_mix = PlainConv(dim, dim, 3, g=dim)
        self.qkv = PlainConv(dim, dim * 3, 1)
        self.pe = PlainConv(dim, dim, 7, g=dim)
        self.proj = PlainConv(dim, dim, 1)
        self.norm1 = GroupNorm(dim, 8)
        self.norm2 = GroupNorm(dim, 8)
        hidden = int(dim * mlp_ratio)
        self.ffn_gate = nn.Sequential(Conv(dim, hidden, 1))  # the reference's Sequential(conv, sigmoid)
        self.ffn_val = Conv(dim, hidden, 1)
        self.ffn_out = Conv(hidden, dim, 1, act=False)
        self.ls1, self.ls2 = _layer_scale(dim), _layer_scale(dim)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = self.qkv(self.dw_mix(self.norm1(x))).split(c, 1)
        v = v + self.pe(v)

        def heads(t):  # [B, C, H, W] -> [B, N, heads, hd]
            return nhwc(t).reshape(b, h * w, self.nh, self.hd)

        out = nchw(attend(heads(q), heads(k), heads(v), self.scale).reshape(b, h, w, c))
        x = x + self.ls1.to(x.dtype)[:, None, None] * self.proj(out)
        xn = self.norm2(x)
        gate = torch.sigmoid(self.ffn_gate(xn).float()).to(x.dtype)
        return x + self.ls2.to(x.dtype)[:, None, None] * self.ffn_out(gate * self.ffn_val(xn))


class WindowTransformerExpert(nn.Module):
    """Swin-style window attention (shifted by half a window with ``shift_size``) and an FFN, on LayerNorms."""

    def __init__(self, dim, num_heads, window_size=7, mlp_ratio=2.0, dropout=0.0, shift_size=0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.nh, self.hd = num_heads, dim // num_heads
        self.scale = self.hd ** -0.5
        self.win = window_size
        self.shift = window_size // 2 if shift_size else 0
        self.qkv = Linear(dim, dim * 3, bias=False)
        self.proj = Linear(dim, dim, bias=False)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.ffn = _ffn(dim, int(dim * mlp_ratio))
        self.ls1, self.ls2 = _layer_scale(dim), _layer_scale(dim)

    def forward(self, x):
        b, c, h, w = x.shape
        win, s = self.win, self.shift
        x = nhwc(x)
        xn = self.norm1(x)
        if s:
            xn = torch.roll(xn, (-s, -s), (1, 2))
        xp, _, _ = pad_hw(xn, win)
        hp, wp = xp.shape[1:3]
        wx = window_partition(xp, win)  # [nW, win*win, C]
        q, k, v = (t.reshape(wx.shape[0], -1, self.nh, self.hd) for t in self.qkv(wx).split(c, -1))
        out = self.proj(attend(q, k, v, self.scale).reshape(wx.shape[0], -1, c))
        out = window_reverse(out, win, b, hp, wp)[:, :h, :w]
        if s:
            out = torch.roll(out, (s, s), (1, 2))
        x = x + self.ls1.to(x.dtype) * out
        x = x + self.ls2.to(x.dtype) * self.ffn(self.norm2(x))
        return nchw(x)


def bilinear_sample(feat: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of feat [B, H, W, C] at pixel coordinates sx, sy [B, ...]
    -> [B, ..., C], the JAX package's explicit gather: each corner's index
    clamped into the map, its value zeroed where the corner lies off the map
    (``grid_sample``'s zero padding with ``align_corners=True``). The
    interpolation weights are sx's dtype (fp32), so bf16 values give fp32
    samples, as in JAX."""
    b, h, w, c = feat.shape
    x0, y0 = sx.floor(), sy.floor()
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = feat.reshape(b, h * w, c)

    def gather(yi, xi):
        idx = yi.long().clamp(0, h - 1) * w + xi.long().clamp(0, w - 1)
        sampled = flat.gather(1, idx.reshape(b, -1, 1).expand(-1, -1, c)).reshape(*idx.shape, c)
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        return sampled * valid[..., None].to(sampled.dtype)

    v00, v01, v10, v11 = gather(y0, x0), gather(y0, x0 + 1), gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy


class DeformableTransformerExpert(nn.Module):
    """Single-scale deformable attention: each query predicts ``n_points``
    offsets (tanh, up to half the map) and softmax weights per head, samples V
    bilinearly there and sums; then an FFN, on LayerNorms. The offset and
    weight projections start at zero (every point samples its own pixel)."""

    def __init__(self, dim, num_heads, n_points=4, mlp_ratio=2.0, dropout=0.0, align_corners=True):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.nh, self.hd, self.np = num_heads, dim // num_heads, n_points
        self.q_proj = Linear(dim, dim, bias=False)
        self.v_proj = Linear(dim, dim, bias=False)
        self.offset_proj = Linear(dim, num_heads * n_points * 2)
        self.attn_proj = Linear(dim, num_heads * n_points)
        self.out_proj = Linear(dim, dim, bias=False)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.ffn = _ffn(dim, int(dim * mlp_ratio))
        self.ls1, self.ls2 = _layer_scale(dim), _layer_scale(dim)

    @torch.no_grad()
    def seeded_init(self, generator):
        for m in (self.offset_proj, self.attn_proj):
            m.weight.zero_()
            m.bias.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        n, nh, npt, hd = h * w, self.nh, self.np, self.hd
        x = nhwc(x)
        xn = self.norm1(x).reshape(b, n, c)
        q = self.q_proj(xn)
        v = self.v_proj(xn).reshape(b, h, w, nh, hd)
        offsets = torch.tanh(self.offset_proj(q).float()).reshape(b, n, nh, npt, 2)  # in [-1, 1]
        attn_w = torch.softmax(self.attn_proj(q).float().reshape(b, n, nh, npt), -1)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                                torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
        sx = xs.reshape(1, n, 1, 1) + offsets[..., 0] * (w - 1) / 2
        sy = ys.reshape(1, n, 1, 1) + offsets[..., 1] * (h - 1) / 2
        out = torch.stack([(bilinear_sample(v[..., i, :], sx[:, :, i], sy[:, :, i]).float()
                            * attn_w[:, :, i, :, None]).sum(2) for i in range(nh)], 2)  # [B, N, heads, hd]
        out = self.out_proj(out.reshape(b, n, c).to(x.dtype)).reshape(b, h, w, c)
        x = x + self.ls1.to(x.dtype) * out
        x = x + self.ls2.to(x.dtype) * self.ffn(self.norm2(x))
        return nchw(x)


class MoTRouter(nn.Module):
    """Token-level (``use_spatial``: 1x1 -> GroupNorm(4) -> SiLU -> 1x1, [B, E, H,
    W]) or image-level (pooled, Linear -> SiLU -> Linear, [B, E, 1, 1]) soft top-k
    router, the last layer zero-initialised: (weights, probabilities, logits),
    fp32. Weights keep every expert whose probability reaches the k-th largest;
    in training they are then lifted to the exploration floor ``eps / E``."""

    def __init__(self, dim, num_experts=3, top_k=2, use_spatial=True, temperature=1.0, exploration_eps=0.02):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.use_spatial = use_spatial
        self.temperature = max(temperature, 0.1)
        self.eps = min(max(exploration_eps, 0.0), 0.2)
        hidden = max(dim // 8, num_experts * 4)
        if use_spatial:
            self.router = nn.Sequential(PlainConv(dim, hidden, 1), GroupNorm(hidden, 4), nn.SiLU(),
                                        PlainConv(hidden, num_experts, 1, bias=True))
        else:
            self.router = nn.Sequential(Linear(dim, hidden, bias=False), nn.SiLU(), Linear(hidden, num_experts))

    @torch.no_grad()
    def seeded_init(self, generator):
        self.router[-1].weight.zero_()
        self.router[-1].bias.zero_()

    def forward(self, x):
        if self.use_spatial:
            logits = self.router(x).float() / self.temperature
        else:
            logits = self.router(x.mean((2, 3))).float()[..., None, None] / self.temperature
        probs = torch.softmax(logits, 1)
        w = probs
        if self.top_k < self.num_experts:
            kth = probs.topk(self.top_k, 1).values[:, -1:]
            w = probs * (probs >= kth)
            w = w / w.sum(1, keepdim=True).clamp_min(1e-9)
        if self.training and self.eps > 0:
            w = (1 - self.eps) * w + self.eps / self.num_experts
        return w, probs, logits


class MoTBlock(nn.Module):
    """x + out_proj(GroupNorm(sum over the experts of weight * expert(x)))."""

    NUM_EXPERTS = 3

    def __init__(self, dim, num_heads=8, top_k=2, window_size=7, n_points=4, mlp_ratio=2.0, temperature=1.0,
                 use_spatial_router=True, balance_loss_coeff=0.01, router_z_loss_coeff=None, dropout=0.0,
                 exploration_eps=0.02, window_shift=False, sparse_train=False):
        super().__init__()
        if not 1 <= top_k <= self.NUM_EXPERTS:
            raise ValueError(f"top_k must be in [1, {self.NUM_EXPERTS}], got {top_k}")
        heads = num_heads
        while dim % heads and heads > 1:
            heads -= 1
        self.experts = nn.ModuleList([
            LocalConvTransformerExpert(dim, heads, mlp_ratio, dropout),
            WindowTransformerExpert(dim, heads, window_size, mlp_ratio, dropout,
                                    shift_size=window_size // 2 if window_shift else 0),
            DeformableTransformerExpert(dim, heads, n_points, mlp_ratio, dropout)])
        self.router = MoTRouter(dim, self.NUM_EXPERTS, top_k, use_spatial=use_spatial_router,
                                temperature=temperature, exploration_eps=exploration_eps)
        self.out_norm = GroupNorm(dim, 8)
        self.out_proj = PlainConv(dim, dim, 1)
        self.balance_loss_coeff = balance_loss_coeff
        self.z_coeff = balance_loss_coeff if router_z_loss_coeff is None else router_z_loss_coeff
        self.aux_record: Optional[AuxRecord] = None  # set by a train-mode forward

    def forward(self, x):
        w, probs, logits = self.router(x)
        if self.training and (self.balance_loss_coeff > 0 or self.z_coeff > 0):
            importance = probs.permute(0, 2, 3, 1).reshape(-1, self.NUM_EXPERTS).mean(0)
            balance = self.NUM_EXPERTS * (importance ** 2).sum()
            z = (torch.logsumexp(logits, 1) ** 2).mean()
            self.aux_record = AuxRecord(self.balance_loss_coeff * balance + self.z_coeff * z, "mot",
                                        importance.detach(), None)
        w = w.to(x.dtype)
        mixed = None
        for i, expert in enumerate(self.experts):
            y = expert(x) * w[:, i:i + 1]
            mixed = y if mixed is None else mixed + y
        return x + self.out_proj(self.out_norm(mixed))


class C2fMoT(nn.Module):
    """C2f around ``n`` MoTBlocks, every second one's window shifted."""

    def __init__(self, c1, c2, n=1, num_heads=8, top_k=2, window_size=7, n_points=4, mlp_ratio=2.0,
                 temperature=1.0, balance_loss_coeff=0.01, e=0.5, use_spatial_router=True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(MoTBlock(self.c, num_heads, top_k, window_size, n_points, mlp_ratio=mlp_ratio,
                                        temperature=temperature, balance_loss_coeff=balance_loss_coeff,
                                        use_spatial_router=use_spatial_router, window_shift=bool(i % 2))
                               for i in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))
