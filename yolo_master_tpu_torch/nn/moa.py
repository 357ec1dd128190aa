"""Mixture-of-Attention (counterpart of ``yolo_master_tpu/nn/moa.py``): a soft
per-token router over three attention head groups, local windowed, regional
(2x-pooled keys and values) and global (exact attention on small maps,
Performer-style linear attention on large ones), then an FFN; ``C2fMoA``
stacks such blocks in a C2f. yolo26-master-moa-mot's P3 block.
``NeckMoAFusion`` cross-attends a high-resolution map into a low-resolution
one for an FPN/PAN neck (no YAML of the repo uses it; a graph dict can).

Activations are NCHW in ``torch.channels_last`` memory, as everywhere in the
port; the heads work on their NHWC views, in the JAX package's order of
operations: window partitions of a map zero-padded to the window multiple
(no mask on the pad), attention logits in the activation dtype with the
softmax in fp32 (``layers.attend``, which in fp32 past 1,024 keys sums the
product with V in chunks), the linear attention in fp32. The global head's
random features, ``_rf_matrix`` (the QR of ``np.random.default_rng`` draws),
are a persistent buffer carried in the state dict and kept fp32 in a bf16 copy.

In training (``self.training``; ``utils/weights.py:calibrate_bn``'s pass sets
it off on these modules alone, which then run their eval form) ``MoABlock``
publishes its aux loss as ``aux_record`` (family ``moa``, the usage the
batch-mean routing weights): ``coeff * 3 * sum(mean(weights)^2)``;
``NeckMoAFusion`` its two-way form, ``coeff * 2 * sum(...)``, with no usage
(JAX publishes no stats for it). ``_rf_matrix`` stays a fixed buffer in
training, as the module's own description and the upstream have it; the JAX
package keeps it in its parameter tree and its optimizer moves it on the linear
path (fault 4 of the reference, ROADMAP.md §3)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, GroupNorm, PlainConv, attend, avg_pool, upsample_nearest
from .mixture_loss import AuxRecord

LINEAR_ATTN_THRESHOLD = 512
LINEAR_ATTN_BLEND_WINDOW = 64
LINEAR_ATTN_ACTIVATION_LIMIT = 1e4


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def pad_hw(x: torch.Tensor, win: int):
    """NHWC x zero-padded at the bottom and right to multiples of ``win``: (x, rows added, columns added)."""
    ph, pw = (win - x.shape[1] % win) % win, (win - x.shape[2] % win) % win
    return (F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x), ph, pw


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * H/win * W/win, win*win, C], windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def window_reverse(wx: torch.Tensor, win: int, b: int, h: int, w: int) -> torch.Tensor:
    x = wx.reshape(b, h // win, w // win, win, win, wx.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Softmax attention over [..., heads, N, d] (the JAX ``sdpa`` layout), through :func:`~.layers.attend`."""
    lead = q.shape[:-3]
    q, k, v = (t.reshape(-1, *t.shape[-3:]).transpose(1, 2) for t in (q, k, v))  # [B', N, heads, d]
    out = attend(q, k, v, scale).transpose(1, 2)
    return out.reshape(*lead, *out.shape[1:])


class LocalAttnHead(nn.Module):
    """Depthwise-biased QKV, attention within win x win windows, a 7x7 depthwise
    positional conv on V, projection and GroupNorm."""

    def __init__(self, dim, num_heads, head_dim=None, window_size=7):
        super().__init__()
        self.nh = num_heads
        self.hd = head_dim or max(dim // num_heads, 16)
        self.win = max(1, window_size)
        self.inner = self.hd * self.nh
        self.qkv_dw = PlainConv(dim, dim, 3, g=dim)
        self.qkv_pw = PlainConv(dim, self.inner * 3, 1)
        self.proj = PlainConv(self.inner, dim, 1)
        self.pe = PlainConv(self.inner, self.inner, 7, g=self.inner)
        self.norm = GroupNorm(dim, 8)
        self.scale = self.hd ** -0.5

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = self.qkv_pw(self.qkv_dw(x)).split(self.inner, 1)
        v = v + self.pe(v)
        win = self.win

        def windows(t):  # [B, inner, H, W] -> [nW, heads, win*win, hd], the map zero-padded first
            t, _, _ = pad_hw(nhwc(t), win)
            return window_partition(t, win).reshape(-1, win * win, self.nh, self.hd).transpose(1, 2)

        out = sdpa(windows(q), windows(k), windows(v), self.scale).transpose(1, 2).reshape(-1, win * win, self.inner)
        hp, wp = h + (win - h % win) % win, w + (win - w % win) % win
        out = window_reverse(out, win, b, hp, wp)[:, :h, :w]
        return self.norm(self.proj(nchw(out)))


class RegionalAttnHead(nn.Module):
    """Full-resolution queries against keys and values of the map average-pooled
    ``pool_stride`` x (VALID windows; the map itself where a side is 1)."""

    def __init__(self, dim, num_heads, head_dim=None, pool_stride=2):
        super().__init__()
        self.nh = num_heads
        self.hd = head_dim or max(dim // num_heads, 16)
        self.inner = self.hd * self.nh
        self.pool_stride = pool_stride
        self.q_proj = PlainConv(dim, self.inner, 1)
        self.kv_proj = PlainConv(dim, self.inner * 2, 1)
        self.proj = PlainConv(self.inner, dim, 1)
        self.norm = GroupNorm(dim, 8)
        self.scale = self.hd ** -0.5

    def forward(self, x):
        b, _, h, w = x.shape
        kv = self.kv_proj(x if min(h, w) <= 1 else avg_pool(x, self.pool_stride))
        k, v = nhwc(kv).reshape(b, -1, 2, self.nh, self.hd).unbind(2)  # [B, N', heads, hd] each
        q = nhwc(self.q_proj(x)).reshape(b, h * w, self.nh, self.hd)
        out = attend(q, k, v, self.scale).reshape(b, h, w, self.inner)
        return self.norm(self.proj(nchw(out)))


class GlobalAttnHead(nn.Module):
    """Attention over every pixel: exact for N <= 448 tokens, Performer-style
    linear attention (fixed orthogonal random features) for N >= 512, and a
    static blend of both in between (the map's size fixes the branch)."""

    def __init__(self, dim, num_heads, head_dim=None, nb_features=64, rf_seed=131074):
        super().__init__()
        self.nh = num_heads
        self.hd = head_dim or max(dim // num_heads, 16)
        self.inner = self.hd * self.nh
        self.qkv = PlainConv(dim, self.inner * 3, 1)
        self.proj = PlainConv(self.inner, dim, 1)
        self.norm = GroupNorm(dim, 8)
        self.scale = self.hd ** -0.5
        rf = np.random.default_rng(rf_seed).standard_normal((self.hd, self.hd)).astype(np.float32)
        qmat, _ = np.linalg.qr(rf)
        self.register_buffer("_rf_matrix", torch.from_numpy(np.ascontiguousarray(qmat[:min(nb_features, self.hd)])))

    def linear_attn(self, q, k, v):
        """q, k, v [B, heads, N, hd] -> [B, heads, N, hd] in v's dtype, computed in fp32."""
        rf = self._rf_matrix.float()
        scale = rf.shape[0] ** -0.5
        qf = (F.relu(q.float() @ rf.T * scale) + 1e-6).clamp(max=LINEAR_ATTN_ACTIVATION_LIMIT)
        kf = (F.relu(k.float() @ rf.T * scale) + 1e-6).clamp(max=LINEAR_ATTN_ACTIVATION_LIMIT)
        kv = torch.einsum("bhnf,bhnd->bhfd", kf, v.float())
        z = 1.0 / (torch.einsum("bhnf,bhf->bhn", qf, kf.sum(2)) + 1e-6)
        return (torch.einsum("bhnf,bhfd->bhnd", qf, kv) * z[..., None]).to(v.dtype)

    def forward(self, x):
        b, _, h, w = x.shape
        n = h * w
        qkv = nhwc(self.qkv(x)).reshape(b, n, 3, self.nh, self.hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, heads, N, hd] each
        lo = LINEAR_ATTN_THRESHOLD - LINEAR_ATTN_BLEND_WINDOW
        if n <= lo:
            out = sdpa(q, k, v, self.scale)
        elif n >= LINEAR_ATTN_THRESHOLD:
            out = self.linear_attn(q * self.scale, k, v)
        else:
            alpha = (n - lo) / LINEAR_ATTN_BLEND_WINDOW
            out = (1 - alpha) * sdpa(q, k, v, self.scale) + alpha * self.linear_attn(q * self.scale, k, v)
        out = out.transpose(1, 2).reshape(b, h, w, self.inner)
        return self.norm(self.proj(nchw(out)))


class MoARouter(nn.Module):
    """Per-token soft router over the head groups: 1x1 -> GroupNorm(4) -> SiLU ->
    1x1 (zero-initialised, so routing starts uniform); fp32 softmax of the
    logits over the temperature, [B, G, H, W]."""

    def __init__(self, dim, num_groups, reduction=8, temperature=1.0):
        super().__init__()
        self.num_groups = num_groups
        self.temperature = max(temperature, 0.1)
        hidden = max(dim // reduction, num_groups * 2)
        self.router = nn.Sequential(PlainConv(dim, hidden, 1), GroupNorm(hidden, 4), nn.SiLU(),
                                    PlainConv(hidden, num_groups, 1, bias=True))

    @torch.no_grad()
    def seeded_init(self, generator):
        self.router[3].weight.zero_()
        self.router[3].bias.zero_()

    def forward(self, x):
        logits = self.router(x).float() / self.temperature
        return torch.softmax(logits, 1), logits


class MoABlock(nn.Module):
    """x + ls_attn * fusion(sum over the groups of weight * head(x)), then x +
    ls_ffn * ffn(x) (without ``shortcut``, each stage's scaled output alone)."""

    NUM_GROUPS = 3

    def __init__(self, dim, num_heads=8, mlp_ratio=2.0, temperature=1.0, attn_drop=0.0, shortcut=True,
                 aux_loss_coeff=0.01, block_index=0, local_window_size=7, sequential_heads=False):
        super().__init__()
        if num_heads <= 0 or num_heads % self.NUM_GROUPS:
            raise ValueError(f"num_heads ({num_heads}) must be divisible by {self.NUM_GROUPS}")
        self.shortcut = shortcut
        head_dim = max(dim // num_heads, 16)
        hpg = num_heads // self.NUM_GROUPS
        self.local_head = LocalAttnHead(dim, hpg, head_dim, window_size=local_window_size)
        self.region_head = RegionalAttnHead(dim, hpg, head_dim)
        self.global_head = GlobalAttnHead(dim, hpg, head_dim, rf_seed=block_index * 7919 + 2 * 65537)
        self.router = MoARouter(dim, self.NUM_GROUPS, temperature=temperature)
        self.fusion = Conv(dim, dim, 1, act=False)
        hidden = int(dim * mlp_ratio)
        self.ffn = nn.Sequential(Conv(dim, hidden, 1), Conv(hidden, dim, 1, act=False))
        ls_init = 0.1 if shortcut else 1.0
        self.ls_attn = nn.Parameter(torch.full((dim,), ls_init))
        self.ls_ffn = nn.Parameter(torch.full((dim,), ls_init))
        self.aux_loss_coeff = aux_loss_coeff
        self.aux_record: Optional[AuxRecord] = None  # set by a train-mode forward

    def forward(self, x):
        weights, _ = self.router(x)
        if self.training and self.aux_loss_coeff > 0:
            importance = weights.mean((0, 2, 3))
            self.aux_record = AuxRecord(self.aux_loss_coeff * self.NUM_GROUPS * (importance ** 2).sum(), "moa",
                                        importance.detach(), None)
        w = weights.to(x.dtype)
        mixed = (w[:, 0:1] * self.local_head(x) + w[:, 1:2] * self.region_head(x)
                 + w[:, 2:3] * self.global_head(x))
        mixed = self.fusion(mixed) * self.ls_attn.to(x.dtype)[:, None, None]
        x = x + mixed if self.shortcut else mixed
        ff = self.ffn(x) * self.ls_ffn.to(x.dtype)[:, None, None]
        return x + ff if self.shortcut else ff


class C2fMoA(nn.Module):
    """C2f around ``n`` MoABlocks (heads rounded up to a multiple of 3)."""

    def __init__(self, c1, c2, n=1, num_heads=6, mlp_ratio=2.0, temperature=1.0, shortcut=True, e=0.5,
                 aux_loss_coeff=0.01, local_window_size=7, sequential_heads=False):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        heads = num_heads + (-num_heads) % MoABlock.NUM_GROUPS
        self.m = nn.ModuleList(MoABlock(self.c, heads, mlp_ratio, temperature, shortcut=shortcut,
                                        aux_loss_coeff=aux_loss_coeff, block_index=i,
                                        local_window_size=local_window_size) for i in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class NeckMoAFusion(nn.Module):
    """Cross-scale fusion for an FPN/PAN neck: queries from the high-resolution
    map ``hi`` attend to keys and values of the low-resolution map ``lo``
    (nearest-upsampled to hi's size first); a two-way router blends
    ``out_proj(cross)`` with ``self_proj(hi)`` per pixel, plus ``hi`` where
    ``shortcut`` holds and the widths agree. ``ch`` = (hi's width, lo's width)."""

    def __init__(self, ch, c_out, num_heads=4, shortcut=True, aux_loss_coeff=0.01):
        super().__init__()
        c_hi, c_lo = ch
        self.shortcut = shortcut and c_hi == c_out
        self.aux_loss_coeff = aux_loss_coeff
        self.nh = num_heads
        self.hd = max(c_hi // num_heads, 16)
        self.inner = self.hd * num_heads
        self.scale = self.hd ** -0.5
        self.q_proj = PlainConv(c_hi, self.inner, 1)
        self.kv_proj = PlainConv(c_lo, self.inner * 2, 1)
        self.router = MoARouter(c_hi, 2)
        self.out_proj = Conv(self.inner, c_out, 1, act=False)
        self.self_proj = Conv(c_hi, c_out, 1, act=False)
        self.aux_record: Optional[AuxRecord] = None  # set by a train-mode forward

    def forward(self, xs):
        hi, lo = xs
        b, _, h, w = hi.shape
        if lo.shape[2] != h:
            lo = upsample_nearest(lo, h // lo.shape[2])
        q = nhwc(self.q_proj(hi)).reshape(b, h * w, self.nh, self.hd)
        k, v = nhwc(self.kv_proj(lo)).reshape(b, h * w, 2, self.nh, self.hd).unbind(2)
        cross = nchw(attend(q, k, v, self.scale).reshape(b, h, w, self.inner))
        weights, _ = self.router(hi)  # [B, 2, H, W]
        if self.training and self.aux_loss_coeff > 0:
            importance = weights.mean((0, 2, 3))
            self.aux_record = AuxRecord(self.aux_loss_coeff * 2 * (importance ** 2).sum(), "moa", None, None)
        wt = weights.to(hi.dtype)
        out = wt[:, 0:1] * self.out_proj(cross) + wt[:, 1:2] * self.self_proj(hi)
        return hi + out if self.shortcut else out
