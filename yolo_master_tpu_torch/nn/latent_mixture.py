"""Latent mixtures (counterpart of ``yolo_master_tpu/nn/latent_mixture.py``):
dense channel-expert mixtures routed through a shared latent bottleneck, one
before each scale of yolo26-master-latent's head.

    tokens = spatial means (fp32) of the inputs, each projected to the output width
    probs  = softmax(router(tokens + scale_embedding) / temperature), fp32
    out    = base + residual_gain * sum over the experts e of probs[:, e] * expert_e(base)

``base`` is the first input (projected where its width differs). Every expert
runs (a dense mixture); ``residual_gain`` starts at ``residual_init`` (0 in
the YAML), so at the init the experts add nothing. The router reads fp32
(LayerNorm, Linears) and keeps its ``scale_embedding`` fp32 in a bf16 copy.

Eval only: the train step refuses these blocks (their aux loss and the
router's train-only logit noise, 0 in the YAML, are the next slice,
``nn/tasks.py:refuse_mixture_training``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..utils import make_divisible
from .layers import GroupNorm, LayerNorm, Linear, PlainConv

ROUTER_LOGIT_LIMIT = 30.0


def _conv1x1_gn(c1: int, c2: int) -> nn.Sequential:
    return nn.Sequential(PlainConv(c1, c2, 1), GroupNorm(c2, 1), nn.SiLU())


class DenseChannelExpert(nn.Module):
    """1x1 -> GN(1) -> SiLU -> 3x3 depthwise -> GN(1) -> SiLU -> 1x1, the last
    conv's weights drawn N(0, 1e-3)."""

    def __init__(self, channels: int, expert_ratio: float = 0.25):
        super().__init__()
        hidden = make_divisible(max(8, round(channels * expert_ratio)), 8)
        self.net = nn.Sequential(PlainConv(channels, hidden, 1), GroupNorm(hidden, 1), nn.SiLU(),
                                 PlainConv(hidden, hidden, 3, g=hidden), GroupNorm(hidden, 1), nn.SiLU(),
                                 PlainConv(hidden, channels, 1))

    @torch.no_grad()
    def seeded_init(self, generator):
        last = self.net[-1].weight
        last.copy_(1e-3 * torch.randn(last.shape, generator=generator))

    def forward(self, x):
        return self.net(x)


class LatentRouter(nn.Module):
    """fp32 router over tokens [B, T, D] (or [B, D]): the scale embedding added,
    the tokens averaged (or kept, ``per_token``), LayerNorm -> Linear -> SiLU ->
    Linear -> SiLU -> expert head (zero-initialised unless ``router_init_std``);
    logits clamped to +-30 (NaN to 0): (logits, softmax(logits / temperature)).
    ``noise_std`` (training only) is not applied: training is refused."""

    def __init__(self, latent_dim, num_experts, router_hidden_dim=None, temperature=1.0, noise_std=0.0,
                 router_init_std=0.0, num_tokens=None, per_token=False):
        super().__init__()
        hidden = router_hidden_dim or latent_dim
        self.num_experts = num_experts
        self.temperature = max(float(temperature), 0.1)
        self.noise_std = float(noise_std)
        self.router_init_std = float(router_init_std)
        self.per_token = per_token
        self.norm = LayerNorm(latent_dim)
        self.trunk = nn.Sequential(Linear(latent_dim, hidden), nn.SiLU(), Linear(hidden, latent_dim), nn.SiLU())
        self.expert_head = Linear(latent_dim, num_experts)
        self.scale_embedding = nn.Parameter(torch.zeros(num_tokens, latent_dim)) if num_tokens is not None else None

    @torch.no_grad()
    def seeded_init(self, generator):
        head = self.expert_head
        for t in (head.weight, head.bias):
            t.copy_(self.router_init_std * torch.randn(t.shape, generator=generator) if self.router_init_std > 0
                    else torch.zeros_like(t))
        if self.scale_embedding is not None:
            self.scale_embedding.copy_(0.02 * torch.randn(self.scale_embedding.shape, generator=generator))

    def forward(self, tokens):
        x = tokens.float()
        if x.ndim == 3:
            if self.scale_embedding is not None:
                x = x + self.scale_embedding[None]
            routed = x if self.per_token else x.mean(1)
        else:
            routed = x
        logits = self.expert_head(self.trunk(self.norm(routed)))
        logits = torch.nan_to_num(logits, nan=0.0, posinf=ROUTER_LOGIT_LIMIT, neginf=-ROUTER_LOGIT_LIMIT)
        logits = logits.clamp(-ROUTER_LOGIT_LIMIT, ROUTER_LOGIT_LIMIT)
        return logits, torch.softmax(logits / self.temperature, -1)


class LatentMixture(nn.Module):
    """Single-scale latent mixture over several aligned inputs (their widths
    ``in_channels``): one output of ``out_channels``."""

    def __init__(self, in_channels, out_channels, num_experts=4, expert_ratio=0.25, router_hidden_dim=None,
                 temperature=1.0, balance_loss_coeff=1e-2, router_z_loss_coeff=1e-3, residual_init=0.0,
                 noise_std=0.0, router_init_std=0.0):
        super().__init__()
        in_channels = [in_channels] if isinstance(in_channels, int) else list(in_channels)
        self.in_channels, self.out_channels = tuple(in_channels), out_channels
        self.num_experts = num_experts
        self.base_proj = None if in_channels[0] == out_channels else _conv1x1_gn(in_channels[0], out_channels)
        self.token_projs = nn.ModuleList(nn.Identity() if c == out_channels else _conv1x1_gn(c, out_channels)
                                         for c in in_channels)
        self.router = LatentRouter(out_channels, num_experts, router_hidden_dim, temperature, noise_std,
                                   router_init_std, num_tokens=len(in_channels), per_token=False)
        self.experts = nn.ModuleList(DenseChannelExpert(out_channels, expert_ratio) for _ in range(num_experts))
        self.residual_gain = nn.Parameter(torch.tensor(float(residual_init)))

    def forward(self, xs):
        xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
        base = xs[0] if self.base_proj is None else self.base_proj(xs[0])
        tokens = torch.stack([proj(x).float().mean((2, 3)) for x, proj in zip(xs, self.token_projs)], 1)
        _, probs = self.router(tokens)  # [B, E]
        mixed = torch.zeros_like(base)
        for e, expert in enumerate(self.experts):
            mixed = mixed + expert(base) * probs[:, e].to(base.dtype)[:, None, None, None]
        return base + self.residual_gain.to(base.dtype) * mixed


class MultiScaleLatentMixture(nn.Module):
    """List-to-list latent mixture: one router over every scale's token
    (``per_token``), a bank of experts and a residual gain a scale."""

    def __init__(self, channels: Sequence[int], latent_dim=128, num_experts=4, expert_ratio=0.25,
                 router_hidden_dim=None, temperature=1.0, balance_loss_coeff=1e-2, router_z_loss_coeff=1e-3,
                 residual_init=0.0, noise_std=0.0, router_init_std=0.0):
        super().__init__()
        self.channels = tuple(channels)
        self.num_experts = num_experts
        self.input_projs = nn.ModuleList(nn.Identity() if c == latent_dim else _conv1x1_gn(c, latent_dim)
                                         for c in self.channels)
        self.router = LatentRouter(latent_dim, num_experts, router_hidden_dim, temperature, noise_std,
                                   router_init_std, num_tokens=len(self.channels), per_token=True)
        self.experts = nn.ModuleList(nn.ModuleList(DenseChannelExpert(c, expert_ratio) for _ in range(num_experts))
                                     for c in self.channels)
        self.residual_gain = nn.Parameter(torch.full((len(self.channels),), float(residual_init)))

    def forward(self, xs):
        tokens = torch.stack([proj(x).float().mean((2, 3)) for x, proj in zip(xs, self.input_projs)], 1)
        _, probs = self.router(tokens)  # [B, T, E]
        outs = []
        for s, x in enumerate(xs):
            mixed = torch.zeros_like(x)
            for e in range(self.num_experts):
                mixed = mixed + self.experts[s][e](x) * probs[:, s, e].to(x.dtype)[:, None, None, None]
            outs.append(x + self.residual_gain[s].to(x.dtype) * mixed)
        return outs
