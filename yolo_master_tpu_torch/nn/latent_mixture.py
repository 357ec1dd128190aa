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

In training (``self.training``; ``utils/weights.py:calibrate_bn``'s pass
sets it off on these modules alone, which then run their eval form):

  * the router adds ``normal(path_key(jax_path, step), logits.shape) *
    noise_std`` to its logits before the NaN guard and the clamp (0 in the
    YAML), JAX's draw bit for bit: ``jax_path`` is the router's JAX module path
    (``layers.23.router``, set when the model is built), ``step`` the optimizer
    step (``DetectionModel.forward_train`` sets it); the draw is made on the
    host once per step and shape and reaches the device in one copy;
  * every forward publishes its aux loss as ``aux_record`` (family
    ``latent``, no usage: JAX publishes no stats for it), even at zero
    coefficients: ``balance_coeff * max(E * sum(importance^2) - 1, 0) +
    z_coeff * mean(logsumexp(logits)^2)`` on the clamped logits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..utils import jax_random, make_divisible
from .layers import GroupNorm, LayerNorm, Linear, PlainConv
from .mixture_loss import AuxRecord
from .moe.mixtures import path_key

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
    in training the logit noise added; logits clamped to +-30 (NaN to 0):
    (logits, softmax(logits / temperature))."""

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
        self.jax_path = ""  # the JAX module path keying the noise (DetectionModel sets it)
        self.step = 0  # the optimizer step of a train-mode forward (DetectionModel.forward_train sets it)
        self._draws: Optional[Tuple[tuple, torch.Tensor]] = None  # (key, the noise on the device): noise()

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
        if self.training and self.noise_std > 0:
            logits = logits + self.noise(tuple(logits.shape), logits.device)
        logits = torch.nan_to_num(logits, nan=0.0, posinf=ROUTER_LOGIT_LIMIT, neginf=-ROUTER_LOGIT_LIMIT)
        logits = logits.clamp(-ROUTER_LOGIT_LIMIT, ROUTER_LOGIT_LIMIT)
        return logits, torch.softmax(logits / self.temperature, -1)

    def noise(self, shape: Tuple[int, ...], device) -> torch.Tensor:
        """normal(path_key(jax_path, step), shape) * noise_std, fp32, made on the host
        and copied to ``device`` once per step and shape (and anew after a change
        to the settings it depends on)."""
        key = (self.step, shape, str(device), self.jax_path, self.noise_std)
        if self._draws is None or self._draws[0] != key:
            host = jax_random.normal(path_key(self.jax_path, self.step), shape) * np.float32(self.noise_std)
            self._draws = (key, torch.from_numpy(host).to(device))
        return self._draws[1]


def latent_aux(logits: torch.Tensor, probs: torch.Tensor, num_experts: int, balance_coeff: float,
               z_coeff: float) -> torch.Tensor:
    """balance_coeff * max(E * sum(importance^2) - 1, 0) + z_coeff * mean(logsumexp(logits)^2),
    the importance the mean of ``probs`` over every row; ``torch.maximum`` splits
    the gradient at the tie (uniform routing) as JAX's clip does."""
    importance = probs.reshape(-1, probs.shape[-1]).mean(0)
    over = num_experts * (importance ** 2).sum() - 1.0
    z = (torch.logsumexp(logits, -1) ** 2).mean()
    return balance_coeff * torch.maximum(over, torch.zeros_like(over)) + z_coeff * z


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
        self.balance_loss_coeff, self.router_z_loss_coeff = balance_loss_coeff, router_z_loss_coeff
        self.aux_record: Optional[AuxRecord] = None  # set by a train-mode forward

    def forward(self, xs):
        xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
        base = xs[0] if self.base_proj is None else self.base_proj(xs[0])
        tokens = torch.stack([proj(x).float().mean((2, 3)) for x, proj in zip(xs, self.token_projs)], 1)
        logits, probs = self.router(tokens)  # [B, E]
        mixed = torch.zeros_like(base)
        for e, expert in enumerate(self.experts):
            mixed = mixed + expert(base) * probs[:, e].to(base.dtype)[:, None, None, None]
        if self.training:
            self.aux_record = AuxRecord(latent_aux(logits, probs, self.num_experts, self.balance_loss_coeff,
                                                   self.router_z_loss_coeff), "latent", None, None)
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
        self.balance_loss_coeff, self.router_z_loss_coeff = balance_loss_coeff, router_z_loss_coeff
        self.aux_record: Optional[AuxRecord] = None  # set by a train-mode forward

    def forward(self, xs):
        tokens = torch.stack([proj(x).float().mean((2, 3)) for x, proj in zip(xs, self.input_projs)], 1)
        logits, probs = self.router(tokens)  # [B, T, E]
        outs = []
        for s, x in enumerate(xs):
            mixed = torch.zeros_like(x)
            for e in range(self.num_experts):
                mixed = mixed + self.experts[s][e](x) * probs[:, s, e].to(x.dtype)[:, None, None, None]
            outs.append(x + self.residual_gain[s].to(x.dtype) * mixed)
        if self.training:
            self.aux_record = AuxRecord(latent_aux(logits, probs, self.num_experts, self.balance_loss_coeff,
                                                   self.router_z_loss_coeff), "latent", None, None)
        return outs
