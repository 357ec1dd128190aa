"""Routers for ES-MoE blocks (counterpart of ``yolo_master_tpu/nn/moe/routers.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

LOGIT_CLAMP = 30.0


def _topk_mask(weights: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of the entries >= the k-th largest along the last axis.

    As in the JAX package, ties at the k-th value select every tied entry, so
    more than k may be kept; :func:`~.dispatch.top_k_from_weights` then takes
    exactly k.
    """
    if k >= weights.shape[-1]:
        return torch.ones_like(weights, dtype=torch.bool)
    threshold = torch.topk(weights, k, dim=-1).values[..., -1:]
    return weights >= threshold


def soft_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Softmax over the experts (logits clamped to +-30, fp32), keep the top-k
    mass, renormalise."""
    w = torch.softmax(logits.float().clamp(-LOGIT_CLAMP, LOGIT_CLAMP), dim=-1)
    w = w * _topk_mask(w, k)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9)


def hard_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The same numbers as :func:`soft_top_k`; kept for parity with the JAX
    package's API (nothing in the port calls it)."""
    return soft_top_k(logits, k)


class DynamicRoutingLayer(nn.Module):
    """Per-sample expert weights: GAP -> 1x1 conv -> SiLU -> 1x1 conv -> clamp(+-30)
    -> softmax, or :func:`soft_top_k` when ``top_k`` is set.

    The two 1x1 convs sit at ``routing_network.0`` and ``routing_network.2``,
    as in the ultralytics state_dict.
    """

    def __init__(self, in_channels: int, num_experts: int = 3, reduction: int = 8, top_k: Optional[int] = None):
        super().__init__()
        if num_experts < 1:
            raise ValueError(f"num_experts must be positive, got {num_experts}")
        if reduction < 1:
            raise ValueError(f"reduction must be positive, got {reduction}")
        if top_k is not None and not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k must be in [1, {num_experts}], got {top_k}")
        self.top_k = top_k
        reduced = max(in_channels // reduction, 8)
        self.routing_network = nn.Sequential(
            nn.Conv2d(in_channels, reduced, 1), nn.SiLU(), nn.Conv2d(reduced, num_experts, 1))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W] -> routing logits [B, E], in the router weights' dtype (fp32)."""
        pooled = x.to(self.routing_network[0].weight.dtype).mean((2, 3), keepdim=True)
        return self.routing_network(pooled).flatten(1)

    def forward(self, x: torch.Tensor):
        logits = self.logits(x)
        if self.top_k is not None:
            w = soft_top_k(logits, self.top_k)
        else:
            w = torch.softmax(logits.clamp(-LOGIT_CLAMP, LOGIT_CLAMP), dim=-1)
        return w.to(x.dtype), logits
