"""Routers for ES-MoE blocks (counterpart of ``yolo_master_tpu/nn/moe/routers.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn

LOGIT_CLAMP = 30.0


class DynamicRoutingLayer(nn.Module):
    """Per-sample expert weights: GAP -> 1x1 conv -> SiLU -> 1x1 conv -> clamp(+-30) -> softmax.

    The two 1x1 convs sit at ``routing_network.0`` and ``routing_network.2``,
    as in the ultralytics state_dict. Dense routing only (``top_k=None``).
    """

    def __init__(self, in_channels: int, num_experts: int = 3, reduction: int = 8):
        super().__init__()
        if num_experts < 1:
            raise ValueError(f"num_experts must be positive, got {num_experts}")
        if reduction < 1:
            raise ValueError(f"reduction must be positive, got {reduction}")
        reduced = max(in_channels // reduction, 8)
        self.routing_network = nn.Sequential(
            nn.Conv2d(in_channels, reduced, 1), nn.SiLU(), nn.Conv2d(reduced, num_experts, 1))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W] -> routing logits [B, E], in the router weights' dtype (fp32)."""
        pooled = x.to(self.routing_network[0].weight.dtype).mean((2, 3), keepdim=True)
        return self.routing_network(pooled).flatten(1)

    def forward(self, x: torch.Tensor):
        logits = self.logits(x)
        w = torch.softmax(logits.clamp(-LOGIT_CLAMP, LOGIT_CLAMP), dim=-1)
        return w.to(x.dtype), logits
