"""MoE aux losses (counterpart of ``yolo_master_tpu/nn/moe/losses.py``)."""

from __future__ import annotations

import torch


def gshard_balance_loss(expert_usage: torch.Tensor, num_experts: int) -> torch.Tensor:
    """GShard balance loss, ``E * sum(p_e^2)`` over the usage normalised to sum 1:
    1.0 at uniform usage, E when one expert takes everything."""
    usage = expert_usage.reshape(-1).float()
    usage = usage / usage.sum().clamp_min(1e-9)
    return num_experts * (usage * usage).sum()


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    """z-loss: the mean over tokens of logsumexp(logits)^2, which keeps router logits small."""
    lse = torch.log(torch.exp(logits.float()).sum(-1))
    return (lse ** 2).mean()
