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


def moe_aux_loss(probs: torch.Tensor, logits: torch.Tensor, keep_mask: torch.Tensor, num_experts: int,
                 balance_coeff: float = 1.0, z_coeff: float = 1.0, entropy_coeff: float = 0.0) -> torch.Tensor:
    """OptimizedMOEImproved's aux loss (the JAX ``moe_aux_loss``):
    ``balance_coeff * E * sum(mean(probs) * usage) + z_coeff * mean(logsumexp(logits)^2)``
    (+ ``entropy_coeff`` times the mean routing entropy), where usage is the
    share of the kept (b, e) pairs of ``keep_mask`` [B, E] each expert holds,
    with no gradient."""
    importance = probs.mean(0)
    counts = keep_mask.float().sum(0)
    usage = (counts / counts.sum().clamp_min(1.0)).detach()
    total = balance_coeff * (num_experts * (importance * usage).sum())
    total = total + z_coeff * (torch.logsumexp(logits, -1) ** 2).mean()
    if entropy_coeff > 0:
        total = total + entropy_coeff * -(probs * torch.log(probs + 1e-8)).sum(-1).mean()
    return total
