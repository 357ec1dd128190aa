"""ES_MOE, the YOLO-Master routed block (counterpart of ``yolo_master_tpu/nn/moe/es_moe.py``).

Eval on the masked-dense path only: every expert runs, and the output is the
routing-weighted sum, then BatchNorm + SiLU (``norm.0`` in the state_dict;
left unfolded by deploy fusion, as in the JAX package). The sparse top-k,
expert-parallel and fused-kernel paths are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from ..layers import BN_EPS, BN_MOMENTUM
from .experts import EfficientExpertGroup
from .routers import DynamicRoutingLayer


def expert_kernel_sizes(num_experts: int, max_kernel_size: int) -> list[int]:
    """Growing odd kernels 3/5/7/... capped at ``max_kernel_size``."""
    default = [3, 5, 7]
    if num_experts <= len(default):
        return [min(k, max_kernel_size) for k in default[:num_experts]]
    return [min(3 + 2 * i, max_kernel_size) for i in range(num_experts)]


class ES_MOE(nn.Module):  # noqa: N801 - the graph YAMLs' module name
    def __init__(self, in_channels: int, out_channels: Optional[int] = None, num_experts: int = 3,
                 reduction: int = 8, top_k: Optional[int] = None, use_sparse_inference: bool = True,
                 dynamic_threshold: float = 0.4, max_kernel_size: int = 15):
        super().__init__()
        if in_channels < 1 or (out_channels is not None and out_channels < 1):
            raise ValueError("in_channels and out_channels must be positive")
        if top_k is not None:
            raise NotImplementedError(
                "ES_MOE with top_k (soft top-k routing and sparse gathered dispatch) is not ported yet: "
                "ROADMAP.md §1.D item 10 (sparse ES_MOE eval)")
        if max_kernel_size < 3:
            raise ValueError(f"max_kernel_size must be at least 3, got {max_kernel_size}")
        max_kernel_size = int(max_kernel_size)
        if max_kernel_size % 2 == 0:
            max_kernel_size -= 1
        out_channels = out_channels or in_channels
        self.num_experts = num_experts
        self.routing = DynamicRoutingLayer(in_channels, num_experts, reduction)
        self.experts = nn.ModuleList(
            EfficientExpertGroup(in_channels, out_channels, k)
            for k in expert_kernel_sizes(num_experts, max_kernel_size))
        self.norm = nn.Sequential(nn.BatchNorm2d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM), nn.SiLU())

    def forward(self, x):
        w, _ = self.routing(x)  # [B, E]
        out = None
        for i, expert in enumerate(self.experts):
            y = expert(x) * w[:, i, None, None, None].to(x.dtype)
            out = y if out is None else out + y
        return self.norm(out)
