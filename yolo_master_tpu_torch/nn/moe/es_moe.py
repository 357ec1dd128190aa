"""ES_MOE, the YOLO-Master routed block (counterpart of ``yolo_master_tpu/nn/moe/es_moe.py``).

Eval on the masked-dense path: every expert runs, and the output is the
routing-weighted sum, then BatchNorm + SiLU (``norm.0`` in the state_dict;
left unfolded by deploy fusion, as in the JAX package). :class:`FusedESMOE`
is the deploy form that runs the whole block as one CUDA kernel
(``utils/fuse.py:fused_esmoe_fuse``). The sparse top-k and expert-parallel
paths are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from ...ops.esmoe import fused_esmoe, pack_esmoe_params
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

    def fusable(self) -> bool:
        """Whether ``fused_esmoe_fuse`` can swap this block for :class:`FusedESMOE`:
        dense eval (always, in the port) and stride-1 experts."""
        return all(e.conv.depthwise.stride == (1, 1) for e in self.experts)


class FusedESMOE(nn.Module):
    """Deploy form of a dense ES_MOE block (counterpart of ``PallasESMOE``): the
    routing MLP stays in PyTorch, and the experts, their mix and the output
    norm run as one kernel (``ops/esmoe.py:fused_esmoe``).

    State: ``routing.*`` as in :class:`ES_MOE`, and ``banks.{dw,pw,pb,gamma,beta}``
    as in the JAX package's fused tree, except that ``dw`` [E, kmax, kmax, C]
    is kept as [E, kmax*kmax, C]: a 4-D parameter would be reordered by the
    facade's channels_last ``.to()``. Eval only.
    """

    def __init__(self, block: ES_MOE):
        super().__init__()
        self.routing = block.routing
        dw, pw, pb, gamma, beta, ks = pack_esmoe_params(block)
        self.ks = ks
        e, kmax, _, c = dw.shape
        self.banks = nn.ParameterDict({
            name: nn.Parameter(t.contiguous(), requires_grad=False)
            for name, t in (("dw", dw.reshape(e, kmax * kmax, c)), ("pw", pw), ("pb", pb), ("gamma", gamma),
                            ("beta", beta))})

    def forward(self, x):
        w, _ = self.routing(x)  # [B, E]
        dw = self.banks["dw"]
        kmax = max(self.ks)
        out = fused_esmoe(x.permute(0, 2, 3, 1).contiguous(), w,
                          dw.view(dw.shape[0], kmax, kmax, dw.shape[2]), self.banks["pw"], self.banks["pb"],
                          self.banks["gamma"], self.banks["beta"], self.ks)
        return out.permute(0, 3, 1, 2)
