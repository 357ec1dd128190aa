"""OptimizedMOEImproved (``ModularRouterExpertMoE``), the routed block of
yolo-master-v0_1, in eval (counterpart of ``yolo_master_tpu/nn/moe/mixtures.py``).

    w      = top-k renormalised softmax of the router's spatial-mean logits
    out    = shared_expert(x) + sum over the top-k experts e of w[b,e] * expert_e(x)
    out   += x                      (add_residual, when C_in == C_out)

Sparse eval (the model's ``sparse_inference`` switch on, as by default, and
top_k below the expert count) runs only the selected experts
(``nn/moe/dispatch.py``); otherwise every expert runs, masked by w. Only the
``simple`` expert and the ``efficient`` router of v0_1 are ported; the
training-only parts (router noise, expert dropout, progressive sparsity, the
aux loss) wait for the training slice (ROADMAP.md §1.C item 7): a train-mode
forward here routes as in eval, densely, and serves BatchNorm calibration.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BN_EPS, BN_MOMENTUM, BatchNorm2d, GroupNorm, PlainConv, avg_pool
from .dispatch import expert_bank, gather_dispatch, top_k_from_weights
from .routers import LOGIT_CLAMP

_UNPORTED = "ROADMAP.md §1.F item 14 (mixture modules)"


class SimpleExpert(nn.Module):
    """1x1 expand -> GroupNorm -> SiLU -> 1x1 project -> GroupNorm, at ``conv.0`` .. ``conv.4``."""

    def __init__(self, c1, c2, expand_ratio=2.0, num_groups=8):
        super().__init__()
        hid = int(c1 * expand_ratio)
        self.conv = nn.Sequential(PlainConv(c1, hid, 1), GroupNorm(hid, num_groups), nn.SiLU(),
                                  PlainConv(hid, c2, 1), GroupNorm(c2, num_groups))

    def forward(self, x):
        return self.conv(x)

    def forward_gathered(self, sel, x):
        """Expert (b, k) on sample b, for gathered banks ``sel`` [B, K, ...]
        (``nn/moe/dispatch.py``): x [B, C, H, W] -> [B, K, O, H, W]; each 1x1
        is a batched matmul over the per-(b, k) weights."""
        b, _, h, w = x.shape
        kk = sel["conv.0.weight"].shape[1]

        def norm(y, gn, weight, bias):  # GroupNorm of each (b, k) map, then its own affine, in the affine's dtype
            ch = y.shape[2]
            y = F.group_norm(y.to(weight.dtype).reshape(b * kk, ch, h * w), gn.num_groups, eps=gn.eps)
            return (y.reshape(b, kk, ch, h * w) * weight[..., None] + bias[..., None]).to(x.dtype)

        w0 = sel["conv.0.weight"].flatten(3).to(x.dtype)
        y = torch.matmul(w0, x.reshape(b, 1, x.shape[1], h * w))  # [B, K, hid, HW]
        y = F.silu(norm(y, self.conv[1], sel["conv.1.weight"], sel["conv.1.bias"]))
        y = torch.matmul(sel["conv.3.weight"].flatten(3).to(x.dtype), y)  # [B, K, O, HW]
        y = norm(y, self.conv[4], sel["conv.4.weight"], sel["conv.4.bias"])
        return y.reshape(b, kk, -1, h, w)


class _SpatialRouterNet(nn.Sequential):
    """conv k x k -> BN -> SiLU -> conv 1x1 -> BN (the torch Sequential's indices)."""

    def __init__(self, c1, reduced, num_experts, first_k=3):
        super().__init__(PlainConv(c1, reduced, first_k), BatchNorm2d(reduced, eps=BN_EPS, momentum=BN_MOMENTUM),
                         nn.SiLU(), PlainConv(reduced, num_experts, 1),
                         BatchNorm2d(num_experts, eps=BN_EPS, momentum=BN_MOMENTUM))


def process_logits(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Router logits [B, E] -> top-k renormalised weights [B, E], in fp32 (the
    eval part of the JAX ``process_logits``).

    The experts are ranked by probability with a stable sort (ties to the
    lower index, as ``jnp.argsort``), and those of rank < top_k keep their mass.
    """
    probs = torch.softmax(logits.float().clamp(-LOGIT_CLAMP, LOGIT_CLAMP), dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)
    w = probs * (ranks < top_k)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9)


class EfficientSpatialRouter(nn.Module):
    """Router over the input average-pooled 4x (when both H and W exceed 4):
    logits are the spatial mean of ``router``'s [B, E, h, w] output, in fp32."""

    def __init__(self, c1, num_experts, reduction=8, pool_scale=4):
        super().__init__()
        self.pool_scale = pool_scale
        self.router = _SpatialRouterNet(c1, max(c1 // reduction, 8), num_experts, first_k=3)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] > self.pool_scale and x.shape[3] > self.pool_scale:
            x = avg_pool(x, self.pool_scale)
        return self.router(x).float().mean((2, 3))


class OptimizedMOEImproved(nn.Module):
    """Pluggable-router MoE with an always-on shared expert (also registered as
    ``ModularRouterExpertMoE``). Eval only, so the JAX constructor's
    training-only arguments (noise, loss coefficients, progressive sparsity,
    expert dropout, detach_routing) are not taken; see the module docstring."""

    def __init__(self, in_channels: int, out_channels: int, num_experts: int = 4, top_k: int = 2,
                 expert_type: str = "simple", router_type: str = "efficient", expert_expand_ratio: float = 2.0,
                 add_residual: bool = True):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k must be in [1, {num_experts}], got {top_k}")
        if expert_type not in ("simple", "ghost", "inverted", "spatial"):
            raise ValueError(f"unknown expert_type '{expert_type}'")
        if router_type not in ("efficient", "local", "adaptive"):
            raise ValueError(f"unknown router_type '{router_type}'")
        if expert_type != "simple":
            raise NotImplementedError(f"expert_type '{expert_type}' is not ported yet: {_UNPORTED}")
        if router_type != "efficient":
            raise NotImplementedError(f"router_type '{router_type}' is not ported yet: {_UNPORTED}")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_experts, self.top_k = num_experts, top_k
        self.add_residual = add_residual
        self.sparse_inference = True  # the model-level switch (DetectionModel.sparse_inference)
        self.routing = EfficientSpatialRouter(in_channels, num_experts)
        self.experts = nn.ModuleList(SimpleExpert(in_channels, out_channels, expand_ratio=expert_expand_ratio)
                                     for _ in range(num_experts))
        self.shared_expert = nn.Sequential(PlainConv(in_channels, out_channels, 1),
                                           BatchNorm2d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM), nn.SiLU())

    def forward(self, x):
        w = process_logits(self.routing.logits(x), self.top_k)
        out = self.shared_expert(x).float()
        if not self.training and self.sparse_inference and self.top_k < self.num_experts:
            wts, idx = top_k_from_weights(w, self.top_k)
            out = out + gather_dispatch(self.experts[0], expert_bank(self.experts), x, idx, wts).float()
        else:
            for i, expert in enumerate(self.experts):
                out = out + expert(x).float() * w[:, i, None, None, None]
        out = out.to(x.dtype)
        if self.add_residual and self.in_channels == self.out_channels:
            out = out + x
        return out


ModularRouterExpertMoE = OptimizedMOEImproved
