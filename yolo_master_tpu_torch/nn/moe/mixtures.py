"""OptimizedMOEImproved (``ModularRouterExpertMoE``), the routed block of
yolo-master-v0_1 (counterpart of ``yolo_master_tpu/nn/moe/mixtures.py``).

    w      = top-k renormalised softmax of the router's spatial-mean logits
    out    = shared_expert(x) + sum over the top-k experts e of w[b,e] * expert_e(x)
    out   += x                      (add_residual, when C_in == C_out)

Sparse eval (the model's ``sparse_inference`` switch on, as by default, and
top_k below the expert count) runs only the selected experts
(``nn/moe/dispatch.py``); otherwise every expert runs, masked by w. Every
expert type (``simple``, ``ghost``, ``inverted``, ``spatial``) and router type
(``efficient``, ``local``, ``adaptive``) of the JAX block is here, in eval and
in training; none has a part of its own that differs in training (the experts'
GroupNorms and the routers' BatchNorms take their train mode from the model).

:class:`ABlockMoE` is an area-attention block whose MLP is this block (no
residual of its own), and :class:`A2C2fMoE` the A2C2f of such blocks: the
mixture of yolo26-master, whose blocks key their draws by JAX's path of that
nesting (``layers.4.m.0.1.mlp``: the A2C2f's ``m`` list, then the pair of
blocks).

Training follows the JAX block at the optimizer step ``step``
(``DetectionModel.forward_train`` sets it) and the block's JAX module path
``jax_path`` (``layers.5`` for the port's ``model.5``, set when the model is
built), which together key every draw, ``fold_in(PRNGKey(crc32(jax_path)),
step)``, as JAX's ``_path_key``:

  * router noise: ``normal(key, [B, E]) * noise_std`` on the fp32 logits;
  * progressive sparsity: k falls from E to top_k over ``warmup_steps``;
  * expert dropout: from ``warmup_steps`` on, every ``dropout_interval``
    steps, the experts ``permutation(fold_in(key, 1), E)[:n_drop]`` get no
    weight;
  * the aux loss (balance on the kept experts' counts, router z-loss),
    published as ``aux_record``.

The draws are made on the host (``utils/jax_random.py``, JAX's threefry bit
for bit) once per step and batch size, and reach the model's device in one
copy; every micro-batch of a step draws the same, as in JAX. Every expert
runs in training, masked by w, as JAX computes them.
"""

from __future__ import annotations

import math
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils import jax_random
from ..layers import A2C2f, AAttn, BN_EPS, BN_MOMENTUM, BatchNorm2d, GlobalAvgPool, GroupNorm, PlainConv, avg_pool
from ..mixture_loss import AuxRecord
from .dispatch import expert_bank, gather_dispatch, top_k_from_weights
from .losses import moe_aux_loss
from .routers import LOGIT_CLAMP


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


def _gathered_sequential(seq: nn.Sequential, sel: dict, prefix: str, y: torch.Tensor) -> torch.Tensor:
    """``seq`` (PlainConv, GroupNorm and SiLU layers) with the parameters of
    expert (b, k), for gathered banks ``sel`` [B, K, ...] named
    ``{prefix}.{index}.{weight, bias}``, on y [B*K, C, H, W] (x[b] repeated K
    times): each conv is one grouped conv over the B*K experts, each GroupNorm
    normalises each (b, k) map and applies its own affine, in the affine's
    dtype, as :class:`~..layers.GroupNorm`."""
    n = y.shape[0]
    for i, layer in enumerate(seq):
        if isinstance(layer, nn.Conv2d):
            w = sel[f"{prefix}.{i}.weight"].flatten(0, 2).to(y.dtype)  # [B*K*O, C/g, kh, kw]
            out = F.conv2d(y.reshape(1, -1, *y.shape[2:]), w, None, layer.stride, layer.padding, layer.dilation,
                           layer.groups * n)
            y = out.reshape(n, -1, *out.shape[2:])
            if layer.bias is not None:
                y = y + sel[f"{prefix}.{i}.bias"].flatten(0, 1).to(y.dtype)[..., None, None]
        elif isinstance(layer, nn.GroupNorm):
            weight, bias = (sel[f"{prefix}.{i}.{k}"].flatten(0, 1)[..., None, None] for k in ("weight", "bias"))
            y = (F.group_norm(y.to(weight.dtype), layer.num_groups, eps=layer.eps) * weight + bias).to(y.dtype)
        else:
            y = layer(y)
    return y


def _repeat_k(sel: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] -> [B*K, C, H, W], x[b] once for each of the K gathered experts."""
    kk = next(iter(sel.values())).shape[1]
    return x.unsqueeze(1).expand(x.shape[0], kk, *x.shape[1:]).flatten(0, 1)


class SpatialExpert(nn.Module):
    """1x1 expand -> GN -> SiLU -> 3x3 depthwise -> GN -> SiLU -> 1x1 project -> GN."""

    def __init__(self, c1, c2, expand_ratio=2.0, num_groups=8, kernel_size=3):
        super().__init__()
        hid = int(c1 * expand_ratio)
        self.conv = nn.Sequential(PlainConv(c1, hid, 1), GroupNorm(hid, num_groups), nn.SiLU(),
                                  PlainConv(hid, hid, kernel_size, g=hid), GroupNorm(hid, num_groups), nn.SiLU(),
                                  PlainConv(hid, c2, 1), GroupNorm(c2, num_groups))

    def forward(self, x):
        return self.conv(x)

    def forward_gathered(self, sel, x):
        """Expert (b, k) on sample b: x [B, C, H, W] -> [B, K, O, H, W]."""
        return _gathered_sequential(self.conv, sel, "conv", _repeat_k(sel, x)).unflatten(0, (x.shape[0], -1))


class InvertedResidualExpert(SpatialExpert):
    """:class:`SpatialExpert` with a ``kernel_size`` depthwise conv, plus x when C_in == C_out."""

    def __init__(self, c1, c2, expand_ratio=2.0, kernel_size=3, num_groups=8):
        super().__init__(c1, c2, expand_ratio, num_groups, kernel_size)
        self.add = c1 == c2

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.add else y

    def forward_gathered(self, sel, x):
        y = super().forward_gathered(sel, x)
        return x.unsqueeze(1) + y if self.add else y


class GhostExpert(nn.Module):
    """A primary conv (GN, SiLU) and a cheap 3x3 depthwise op on its output
    (GN, SiLU), concatenated and cut to ``c2`` channels."""

    def __init__(self, c1, c2, kernel_size=3, ratio=2, num_groups=8):
        super().__init__()
        self.c2 = c2
        init_c = math.ceil(c2 / ratio)
        new_c = init_c * (ratio - 1)
        self.primary_conv = nn.Sequential(PlainConv(c1, init_c, kernel_size), GroupNorm(init_c, num_groups), nn.SiLU())
        self.cheap_operation = nn.Sequential(PlainConv(init_c, new_c, 3, g=init_c), GroupNorm(new_c, num_groups),
                                             nn.SiLU())

    def forward(self, x):
        x1 = self.primary_conv(x)
        return torch.cat([x1, self.cheap_operation(x1)], 1)[:, :self.c2]

    def forward_gathered(self, sel, x):
        x1 = _gathered_sequential(self.primary_conv, sel, "primary_conv", _repeat_k(sel, x))
        y = torch.cat([x1, _gathered_sequential(self.cheap_operation, sel, "cheap_operation", x1)], 1)
        return y[:, :self.c2].unflatten(0, (x.shape[0], -1))


EXPERT_TYPES = {"simple": SimpleExpert, "ghost": GhostExpert, "inverted": InvertedResidualExpert,
                "spatial": SpatialExpert}


class _SpatialRouterNet(nn.Sequential):
    """conv k x k -> BN -> SiLU -> conv 1x1 -> BN (the torch Sequential's indices)."""

    def __init__(self, c1, reduced, num_experts, first_k=3):
        super().__init__(PlainConv(c1, reduced, first_k), BatchNorm2d(reduced, eps=BN_EPS, momentum=BN_MOMENTUM),
                         nn.SiLU(), PlainConv(reduced, num_experts, 1),
                         BatchNorm2d(num_experts, eps=BN_EPS, momentum=BN_MOMENTUM))


def process_logits(logits: torch.Tensor, top_k: int,
                   noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits [B, E] -> (top-k renormalised weights, probabilities, the
    logits the aux loss reads), all fp32 [B, E], as the JAX ``process_logits``.

    ``noise`` (training: the router noise, already scaled) is added to the fp32
    logits; the softmax reads them clamped to +-LOGIT_CLAMP, the aux loss
    unclamped. The experts are ranked by probability with a stable sort (ties
    to the lower index, as ``jnp.argsort``), and those of rank < top_k keep
    their mass.
    """
    logits = logits.float()
    if noise is not None:
        logits = logits + noise
    probs = torch.softmax(logits.clamp(-LOGIT_CLAMP, LOGIT_CLAMP), dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)
    w = probs * (ranks < top_k)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9), probs, logits


def path_key(jax_path: str, step: int) -> np.ndarray:
    """The block's key at ``step``: ``fold_in(PRNGKey(crc32(jax_path) & 0x7FFFFFFF),
    uint32(step))``, the JAX package's ``_path_key``."""
    return jax_random.fold_in(jax_random.PRNGKey(zlib.crc32(jax_path.encode()) & 0x7FFFFFFF), step)


def adaptive_top_k(step: int, num_experts: int, top_k: int, warmup_steps: int) -> int:
    """Progressive sparsity: ``max(top_k, floor(E - clip(step / warmup, 0, 1) * (E -
    top_k)))``, in float32 as JAX's compiled train step computes it: step times
    the float32 reciprocal of warmup, and the multiply-subtract fused (a float64
    quotient floors the other way at some steps, e.g. E=16, top_k=2, warmup 7,
    step 4: 8 against JAX's 7)."""
    f32 = np.float32
    progress = np.clip(f32(step) * (f32(1) / f32(warmup_steps)), f32(0), f32(1))
    k = jax_random.fma32(-progress, f32(num_experts - top_k), f32(num_experts))
    return max(top_k, int(np.floor(k)))


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


class LocalRoutingLayer(EfficientSpatialRouter):
    """Router over the input average-pooled 2x (when H exceeds 2), spatial-mean logits."""

    def __init__(self, c1, num_experts, reduction=8):
        super().__init__(c1, num_experts, reduction, pool_scale=2)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] > self.pool_scale:
            x = avg_pool(x, self.pool_scale)
        return self.router(x).float().mean((2, 3))


class AdaptiveRoutingLayer(nn.Module):
    """Router over the spatial mean of the input (in its dtype): 1x1 conv -> BN
    -> SiLU -> 1x1 conv -> BN, logits in fp32."""

    def __init__(self, c1, num_experts, reduction=8):
        super().__init__()
        self.pool = GlobalAvgPool()
        self.router = _SpatialRouterNet(c1, max(c1 // reduction, 8), num_experts, first_k=1)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.router(self.pool(x)).flatten(1).float()


ROUTER_TYPES = {"efficient": EfficientSpatialRouter, "local": LocalRoutingLayer, "adaptive": AdaptiveRoutingLayer}


class OptimizedMOEImproved(nn.Module):
    """Pluggable-router MoE with an always-on shared expert (also registered as
    ``ModularRouterExpertMoE``), with the JAX constructor's arguments and
    defaults; see the module docstring for the training form."""

    def __init__(self, in_channels: int, out_channels: int, num_experts: int = 4, top_k: int = 2,
                 expert_type: str = "simple", router_type: str = "efficient", noise_std: float = 1.0,
                 balance_loss_coeff: float = 1.0, router_z_loss_coeff: float = 1.0,
                 expert_expand_ratio: float = 2.0, progressive_sparsity: bool = True, detach_routing: bool = False,
                 add_residual: bool = True, warmup_steps: int = 5000, expert_dropout_rate: float = 0.15,
                 dropout_interval: int = 100):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k must be in [1, {num_experts}], got {top_k}")
        if expert_type not in EXPERT_TYPES:
            raise ValueError(f"unknown expert_type '{expert_type}'")
        if router_type not in ROUTER_TYPES:
            raise ValueError(f"unknown router_type '{router_type}'")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_experts, self.top_k = num_experts, top_k
        self.expert_type, self.router_type = expert_type, router_type
        self.noise_std = noise_std
        self.balance_loss_coeff = balance_loss_coeff
        self.router_z_loss_coeff = router_z_loss_coeff
        self.progressive_sparsity = progressive_sparsity
        self.detach_routing = detach_routing
        self.add_residual = add_residual
        self.warmup_steps = warmup_steps
        self.expert_dropout_rate = expert_dropout_rate
        self.dropout_interval = dropout_interval
        self.sparse_inference = True  # the model-level switch (DetectionModel.sparse_inference)
        self.jax_path = ""  # the JAX module path keying the draws (DetectionModel sets it)
        self.step = 0  # the optimizer step of a train-mode forward (DetectionModel.forward_train sets it)
        self.aux_record: Optional[AuxRecord] = None  # set by a train-mode forward
        self._draws: Optional[tuple] = None  # (key, [B + 1, E] noise and keep mask, any drop): draws()
        self.routing = ROUTER_TYPES[router_type](in_channels, num_experts)
        kwargs = {"ratio": int(expert_expand_ratio)} if expert_type == "ghost" else {"expand_ratio": expert_expand_ratio}
        self.experts = nn.ModuleList(EXPERT_TYPES[expert_type](in_channels, out_channels, **kwargs)
                                     for _ in range(num_experts))
        self.shared_expert = nn.Sequential(PlainConv(in_channels, out_channels, 1),
                                           BatchNorm2d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM), nn.SiLU())

    def adaptive_top_k(self) -> int:
        """The training k at ``self.step`` (top_k without progressive sparsity)."""
        if not self.progressive_sparsity:
            return self.top_k
        return adaptive_top_k(self.step, self.num_experts, self.top_k, self.warmup_steps)

    def dropped_experts(self) -> np.ndarray:
        """The experts expert dropout silences at ``self.step`` (none off its steps)."""
        step, e = self.step, self.num_experts
        if not (self.expert_dropout_rate > 0 and step >= self.warmup_steps and step % self.dropout_interval == 0):
            return np.zeros(0, np.int32)
        n_drop = max(1, int(e * self.expert_dropout_rate))
        return jax_random.permutation(jax_random.fold_in(path_key(self.jax_path, step), 1), e)[:n_drop]

    def draws(self, batch: int, device) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(router noise [B, E] or None, keep mask [E] or None) of this step, made
        on the host and copied to ``device`` once per step and batch size (and
        anew after a change to the settings they depend on)."""
        key = (self.step, batch, str(device), self.jax_path, self.noise_std, self.expert_dropout_rate,
               self.warmup_steps, self.dropout_interval)
        if self._draws is None or self._draws[0] != key:
            host = np.ones((batch + 1, self.num_experts), np.float32)
            if self.noise_std > 0:
                noise = jax_random.normal(path_key(self.jax_path, self.step), (batch, self.num_experts))
                host[:batch] = noise * np.float32(self.noise_std)
            dropped = self.dropped_experts()
            host[batch, dropped] = 0.0
            self._draws = (key, torch.from_numpy(host).to(device), dropped.size > 0)
        _, t, drop = self._draws
        return (t[:batch] if self.noise_std > 0 else None), (t[batch] if drop else None)

    def forward(self, x):
        logits = self.routing.logits(x)
        if self.training:
            noise, keep = self.draws(x.shape[0], x.device)
            w, probs, logits = process_logits(logits, self.adaptive_top_k(), noise)
            if keep is not None:
                w = w * keep
            if self.detach_routing:
                w = w.detach()
        else:
            w = process_logits(logits, self.top_k)[0]
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
        if self.training:
            aux = moe_aux_loss(probs, logits, w > 0, self.num_experts, balance_coeff=self.balance_loss_coeff,
                               z_coeff=self.router_z_loss_coeff)
            self.aux_record = AuxRecord(aux, "moe", probs.mean(0).detach(), "aux_loss")
        return out


ModularRouterExpertMoE = OptimizedMOEImproved


class ABlockMoE(nn.Module):
    """x + attn(x), then x + moe(x): an area-attention block whose MLP is an
    :class:`OptimizedMOEImproved` with ``mlp_ratio`` as its experts' expansion,
    progressive sparsity and no residual of its own."""

    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1, num_experts=4, top_k=2, expert_type="simple"):
        super().__init__()
        self.attn = AAttn(dim, num_heads=num_heads, area=area)
        self.mlp = OptimizedMOEImproved(dim, dim, num_experts=num_experts, top_k=top_k, expert_type=expert_type,
                                        expert_expand_ratio=mlp_ratio, progressive_sparsity=True, add_residual=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2fMoE(A2C2f):
    """:class:`~..layers.A2C2f` whose attention blocks are :class:`ABlockMoE` (the C3k form without ``a2``)."""

    def __init__(self, c1, c2, n=1, a2=True, area=1, residual=False, mlp_ratio=2.0, e=0.5, g=1, shortcut=True,
                 num_experts=4, top_k=2, expert_type="simple"):
        super().__init__(c1, c2, n, a2, area, residual, mlp_ratio, e, g, shortcut,
                         block=lambda c: ABlockMoE(c, c // 32, mlp_ratio, area, num_experts, top_k, expert_type))
