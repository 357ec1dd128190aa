"""The AdaptiveGate MoE family, v0_4 to v0_15, in eval and in training
(counterpart of ``yolo_master_tpu/nn/moe/gated.py``). VisualEnhancedAdaptiveGateMoE is the
block of the released EsMoE checkpoints (yolo-master-v0_10).

One block, :class:`AdaptiveGateMoE`, and its hooks carry the family:

    gate        = sigmoid(se_gate(mean(x)))             SE gate, fp32
    xs, xd      = x[:, :static] * gate, x[:, static:] * gate
    xd          = detail_gate(xd)                        (v0_9, v0_10)
    out_static  = static_net(xs)                         dw 3x3, BN, SiLU, 1x1, BN, SiLU
    w, idx      = router(xd) at the final temperature    top-k, ties to the lower index
    w           = w with the ranks past round(c * k) zeroed, renormalised,
                  c = clip(mean over the batch of sigmoid(complexity_estimator(mean(xd))), 0.3, 1.5)
    out_dynamic = experts(xd, w, idx)                    one of the backends below
    out         = shuffle(fuse_paths(out_static, out_dynamic))
    out         = x + pre_residual(bn(proj(post_mix(out))))

``c`` is a mean over the whole batch, so each image's kept expert count
depends on the other images of its batch, as in the JAX block.

Expert backends: :class:`SharedInvertedExpertGroup` (a shared expand + dw
trunk, one 1x1 + GroupNorm per expert, masked-dense), :class:`FusedExpertGroup`
(every expert in one grouped 3x3 conv, the top-k gathered, a GroupNorm per
(sample, expert) with the expert's own affine; :class:`LowRankFusedExpertGroup`
puts a shared 1x1 bottleneck before it) and :class:`DiversifiedExpertGroup`
(v0_14: per-expert dilated dw convs). None reaches a kernel of the JAX package:
the port's are plain PyTorch. The per-op casts are the JAX blocks': the pooled
statistics, the routers, the GroupNorms and the fused experts' normalisation
are fp32, the gates' sigmoids are fp32 cast to the activation's dtype, and the
parameters the family's modules hold themselves (the scalars ``alpha``,
``*_scale``, ``head_alpha``, ``global_weight``, the ``expert_prior`` and the
fused experts' affines) stay fp32 in a bf16 copy, with the Linears and
LayerNorms (``utils/fuse.py:KEEP_FP32``, ``KEEP_FP32_OWN``).

State_dict names are the reference's (``yolo_master_tpu/utils/torch_import.py``):
parameter-free modules hold the reference's ``nn.Sequential`` slots
(``se_gate.2``, ``feature_gate.1``, ``complexity_estimator.1``,
``context_gate.0``, ``cross_gate.gate_net.4``). DiversifiedExpertGroup's
``dw_dilations``, a record of each expert's dilation that the reference keeps
as a parameter and no forward reads, is left out, as the JAX importer leaves
it over.

Training follows the JAX blocks at the optimizer step ``step``
(``DetectionModel.forward_train`` sets it on every block and router) and the
JAX module paths ``jax_path`` (``layers.5`` for the block at ``model.5``,
``layers.5.routing`` for its router), which key the draws as JAX's
``_path_key`` does (``nn/moe/mixtures.py:path_key``):

  * the router's temperature cosine-anneals from ``initial_temperature`` to
    ``final_temperature`` over ``anneal_steps`` (2000), floored at 0.1 (eval:
    ``final_temperature``);
  * V2 and V3 routers add ``normal(path_key(router, step), [B, E]) * noise_std
    * clip(1 - step / 1000, 0, 1)`` to their logits after the prior, before
    the +-30 clip;
  * V3's soft expert dropout: ``k1, k2 = split(path_key(router, step + 1))``;
    where ``uniform(k1, [B, 1]) < expert_dropout``, the top-k slot
    ``randint(k2, [B, 1], 0, top_k)`` keeps half its weight, before the
    weights are renormalised;
  * v0_15's drop-path: where ``uniform(path_key(block, step + 2), [B, 1, 1, 1])
    < drop_prob`` the projection branch is 0, elsewhere scaled by 1 / (1 -
    drop_prob), after ``bn`` and before the residual add;
  * the aux loss (``moe_aux_loss`` on the router's probabilities and logits,
    the top-k picks counted before the complexity gate zeroes any, with the
    entropy term), published as ``aux_record`` with the usage mean(probs).

The draws are made on the host (``utils/jax_random.py``, JAX's threefry bit
for bit) once per step and batch size, and reach the block's device in one
copy; every micro-batch of a step draws the same, as in JAX.
``calibrate_bn`` runs the eval forward with its BatchNorms on batch
statistics (``calibrating``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils import jax_random
from ..layers import (BN_EPS, BN_MOMENTUM, BatchNorm2d, GlobalAvgPool, GroupNorm, LayerNorm, Linear, PlainConv,
                      avg_pool, get_safe_groups, upsample_nearest)
from ..mixture_loss import AuxRecord
from .losses import moe_aux_loss
from .mixtures import path_key

LOGIT_CLAMP = 30.0
NOISE_DECAY_STEPS = 1000  # the V2/V3 router noise decays linearly to 0 over these steps


def topk_renorm(probs: torch.Tensor, k: int):
    """(the k largest of probs [B, E] renormalised by their sum + 1e-6, their
    indices [B, k]), largest first and ties to the lower index, as
    ``lax.top_k``."""
    idx = torch.argsort(-probs, dim=-1, stable=True)[:, :k]
    vals = probs.gather(1, idx)
    return vals / (vals.sum(-1, keepdim=True) + 1e-6), idx


def keep_count(complexity: torch.Tensor, k: int) -> torch.Tensor:
    """How many of the top-k slots the complexity gate keeps: clip(round(c * k), 1, k)."""
    return torch.clamp(torch.round(complexity * k), 1, k)


def _channel_stats(x: torch.Tensor) -> torch.Tensor:
    """[spatial mean, population std] of each channel, fp32 [B, 2C]."""
    xf = x.float()
    return torch.cat([xf.mean((2, 3)), xf.std((2, 3), correction=0)], -1)


def _scalar(value: float) -> nn.Parameter:
    return nn.Parameter(torch.tensor(float(value)))


def noise_decay(step: int) -> np.float32:
    """clip(1 - step / 1000, 0, 1) in float32, as JAX's compiled step computes it:
    step times the float32 reciprocal of 1000, the multiply-subtract fused."""
    f32 = np.float32
    d = jax_random.fma32(-f32(step), f32(1) / f32(NOISE_DECAY_STEPS), f32(1))
    return f32(np.clip(d, f32(0), f32(1)))


def anneal_temperature(step: int, initial: float, final: float, anneal_steps: int) -> float:
    """The cosine anneal ``max(final + (initial - final) * (1 + cos(pi * clip(step /
    anneal_steps, 0, 1))) / 2, 0.1)`` in float32 (XLA's cos may differ from this
    one by an ulp; the picks do not depend on the temperature)."""
    f32 = np.float32
    progress = np.clip(f32(step) * (f32(1) / f32(anneal_steps)), f32(0), f32(1))
    cos_val = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * progress))
    return float(np.maximum(f32(final) + (f32(initial) - f32(final)) * cos_val, f32(0.1)))


# ---------------------------------------------------------------------------
# Routers
# ---------------------------------------------------------------------------

class ZeroCostRouter(nn.Module):
    """Channel statistics [mean, std] -> Linear -> softmax, then divided by the
    temperature, clamped and softmaxed again: the reference softmaxes twice,
    and so does the port, so that its checkpoints route the same."""

    def __init__(self, in_channels, num_experts, top_k, temperature=1.0):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.temperature = max(temperature, 1e-3)
        self.router = nn.Sequential(Linear(2 * in_channels, num_experts, bias=False))

    def seeded_init(self, generator):
        self.router[0].weight.normal_(0.0, 0.05, generator=generator)

    def logits(self, x):
        return torch.softmax(self.router(_channel_stats(x)).float(), -1)

    def forward(self, x, temperature=None, draws=None):
        """Eval: (w, idx). With ``draws`` (training; this router draws nothing)
        also the probabilities and the logits the aux loss reads."""
        logits = (self.logits(x) / (temperature or self.temperature)).clamp(-LOGIT_CLAMP, LOGIT_CLAMP)
        probs = torch.softmax(logits, -1)
        w, idx = topk_renorm(probs, self.top_k)
        return (w, idx) if draws is None else (w, idx, probs, logits)


class UltraLightRouter(ZeroCostRouter):
    """The reference's alias of ZeroCostRouter."""


class DualStreamGateRouter(nn.Module):
    """A global stream (channel statistics -> Linear) and a local one (the map,
    average-pooled by ``pool_scale`` when both sides exceed it, through dw 3x3
    -> GroupNorm -> SiLU -> 1x1 -> GroupNorm -> SiLU -> 1x1, spatially
    averaged), mixed by sigmoid(alpha) and clamped to +-30."""

    def __init__(self, in_channels, num_experts, top_k, temperature=1.0, local_reduction=16, pool_scale=4):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.temperature = max(temperature, 1e-3)
        self.pool_scale = pool_scale
        self.global_fc = Linear(2 * in_channels, num_experts, bias=False)
        reduced = max(in_channels // local_reduction, 4)
        self.local_conv = nn.Sequential(
            PlainConv(in_channels, in_channels, 3, g=in_channels), GroupNorm(in_channels, 8), nn.SiLU(),
            PlainConv(in_channels, reduced, 1), GroupNorm(reduced, 4), nn.SiLU(),
            PlainConv(reduced, num_experts, 1, bias=True))
        self.alpha = _scalar(0.5)
        self.step = 0  # the optimizer step of a train-mode forward (DetectionModel.forward_train sets it)
        self.jax_path = ""  # the JAX module path keying the draws (DetectionModel sets it)

    def seeded_init(self, generator):
        self.global_fc.weight.normal_(0.0, 0.05, generator=generator)

    def host_draws(self, batch: int) -> np.ndarray:
        """This step's draws of the router, [batch, columns] float32 on the host (none here);
        the block copies them to its device and passes them as ``draws``."""
        return np.zeros((batch, 0), np.float32)

    def _local_logits(self, x):
        if x.shape[2] > self.pool_scale and x.shape[3] > self.pool_scale:
            x = avg_pool(x, self.pool_scale)
        return self.local_conv(x).float().mean((2, 3))

    def fused_logits(self, x, draws=None):
        alpha = torch.sigmoid(self.alpha)
        g = self.global_fc(_channel_stats(x))
        return (alpha * g + (1 - alpha) * self._local_logits(x)).clamp(-LOGIT_CLAMP, LOGIT_CLAMP)

    def _train_topk(self, probs, draws):
        return topk_renorm(probs, self.top_k)

    def forward(self, x, temperature=None, draws=None):
        """Eval: (w, idx). With ``draws`` (training: the columns of :meth:`host_draws`
        on x's device) the logits take the router's noise and the weights its
        dropout, and (w, idx, probs, logits) are returned, the logits those the
        aux loss reads (before the temperature)."""
        t = temperature if temperature is not None else self.temperature
        if draws is None:
            return topk_renorm(torch.softmax(self.fused_logits(x) / t, -1), self.top_k)
        logits = self.fused_logits(x, draws)
        probs = torch.softmax(logits / t, -1)
        w, idx = self._train_topk(probs, draws)
        return w, idx, probs, logits


class DualStreamGateRouterV2(DualStreamGateRouter):
    """v0_11's router: LayerNorm on the statistics and a learned per-expert
    prior; in training, the decaying noise (module docstring)."""

    def __init__(self, in_channels, num_experts, top_k, temperature=1.0, local_reduction=16, pool_scale=4,
                 noise_std=0.1):
        super().__init__(in_channels, num_experts, top_k, temperature, local_reduction, pool_scale)
        self.stat_norm = LayerNorm(2 * in_channels)
        self.noise_std_init = noise_std
        self.expert_prior = nn.Parameter(torch.zeros(num_experts))

    def host_draws(self, batch: int) -> np.ndarray:
        """The noise [batch, E], already scaled: normal(path_key(jax_path, step)) * noise_std * decay."""
        if self.noise_std_init <= 0:
            return np.zeros((batch, 0), np.float32)
        return jax_random.normal_scaled(path_key(self.jax_path, self.step), (batch, self.num_experts),
                                        self.noise_std_init, noise_decay(self.step))

    def _noisy(self, logits, draws):
        if draws is not None and self.noise_std_init > 0:
            logits = logits + draws[:, :self.num_experts]
        return logits.clamp(-LOGIT_CLAMP, LOGIT_CLAMP)

    def fused_logits(self, x, draws=None):
        alpha = torch.sigmoid(self.alpha)
        g = self.global_fc(self.stat_norm(_channel_stats(x)))
        logits = alpha * g + (1 - alpha) * self._local_logits(x) + self.expert_prior[None]
        return self._noisy(logits, draws)


class MultiHeadRouterV3(DualStreamGateRouterV2):
    """v0_13's router: the normalised statistics split into ``num_heads``
    slices, each with its own projection, mixed by sigmoid(head_alpha)
    (normalised) around a full-statistics projection ``global_proj`` weighted by
    sigmoid(global_weight), then V2's local stream and prior; in training,
    V2's noise and the soft expert dropout (module docstring)."""

    def __init__(self, in_channels, num_experts, top_k, temperature=1.0, local_reduction=16, pool_scale=4,
                 noise_std=0.1, num_heads=4, expert_dropout=0.1):
        super().__init__(in_channels, num_experts, top_k, temperature, local_reduction, pool_scale, noise_std)
        stat_dim = 2 * in_channels
        self.num_heads = max(1, min(num_heads, num_experts))
        self.head_dim = max(stat_dim // self.num_heads, 4)
        self.expert_dropout = float(expert_dropout)
        self.heads = nn.ModuleList(Linear(self.head_dim, num_experts, bias=False) for _ in range(self.num_heads))
        self.global_proj = self.global_fc  # the reference's name: its V3 has no global_fc
        del self.global_fc
        self.head_alpha = nn.Parameter(torch.full((self.num_heads,), 1.0 / self.num_heads))
        self.global_weight = _scalar(0.1)

    def seeded_init(self, generator):
        for h in self.heads:
            h.weight.normal_(0.0, 0.02, generator=generator)
        self.global_proj.weight.normal_(0.0, 0.02, generator=generator)

    def dropout_draws(self, batch: int):
        """(drop [batch, 1] bool, slot [batch, 1] int32) of the soft expert dropout at this step."""
        k1, k2 = jax_random.split(path_key(self.jax_path, self.step + 1))
        drop = jax_random.uniform(k1, (batch, 1)) < np.float32(self.expert_dropout)
        return drop, jax_random.randint(k2, (batch, 1), 0, self.top_k)

    def _drops(self) -> bool:
        return self.expert_dropout > 0 and self.top_k > 1

    def host_draws(self, batch: int) -> np.ndarray:
        """V2's noise columns, then the dropout's factor on each top-k slot [batch, k]: 0.5 on the dropped slot."""
        cols = [super().host_draws(batch)]
        if self._drops():
            drop, slot = self.dropout_draws(batch)
            cols.append(np.where(drop & (np.arange(self.top_k)[None] == slot), np.float32(0.5), np.float32(1)))
        return np.concatenate(cols, 1).astype(np.float32)

    def _train_topk(self, probs, draws):
        _, idx = topk_renorm(probs, self.top_k)  # the picks; JAX's weights are the raw top-k probabilities
        w = probs.gather(1, idx)
        if self._drops():
            w = w * draws[:, -self.top_k:]
        return w / (w.sum(-1, keepdim=True) + 1e-6), idx

    def fused_logits(self, x, draws=None):
        stats = self.stat_norm(_channel_stats(x))
        hw = torch.sigmoid(self.head_alpha)
        hw = hw / (hw.sum() + 1e-6)
        gw = torch.sigmoid(self.global_weight)
        need = self.head_dim * self.num_heads
        chunks = F.pad(stats, (0, max(need - stats.shape[1], 0)))[:, :need].reshape(stats.shape[0], self.num_heads,
                                                                                     self.head_dim)
        logits = gw * self.global_proj(stats)
        for i, h in enumerate(self.heads):
            logits = logits + (1 - gw) * hw[i] * h(chunks[:, i])
        alpha = torch.sigmoid(self.alpha)
        logits = alpha * logits + (1 - alpha) * self._local_logits(x) + self.expert_prior[None]
        return self._noisy(logits, draws)


# ---------------------------------------------------------------------------
# Expert backends: (x, weights [B, k], indices [B, k]) -> [B, O, H, W]
# ---------------------------------------------------------------------------

def _dense_weights(w, idx, num_experts, threshold):
    """Each sample's weight on every expert, [B, E] (0 where not picked or at
    most ``threshold``)."""
    w = w * (w > threshold)
    return torch.zeros(w.shape[0], num_experts, dtype=w.dtype, device=w.device).scatter_add_(1, idx, w)


def _masked_sum(experts, feats, w_full):
    """sum_e expert_e(feats) * w_full[:, e], every expert computed, summed in
    the activation's dtype in expert order (the JAX blocks' masked-dense
    dispatch)."""
    out = None
    for e, expert in enumerate(experts):
        term = expert(feats) * w_full[:, e, None, None, None].to(feats.dtype)
        out = term if out is None else out + term
    return out


class FusedExpertGroup(nn.Module):
    """Every expert as one grouped 3x3 conv -> [B, E, O, H, W] -> the top-k
    gathered -> GroupNorm per (sample, expert) in fp32 (eps 1e-5) with the
    expert's own affine (``expert_norm_weight/bias`` [E, O]) -> SiLU -> the
    routing-weighted sum, in fp32, cast back."""

    kernel_size = 3

    def __init__(self, in_channels, out_channels, num_experts, num_groups=8, top_k=2):
        super().__init__()
        self.num_experts, self.out_channels = num_experts, out_channels
        self.top_k = min(top_k, num_experts)
        fused_out = num_experts * out_channels
        g = min(get_safe_groups(in_channels, num_groups), fused_out)
        while g > 1 and (in_channels % g or fused_out % g):
            g -= 1
        self.conv_groups = max(1, g)
        self.fused_conv = PlainConv(in_channels, fused_out, self.kernel_size, g=self.conv_groups)
        self.norm_groups = get_safe_groups(out_channels, num_groups)
        self.expert_norm_weight = nn.Parameter(torch.ones(num_experts, out_channels))
        self.expert_norm_bias = nn.Parameter(torch.zeros(num_experts, out_channels))

    def forward(self, x, w, idx):
        b, _, h, wd = x.shape
        k, oc = idx.shape[1], self.out_channels
        fused = self.fused_conv(x).reshape(b, self.num_experts, oc, h, wd)
        sel = fused[torch.arange(b, device=x.device)[:, None], idx]  # [B, k, O, H, W]
        y = F.group_norm(sel.float().reshape(b * k, oc, h * wd), self.norm_groups, eps=1e-5).reshape(b, k, oc, h, wd)
        y = y * self.expert_norm_weight.float()[idx][..., None, None] + self.expert_norm_bias.float()[idx][..., None, None]
        return (F.silu(y) * w.float()[:, :, None, None, None]).sum(1).to(x.dtype)


class MatMulFusedExperts(FusedExpertGroup):
    """The reference's alias of FusedExpertGroup (3x3; the same parameters)."""


class LowRankFusedExpertGroup(nn.Module):
    """A shared 1x1 bottleneck (+ GroupNorm, SiLU) before the fused experts."""

    def __init__(self, in_channels, out_channels, num_experts, num_groups=8, top_k=2, bottleneck_ratio=0.5,
                 min_channels=16):
        super().__init__()
        bc = min(in_channels, max(min_channels, round(in_channels * bottleneck_ratio)))
        self.bottleneck = nn.Sequential(PlainConv(in_channels, bc, 1), GroupNorm(bc, num_groups), nn.SiLU())
        self.fused = FusedExpertGroup(bc, out_channels, num_experts, num_groups, top_k=top_k)

    def forward(self, x, w, idx):
        return self.fused(self.bottleneck(x), w, idx)


class SharedInvertedExpertGroup(nn.Module):
    """A shared expand 1x1 + dw trunk, then one 1x1 + GroupNorm per expert,
    masked-dense."""

    def __init__(self, in_channels, out_channels, num_experts, expand_ratio=2.0, kernel_size=3, top_k=2,
                 weight_threshold=0.0):
        super().__init__()
        self.num_experts, self.out_channels = num_experts, out_channels
        self.top_k, self.weight_threshold = top_k, weight_threshold
        hid = max(1, int(in_channels * expand_ratio))
        self.shared_feature = nn.Sequential(
            PlainConv(in_channels, hid, 1), GroupNorm(hid, 8), nn.SiLU(),
            PlainConv(hid, hid, kernel_size, g=hid), GroupNorm(hid, 8), nn.SiLU())
        self.expert_projections = nn.ModuleList(
            nn.Sequential(PlainConv(hid, out_channels, 1), GroupNorm(out_channels, 8)) for _ in range(num_experts))

    def forward(self, x, w, idx):
        w_full = _dense_weights(w, idx, self.num_experts, self.weight_threshold)
        return _masked_sum(self.expert_projections, self.shared_feature(x), w_full)


class DiversifiedExpertGroup(nn.Module):
    """v0_14's experts: a shared 1x1 expand, then per expert a dw 3x3 of
    dilation 1 + e // 2 and a 1x1 + GroupNorm, masked-dense."""

    def __init__(self, in_channels, out_channels, num_experts, expand_ratio=2.0, top_k=2, weight_threshold=0.0,
                 num_groups=8):
        super().__init__()
        self.num_experts, self.out_channels = num_experts, out_channels
        self.top_k, self.weight_threshold = top_k, weight_threshold
        hid = self.hid = max(1, int(in_channels * expand_ratio))
        self.shared_expand = nn.Sequential(PlainConv(in_channels, hid, 1), GroupNorm(hid, num_groups), nn.SiLU())
        self.dilations = [1 + i // 2 for i in range(num_experts)]
        self.dw_layers = nn.ModuleList(
            nn.Sequential(PlainConv(hid, hid, 3, g=hid, dilation=d), GroupNorm(hid, num_groups), nn.SiLU())
            for d in self.dilations)
        self.expert_projections = nn.ModuleList(
            nn.Sequential(PlainConv(hid, out_channels, 1), GroupNorm(out_channels, num_groups))
            for _ in range(num_experts))

    def forward(self, x, w, idx):
        w_full = _dense_weights(w, idx, self.num_experts, self.weight_threshold)
        experts = [lambda f, dw=dw, proj=proj: proj(dw(f))
                   for dw, proj in zip(self.dw_layers, self.expert_projections)]
        return _masked_sum(experts, self.shared_expand(x), w_full)


# ---------------------------------------------------------------------------
# Gates and mixers of the later generations
# ---------------------------------------------------------------------------

class VisualDetailGate(nn.Module):
    """x * (1 + tanh(detail_scale) * sigmoid(filter(x - blur(x)))), the blur a
    3x3 stride-1 average over the edge-padded map."""

    def __init__(self, channels, num_groups=8, reduction=8):
        super().__init__()
        hid = max(channels // reduction, 8)
        self.detail_filter = nn.Sequential(
            PlainConv(channels, channels, 3, g=channels), GroupNorm(channels, num_groups), nn.SiLU(),
            PlainConv(channels, hid, 1), nn.SiLU(), PlainConv(hid, channels, 1, bias=True))
        self.detail_scale = _scalar(0.1)

    def forward(self, x):
        detail = x - avg_pool(F.pad(x, (1, 1, 1, 1), mode="replicate"), 3, 1)
        gate = torch.sigmoid(self.detail_filter(detail).float()).to(x.dtype)
        return x * (1 + torch.tanh(self.detail_scale).to(x.dtype) * gate)


class PyramidContextMixer(nn.Module):
    """The mean of a dw 3x3 context and one 1x1 context per pool scale (pooled
    and upsampled back where H and W divide by the scale and H exceeds it, else
    at full size), added back through a sigmoid gate times tanh(context_scale)."""

    def __init__(self, channels, num_groups=8, pool_scales=(2, 4)):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        self.local_context = nn.Sequential(
            PlainConv(channels, channels, 3, g=channels), GroupNorm(channels, num_groups), nn.SiLU())
        self.pool_projections = nn.ModuleList(
            nn.Sequential(PlainConv(channels, channels, 1), GroupNorm(channels, num_groups), nn.SiLU())
            for _ in self.pool_scales)
        self.context_gate = nn.Sequential(PlainConv(channels, channels, 1, bias=True))
        self.context_scale = _scalar(0.1)

    def forward(self, x):
        h, w = x.shape[2:]
        contexts = [self.local_context(x)]
        for s, proj in zip(self.pool_scales, self.pool_projections):
            if h % s == 0 and w % s == 0 and h > s:  # the JAX block does not test w > s
                contexts.append(upsample_nearest(proj(avg_pool(x, s)), s))
            else:
                contexts.append(proj(x))
        context = sum(contexts) / len(contexts)
        gate = torch.sigmoid(self.context_gate(context).float()).to(x.dtype)
        return x + torch.tanh(self.context_scale).to(x.dtype) * context * gate


class CrossPathGate(nn.Module):
    """v0_15's fusion: a channel gate 0.5 + tanh(gate_scale) * 0.5 * sigmoid(raw)
    from both paths' pooled statistics scales each path before the concat.
    ``drop_scale`` is the reference's parameter, read by no forward."""

    def __init__(self, static_channels, dynamic_channels, out_channels, drop_prob=0.05):
        super().__init__()
        self.static_channels, self.dynamic_channels = static_channels, dynamic_channels
        self.drop_prob = float(drop_prob)
        stat_dim = static_channels + dynamic_channels
        hid = max(stat_dim // 4, 8)
        self.gate_net = nn.Sequential(GlobalAvgPool(fp32=True), nn.Flatten(), Linear(stat_dim, hid, bias=False),
                                      nn.SiLU(), Linear(hid, out_channels * 2, bias=True))
        self.gate_scale = _scalar(0.0)
        self.drop_scale = _scalar(1.0)

    def seeded_init(self, generator):
        nn.init.zeros_(self.gate_net[4].weight)  # the fusion starts as the plain concat
        nn.init.zeros_(self.gate_net[4].bias)

    def forward(self, out_static, out_dynamic):
        raw = self.gate_net(torch.cat([out_static, out_dynamic], 1)).float()
        gate = 0.5 + torch.tanh(self.gate_scale) * 0.5 * torch.sigmoid(raw)
        sc, dc = self.static_channels, self.dynamic_channels
        gs = gate[:, :sc, None, None].to(out_static.dtype)
        gd = gate[:, sc:sc + dc, None, None].to(out_dynamic.dtype)
        return torch.cat([out_static * gs, out_dynamic * gd], 1)


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

class AdaptiveGateMoE(nn.Module):
    """v0_4: the SE-gated channel split, dual-stream routing, shared-inverted
    experts, the complexity gate, a 1x1 projection + GroupNorm and the residual
    (the module docstring has the forward). Subclasses change the router
    (``router_cls``), the experts, and the hooks ``_fuse_paths``,
    ``_post_mix`` and ``_pre_residual``."""

    router_cls = DualStreamGateRouter
    anneal_steps = 2000

    def __init__(self, in_channels, out_channels, num_experts=4, top_k=2, split_ratio=0.5, num_groups=8,
                 initial_temperature=1.0, final_temperature=0.5, balance_loss_coeff=1.0, router_z_loss_coeff=1.0,
                 entropy_loss_coeff=0.01):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_experts, self.top_k, self.num_groups = num_experts, top_k, num_groups
        self.balance_loss_coeff = balance_loss_coeff
        self.router_z_loss_coeff = router_z_loss_coeff
        self.entropy_loss_coeff = entropy_loss_coeff
        self.initial_temperature, self.final_temperature = initial_temperature, final_temperature
        self.dynamic_channels = int(in_channels * split_ratio)
        self.static_channels = in_channels - self.dynamic_channels
        self.out_dynamic = int(out_channels * split_ratio)
        self.out_static = out_channels - self.out_dynamic
        self.shuffle_groups = 1
        self.calibrating = False  # utils/weights.py:calibrate_bn's pass: the eval forward, BN on batch statistics
        self.detail_gate = None
        self.jax_path = ""  # the JAX module path keying the draws (DetectionModel sets it)
        self.step = 0  # the optimizer step of a train-mode forward (DetectionModel.forward_train sets it)
        self.aux_record: Optional[AuxRecord] = None  # set by a train-mode forward
        self._draws: Optional[tuple] = None  # (key, this step's draws on the device): draws()

        se_hidden = max(in_channels // 4, 4)
        self.se_gate = nn.Sequential(GlobalAvgPool(fp32=True), nn.Flatten(), Linear(in_channels, se_hidden, bias=False),
                                     nn.SiLU(), Linear(se_hidden, in_channels))
        sc = self.static_channels
        self.static_net = nn.Sequential(
            PlainConv(sc, sc, 3, g=sc), BatchNorm2d(sc, eps=BN_EPS, momentum=BN_MOMENTUM), nn.SiLU(),
            PlainConv(sc, self.out_static, 1), BatchNorm2d(self.out_static, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.SiLU())
        self.routing = self.router_cls(self.dynamic_channels, num_experts, top_k, temperature=initial_temperature)
        self.fused_experts = SharedInvertedExpertGroup(self.dynamic_channels, self.out_dynamic, num_experts,
                                                       top_k=top_k, weight_threshold=0.0)
        self.complexity_estimator = nn.Sequential(GlobalAvgPool(), PlainConv(self.dynamic_channels, 1, 1, bias=True))
        self.proj = PlainConv(out_channels, out_channels, 1)
        self.bn = GroupNorm(out_channels, num_groups)

    def temperature(self) -> float:
        """The router's temperature in training at ``self.step`` (module docstring)."""
        return anneal_temperature(self.step, self.initial_temperature, self.final_temperature, self.anneal_steps)

    def host_draws(self, batch: int) -> np.ndarray:
        """This step's draws of the block itself, [batch, columns] float32 (none here)."""
        return np.zeros((batch, 0), np.float32)

    def draws(self, batch: int, device):
        """(the router's draws, the block's own) of this step, made on the host and
        copied to ``device`` in one copy, once per step and batch size (and anew
        after a change to a setting they depend on)."""
        r = self.routing
        key = (self.step, batch, str(device), self.jax_path, r.jax_path,
               getattr(r, "noise_std_init", 0.0), getattr(r, "expert_dropout", 0.0), r.top_k,
               getattr(getattr(self, "cross_gate", None), "drop_prob", 0.0))
        if self._draws is None or self._draws[0] != key:
            r.step = self.step
            router = r.host_draws(batch)
            host = np.concatenate([router, self.host_draws(batch)], 1)
            t = torch.from_numpy(np.ascontiguousarray(host, np.float32)).to(device)
            self._draws = (key, (t[:, :router.shape[1]], t[:, router.shape[1]:]))
        return self._draws[1]

    def _publish_aux(self, probs, logits, idx):
        """The aux loss of this forward, the top-k picks counted before the complexity gate."""
        keep = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, idx, True)
        aux = moe_aux_loss(probs, logits, keep, self.num_experts, balance_coeff=self.balance_loss_coeff,
                           z_coeff=self.router_z_loss_coeff, entropy_coeff=self.entropy_loss_coeff)
        self.aux_record = AuxRecord(aux, "moe", probs.mean(0).detach(), None)

    def _se_split(self, x):
        gate = torch.sigmoid(self.se_gate(x)).to(x.dtype)[:, :, None, None]
        sc = self.static_channels
        return x[:, :sc] * gate[:, :sc], x[:, sc:] * gate[:, sc:]

    def _complexity(self, xd):
        raw = torch.sigmoid(self.complexity_estimator(xd).float()).mean()
        return torch.nan_to_num(raw, nan=1.0, posinf=1.0, neginf=1.0).clamp(0.3, 1.5)

    def _complexity_gate(self, w, complexity):
        """Zero the top-k slots ranked past keep_count(c, k), renormalise."""
        k = w.shape[1]
        if k <= 1:
            return w
        rank = torch.arange(1, k + 1, dtype=torch.float32, device=w.device)
        w = w * (rank[None] <= keep_count(complexity, k)).to(w.dtype)
        return w / w.sum(1, keepdim=True).clamp_min(1e-6)

    def _channel_shuffle(self, x):
        g = self.shuffle_groups
        if g <= 1:
            return x
        b, c, h, w = x.shape
        return x.reshape(b, g, c // g, h, w).transpose(1, 2).reshape(b, c, h, w)

    def _fuse_paths(self, out_static, out_dynamic):
        return torch.cat([out_static, out_dynamic], 1)

    def _post_mix(self, out):
        return out

    def _pre_residual(self, out, own_draws=None):
        return out

    def forward(self, x):
        train = self.training and not self.calibrating
        router_draws, own_draws = self.draws(x.shape[0], x.device) if train else (None, None)
        xs, xd = self._se_split(x)
        if self.detail_gate is not None:
            xd = self.detail_gate(xd)
        out_static = self.static_net(xs)
        complexity = self._complexity(xd)
        if train:
            w, idx, probs, logits = self.routing(xd, temperature=self.temperature(), draws=router_draws)
        else:
            w, idx = self.routing(xd, temperature=self.final_temperature)
        w = self._complexity_gate(w, complexity)
        out_dynamic = self.fused_experts(xd, w, idx)
        out = self._post_mix(self._channel_shuffle(self._fuse_paths(out_static, out_dynamic)))
        out = self._pre_residual(self.bn(self.proj(out)), own_draws) + x
        if train:
            self._publish_aux(probs, logits, idx)
        return out


class FusedAdaptiveGateMoE(AdaptiveGateMoE):
    """v0_5: v0_4 with the fused experts."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.fused_experts = FusedExpertGroup(self.dynamic_channels, self.out_dynamic, self.num_experts,
                                              self.num_groups, top_k=self.top_k)


class HybridAdaptiveGateMoE(AdaptiveGateMoE):
    """v0_6: the fused experts up to ``fused_expert_threshold`` experts, the
    shared-inverted ones above, and a channel shuffle of the fused paths."""

    def __init__(self, in_channels, out_channels, num_experts=4, top_k=2, split_ratio=0.5, num_groups=8,
                 initial_temperature=1.2, final_temperature=0.5, balance_loss_coeff=1.0, router_z_loss_coeff=1.0,
                 entropy_loss_coeff=0.01, fused_expert_threshold=8, shuffle_groups=2):
        super().__init__(in_channels, out_channels, num_experts, top_k, split_ratio, num_groups, initial_temperature,
                         final_temperature, balance_loss_coeff, router_z_loss_coeff, entropy_loss_coeff)
        self.shuffle_groups = shuffle_groups if out_channels % shuffle_groups == 0 else 1
        if num_experts <= fused_expert_threshold:
            self.expert_backend = "fused"
            self.fused_experts = FusedExpertGroup(self.dynamic_channels, self.out_dynamic, num_experts, num_groups,
                                                  top_k=top_k)
        else:
            self.expert_backend = "shared_inverted"


class HybridAdaptiveGateMoEv2(HybridAdaptiveGateMoE):
    """v0_11: v0_6 with DualStreamGateRouterV2."""

    router_cls = DualStreamGateRouterV2


class LowRankHybridAdaptiveGateMoE(HybridAdaptiveGateMoE):
    """v0_7: v0_6 with the low-rank fused experts."""

    def __init__(self, *args, bottleneck_ratio=0.5, **kw):
        super().__init__(*args, **kw)
        if self.expert_backend == "fused":
            self.fused_experts = LowRankFusedExpertGroup(self.dynamic_channels, self.out_dynamic, self.num_experts,
                                                         top_k=self.top_k, bottleneck_ratio=bottleneck_ratio)


class _RefineMixin:
    """v0_8's refinement: x + tanh(refine_scale) * (dw 3x3 -> GroupNorm -> SiLU)(x)
    * sigmoid(1x1 -> SiLU -> 1x1 of mean(x))."""

    def _build_refine(self, out_channels, num_groups=8, refine_reduction=8):
        hid = max(out_channels // refine_reduction, 8)
        self.feature_refiner = nn.Sequential(
            PlainConv(out_channels, out_channels, 3, g=out_channels), GroupNorm(out_channels, num_groups), nn.SiLU())
        self.feature_gate = nn.Sequential(GlobalAvgPool(), PlainConv(out_channels, hid, 1), nn.SiLU(),
                                          PlainConv(hid, out_channels, 1, bias=True))
        self.refine_scale = _scalar(0.1)

    def _refine(self, x):
        gate = torch.sigmoid(self.feature_gate(x).float()).to(x.dtype)
        return x + torch.tanh(self.refine_scale).to(x.dtype) * self.feature_refiner(x) * gate


class RefinedLowRankHybridAdaptiveGateMoE(_RefineMixin, LowRankHybridAdaptiveGateMoE):
    """v0_8: v0_7 with the refinement after the fused paths."""

    def __init__(self, *args, refine_reduction=8, **kw):
        super().__init__(*args, **kw)
        self._build_refine(self.out_channels, refine_reduction=refine_reduction)

    def _post_mix(self, out):
        return self._refine(out)


class ContextRefinedLowRankHybridAdaptiveGateMoE(RefinedLowRankHybridAdaptiveGateMoE):
    """v0_8 with a PyramidContextMixer before the refinement."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.context_mixer = PyramidContextMixer(self.out_channels)

    def _post_mix(self, out):
        return self._refine(self.context_mixer(out))


class VisualEnhancedAdaptiveGateMoE(ContextRefinedLowRankHybridAdaptiveGateMoE):
    """v0_10, the released EsMoE block: the detail gate on the dynamic branch
    before routing, the context mixer and the refinement after the fusion."""

    def __init__(self, *args, detail_reduction=8, **kw):
        super().__init__(*args, **kw)
        self.detail_gate = VisualDetailGate(self.dynamic_channels, reduction=detail_reduction)


class DetailAwareLowRankHybridAdaptiveGateMoE(LowRankHybridAdaptiveGateMoE):
    """v0_9: v0_7 with the detail gate on the dynamic branch before routing."""

    def __init__(self, *args, detail_reduction=8, **kw):
        super().__init__(*args, **kw)
        self.detail_gate = VisualDetailGate(self.dynamic_channels, reduction=detail_reduction)


class OptimalHybridGateMoE(HybridAdaptiveGateMoEv2):
    """v0_12: v0_11 with a light refinement, out + tanh(refine_scale) * (dw 3x3
    -> GroupNorm)(out) * sigmoid(1x1 -> SiLU -> 1x1 of mean(out))."""

    def __init__(self, in_channels, out_channels, num_experts=4, top_k=2, split_ratio=0.5, num_groups=8,
                 initial_temperature=1.2, final_temperature=0.5, balance_loss_coeff=1.0, router_z_loss_coeff=1.0,
                 entropy_loss_coeff=0.01, fused_expert_threshold=8, shuffle_groups=2, refine=True,
                 refine_reduction=8):
        super().__init__(in_channels, out_channels, num_experts, top_k, split_ratio, num_groups, initial_temperature,
                         final_temperature, balance_loss_coeff, router_z_loss_coeff, entropy_loss_coeff,
                         fused_expert_threshold, shuffle_groups)
        self.refine_on = refine
        if refine:
            oc, hid = self.out_channels, max(self.out_channels // refine_reduction, 8)
            self.refine_dw = nn.Sequential(PlainConv(oc, oc, 3, g=oc), GroupNorm(oc, num_groups))
            self.refine_gate = nn.Sequential(GlobalAvgPool(), PlainConv(oc, hid, 1), nn.SiLU(),
                                             PlainConv(hid, oc, 1, bias=True))
            self.refine_scale = _scalar(0.1)

    def _post_mix(self, out):
        if not self.refine_on:
            return out
        gate = torch.sigmoid(self.refine_gate(out).float()).to(out.dtype)
        return out + torch.tanh(self.refine_scale).to(out.dtype) * (self.refine_dw(out) * gate)


class MultiHeadRouterMoE(OptimalHybridGateMoE):
    """v0_13: v0_12 with MultiHeadRouterV3."""

    def __init__(self, in_channels, out_channels, num_experts=4, top_k=2, split_ratio=0.5, num_groups=8,
                 initial_temperature=1.2, final_temperature=0.5, balance_loss_coeff=1.0, router_z_loss_coeff=1.0,
                 entropy_loss_coeff=0.01, fused_expert_threshold=8, shuffle_groups=2, refine=True,
                 refine_reduction=8, num_heads=4, expert_dropout=0.05):
        super().__init__(in_channels, out_channels, num_experts, top_k, split_ratio, num_groups, initial_temperature,
                         final_temperature, balance_loss_coeff, router_z_loss_coeff, entropy_loss_coeff,
                         fused_expert_threshold, shuffle_groups, refine=refine, refine_reduction=refine_reduction)
        self.routing = MultiHeadRouterV3(self.dynamic_channels, num_experts, top_k, temperature=initial_temperature,
                                         num_heads=num_heads, expert_dropout=expert_dropout)


class DiversifiedExpertMoE(OptimalHybridGateMoE):
    """v0_14: v0_12 with DiversifiedExpertGroup experts."""

    def __init__(self, in_channels, out_channels, num_experts=4, top_k=2, split_ratio=0.5, num_groups=8,
                 initial_temperature=1.2, final_temperature=0.5, balance_loss_coeff=1.0, router_z_loss_coeff=1.0,
                 entropy_loss_coeff=0.01, fused_expert_threshold=8, shuffle_groups=2, refine=True,
                 refine_reduction=8):
        super().__init__(in_channels, out_channels, num_experts, top_k, split_ratio, num_groups, initial_temperature,
                         final_temperature, balance_loss_coeff, router_z_loss_coeff, entropy_loss_coeff,
                         fused_expert_threshold, shuffle_groups, refine=refine, refine_reduction=refine_reduction)
        self.fused_experts = DiversifiedExpertGroup(self.dynamic_channels, self.out_dynamic, num_experts,
                                                    expand_ratio=2.0, top_k=top_k, weight_threshold=0.0,
                                                    num_groups=num_groups)


class GatedFusionMoE(OptimalHybridGateMoE):
    """v0_15: v0_12 with the CrossPathGate fusion in place of the concat; in
    training, the drop-path on the projection branch (module docstring)."""

    def __init__(self, in_channels, out_channels, num_experts=4, top_k=2, split_ratio=0.5, num_groups=8,
                 initial_temperature=1.2, final_temperature=0.5, balance_loss_coeff=1.0, router_z_loss_coeff=1.0,
                 entropy_loss_coeff=0.01, fused_expert_threshold=8, shuffle_groups=2, refine=True,
                 refine_reduction=8, drop_prob=0.05):
        super().__init__(in_channels, out_channels, num_experts, top_k, split_ratio, num_groups, initial_temperature,
                         final_temperature, balance_loss_coeff, router_z_loss_coeff, entropy_loss_coeff,
                         fused_expert_threshold, shuffle_groups, refine=refine, refine_reduction=refine_reduction)
        self.cross_gate = CrossPathGate(self.out_static, self.out_dynamic, out_channels, drop_prob=drop_prob)

    def _fuse_paths(self, out_static, out_dynamic):
        return self.cross_gate(out_static, out_dynamic)

    def drop_path_scale(self, batch: int) -> np.ndarray:
        """[batch] float32: 0 where uniform(path_key(jax_path, step + 2), [batch, 1, 1, 1])
        < drop_prob, else float32(1 / (1 - drop_prob))."""
        dp = self.cross_gate.drop_prob
        u = jax_random.uniform(path_key(self.jax_path, self.step + 2), (batch, 1, 1, 1)).reshape(batch)
        drop = u < np.float32(dp)
        return np.where(drop, np.float32(0), np.float32(1.0 / (1.0 - dp)))

    def host_draws(self, batch: int) -> np.ndarray:
        if self.cross_gate.drop_prob <= 0:
            return np.zeros((batch, 0), np.float32)
        return self.drop_path_scale(batch)[:, None]

    def _pre_residual(self, out, own_draws=None):
        if own_draws is None or self.cross_gate.drop_prob <= 0:
            return out
        return out * own_draws[:, 0, None, None, None].to(out.dtype)


GATED_BLOCKS = {c.__name__: c for c in (
    AdaptiveGateMoE, FusedAdaptiveGateMoE, HybridAdaptiveGateMoE, HybridAdaptiveGateMoEv2,
    LowRankHybridAdaptiveGateMoE, RefinedLowRankHybridAdaptiveGateMoE, ContextRefinedLowRankHybridAdaptiveGateMoE,
    VisualEnhancedAdaptiveGateMoE, DetailAwareLowRankHybridAdaptiveGateMoE, OptimalHybridGateMoE,
    MultiHeadRouterMoE, DiversifiedExpertMoE, GatedFusionMoE)}
