"""ES_MOE, the YOLO-Master routed block (counterpart of ``yolo_master_tpu/nn/moe/es_moe.py``).

Dense eval (``top_k=None``): every expert runs, and the output is the
routing-weighted sum, then BatchNorm + SiLU (``norm.0`` in the state_dict;
left unfolded by deploy fusion, as in the JAX package). Sparse eval (``top_k``
below the expert count, ``use_sparse_inference``, and the model's
``sparse_inference`` switch on, as by default): the top-k weights, pruned by
``dynamic_threshold`` and renormalised, and only the selected experts run
(``nn/moe/dispatch.py``). In training every expert runs, masked by the
weights, and the block publishes its GShard balance loss on the batch-mean
weights as ``aux_record`` for ``DetectionModel.forward_train`` to collect.
:class:`FusedESMOE` is the deploy form of a dense block as one CUDA kernel
(``utils/fuse.py:fused_esmoe_fuse``). The expert-parallel path is not ported
yet (ROADMAP.md §1.H item 20).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...ops.esmoe import fused_esmoe, pack_esmoe_params
from ..layers import BN_EPS, BN_MOMENTUM, BatchNorm2d
from ..mixture_loss import AuxRecord
from .dispatch import expert_bank, gather_dispatch, top_k_from_weights
from .experts import EfficientExpertGroup
from .losses import gshard_balance_loss
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
        if num_experts < 1:
            raise ValueError(f"num_experts must be positive, got {num_experts}")
        if top_k is not None and not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k must be in [1, {num_experts}], got {top_k}")
        if not 0.0 <= dynamic_threshold <= 1.0:
            raise ValueError(f"dynamic_threshold must be in [0, 1], got {dynamic_threshold}")
        if max_kernel_size < 3:
            raise ValueError(f"max_kernel_size must be at least 3, got {max_kernel_size}")
        max_kernel_size = int(max_kernel_size)
        if max_kernel_size % 2 == 0:
            max_kernel_size -= 1
        out_channels = out_channels or in_channels
        self.in_channels, self.out_channels, self.max_kernel_size = in_channels, out_channels, max_kernel_size
        self.num_experts = num_experts
        self.top_k = top_k
        self.use_sparse_inference = use_sparse_inference
        self.dynamic_threshold = dynamic_threshold
        self.sparse_inference = True  # the model-level switch (DetectionModel.sparse_inference)
        self.balance_loss_coeff = 1.0
        self.aux_record: Optional[AuxRecord] = None  # set by a train-mode forward
        self.routing = DynamicRoutingLayer(in_channels, num_experts, reduction, top_k)
        self.experts = nn.ModuleList(
            EfficientExpertGroup(in_channels, out_channels, k)
            for k in expert_kernel_sizes(num_experts, max_kernel_size))
        self.norm = nn.Sequential(BatchNorm2d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM), nn.SiLU())

    def _sparse_block(self) -> bool:
        return self.use_sparse_inference and self.top_k is not None and self.top_k < self.num_experts

    def _sparse_retained_weights(self, w: torch.Tensor) -> torch.Tensor:
        """Top-k weights [B, E] -> those of at least ``dynamic_threshold`` (and
        always the largest), renormalised."""
        if self.dynamic_threshold <= 0:
            return w
        wf = w.float()
        retained = (wf >= wf.max(-1, keepdim=True).values) | (wf >= self.dynamic_threshold)
        wf = wf * retained
        return (wf / wf.sum(-1, keepdim=True).clamp_min(1e-9)).to(w.dtype)

    def forward(self, x):
        w, _ = self.routing(x)  # [B, E]
        if self.training:
            usage = w.float().mean(0)
            self.aux_record = AuxRecord(gshard_balance_loss(usage, self.num_experts) * self.balance_loss_coeff,
                                        "moe", usage.detach())
        if not self.training and self.sparse_inference and self._sparse_block():
            wts, idx = top_k_from_weights(self._sparse_retained_weights(w), self.top_k)
            out = gather_dispatch(self.experts[-1], expert_bank(self.experts), x, idx, wts)
        else:  # masked dense: zeros in w for the experts outside the top-k
            out = None
            for i, expert in enumerate(self.experts):
                y = expert(x) * w[:, i, None, None, None].to(x.dtype)
                out = y if out is None else out + y
        return self.norm(out)

    def fusable(self) -> bool:
        """Whether ``fused_esmoe_fuse`` can swap this block for :class:`FusedESMOE`:
        a block that evaluates densely (no sparse top-k path) with stride-1 experts."""
        return not self._sparse_block() and all(e.conv.depthwise.stride == (1, 1) for e in self.experts)


class FusedESMOE(nn.Module):
    """Deploy form of a dense ES_MOE block (counterpart of ``PallasESMOE``): the
    routing MLP stays in PyTorch, and the experts, their mix and the output
    norm run as one kernel (``ops/esmoe.py:fused_esmoe``).

    State: ``routing.*`` as in :class:`ES_MOE`, and ``banks.{dw,pw,pb,gamma,beta}``
    as in the JAX package's fused tree, except that ``dw`` [E, kmax, kmax, C]
    is kept as [E, kmax*kmax, C]: a 4-D parameter would be reordered by the
    facade's channels_last ``.to()``. Eval only. The banks stay fp32 in a bf16
    copy of the model, as the JAX kernel widens its weights; x and the output
    are in the activation dtype.
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
        w, _ = self.routing(x)  # [B, E], in x's dtype (JAX: w.astype(x.dtype), widened for the kernel)
        dw = self.banks["dw"]
        kmax = max(self.ks)
        out = fused_esmoe(x.permute(0, 2, 3, 1).contiguous(), w.float(),
                          dw.view(dw.shape[0], kmax, kmax, dw.shape[2]), self.banks["pw"], self.banks["pb"],
                          self.banks["gamma"], self.banks["beta"], self.ks)
        return out.permute(0, 3, 1, 2)
