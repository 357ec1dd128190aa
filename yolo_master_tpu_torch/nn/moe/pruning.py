"""MoE expert pruning (counterpart of ``yolo_master_tpu/nn/moe/pruning.py``):
remove under-used experts from a trained model (reference:
ultralytics/nn/modules/moe/pruning.py:12-632 MoEPruner / prune_moe_model).

    usage = collect_usage_stats(model, batches)          # JAX path -> mean usage [E]
    prune_moe_model(model, usage, threshold=0.15)        # ES_MOE blocks, in place

The usage comes from a diagnosis pass: train-mode forwards at step 0
(``DetectionModel.forward_train``), each MoE block's published usage
averaged over the batches, keyed by its JAX path (``layers.N``); the pass
leaves the model's BatchNorm statistics and mode as they were, as the JAX
pass drops its statistics' updates. Pruning is module surgery on the
ES_MOE blocks only, as in the JAX package: the kept experts (their kernel
sizes and weights), the router's last 1x1 sliced to their rows.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from .es_moe import ES_MOE

LOGGER = logging.getLogger(__name__)


@torch.no_grad()
def collect_usage_stats(model, batches, max_batches: int = 16) -> Dict[str, np.ndarray]:
    """Run train-mode forwards at step 0 over ``batches`` (dicts with ``images``
    [B, H, W, 3] in 0..1, arrays or tensors, or the images themselves; at most
    ``max_batches``) and average each MoE block's expert usage, float64 by JAX
    path (reference pruning.py diagnose)."""
    from ..tasks import jax_module_path

    device = next(model.parameters()).device
    was_training = model.training
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    totals: Dict[str, np.ndarray] = {}
    count = 0
    model.train()
    try:
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            x = batch["images"] if isinstance(batch, dict) else batch
            x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            _, aux = model.forward_train(x.to(device), step=0)
            for name, rec in aux.items():
                if rec.usage is None:  # the latent mixtures and NeckMoAFusion publish no usage
                    continue
                path = jax_module_path(name)
                totals[path] = totals.get(path, 0.0) + rec.usage.double().cpu().numpy()
            count += 1
    finally:
        for n, b in model.named_buffers():
            b.copy_(buffers[n])
        model.train(was_training)
    return {k: v / max(count, 1) for k, v in totals.items()}


def expert_importance(usage: np.ndarray, mode: str = "usage", mean_weight: Optional[np.ndarray] = None) -> np.ndarray:
    """Importance scores (reference pruning.py importance_mode usage/usage_weight)."""
    if mode == "usage_weight" and mean_weight is not None:
        return usage * mean_weight
    return usage


def select_experts_to_keep(usage: np.ndarray, threshold: float = 0.15, keep_top_m: Optional[int] = None) -> List[int]:
    """Keep experts above the usage threshold; always keep at least the best
    (and optionally the top-M) (reference pruning.py:18-42)."""
    order = np.argsort(-usage)
    keep = {int(i) for i in np.nonzero(usage >= threshold)[0]}
    keep.add(int(order[0]))
    if keep_top_m:
        keep.update(int(i) for i in order[:keep_top_m])
    return sorted(keep)


@torch.no_grad()
def prune_es_moe_block(block: ES_MOE, keep: List[int]) -> ES_MOE:
    """A new ES_MOE holding the kept experts of ``block`` (their kernel sizes and
    weights, in the kept order), its router's last 1x1 sliced to their rows, and
    its output norm, on the block's device and in its mode."""
    new = ES_MOE(block.in_channels, block.out_channels, num_experts=len(keep),
                 top_k=min(block.top_k, len(keep)) if block.top_k is not None else None,
                 use_sparse_inference=block.use_sparse_inference, dynamic_threshold=block.dynamic_threshold,
                 max_kernel_size=block.max_kernel_size)
    new.experts = nn.ModuleList(copy.deepcopy(block.experts[i]) for i in keep)
    new.routing.load_state_dict({k: v[keep] if k.startswith("routing_network.2.") else v
                                 for k, v in block.routing.state_dict().items()})
    new.norm.load_state_dict(block.norm.state_dict())
    new.sparse_inference, new.balance_loss_coeff = block.sparse_inference, block.balance_loss_coeff
    ref = next(block.parameters())
    return new.to(device=ref.device, dtype=ref.dtype).train(block.training)


def prune_moe_model(model, usage_stats: Dict[str, np.ndarray], threshold: float = 0.15,
                    keep_top_m: Optional[int] = None):
    """Prune every ES_MOE layer of a DetectionModel by usage (reference
    pruning.py:549-572), in place; returns the model."""
    pruned = 0
    for i, m in enumerate(model.model):
        if not isinstance(m, ES_MOE):
            continue
        path = f"layers.{i}"
        usage = usage_stats.get(path)
        if usage is None:
            continue
        keep = select_experts_to_keep(np.asarray(usage), threshold, keep_top_m)
        if len(keep) == m.num_experts:
            continue
        new = prune_es_moe_block(m, keep)
        new.i, new.f = m.i, m.f
        model.model[i] = new
        pruned += 1
        LOGGER.info(f"pruned {path}: kept experts {keep}")
    LOGGER.info(f"pruned {pruned} ES_MOE blocks (threshold {threshold})")
    return model
