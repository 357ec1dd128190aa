"""Mixture aux-loss composition (counterpart of ``yolo_master_tpu/nn/mixture_loss.py``).

Each aux record of a train-mode forward (``nn/tasks.py:AuxRecord``) belongs
to a family. The families' sums are scaled by per-family gains, each
normalised by an EMA of its own magnitude (``aux_ema``, carried in the train
state), capped by a budget, and a non-finite family is dropped rather than
allowed to poison the step.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

FAMILIES = ("moe", "moa", "mot", "latent", "molora", "other")
DEFAULT_EMA_DECAY = 0.9


class AuxRecord(NamedTuple):
    """One block's aux loss of a train-mode forward: the value (with its graph),
    its family, the block's expert usage (detached; None where the JAX block
    publishes no routing stats, as the latent mixtures and NeckMoAFusion), and
    the name the JAX block gives the value in its routing stats (None where it
    publishes only the usage, as the gated, MoA and MoT blocks do)."""
    value: torch.Tensor
    family: str
    usage: Optional[torch.Tensor]
    stat: Optional[str] = "balance_loss"


def family_sums(aux: Mapping, device=None) -> torch.Tensor:
    """[F] per-family sums of the aux records (a record without a known family counts as "other")."""
    sums = [torch.zeros((), device=device) for _ in FAMILIES]
    idx = {f: i for i, f in enumerate(FAMILIES)}
    for rec in aux.values():
        i = idx.get(rec.family, idx["other"])
        sums[i] = sums[i] + rec.value.float()
    return torch.stack(sums)


def compose_aux(aux: Mapping, gains: Dict[str, float], ema: torch.Tensor, budget: float = 0.0,
                ema_decay: float = DEFAULT_EMA_DECAY,
                normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(aux_total, new_ema, metrics) from the aux records of one forward.

    ``gains``: per family; a family not named takes ``gains["moe"]`` (0.01 if
    absent). ``ema`` [F]: the running magnitudes. ``budget`` > 0 scales the
    total down to at most that size. With ``normalize`` each family is divided
    by its EMA magnitude, so that its gain sets its share whatever its raw scale.
    """
    sums = family_sums(aux, ema.device)
    finite = torch.isfinite(sums)
    sums = torch.where(finite, sums, torch.zeros_like(sums))  # a non-finite family is dropped

    mag = sums.detach().abs()
    active = mag > 0
    new_ema = torch.where(active, ema_decay * ema + (1.0 - ema_decay) * mag, ema)

    base_gain = float(gains.get("moe", 0.01))
    g = torch.tensor([float(gains.get(f, base_gain)) for f in FAMILIES], dtype=torch.float32, device=ema.device)
    if normalize:
        contrib = g * sums * torch.where(active, 1.0 / new_ema.clamp_min(1e-8), torch.ones_like(new_ema))
    else:
        contrib = g * sums
    total = contrib.sum()
    if budget and budget > 0:
        total = total * torch.clamp(budget / total.abs().clamp_min(1e-12), max=1.0)
    metrics = {f"aux_{f}": contrib[i] for i, f in enumerate(FAMILIES) if f != "other"}
    metrics["aux_isolated"] = (~finite).sum().float()
    return total, new_ema, metrics


def init_aux_ema(device=None) -> torch.Tensor:
    return torch.ones(len(FAMILIES), device=device)
