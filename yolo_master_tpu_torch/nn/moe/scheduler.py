"""MoE balance-coefficient schedulers, the port's copy of
``yolo_master_tpu/nn/moe/scheduler.py`` (reference: ultralytics/nn/modules/moe/
scheduler.py:37-220 + engine/extensions/mixture.py:22-90). numpy only.

The reference mutates per-block ``balance_loss_coeff`` attributes between
epochs; here the trainer passes one ``moe_gain`` to the train step, and these
host-side schedulers update it once an epoch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def compute_gini(usage: np.ndarray) -> float:
    """Gini coefficient of expert usage: 0 = perfectly balanced
    (reference scheduler.py:37-51)."""
    u = np.sort(np.asarray(usage, np.float64).reshape(-1))
    n = u.size
    if n == 0 or u.sum() <= 0:
        return 0.0
    cum = np.cumsum(u)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


class GiniBalanceScheduler:
    """Epoch-level: raise the aux gain when routing is imbalanced (high Gini),
    lower it when balanced (reference engine/extensions/mixture.py:50,
    cfg key moe_dynamic_schedule: gini)."""

    def __init__(self, base_gain: float = 0.01, low: float = 0.2, high: float = 0.5,
                 up_factor: float = 1.5, down_factor: float = 0.7,
                 min_gain: float = 1e-4, max_gain: float = 1.0):
        self.gain = base_gain
        self.low, self.high = low, high
        self.up, self.down = up_factor, down_factor
        self.min_gain, self.max_gain = min_gain, max_gain

    def update(self, usage_by_block: Dict[str, np.ndarray]) -> float:
        if usage_by_block:
            gini = float(np.mean([compute_gini(u) for u in usage_by_block.values()]))
            if gini > self.high:
                self.gain = min(self.gain * self.up, self.max_gain)
            elif gini < self.low:
                self.gain = max(self.gain * self.down, self.min_gain)
        return self.gain


class MapSaturationScheduler:
    """Decay the balance gain when val mAP plateaus (reference
    scheduler.py:113-161 MapSaturationScheduler)."""

    def __init__(self, base_gain: float = 0.01, patience: int = 3, decay: float = 0.5,
                 min_gain: float = 1e-4, min_delta: float = 1e-3):
        self.gain = base_gain
        self.patience = patience
        self.decay = decay
        self.min_gain = min_gain
        self.min_delta = min_delta
        self.best = -float("inf")
        self.stale = 0

    def update(self, val_map: float) -> float:
        if val_map > self.best + self.min_delta:
            self.best = val_map
            self.stale = 0
        else:
            self.stale += 1
            if self.stale >= self.patience:
                self.gain = max(self.gain * self.decay, self.min_gain)
                self.stale = 0
        return self.gain
