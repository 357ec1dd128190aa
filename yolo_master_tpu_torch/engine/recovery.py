"""Training recovery controller (counterpart of ``yolo_master_tpu/engine/recovery.py``;
reference: ultralytics/engine/extensions/recovery.py:23-370 and trainer.py:1392
_handle_nan_recovery).

* After each finite epoch whose weights pass a forward smoke test (a 0.5-gray
  image of ``smoke_imgsz`` through ``forward_predict`` in eval mode, every
  output finite), the state is adopted as healthy: a copy of the model's
  parameters and BatchNorm statistics (the port's model holds them; in JAX
  they are the TrainState's ``params``) and of the TrainState (optimizer,
  EMA, counters, ``aux_ema``), with the EMA weights in ``healthy.npz``.
* After a non-finite epoch the healthy copy is restored, except ``step``,
  which keeps counting so that no schedule rewinds. (Single steps are guarded
  by the train step itself.)
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils.checkpoint import restore, save_weights_npz, snapshot

LOGGER = logging.getLogger(__name__)


def _finite(metrics: dict) -> bool:
    return all(np.isfinite(v) for v in metrics.values() if np.isscalar(v))


class TrainingRecoveryController:
    def __init__(self, model, save_dir: str, smoke_imgsz: int = 64, keep_on_disk: bool = True):
        self.model = model
        self.save_dir = Path(save_dir)
        self.smoke_imgsz = smoke_imgsz
        self.keep_on_disk = keep_on_disk
        self.healthy_state = None  # a utils/checkpoint.py:snapshot
        self.healthy_epoch = -1
        self.recoveries = 0

    @torch.no_grad()
    def _forward_smoke(self) -> bool:
        """The model as it is, in eval mode, on a gray image: every output finite.
        The model's mode is restored after; eval mode leaves the BN statistics alone."""
        was_training = self.model.training
        try:
            device = next(self.model.parameters()).device
            x = torch.full((1, self.smoke_imgsz, self.smoke_imgsz, 3), 0.5, device=device)
            self.model.eval()
            return bool(torch.isfinite(self.model.forward_predict(x)).all())
        except Exception as e:  # noqa: BLE001 - any failure marks the weights unhealthy
            LOGGER.warning(f"recovery smoke test failed: {e}")
            return False
        finally:
            self.model.train(was_training)

    def refresh(self, state, epoch: int, metrics: Optional[dict] = None) -> bool:
        """Adopt the current state as healthy if the epoch's metrics are finite and
        the model passes the smoke test."""
        if metrics is not None and not _finite(metrics):
            return False
        if not self._forward_smoke():
            return False
        self.healthy_state = snapshot(state)
        self.healthy_epoch = epoch
        if self.keep_on_disk:
            weights = {k: self.healthy_state["ema"].get(k, v) for k, v in self.healthy_state["model"].items()}
            save_weights_npz(weights, self.save_dir / "healthy.npz")
        return True

    def maybe_recover(self, state, metrics: dict):
        """Restore the last healthy state after a non-finite epoch. Returns (state, recovered)."""
        if _finite(metrics):
            return state, False
        if self.healthy_state is None:
            LOGGER.warning("non-finite epoch but no healthy checkpoint yet — continuing")
            return state, False
        self.recoveries += 1
        LOGGER.warning(f"non-finite epoch metrics — restoring healthy checkpoint from epoch {self.healthy_epoch} "
                       f"(recovery #{self.recoveries})")
        step = state.step
        restore(state, self.healthy_state)
        state.step = step  # the schedules do not rewind
        return state, True
