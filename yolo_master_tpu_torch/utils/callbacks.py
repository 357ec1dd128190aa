"""Callback fan-out, the port's copy of ``yolo_master_tpu/utils/callbacks.py``
(reference: ultralytics/utils/callbacks/base.py:10-141 — event list +
per-integration hooks; TensorBoard/W&B/CSV consumers).

CSV (``results.csv``) always; TensorBoard through tf.summary, W&B, MLflow and
a console JSON line attach when asked for and their package imports, and
register nothing otherwise, as in the reference.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List

EVENTS = (
    "on_pretrain_routine_start",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_fit_epoch_end",
    "on_val_end",
    "on_model_save",
    "on_train_end",
)


class CallbackRegistry:
    def __init__(self):
        self._hooks: Dict[str, List[Callable]] = defaultdict(list)

    def add(self, event: str, fn: Callable):
        if event not in EVENTS:
            raise KeyError(f"unknown event '{event}' (valid: {EVENTS})")
        self._hooks[event].append(fn)

    def fire(self, event: str, *args, **kwargs):
        for fn in self._hooks.get(event, []):
            fn(*args, **kwargs)


class CSVLogger:
    """results.csv writer (reference trainer.py:769 save_metrics)."""

    def __init__(self, save_dir: str):
        self.path = Path(save_dir) / "results.csv"
        self.keys: List[str] = []

    def on_fit_epoch_end(self, epoch: int, metrics: Dict[str, float]):
        row = {"epoch": epoch, **{k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}}
        write_header = not self.path.exists() or not self.keys
        if not self.keys:
            self.keys = list(row)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.keys, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)


class TensorBoardLogger:
    def __init__(self, save_dir: str):
        import tensorflow as tf

        self.writer = tf.summary.create_file_writer(str(Path(save_dir) / "tb"))

    def on_fit_epoch_end(self, epoch: int, metrics: Dict[str, float]):
        import tensorflow as tf

        with self.writer.as_default():
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    tf.summary.scalar(k, v, step=epoch)
            self.writer.flush()


class WandbLogger:
    """Weights & Biases adapter (reference utils/callbacks/wb.py). Imports
    lazily; raises ImportError at construction when wandb is absent (the
    registry builder degrades it to a no-op)."""

    def __init__(self, save_dir: str, project: str = "yolo-master-tpu", run=None):
        import wandb

        self._wandb = wandb
        self.run = run or wandb.init(project=project, dir=save_dir)

    def on_fit_epoch_end(self, epoch: int, metrics: Dict[str, float]):
        self.run.log({k: v for k, v in metrics.items() if isinstance(v, (int, float))}, step=epoch)

    def on_train_end(self, *a, **k):
        self.run.finish()


class MLflowLogger:
    """MLflow adapter (reference utils/callbacks/mlflow.py)."""

    def __init__(self, save_dir: str, experiment: str = "yolo-master-tpu"):
        import mlflow

        self._mlflow = mlflow
        mlflow.set_experiment(experiment)
        self.active = mlflow.start_run()

    def on_fit_epoch_end(self, epoch: int, metrics: Dict[str, float]):
        self._mlflow.log_metrics(
            {k.replace("(", "").replace(")", ""): float(v) for k, v in metrics.items() if isinstance(v, (int, float))},
            step=epoch,
        )

    def on_train_end(self, *a, **k):
        self._mlflow.end_run()


class ConsoleLogger:
    """Structured stream capture for platform log shipping (reference
    utils/logger.py ConsoleLogger): mirrors per-epoch metrics as one JSON line
    to a sink callable (default: LOGGER.info)."""

    def __init__(self, sink: Callable[[str], None] | None = None):
        import json
        import logging

        self._json = json
        self.sink = sink or logging.getLogger(__name__).info

    def on_fit_epoch_end(self, epoch: int, metrics: Dict[str, float]):
        row = {"epoch": epoch, **{k: round(float(v), 5) for k, v in metrics.items() if isinstance(v, (int, float))}}
        self.sink(self._json.dumps(row))


INTEGRATIONS = {"tensorboard": TensorBoardLogger, "wandb": WandbLogger, "mlflow": MLflowLogger, "console": ConsoleLogger}


def default_callbacks(save_dir: str, tensorboard: bool = False, integrations: tuple = ()) -> CallbackRegistry:
    """CSV always; named integrations attach when their package imports,
    no-op otherwise (reference callbacks/__init__.py add_integration_callbacks)."""
    reg = CallbackRegistry()
    csv_logger = CSVLogger(save_dir)
    reg.add("on_fit_epoch_end", csv_logger.on_fit_epoch_end)
    names = tuple(integrations) + (("tensorboard",) if tensorboard else ())
    for name in names:
        try:
            hook = INTEGRATIONS[name](save_dir) if name != "console" else ConsoleLogger()
            reg.add("on_fit_epoch_end", hook.on_fit_epoch_end)
            if hasattr(hook, "on_train_end"):
                reg.add("on_train_end", hook.on_train_end)
        except Exception:  # package absent -> no-op, like the reference
            pass
    return reg
