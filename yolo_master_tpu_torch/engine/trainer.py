"""Detection trainer (counterpart of ``yolo_master_tpu/engine/trainer.py``;
reference: ultralytics/engine/trainer.py:164-1719 BaseTrainer) and
:class:`MultiTrainer`.

    YOLO("yolo-master-n").train(data="data.yaml", epochs=100, batch=16, imgsz=640)
    YOLO("yolo-master-v0_1-n").train(data="data.yaml", epochs=100)      # routed MoE blocks
    YOLO("yolo-master-n").train(data=["a.yaml", "b.yaml"], epochs=10)  # MultiTrainer

``amp=True`` (the default, as in the JAX package) trains in bf16 mixed
precision: the forward and backward in bf16 from the fp32 parameters through
each op's cast, the loss in fp32, no loss scaling; the parameters, the
optimizer, the EMA and the BatchNorm statistics stay fp32
(``engine/train_step.py``). ``amp=False`` or ``compute_dtype=torch.float32``
trains in fp32. The EMA's val runs in fp32 (JAX's validator has no compute
dtype), and every checkpoint holds fp32 weights.

One epoch: the train split, augmented (``data/dataset.py``; ``PrefetchLoader``
with ``workers`` threads, or the synchronous ``DataLoader`` at ``workers=0``),
shuffled by ``seed + epoch``; ``accumulate = max(1, min(round(nbs / batch),
nb))`` loader batches make one optimizer step (the partial tail group is
dropped); ``engine/train_step.py`` takes the step with the MoE gain of the
epoch and reports the blocks' routing. After it:

  * the per-epoch means of the step's metrics, to ``results.csv`` and the callbacks;
  * the MoE runtime control (reference engine/extensions/mixture.py:22-90):
    routing history, collapse alarms, the Gini (or mAP-saturation) schedule
    of the next epoch's ``moe_gain``;
  * recovery (``engine/recovery.py``): restore the healthy state after a
    non-finite epoch, else adopt this one;
  * val of the EMA weights (``engine/validator.py``, batch ``min(batch, 8)``) on
    a copy of the model that holds the EMA state in eval mode, so that the
    training model's BatchNorm statistics are not touched; ``best.npz`` on a
    fitness gain, early stop after ``patience`` epochs without one;
  * every ``save_period`` epochs the resume checkpoint (``state/``,
    ``state_meta.json``).

At the end ``last.npz`` (the EMA weights), the routing history and its
dashboard; the facade's model takes the EMA weights and is left in eval mode.
``close_mosaic`` turns mosaic off for the last epochs; ``resume=True``
continues from ``save_dir/state`` at the epoch ``state_meta.json`` records.

yolo-master-v0_1's routed blocks train as JAX's (router noise, progressive
sparsity, expert dropout, aux loss), keyed by the optimizer step, which a
resumed run restores; their usage reaches the routing history and the Gini
rule, as do the gated blocks' and the MoA and MoT blocks' (the latent
mixtures publish none, as in JAX). Refused, each naming its ROADMAP.md item: ``mesh=``, ``expert_parallel >
1``, ``peft=`` and ``batch=-1``; the train step refuses Muon / MuSGD.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import DataLoader, PrefetchLoader, YOLODataset
from ..nn.moe.analysis import ExpertUsageTracker, RoutingCollapseDetector, RoutingHistory, render_dashboard
from ..nn.moe.scheduler import GiniBalanceScheduler, MapSaturationScheduler
from ..utils.callbacks import default_callbacks
from ..utils.checkpoint import load_train_state, model_ref, save_train_state, save_weights_npz
from .recovery import TrainingRecoveryController
from .train_step import COMPUTE_DTYPES, TrainPolicy, make_train_state, make_train_step
from .validator import DetectionValidator

LOGGER = logging.getLogger(__name__)
REFUSED = {
    "mesh": "ROADMAP.md §1.H item 19 (data parallelism)",
    "expert_parallel": "ROADMAP.md §1.H item 20 (expert parallelism)",
    "peft": "ROADMAP.md §1.I item 22 (PEFT and distillation)",
    "batch=-1": "ROADMAP.md §1.G item 18 (utils/autobatch.py)",
}


def ema_weights(state) -> Dict[str, torch.Tensor]:
    """The EMA of every floating state entry, with the model's other entries
    (BatchNorm's ``num_batches_tracked``): a whole state_dict."""
    return {k: state.ema_params.get(k, v) for k, v in state.model.state_dict().items()}


class DetectionTrainer:
    dataset_cls = YOLODataset
    validator_cls = DetectionValidator
    task = "detect"

    def __init__(self, yolo, data: str, epochs: int = 100, batch: int = 16, imgsz: int = 640,
                 optimizer: str = "auto", lr0: float = 0.01, lrf: float = 0.01, cos_lr: bool = False,
                 momentum: float = 0.937, weight_decay: float = 5e-4, warmup_epochs: float = 3.0,
                 warmup_momentum: float = 0.8, warmup_bias_lr: float = 0.1, max_gt: int = 128,
                 patience: int = 100, save_dir: str = "runs/train", mesh=None, val: bool = True, seed: int = 0,
                 hyp: Optional[Dict] = None, save_period: int = -1, amp: bool = True, compute_dtype=None,
                 nbs: int = 64, resume: bool = False, tensorboard: bool = False, close_mosaic: int = 10,
                 moe_schedule: Optional[str] = "gini", peft: Optional[Dict] = None, workers: int = 4,
                 prefetch: int = 3, expert_parallel: int = 1, cache: Optional[str] = None):
        dtype = compute_dtype or (torch.bfloat16 if amp else torch.float32)
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {dtype}")
        for name, given in (("mesh", mesh is not None), ("expert_parallel", expert_parallel > 1),
                            ("peft", bool(peft)), ("batch=-1", batch == -1)):
            if given:
                raise NotImplementedError(f"{name} is not ported yet: {REFUSED[name]}")
        self.yolo = yolo
        self.model = yolo.model
        self.compute_dtype = dtype
        self.device = next(self.model.parameters()).device
        self.data = data
        self.epochs = epochs
        self.batch = batch
        self.imgsz = imgsz
        self.max_gt = max_gt
        self.patience = patience
        self.save_dir = Path(save_dir)
        self.seed = seed
        self.hyp = hyp or {}
        self.save_period = save_period
        self.close_mosaic = close_mosaic
        self.cache = cache

        self.train_set = self._build_dataset(data, "train")
        if workers and workers > 0:
            self.loader = PrefetchLoader(self.train_set, batch, shuffle=True, seed=seed, workers=workers,
                                         prefetch=prefetch, images=np.float32)
        else:
            self.loader = DataLoader(self.train_set, batch, shuffle=True, seed=seed, images=np.float32)
        self.policy = TrainPolicy(
            nc=self.model.nc, epochs=epochs, nb=max(len(self.loader), 1), batch=batch, nbs=nbs,
            optimizer=optimizer, lr0=lr0, lrf=lrf, cos_lr=cos_lr, momentum=momentum, weight_decay=weight_decay,
            warmup_epochs=warmup_epochs, warmup_momentum=warmup_momentum, warmup_bias_lr=warmup_bias_lr,
            router_lr_scale=float(self.hyp.get("moe_router_lr_scale", 0.5)))
        self.accumulate = self.policy.accumulate
        self.nb_opt = self.policy.nb_opt  # optimizer steps per epoch
        if optimizer == "auto":
            LOGGER.info(f"optimizer 'auto' -> {self.policy.opt_name}(lr={self.policy.opt_lr0}, "
                        f"momentum={self.policy.opt_momentum})")
        self.tx = self.policy.build_optimizer(self.model)
        self.state = make_train_state(self.model, self.tx)
        self.step_fn = make_train_step(self.model, self.tx, hyp=self.hyp, accumulate=self.accumulate,
                                       compute_dtype=dtype, return_stats=True)

        self.callbacks = default_callbacks(str(self.save_dir), tensorboard=tensorboard)
        self.recovery = TrainingRecoveryController(self.model, str(self.save_dir), smoke_imgsz=min(imgsz, 64))
        # MoE runtime control (reference MixtureRuntimeController)
        self.moe_gain = float(self.hyp.get("moe", 0.01))
        self.usage_tracker = ExpertUsageTracker()
        self.collapse_detector = RoutingCollapseDetector()
        self.routing_history = RoutingHistory(str(self.save_dir))
        self.gini_sched = GiniBalanceScheduler(self.moe_gain) if moe_schedule == "gini" else None
        self.map_sched = MapSaturationScheduler(self.moe_gain) if moe_schedule == "map" else None
        self.start_epoch = 0
        if resume:
            ckpt = self.save_dir / "state"
            if ckpt.exists():
                load_train_state(ckpt, self.state)
                meta_f = self.save_dir / "state_meta.json"
                if meta_f.exists():  # the epoch itself: step // nb_opt misaligns after a loader-length change
                    self.start_epoch = int(json.loads(meta_f.read_text())["epoch"])
                else:
                    self.start_epoch = self.state.step // max(self.nb_opt, 1)
                LOGGER.info(f"resumed from {ckpt} at epoch {self.start_epoch}")
        self.ema_model = None  # the val model, made at the first val
        self.validator = self._build_validator() if val else None
        self.timings = []  # per epoch: seconds waiting on the loader, in steps, in val, writing checkpoints
        self.last_weights: Optional[Dict[str, torch.Tensor]] = None  # the live model's, before the EMA replaces them

    def _build_dataset(self, data, split: str):
        return self.dataset_cls(data, split=split, imgsz=self.imgsz, max_gt=self.max_gt, augment=split == "train",
                                hyp=self.hyp, cache=self.cache)

    def _build_validator(self):
        self.ema_model = copy.deepcopy(self.model).eval()
        return self.validator_cls(self.ema_model, data=self.data, imgsz=self.imgsz, batch=min(self.batch, 8),
                                  max_gt=self.max_gt)

    @torch.no_grad()
    def _load_ema_model(self) -> None:
        """The EMA of every floating entry into the val model (``num_batches_tracked``
        from the training model), in eval mode."""
        for k, v in self.ema_model.state_dict().items():
            v.copy_(self.state.ema_params[k] if k in self.state.ema_params else self.model.state_dict()[k])
        self.ema_model.eval()

    def _super_batches(self, epoch: int):
        """``accumulate`` loader batches concatenated into one optimizer step's
        batch; a partial tail group is dropped."""
        buf = []
        for b in self.loader.epoch(epoch):
            buf.append(b)
            if len(buf) == self.accumulate:
                yield buf[0] if self.accumulate == 1 else {k: np.concatenate([x[k] for x in buf], 0) for k in buf[0]}
                buf = []

    def _save_weights(self, name: str) -> None:
        save_weights_npz(ema_weights(self.state), self.save_dir / name,
                         metadata={"model": model_ref(self.yolo.cfg)})

    def train(self) -> Dict[str, float]:
        self.save_dir.mkdir(parents=True, exist_ok=True)
        best_fitness, best_epoch = -1.0, -1
        metrics_out: Dict[str, float] = {}
        nb_opt = self.nb_opt
        LOGGER.info(f"training {self.epochs} epochs x {nb_opt} steps, batch {self.batch}"
                    f"{f' x{self.accumulate} accumulated' if self.accumulate > 1 else ''}, imgsz {self.imgsz}, "
                    f"{str(self.compute_dtype).removeprefix('torch.')}")
        for epoch in range(self.start_epoch, self.epochs):
            if self.close_mosaic and epoch >= self.epochs - self.close_mosaic and self.train_set.mosaic_enabled:
                self.train_set.mosaic_enabled = False  # reference close_mosaic
                LOGGER.info("closing mosaic augmentation for final epochs")
            t0 = time.perf_counter()
            times = {"loader_s": 0.0, "step_s": 0.0, "val_s": 0.0, "save_s": 0.0}
            agg: Dict[str, float] = {}
            self.usage_tracker.reset()
            batches = self._super_batches(epoch)
            while True:
                t_load = time.perf_counter()
                batch = next(batches, None)
                t_step = time.perf_counter()
                times["loader_s"] += t_step - t_load
                if batch is None:
                    break
                batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
                self.state, m = self.step_fn(self.state, batch, self.moe_gain)
                stats = m.pop("moe_stats", None)
                if stats:  # by sorted path, as JAX's tree_map hands them over: the routing history's row order
                    self.usage_tracker.update({p: {k: v.cpu().numpy() for k, v in s.items()}
                                               for p, s in sorted(stats.items())})
                for k, v in sorted(m.items()):  # the JAX step's metrics come back in key order: results.csv's columns
                    agg[k] = agg.get(k, 0.0) + float(v)
                times["step_s"] += time.perf_counter() - t_step
            agg = {k: v / max(nb_opt, 1) for k, v in agg.items()}
            LOGGER.info(
                f"epoch {epoch + 1}/{self.epochs}  loss {agg.get('loss', 0):.4f} "
                f"(box {agg.get('box_loss', 0):.3f} cls {agg.get('cls_loss', 0):.3f} "
                f"dfl {agg.get('dfl_loss', 0):.3f} aux {agg.get('aux_loss', 0):.3f}) "
                f"lr {self.policy.lr_schedule(self.state.step):.5f}  moe_gain {self.moe_gain:.4f}  "
                f"{time.perf_counter() - t0:.1f}s")
            # MoE runtime control: history, collapse alarm, gain schedule
            usage = self.usage_tracker.mean_usage()
            if usage:
                self.routing_history.record(epoch, usage)
                for alarm in self.collapse_detector.check(usage):
                    LOGGER.warning(f"routing collapse: {alarm}")
                if self.gini_sched is not None:
                    self.moe_gain = self.gini_sched.update(usage)
            # coordinated NaN recovery (reference recovery.py / trainer.py:1392)
            self.state, recovered = self.recovery.maybe_recover(self.state, agg)
            if not recovered:
                self.recovery.refresh(self.state, epoch, agg)
            self.callbacks.fire("on_fit_epoch_end", epoch, agg)
            if self.validator is not None:
                t_val = time.perf_counter()
                self._load_ema_model()
                metrics_out = self.validator()
                times["val_s"] = time.perf_counter() - t_val
                fit = metrics_out.get("fitness", 0.0)
                if self.map_sched is not None:
                    self.moe_gain = self.map_sched.update(metrics_out.get("mAP50-95", 0.0))
                if fit > best_fitness:
                    best_fitness, best_epoch = fit, epoch
                    t_save = time.perf_counter()
                    self._save_weights("best.npz")
                    times["save_s"] += time.perf_counter() - t_save
                if epoch - best_epoch >= self.patience:
                    LOGGER.info(f"early stop at epoch {epoch + 1} (no fitness gain for {self.patience} epochs)")
                    self.timings.append({**times, "epoch_s": time.perf_counter() - t0})
                    break
            if self.save_period > 0 and (epoch + 1) % self.save_period == 0:
                t_save = time.perf_counter()
                save_train_state(self.state, self.save_dir / "state")
                (self.save_dir / "state_meta.json").write_text(
                    json.dumps({"epoch": epoch + 1, "nb_opt": nb_opt, "step": int(self.state.step)}))
                times["save_s"] += time.perf_counter() - t_save
            self.timings.append({**times, "epoch_s": time.perf_counter() - t0})
        self.routing_history.save()
        if self.routing_history.rows:
            render_dashboard(self.routing_history)  # routing_dashboard.html (reference moe/viz.py)
        self.callbacks.fire("on_train_end")
        self._save_weights("last.npz")
        self.last_weights = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self.yolo.load_state_dict(ema_weights(self.state))  # the facade's model: the EMA weights, eval mode
        self.model.eval()
        metrics_out["best_fitness"] = best_fitness
        return metrics_out


class MultiTrainer:
    """Fine-tune one base model on each of a list of datasets in turn
    (counterpart of ``yolo_master_tpu/engine/trainer.py:MultiTrainer``;
    reference engine/trainer.py:1564, ``Model.train(data=[...])``).

    Every run starts from a copy of the base weights; runs are named by their
    dataset's stem, a repeat as ``name-2``, ``name-3``, ..., and write under
    ``save_dir/<name>``. A run that raises is recorded as ``{"error": 1.0}``
    and the sweep goes on. ``multitrain_results.json`` holds each run's
    numeric metrics and their mean over the runs that finished; a
    ``multitrain_results.png`` fitness bar chart is drawn where matplotlib is
    installed (skipped with a warning elsewhere, as in JAX). The facade's
    model is restored to the base weights afterwards, in eval mode.
    """

    def __init__(self, yolo, datasets, trainer_cls=None, save_dir: str = "runs/multitrain", **kwargs):
        self.yolo = yolo
        self.datasets = list(datasets)
        self.trainer_cls = trainer_cls or DetectionTrainer
        self.save_dir = Path(save_dir)
        self.kwargs = kwargs
        self.metrics: Dict[str, Dict[str, float]] = {}

    def train(self) -> Dict[str, Dict[str, float]]:
        self.save_dir.mkdir(parents=True, exist_ok=True)
        base = {k: v.detach().clone() for k, v in self.yolo.model.state_dict().items()}
        names: list = []
        for i, data in enumerate(self.datasets):
            stem = Path(str(data)).stem or f"dataset{i}"
            name, k = stem, 2
            while name in names:
                name, k = f"{stem}-{k}", k + 1
            names.append(name)
            LOGGER.info(f"MultiTrainer {i + 1}/{len(self.datasets)}: fine-tuning on {data}")
            self.yolo.load_state_dict(base)
            try:
                trainer = self.trainer_cls(self.yolo, data=data, save_dir=str(self.save_dir / name), **self.kwargs)
                out = trainer.train()
                self.metrics[name] = {k_: float(v) for k_, v in out.items() if isinstance(v, (int, float))}
            except Exception as e:  # noqa: BLE001 - one bad dataset must not sink the sweep
                LOGGER.warning(f"MultiTrainer: run '{name}' failed: {e}")
                self.metrics[name] = {"error": 1.0}
        self.yolo.load_state_dict(base)
        self.yolo.model.eval()
        ok = {n: m for n, m in self.metrics.items() if "error" not in m}
        keys = sorted({k for m in ok.values() for k in m})
        mean = {k: float(np.mean([m[k] for m in ok.values() if k in m])) for k in keys}
        (self.save_dir / "multitrain_results.json").write_text(json.dumps({"runs": self.metrics, "mean": mean},
                                                                          indent=2))
        self._plot(ok)
        return self.metrics

    def _plot(self, ok: Dict[str, Dict[str, float]]) -> None:
        """``multitrain_results.png``, each run's fitness as a bar (best-effort)."""
        if not ok:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            names = list(ok)
            fits = [ok[n].get("best_fitness", ok[n].get("fitness", 0.0)) for n in names]
            fig, ax = plt.subplots(figsize=(max(4, 1.2 * len(names)), 4))
            ax.bar(names, fits, color="#4878cf")
            ax.set_ylabel("fitness")
            ax.set_title("MultiTrainer per-dataset fitness")
            for lbl in ax.get_xticklabels():
                lbl.set_rotation(30)
            fig.tight_layout()
            fig.savefig(self.save_dir / "multitrain_results.png", dpi=100)
            plt.close(fig)
        except Exception as e:  # noqa: BLE001
            LOGGER.warning(f"MultiTrainer: plot skipped: {e}")
