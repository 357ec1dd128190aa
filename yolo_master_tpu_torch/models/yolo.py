"""YOLO facade (counterpart of ``yolo_master_tpu/models/yolo.py``).

    YOLO("yolo-master-n").fuse().predict(images)   # fuse(pallas_stem=True), the JAX README's form, too
    YOLO("yolo-master-seg-n").fuse().predict(images)   # -pose-n, -obb-n, -cls-n; v0_4-v0_15 too (eval, fp32)
    YOLO("yolo-master-cls-n").fuse().val(data="imagenet_dir")   # a folder per class under data/val
    YOLO("yolo-master-v0_10-n").fuse().predict(images)   # the released EsMoE graph (any of v0_4-v0_15)
    YOLO("yolo-master-n").fuse().val(data="data.yaml", imgsz=640, batch=16)
    YOLO("yolo-master-n").train(data="data.yaml", epochs=100, batch=16, imgsz=640)
    YOLO("runs/train/best.npz").fuse().predict(images)

The model runs on the card (``device="cuda"``) unless the caller asks for
another device, as the CPU tests do with ``device="cpu"``. Weights are drawn
from ``seed`` with a ``torch.Generator`` on the CPU, so one seed gives the
same model on every device. A ``.npz`` is a weights file: the port's
``best.npz`` / ``last.npz``, which name their graph, or the JAX package's
``save_params_npz`` file, whose graph comes from a ``<file>.json`` beside it
(``{"model": ...}``, the JAX package's convention) or from ``cfg=``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch

from ..engine.predictor import DetectionPredictor
from ..engine.predictors_task import TASK_PREDICTORS
from ..engine.validator import DetectionValidator
from ..engine.validators_task import TASK_VALIDATORS
from ..nn.tasks import TASK_MODELS
from ..utils import coco_names
from ..utils.checkpoint import load_weights_npz, model_from_ref
from ..utils.fuse import fuse_bn, fused_stem_fuse
from ..utils.weights import state_dict_from_jax

TASK_ITEM = "ROADMAP.md §1.E item 13 (the task heads' training: losses, trainers; SemanticSegment)"
VAL_KEYS = {"detect": {"data", "imgsz", "batch", "conf", "iou", "max_det", "max_nms", "max_gt", "save_json",
                       "compute_dtype"},
            "segment": {"data", "imgsz", "batch", "conf", "iou", "max_det", "max_gt", "compute_dtype"},  # pose, obb
            "classify": {"data", "imgsz", "batch", "compute_dtype"}}
OTHER_TASKS = {"semantic": TASK_ITEM, "world": "ROADMAP.md §1.I item 21", "yoloe": "ROADMAP.md §1.I item 21",
               "rtdetr": "ROADMAP.md §1.I item 21"}


def guess_task(name: str) -> str:
    """The task a model name implies (JAX ``YOLO._guess_task``): ``-seg`` segment,
    ``-pose``, ``-obb``, ``-cls`` classify, ``-semantic``; else detect."""
    for key in ("seg", "pose", "obb", "cls", "semantic"):
        if f"-{key}" in name or f"_{key}" in name:
            return {"seg": "segment", "cls": "classify"}.get(key, key)
    for key in ("rtdetr", "yoloe", "world"):
        if key in name:
            return key
    return "detect"


def _npz_graph(path: Path, meta: dict, cfg, sd: dict):
    """(graph, nc) of a weights file: ``cfg``, else the file's ``__meta__.model``,
    else a ``<file>.json`` beside it; nc from the Detect head's class convs."""
    sidecar = Path(f"{path}.json")
    ref = cfg or meta.get("model") or (json.loads(sidecar.read_text()).get("model") if sidecar.exists() else None)
    if not ref:
        raise ValueError(f"{path} does not name its graph: pass cfg= (a model name or config dict)")
    ref = model_from_ref(ref) if isinstance(ref, str) else ref
    if isinstance(ref, str):
        ref = ref.removesuffix(".yaml")
    nc = next((v.shape[0] for k, v in sd.items() if k.endswith((".cv3.0.2.weight", ".linear.weight"))), None)
    return ref, nc


class YOLO:
    def __init__(self, model="yolo-master-n", *, device="cuda", nc: Optional[int] = None, seed: int = 0,
                 task: Optional[str] = None, cfg=None):
        task = task or guess_task(str(cfg if isinstance(cfg, str) else model))
        if task in OTHER_TASKS:
            raise NotImplementedError(f"task '{task}' is not ported yet: {OTHER_TASKS[task]}")
        if task not in TASK_MODELS:
            raise KeyError(f"unknown task '{task}' (choices: {list(TASK_MODELS)})")
        self.task = task
        self.device = torch.device(device)
        self.model_name = str(model)
        weights = None
        if str(model).endswith(".npz"):
            weights, meta = load_weights_npz(model)
            model, file_nc = _npz_graph(Path(model), meta, cfg, weights)
            nc = nc or file_nc
        self.cfg = model  # the graph: a model name or a config dict
        self.model = TASK_MODELS[task](model, nc=nc, seed=seed).eval()
        if weights is not None:
            self.model.load_state_dict(weights, strict=True)
        self._to_device()
        self.names: Dict[int, str] = coco_names() if self.model.nc == 80 else {i: str(i) for i in range(self.model.nc)}
        self._predictor: Optional[DetectionPredictor] = None
        self._predict_cfg: dict = {}

    def _to_device(self):
        self.model.to(self.device, memory_format=torch.channels_last)

    # -- weights ---------------------------------------------------------------
    def load_state_dict(self, state_dict) -> "YOLO":
        """Load an ultralytics-named state_dict (unfused model; strict)."""
        self.model.load_state_dict(state_dict, strict=True)
        self._to_device()
        self._predictor = None  # a predictor's bf16 copy holds the old weights
        return self

    def load_jax_params(self, params_np) -> "YOLO":
        """Load the JAX package's parameter tree (numpy leaves) for the same YAML."""
        return self.load_state_dict(state_dict_from_jax(params_np))

    # -- deploy ------------------------------------------------------------------
    def fuse(self, s2d: bool = False, pallas_stem: bool = False, imgsz: int = 640) -> "YOLO":
        """Fold BN into the convs and replace the two stem convs by the fused stem
        kernel over uint8 NHWC input (``ops/stem.py``). Inference only.

        The JAX facade's keywords are taken and change nothing here: the stem
        kernel is always installed (``pallas_stem``), the space-to-depth stem
        is a TPU re-layout whose output is the plain stem's (``s2d``), and the
        kernel reads any image size (``imgsz``)."""
        fuse_bn(self.model)
        fused_stem_fuse(self.model)
        self._to_device()
        self._predictor = None
        return self

    # -- inference ---------------------------------------------------------------
    def predict(self, source, **kwargs):
        """Run the model's task on a BGR HWC uint8 image, an image path, or a list of them
        (``engine/predictor.py``, ``engine/predictors_task.py``).

        Keyword arguments: imgsz, conf, iou, max_det, max_nms, agnostic_nms, classes, batch,
        compute_dtype (``torch.float32``, the default, or ``torch.bfloat16`` for detection: the
        predictor then runs a bf16 copy of the model, and this model stays fp32; a task
        model raises for bf16, ROADMAP.md §1.E item 13).
        """
        keys = {"imgsz", "conf", "iou", "max_det", "max_nms", "agnostic_nms", "classes", "batch", "compute_dtype"}
        unknown = set(kwargs) - keys
        if unknown:
            raise TypeError(f"unknown predict arguments: {sorted(unknown)}")
        if self._predictor is None or (kwargs and kwargs != self._predict_cfg):
            self._predictor = TASK_PREDICTORS[self.task](self.model, names=self.names, **kwargs)
            self._predict_cfg = kwargs
        return self._predictor(source)

    def __call__(self, source, **kwargs):
        return self.predict(source, **kwargs)

    # -- training --------------------------------------------------------------------
    def train(self, **kwargs) -> dict:
        """Train this model (``engine/trainer.py:DetectionTrainer``; its keyword
        arguments, ``data`` a dataset yaml), in bf16 mixed precision by default
        (``amp=True``; ``amp=False`` trains in fp32). The model ends with the
        EMA weights, in eval mode; ``save_dir`` (default ``runs/train``) holds
        ``best.npz``, ``last.npz``, ``results.csv``, the routing history and,
        with ``save_period``, the resume checkpoint. Returns the last val
        metrics and ``best_fitness``. With ``data`` a list of yamls, the model
        is fine-tuned on each from its current weights
        (``engine/trainer.py:MultiTrainer``, ``save_dir`` default
        ``runs/multitrain``), left as it was, and ``{run name: metrics}`` is
        returned."""
        from ..engine.trainer import DetectionTrainer, MultiTrainer

        if self.task != "detect":
            raise NotImplementedError(f"training task '{self.task}' is not ported yet: {TASK_ITEM}")
        data = kwargs.get("data")
        if isinstance(data, (list, tuple)):
            kwargs = dict(kwargs)
            kwargs.pop("data")
            save_dir = kwargs.pop("save_dir", "runs/multitrain")
            return MultiTrainer(self, data, save_dir=save_dir, **kwargs).train()
        return DetectionTrainer(self, **kwargs).train()

    # -- validation ----------------------------------------------------------------
    def val(self, **kwargs) -> dict:
        """mAP of the model on a dataset yaml's val split (``engine/validator.py``).

        Keyword arguments: data, imgsz, batch, conf, iou, max_det, max_nms, max_gt,
        save_json (a path for COCO-format predictions), compute_dtype
        (``torch.float32``, the default, or ``torch.bfloat16``: the model's bf16 copy).
        Returns precision, recall, mAP50, mAP50-95, fitness, images, sec and speed
        (ms per image of load, device and match).

        A task model runs its task's validator (``engine/validators_task.py``; fp32):
        segment, pose and obb take data, imgsz, batch, conf, iou, max_det and max_gt
        and add their mask_/pose_ metrics; classify takes data (a directory with a
        folder per class under ``val``), imgsz (default 224) and batch, and returns
        top1 and top5.
        """
        keys = VAL_KEYS.get(self.task, VAL_KEYS["segment"])
        unknown = set(kwargs) - keys
        if unknown:
            raise TypeError(f"unknown val arguments: {sorted(unknown)}")
        if self.task != "detect":
            return TASK_VALIDATORS[self.task](self.model, **kwargs)()
        return DetectionValidator(self.model, **kwargs)()
