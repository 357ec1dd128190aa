"""YOLO facade (counterpart of ``yolo_master_tpu/models/yolo.py``): detection only.

    YOLO("yolo-master-n").fuse().predict(images)
    YOLO("yolo-master-n").fuse().val(data="data.yaml", imgsz=640, batch=16)

The model runs on the card (``device="cuda"``) unless the caller asks for
another device, as the CPU tests do with ``device="cpu"``. Weights are drawn
from ``seed`` with a ``torch.Generator`` on the CPU, so one seed gives the
same model on every device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..engine.predictor import DetectionPredictor
from ..engine.validator import DetectionValidator
from ..nn.tasks import DetectionModel
from ..utils import coco_names
from ..utils.fuse import fuse_bn, fused_stem_fuse
from ..utils.weights import state_dict_from_jax


class YOLO:
    def __init__(self, model: str = "yolo-master-n", *, device="cuda", nc: Optional[int] = None, seed: int = 0):
        self.device = torch.device(device)
        self.model_name = str(model)
        self.model = DetectionModel(model, nc=nc, seed=seed).eval()
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
    def fuse(self) -> "YOLO":
        """Fold BN into the convs and replace the two stem convs by the fused stem
        kernel over uint8 NHWC input (``ops/stem.py``). Inference only."""
        fuse_bn(self.model)
        fused_stem_fuse(self.model)
        self._to_device()
        self._predictor = None
        return self

    # -- inference ---------------------------------------------------------------
    def predict(self, source, **kwargs):
        """Detect objects in a BGR HWC uint8 image, an image path, or a list of them.

        Keyword arguments: imgsz, conf, iou, max_det, max_nms, agnostic_nms, classes, batch,
        compute_dtype (``torch.float32``, the default, or ``torch.bfloat16``: the
        predictor then runs a bf16 copy of the model, and this model stays fp32).
        """
        keys = {"imgsz", "conf", "iou", "max_det", "max_nms", "agnostic_nms", "classes", "batch", "compute_dtype"}
        unknown = set(kwargs) - keys
        if unknown:
            raise TypeError(f"unknown predict arguments: {sorted(unknown)}")
        if self._predictor is None or (kwargs and kwargs != self._predict_cfg):
            self._predictor = DetectionPredictor(self.model, names=self.names, **kwargs)
            self._predict_cfg = kwargs
        return self._predictor(source)

    def __call__(self, source, **kwargs):
        return self.predict(source, **kwargs)

    # -- validation ----------------------------------------------------------------
    def val(self, **kwargs) -> dict:
        """mAP of the model on a dataset yaml's val split (``engine/validator.py``).

        Keyword arguments: data, imgsz, batch, conf, iou, max_det, max_nms, max_gt,
        save_json (a path for COCO-format predictions), compute_dtype
        (``torch.float32``, the default, or ``torch.bfloat16``: the model's bf16 copy).
        Returns precision, recall, mAP50, mAP50-95, fitness, images, sec and speed
        (ms per image of load, device and match).
        """
        keys = {"data", "imgsz", "batch", "conf", "iou", "max_det", "max_nms", "max_gt", "save_json",
                "compute_dtype"}
        unknown = set(kwargs) - keys
        if unknown:
            raise TypeError(f"unknown val arguments: {sorted(unknown)}")
        return DetectionValidator(self.model, **kwargs)()
