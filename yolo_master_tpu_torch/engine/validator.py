"""Detection validator (counterpart of ``yolo_master_tpu/engine/validator.py``;
reference: ultralytics/engine/validator.py + models/yolo/detect/val.py).

    YOLO("yolo-master-n").fuse().val(data="data.yaml", imgsz=640, batch=16)

Host: ``data/dataset.py`` loads, rect-resizes and letterboxes each image into a
uint8 batch. Device: the batch goes to the model's device as it is (uint8 for
a fused model, whose stem kernel reads it; float /255 otherwise) ->
``model.forward_predict`` (xywh boxes, sigmoid probabilities) -> batched NMS
with multi-label candidates (conf 0.001, iou 0.7, ``max_nms`` 4096: the
reference's val defaults). The candidates are the top ``max_nms`` of every
(anchor, class) probability, as the JAX package's ``lax.top_k`` takes them:
not the predictor's top-k of logits, since probabilities that saturate in
fp32 tie where their logits did not, and the tie order decides the keep set.

Host (:meth:`DetectionValidator.update`): predictions and targets are
unletterboxed to the ORIGINAL image, predictions clipped to its bounds, then
greedy matching at 10 IoU thresholds and ``ap_per_class`` (``utils/metrics.py``),
and with ``save_json`` COCO-format rows (80 COCO classes mapped to the sparse
ids 1-90).

An end2end (NMS-free) head's detections are the predictor's graph at the
validator's conf and ``max_det``: ``forward_predict`` (xyxy boxes) ->
``Detect.postprocess_end2end`` -> ``engine/predictor.py:end2end_detections``,
with no NMS, as the upstream end2end validator does. (The JAX validator feeds
that xyxy decode to its NMS, which reads xywh.)

``compute_dtype=torch.bfloat16`` runs the forward on the model's current bf16
copy (``utils/fuse.py:current_dtype_copy``), as the predictor does; decode,
NMS and matching stay fp32.

The result carries ``speed``: ms per image of the host's load + resize +
letterbox, of the device's forward + decode + NMS (CUDA events on the card),
and of the host's matching.
"""

from __future__ import annotations

import json
import logging
import math
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import DataLoader, YOLODataset
from ..ops.nms import non_max_suppression
from ..utils.coco import COCO80_TO_COCO91
from ..utils.fuse import current_dtype_copy
from ..utils.metrics import DetMetrics
from .predictor import COMPUTE_DTYPES, end2end_detections

LOGGER = logging.getLogger(__name__)


def timed_batches(loader, device, preprocess, run, update) -> Dict[str, float]:
    """One epoch of ``loader``: each batch's ``run(preprocess(images))`` on ``device``,
    its outputs (a dict of tensors, or of such dicts) to numpy, then ``update(batch,
    outputs)`` on the host. Returns the seconds of the host's loading, the
    device's step (CUDA events on the card, the host clock elsewhere) and the
    host's update, summed."""
    on_card = device.type == "cuda"
    load_s = match_s = 0.0
    device_ms = []  # (start, end) CUDA events on the card, ms on the host clock elsewhere
    batches = loader.epoch()
    while True:
        t_load = time.perf_counter()
        batch = next(batches, None)
        load_s += time.perf_counter() - t_load
        if batch is None:
            break
        x = preprocess(batch["images"])
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = run(x)
            end.record()
            device_ms.append((start, end))
        else:
            t_dev = time.perf_counter()
            out = run(x)
            device_ms.append((time.perf_counter() - t_dev) * 1e3)
        out = {k: ({n: t.cpu().numpy() for n, t in v.items()} if isinstance(v, dict) else v.cpu().numpy())
               for k, v in out.items()}
        t_match = time.perf_counter()
        update(batch, out)
        match_s += time.perf_counter() - t_match
    if on_card:
        torch.cuda.synchronize(device)
        device_ms = [s.elapsed_time(e) for s, e in device_ms]
    return {"load": load_s, "device": sum(device_ms) / 1e3, "match": match_s}


class DetectionValidator:
    def __init__(self, model, data: Optional[str] = None, imgsz: int = 640, batch: int = 8, conf: float = 0.001,
                 iou: float = 0.7, max_det: int = 300, max_nms: int = 4096, max_gt: int = 128,
                 save_json: Optional[str] = None, compute_dtype: torch.dtype = torch.float32):
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
        self.source_model = model
        self.device = next(model.parameters()).device
        self.data = data
        self.imgsz = imgsz
        self.batch = batch
        self.conf, self.iou = conf, iou
        self.max_det, self.max_nms = max_det, max_nms
        self.max_gt = max_gt
        self.save_json = save_json
        self.compute_dtype = compute_dtype
        self._class_map = None

    @property
    def model(self):
        """The model the forward runs: ``source_model`` in fp32; in bf16 its copy
        as the model is now (``engine/predictor.py:DetectionPredictor.model``)."""
        if self.compute_dtype == torch.float32:
            return self.source_model
        return current_dtype_copy(self.source_model, self.compute_dtype)

    # -- device graph --------------------------------------------------------
    def preprocess(self, images: np.ndarray) -> torch.Tensor:
        """uint8 RGB NHWC batch (numpy) -> the model's input on its device: uint8
        where the model folds /255 into layer 0, else float /255 in the compute dtype."""
        x = torch.from_numpy(images).to(self.device, non_blocking=True)
        if getattr(self.source_model, "uint8_input", False):
            return x
        return (x.float() / 255.0).to(self.compute_dtype)

    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> dict:
        """Input batch on the device -> fixed-shape detections (device tensors)."""
        model = self.model
        decoded = model.forward_predict(x)
        if model.head.end2end:
            return end2end_detections(model.head.postprocess_end2end(decoded, self.max_det), self.conf)
        return non_max_suppression(decoded, nc=model.nc, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det, max_nms=self.max_nms, multi_label=True)

    # -- the loop --------------------------------------------------------------
    def __call__(self) -> Dict[str, float]:
        dataset = YOLODataset(self.data, split="val", imgsz=self.imgsz, max_gt=self.max_gt)
        loader = DataLoader(dataset, self.batch, shuffle=False, images=np.uint8)
        metrics = DetMetrics(self.source_model.nc, dataset.names)
        jdict = [] if self.save_json else None
        # real COCO annotations use sparse category ids 1-90; map the
        # contiguous model index when the dataset is COCO (reference pred_to_json)
        names = dataset.names
        is_coco = len(names) == 80 and names.get(0) == "person" and names.get(79) == "toothbrush"
        self._class_map = COCO80_TO_COCO91 if is_coco else None
        seen = 0

        def update(batch, det):
            nonlocal seen
            seen = self.update(metrics, det, batch, dataset, seen, jdict)

        t0 = time.perf_counter()
        speed_s = timed_batches(loader, self.device, self.preprocess, self.run, update)
        if jdict is not None:
            Path(self.save_json).write_text(json.dumps(jdict))
            LOGGER.info(f"saved {len(jdict)} COCO-format predictions to {self.save_json}")
        out = metrics.compute()
        out["images"] = seen
        out["sec"] = time.perf_counter() - t0
        out["speed"] = {k: v * 1e3 / max(seen, 1) for k, v in speed_s.items()}
        LOGGER.info(
            f"val: {seen} imgs  P {out['precision']:.3f}  R {out['recall']:.3f}  "
            f"mAP50 {out['mAP50']:.3f}  mAP50-95 {out['mAP50-95']:.3f}  ({out['sec']:.1f}s)"
        )
        return out

    # -- host half -------------------------------------------------------------
    def update(self, metrics: DetMetrics, det: Dict[str, np.ndarray], batch: Dict[str, np.ndarray],
               dataset: YOLODataset, seen: int, jdict: Optional[list] = None) -> int:
        """One batch's detections (numpy ``boxes``, ``scores``, ``classes``,
        ``valid``, letterboxed space) and its targets into ``metrics`` (and COCO
        rows into ``jdict``); ``seen`` images came before it. Returns the new
        count: the wrap-padded tail of the last batch is skipped."""
        n_img = len(dataset)
        for i in range(batch["images"].shape[0]):
            if seen >= n_img:
                break  # wrap-padded tail duplicates
            n = int(det["valid"][i].sum())
            gt_n = int(batch["mask"][i].sum())
            # match in ORIGINAL image space (reference scale_boxes before
            # update_metrics): unletterbox preds+GT, clip preds to bounds
            h0, w0 = dataset.shapes[seen]
            r, pad_x, pad_y = self._letterbox_params(h0, w0)
            pboxes = self._to_original(det["boxes"][i, :n], r, pad_x, pad_y, w0, h0, clip=True)
            gboxes = self._to_original(batch["boxes"][i, :gt_n], r, pad_x, pad_y, w0, h0, clip=False)
            metrics.update(pboxes, det["scores"][i, :n], det["classes"][i, :n], gboxes, batch["classes"][i, :gt_n])
            if jdict is not None and n:
                self._append_json(jdict, dataset, seen, pboxes, det, i, n)
            seen += 1
        return seen

    def _letterbox_params(self, h0: int, w0: int):
        """Val preprocess transform, mirroring the reference composition:
        base.load_image rect-resize (long side -> imgsz, CEIL dims, up- and
        down-scaling) + LetterBox center pads. The returned gain is the
        H-axis resize ratio applied to BOTH axes — exactly the reference's
        scale_boxes with ratio_pad ((h1/h0, w1/w0), (left, top)), whose
        gain = ratio_pad[0][0] (utils/ops.py:148)."""
        r0 = self.imgsz / max(h0, w0)
        h1 = min(math.ceil(h0 * r0), self.imgsz) if r0 != 1 else h0
        w1 = min(math.ceil(w0 * r0), self.imgsz) if r0 != 1 else w0
        pad_x = round((self.imgsz - w1) / 2 - 0.1)
        pad_y = round((self.imgsz - h1) / 2 - 0.1)
        return h1 / h0, pad_x, pad_y

    @staticmethod
    def _to_original(boxes, r, pad_x, pad_y, w0, h0, clip: bool):
        boxes = np.asarray(boxes, np.float32).copy()
        boxes[:, [0, 2]] = (boxes[:, [0, 2]] - pad_x) / r
        boxes[:, [1, 3]] = (boxes[:, [1, 3]] - pad_y) / r
        if clip:
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w0)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h0)
        return boxes

    def _append_json(self, jdict, dataset, img_index, boxes, det, i, n):
        """Append COCO-format rows from already-unletterboxed boxes
        (reference detect/val.py pred_to_json)."""
        stem = Path(dataset.img_files[img_index]).stem
        image_id = int(stem) if stem.isnumeric() else img_index
        cmap = self._class_map
        for j in range(n):
            x1, y1, x2, y2 = boxes[j]
            c = int(det["classes"][i, j])
            jdict.append({
                "image_id": image_id,
                "category_id": cmap[c] if cmap else c,
                "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                "score": round(float(det["scores"][i, j]), 5),
            })
