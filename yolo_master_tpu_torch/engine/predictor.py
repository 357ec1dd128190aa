"""Batched detection inference (counterpart of ``yolo_master_tpu/engine/predictor.py``).

Host: letterbox (``data/letterbox.py``) -> BGR->RGB -> uint8 NHWC for a model
whose layer 0 takes uint8 (``YOLO.fuse()``), else float /255. Device: forward
-> ``Detect.decode_topk`` -> batched NMS, with no host round trip between
them. Host: boxes back to the original image -> ``engine/results.py:Results``.
An end2end (NMS-free) head takes no NMS: forward -> ``Detect.decode`` ->
``Detect.postprocess_end2end`` -> :func:`end2end_detections` (the JAX
predictor's graph; ``iou``, ``max_nms`` and ``agnostic_nms`` do not apply).

``compute_dtype=torch.bfloat16`` runs the forward on a bf16 copy of the model
(``utils/fuse.py:compute_dtype_copy``), kept while the model stays as it was
and made anew when it changed (``utils/fuse.py:current_dtype_copy``): uint8
input goes to the fused stem as it is, float input is cast to bf16, and the
decode, NMS and detections stay fp32, as in the JAX package.

PyTorch runs eagerly, so there is no per-batch-size compile and no padding of
ragged batches to a power of two.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.letterbox import letterbox
from ..ops.nms import non_max_suppression
from ..utils.fuse import current_dtype_copy
from .results import Results

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def load_image(path: str) -> np.ndarray:
    """BGR HWC uint8 from an image file (needs OpenCV)."""
    import cv2

    im = cv2.imread(str(path))
    if im is None:
        raise FileNotFoundError(f"image not found or unreadable: {path}")
    return im


def expand_source(source) -> List[tuple]:
    """A source -> [(path, BGR image)]: an HWC uint8 array, a file path, or a list of them."""
    if isinstance(source, (list, tuple)):
        return [item for s in source for item in expand_source(s)]
    if isinstance(source, np.ndarray):
        return [("array", source)]
    return [(str(Path(source)), load_image(source))]


def end2end_detections(out: torch.Tensor, conf: float, class_mask: Optional[torch.Tensor] = None) -> dict:
    """An end2end head's [B, k, 6] selection (``Detect.postprocess_end2end``:
    xyxy box, score, class; best first) -> the fixed-shape detections that NMS
    gives elsewhere: ``valid`` where the score exceeds ``conf``, scores 0 and
    classes -1 where not valid, as the JAX predictor does. With ``class_mask``
    the detections of other classes are dropped after the selection, as the
    upstream end2end postprocess does (the JAX predictor ignores ``classes``
    here), and the valid ones move to the front in their order."""
    valid = out[..., 4] > conf
    if class_mask is not None:
        valid = valid & (class_mask[out[..., 5].long()] > 0)
        order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
        out, valid = out.gather(1, order[..., None].expand_as(out)), valid.gather(1, order)
    return {"boxes": out[..., :4], "scores": out[..., 4] * valid, "classes": torch.where(valid, out[..., 5], -1.0),
            "valid": valid}


class DetectionPredictor:
    def __init__(self, model, names: Optional[Dict[int, str]] = None, imgsz=640, conf: float = 0.25,
                 iou: float = 0.45, max_det: int = 300, max_nms: int = 2048, agnostic_nms: bool = False,
                 classes: Optional[Sequence[int]] = None, compute_dtype: torch.dtype = torch.float32,
                 batch: int = 1):
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.source_model = model
        self.device = next(model.parameters()).device
        self.names = names or {i: str(i) for i in range(model.nc)}
        self.imgsz = imgsz if isinstance(imgsz, (tuple, list)) else (imgsz, imgsz)
        self.conf, self.iou = conf, iou
        self.max_det, self.max_nms = max_det, max_nms
        self.agnostic = agnostic_nms
        self.batch = batch
        self.class_mask = None
        if classes is not None:
            m = torch.zeros(model.nc, dtype=torch.float32)
            m[list(classes)] = 1.0
            self.class_mask = m.to(self.device)

    @property
    def model(self):
        """The model the forward runs: ``source_model`` in fp32; in bf16 its copy
        as the model is now (a predict after any change to the model runs the
        changed model, as in the JAX package, whose predictor casts the current
        params per op)."""
        if self.compute_dtype == torch.float32:
            return self.source_model
        return current_dtype_copy(self.source_model, self.compute_dtype)

    # -- device graph --------------------------------------------------------
    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> dict:
        """NHWC batch on the model's device -> fixed-shape detections (device tensors)."""
        model = self.model
        preds = model(x)
        head = model.head
        if head.end2end:
            return end2end_detections(head.postprocess_end2end(head.decode(preds), self.max_det), self.conf,
                                      self.class_mask)
        if self.class_mask is None:
            # top-k-first: choosing anchors on the max class logit commutes with
            # the sigmoid, and single-label NMS only reads the top max_nms
            decoded = head.decode_topk(preds, k=self.max_nms)
        else:  # a class mask changes each anchor's ranking score
            decoded = head.decode(preds, raw_scores=True)
        return non_max_suppression(decoded, nc=model.nc, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det, max_nms=self.max_nms, agnostic=self.agnostic,
                                   class_mask=self.class_mask, scores_are_logits=True)

    # -- host pipeline ---------------------------------------------------------
    def preprocess(self, images: List[np.ndarray]):
        """Letterbox + BGR->RGB, stacked NHWC: uint8 when the model folds /255 into
        layer 0, else float32 /255 in the compute dtype. Returns (batch tensor on device, metadata)."""
        u8 = getattr(self.source_model, "uint8_input", False)
        processed, meta = [], []
        for im in images:
            lb, ratio, pad = letterbox(im, self.imgsz)
            rgb = np.ascontiguousarray(lb[..., ::-1])
            processed.append(rgb if u8 else rgb.astype(np.float32) / 255.0)
            meta.append((im.shape[:2], ratio, pad))
        x = torch.from_numpy(np.stack(processed)).to(self.device, non_blocking=True)
        return (x.to(self.compute_dtype) if x.is_floating_point() else x), meta

    def __call__(self, source) -> List[Results]:
        items = expand_source(source)
        results = []
        for s in range(0, len(items), self.batch):
            results.extend(self._run_batch(items[s: s + self.batch]))
        return results

    def _run_batch(self, items) -> List[Results]:
        t0 = time.perf_counter()
        images = [im for _, im in items]
        x, meta = self.preprocess(images)
        t1 = time.perf_counter()
        det = {k: v.cpu().numpy() for k, v in self.run(x).items()}
        t2 = time.perf_counter()
        results = [self._build_result(items[i][0], images[i], meta[i], {k: v[i] for k, v in det.items()})
                   for i in range(len(items))]
        t3 = time.perf_counter()
        bs = len(items)
        for r in results:
            r.speed = {"preprocess": (t1 - t0) / bs * 1e3, "inference": (t2 - t1) / bs * 1e3,
                       "postprocess": (t3 - t2) / bs * 1e3}
        return results

    def _build_result(self, path, orig_img, meta, det) -> Results:
        orig_shape, ratio, pad = meta
        n = int(det["valid"].sum())  # greedy keeps are a prefix of the slots
        boxes = det["boxes"][:n].copy()
        boxes[:, [0, 2]] = ((boxes[:, [0, 2]] - pad[0]) / ratio[0]).clip(0, orig_shape[1])
        boxes[:, [1, 3]] = ((boxes[:, [1, 3]] - pad[1]) / ratio[1]).clip(0, orig_shape[0])
        data = np.concatenate([boxes, det["scores"][:n, None], det["classes"][:n, None]], -1)
        return Results(orig_img, path=path, names=self.names, boxes=data)
