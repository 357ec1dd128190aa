"""The task heads' predictors (counterpart of ``yolo_master_tpu/engine/predictors_task.py``).

Each subclasses :class:`~.predictor.DetectionPredictor` and changes only the
device graph (what comes back) and the host's ``Results``:

- :class:`SegmentationPredictor`: forward -> ``Segment.decode`` -> batched NMS
  (the NMS kernel on the card) with the 32 mask coefficients riding along as
  NMS ``extra`` columns, and the prototypes; on the host each kept box's mask
  is sigmoid(coefficients @ prototypes) > 0.5, cropped to the box at the
  prototypes' resolution, un-letterboxed with ``cv2.resize`` (INTER_LINEAR).
- :class:`PosePredictor`: forward -> ``Pose.decode`` -> batched NMS with the
  keypoints as ``extra`` columns; un-letterboxed on the host.
- :class:`OBBPredictor`: forward -> ``OBB.decode`` -> the rotated fast-NMS
  (``ops/nms.py:rotated_non_max_suppression``, plain PyTorch); xywhr
  un-letterboxed on the host.
- :class:`ClassificationPredictor`: a centre crop to a square, resized to 224,
  no letterbox; the eval forward's probabilities into ``Results.probs``. (The
  JAX predictor applies a second softmax to them; the order of the classes is
  the same.)

Segment and Pose run NMS on probabilities (``decode``), as the JAX task
predictors do, not the detection predictor's top-k of logits. fp32 only: a
bf16 compute dtype comes with the task heads' training (ROADMAP.md §1.E
item 13).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.nms import non_max_suppression, rotated_non_max_suppression
from ..utils.metrics import sigmoid_np
from .predictor import DetectionPredictor
from .results import Keypoints, Masks, Results

TASK_BF16_ITEM = "ROADMAP.md §1.E item 13 (bf16 of the task heads comes with their training)"


def refuse_task_bf16(task: str, compute_dtype: torch.dtype) -> None:
    if compute_dtype != torch.float32:
        raise NotImplementedError(f"compute_dtype={compute_dtype} on a {task} model: {TASK_BF16_ITEM}")


class _TaskPredictor(DetectionPredictor):
    def __init__(self, model, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        refuse_task_bf16(model.task, compute_dtype)
        super().__init__(model, *args, compute_dtype=compute_dtype, **kwargs)


class _NMSTaskPredictor(_TaskPredictor):
    """forward -> the head's decode (probabilities, extra columns) -> batched NMS."""

    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> dict:
        model = self.model
        preds = model(x)
        det = non_max_suppression(model.head.decode(preds), nc=model.nc, conf_thres=self.conf, iou_thres=self.iou,
                                  max_det=self.max_det, max_nms=self.max_nms, agnostic=self.agnostic,
                                  class_mask=self.class_mask)
        if "proto" in preds:
            det["proto"] = preds["proto"].permute(0, 2, 3, 1)  # NCHW -> [B, mh, mw, nm]
        return det


def assemble_masks(coefs: np.ndarray, proto: np.ndarray, boxes: np.ndarray, imgsz, orig_shape, ratio, pad):
    """One image's masks in the original image, bool [n, H0, W0]: sigmoid(coefs
    [n, nm] @ proto [mh, mw, nm]) > 0.5 after a crop to each letterboxed box
    [n, 4] (xyxy) at the prototypes' resolution, the letterbox's content window
    resized to the original size (INTER_LINEAR)."""
    import cv2

    n = len(coefs)
    mh, mw, nm = proto.shape
    pm = sigmoid_np(coefs @ proto.reshape(-1, nm).T).reshape(n, mh, mw)
    sx, sy = mw / imgsz[1], mh / imgsz[0]
    ys, xs = np.mgrid[0:mh, 0:mw]
    masks = np.zeros((n, *orig_shape), bool)
    cx1, cy1 = pad[0] * sx, pad[1] * sy  # the letterbox's content window, in prototype coordinates
    cx2 = (pad[0] + orig_shape[1] * ratio[0]) * sx
    cy2 = (pad[1] + orig_shape[0] * ratio[1]) * sy
    for j in range(n):
        x1, y1, x2, y2 = boxes[j] * np.array([sx, sy, sx, sy])
        m = pm[j] * ((xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2))
        crop = m[int(round(cy1)): max(int(round(cy2)), int(round(cy1)) + 1),
                 int(round(cx1)): max(int(round(cx2)), int(round(cx1)) + 1)]
        masks[j] = cv2.resize(crop.astype(np.float32), (orig_shape[1], orig_shape[0]),
                              interpolation=cv2.INTER_LINEAR) > 0.5
    return masks


class SegmentationPredictor(_NMSTaskPredictor):
    """Detections + instance masks."""

    def _build_result(self, path, orig_img, meta, det) -> Results:
        proto = det.pop("proto")
        r = super()._build_result(path, orig_img, meta, det)
        n = len(r.boxes)
        if n:
            orig_shape, ratio, pad = meta
            r.masks = Masks(assemble_masks(det["extra"][:n, :proto.shape[-1]], proto, det["boxes"][:n],
                                           self.imgsz, orig_shape, ratio, pad), orig_shape)
        return r


class PosePredictor(_NMSTaskPredictor):
    """Detections + keypoints [n, nk, nd] in the original image (clipped to it)."""

    def _build_result(self, path, orig_img, meta, det) -> Results:
        r = super()._build_result(path, orig_img, meta, det)
        orig_shape, ratio, pad = meta
        n = len(r.boxes)
        nk, nd = self.source_model.head.kpt_shape
        k = det["extra"][:n, : nk * nd].reshape(n, nk, nd).copy()
        k[..., 0] = ((k[..., 0] - pad[0]) / ratio[0]).clip(0, orig_shape[1])
        k[..., 1] = ((k[..., 1] - pad[1]) / ratio[1]).clip(0, orig_shape[0])
        r.keypoints = Keypoints(k, orig_shape) if n else None
        return r


class OBBPredictor(_TaskPredictor):
    """Oriented detections: xywhr, score and class in ``Results.obb``. The
    rotated NMS takes no class filter (``classes``), as in the JAX package."""

    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> dict:
        model = self.model
        return rotated_non_max_suppression(model.head.decode(model(x)), nc=model.nc, conf_thres=self.conf,
                                           iou_thres=self.iou, max_det=self.max_det, max_nms=self.max_nms,
                                           agnostic=self.agnostic)

    def _build_result(self, path, orig_img, meta, det) -> Results:
        orig_shape, ratio, pad = meta
        n = int(det["valid"].sum())
        rb = det["rboxes"][:n]
        data = np.stack([(rb[:, 0] - pad[0]) / ratio[0], (rb[:, 1] - pad[1]) / ratio[1], rb[:, 2] / ratio[0],
                         rb[:, 3] / ratio[1], rb[:, 4], det["scores"][:n], det["classes"][:n]], -1)
        return Results(orig_img, path=path, names=self.names, obb=data)


class ClassificationPredictor(_TaskPredictor):
    """Whole-image classification into ``Results.probs``."""

    def __init__(self, model, *args, imgsz=224, **kwargs):
        super().__init__(model, *args, imgsz=imgsz, **kwargs)

    def preprocess(self, images):
        """Centre crop to a square, resize to imgsz (INTER_LINEAR), BGR -> RGB:
        uint8 where the model folds /255 into layer 0, else float32 /255."""
        import cv2

        u8 = getattr(self.source_model, "uint8_input", False)
        th, tw = self.imgsz
        processed, meta = [], []
        for im in images:
            h, w = im.shape[:2]
            s = min(h, w)
            y0, x0 = (h - s) // 2, (w - s) // 2
            rgb = np.ascontiguousarray(cv2.resize(im[y0: y0 + s, x0: x0 + s], (tw, th),
                                                  interpolation=cv2.INTER_LINEAR)[..., ::-1])
            processed.append(rgb if u8 else rgb.astype(np.float32) / 255.0)
            meta.append((im.shape[:2], (1.0, 1.0), (0.0, 0.0)))
        return torch.from_numpy(np.stack(processed)).to(self.device, non_blocking=True), meta

    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> dict:
        return {"probs": self.model.forward_predict(x)}

    def _build_result(self, path, orig_img, meta, det) -> Results:
        return Results(orig_img, path=path, names=self.names, probs=det["probs"])


TASK_PREDICTORS = {
    "detect": DetectionPredictor,
    "segment": SegmentationPredictor,
    "pose": PosePredictor,
    "obb": OBBPredictor,
    "classify": ClassificationPredictor,
}
