"""The task heads' validators (counterpart of ``yolo_master_tpu/engine/validators_task.py``).

Segment (box and mask mAP), Pose (box and OKS mAP), OBB (probIoU mAP) and
Classify (top-1 / top-5). Host: the task dataset's uint8 batches
(``data/dataset.py``). Device: the batch goes to the model's device as it is
(uint8 for a fused model, whose stem kernel reads it; float /255 otherwise)
-> the head's decode -> multi-label NMS at conf 0.001, iou 0.7, ``max_nms``
4096 (the batched NMS kernel on the card; the rotated fast-NMS for OBB).
Host: matching in letterboxed pixels at 10 IoU thresholds with the task's
IoU (mask IoU over binarised prototype masks cropped to the box, OKS over
keypoints, probIoU over rotated boxes), then ``ap_per_class``
(``utils/metrics.py``), as the JAX validators do. The result carries
``speed``: ms per image of the host's load, the device's forward + decode +
NMS (CUDA events on the card), and the host's matching. fp32 only (ROADMAP.md
§1.E item 13).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..data.dataset import ClassificationDataset, DataLoader, OBBDataset, PoseDataset, SegmentDataset
from ..ops.nms import non_max_suppression, rotated_non_max_suppression
from ..ops.rotated import probiou
from ..utils.metrics import IOUV, ap_per_class, box_iou_np, match_predictions, sigmoid_np
from .predictors_task import refuse_task_bf16
from .validator import timed_batches

LOGGER = logging.getLogger(__name__)

OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89,
                      0.89], np.float32) / 10.0


def mask_iou_np(gt_masks: np.ndarray, pred_masks: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """[M, H, W] x [N, H, W] binary masks -> [M, N] IoU."""
    g = gt_masks.reshape(len(gt_masks), -1).astype(np.float32)
    p = pred_masks.reshape(len(pred_masks), -1).astype(np.float32)
    inter = g @ p.T
    return inter / (g.sum(1)[:, None] + p.sum(1)[None] - inter + eps)


def oks_np(gt_kpts: np.ndarray, pred_kpts: np.ndarray, areas: np.ndarray, ndim: int = 3,
           eps: float = 1e-7) -> np.ndarray:
    """Object keypoint similarity [M, N] (COCO's: e = d / ((2 sigma)^2 (area + eps) 2),
    over the keypoints visible in the ground truth, divided by their count + eps)."""
    m, nk = gt_kpts.shape[:2]
    sigmas = OKS_SIGMA if nk == 17 else np.ones(nk, np.float32) / nk
    d = ((gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2
         + (gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]) ** 2)
    vis = (gt_kpts[..., 2] != 0) if ndim == 3 else np.ones((m, nk), bool)
    e = d / ((2 * sigmas[None, None]) ** 2 * (areas[:, None, None] + eps) * 2)
    return np.sum(np.exp(-e) * vis[:, None, :], -1) / (vis.sum(-1)[:, None] + eps)


def probiou_np(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Pairwise probIoU [M, N] of xywhr boxes (``ops/rotated.py:probiou`` in fp32 on the CPU)."""
    g = torch.from_numpy(np.asarray(gt, np.float32))[:, None, :]
    p = torch.from_numpy(np.asarray(pred, np.float32))[None, :, :]
    return probiou(g, p).numpy()


NO_MATCH = np.zeros((0, len(IOUV)), bool)  # an image without detections


class _TaskValidator:
    """Shared loop: device forward + decode + NMS a batch, matching one image at a time on the host."""

    dataset_cls = None

    def __init__(self, model, data=None, imgsz: int = 640, batch: int = 8, conf: float = 0.001, iou: float = 0.7,
                 max_det: int = 300, max_gt: int = 64, compute_dtype: torch.dtype = torch.float32, **dkw):
        refuse_task_bf16(model.task, compute_dtype)
        self.model = model
        self.device = next(model.parameters()).device
        self.data = data
        self.imgsz, self.batch = imgsz, batch
        self.conf, self.iou, self.max_det = conf, iou, max_det
        self.max_nms = 4096
        self.max_gt = max_gt
        self.dkw = dkw

    def dataset(self):
        return self.dataset_cls(self.data, split="val", imgsz=self.imgsz, max_gt=self.max_gt, **self.dkw)

    def preprocess(self, images: np.ndarray) -> torch.Tensor:
        """uint8 RGB NHWC batch (numpy) -> the model's input on its device: uint8
        where the model folds /255 into layer 0, else float32 /255."""
        x = torch.from_numpy(images).to(self.device, non_blocking=True)
        return x if getattr(self.model, "uint8_input", False) else x.float() / 255.0

    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> dict:
        """Input batch on the device -> {"det": fixed-shape detections, ...} (device tensors)."""
        model = self.model
        preds = model(x)
        det = non_max_suppression(model.head.decode(preds), nc=model.nc, conf_thres=self.conf, iou_thres=self.iou,
                                  max_det=self.max_det, max_nms=self.max_nms, multi_label=True)
        out = {"det": det}
        if "proto" in preds:
            out["proto"] = preds["proto"].permute(0, 2, 3, 1)  # NCHW -> [B, mh, mw, nm]
        return out

    def __call__(self, dataset=None) -> Dict[str, float]:
        ds = dataset or self.dataset()
        stats = {"box": [], "task": []}
        seen = 0

        def update(batch, out):
            nonlocal seen
            for i in range(batch["images"].shape[0]):
                if seen >= len(ds):
                    break  # the wrap-padded tail of the last batch
                self.update(stats, out, batch, i)
                seen += 1

        t0 = time.perf_counter()
        speed_s = timed_batches(DataLoader(ds, self.batch, shuffle=False, images=np.uint8), self.device,
                                self.preprocess, self.run, update)
        res = self.compute(stats)
        res.update(images=seen, sec=time.perf_counter() - t0,
                   speed={k: v * 1e3 / max(seen, 1) for k, v in speed_s.items()})
        LOGGER.info(f"{type(self).__name__}: {seen} imgs {res}")
        return res

    def _box_stats(self, stats, det, batch, i):
        """Append the image's box matches; returns (n, gt_n, boxes, scores, classes, gt_boxes, gt_classes)."""
        n = int(det["valid"][i].sum())
        gt_n = int(batch["mask"][i].sum())
        boxes, scores, cls = det["boxes"][i, :n], det["scores"][i, :n], det["classes"][i, :n]
        gt_boxes, gt_cls = batch["boxes"][i, :gt_n], batch["classes"][i, :gt_n]
        iou = box_iou_np(gt_boxes, boxes) if n and gt_n else np.zeros((gt_n, n))
        stats["box"].append((match_predictions(cls, gt_cls, iou) if n else NO_MATCH, scores, cls, gt_cls))
        return n, gt_n, boxes, scores, cls, gt_boxes, gt_cls

    @staticmethod
    def _ap_from(stats) -> Dict[str, float]:
        if not stats:
            return {"mAP50": 0.0, "mAP50-95": 0.0}
        tp, conf, pcls, tcls = (np.concatenate([s[j] for s in stats]) for j in range(4))
        if tcls.size == 0:
            return {"mAP50": 0.0, "mAP50-95": 0.0}
        r = ap_per_class(tp, conf, pcls, tcls)
        return {"mAP50": float(r["ap50"].mean()) if r["ap50"].size else 0.0,
                "mAP50-95": float(r["ap"].mean()) if r["ap"].size else 0.0}


class SegmentationValidator(_TaskValidator):
    """Box and mask mAP (``mask_mAP50``, ``mask_mAP50-95``)."""

    dataset_cls = SegmentDataset

    def update(self, stats, out, batch, i):
        n, gt_n, boxes, scores, cls, _, gt_cls = self._box_stats(stats, out["det"], batch, i)
        proto = out["proto"][i]  # [mh, mw, nm]
        mh, mw = proto.shape[:2]
        if n:  # sigmoid(coefficients @ prototypes) > 0.5, cropped to the boxes
            pm = sigmoid_np(out["det"]["extra"][i, :n] @ proto.reshape(-1, proto.shape[-1]).T)
            pm = pm.reshape(n, mh, mw) > 0.5
            scale = mh / self.imgsz
            ys, xs = np.mgrid[0:mh, 0:mw]
            for j in range(n):
                x1, y1, x2, y2 = boxes[j] * scale
                pm[j] &= (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
        else:
            pm = np.zeros((0, mh, mw), bool)
        gm = batch["masks"][i, :gt_n] > 0.5
        miou = mask_iou_np(gm, pm) if n and gt_n else np.zeros((gt_n, n))
        stats["task"].append((match_predictions(cls, gt_cls, miou) if n else NO_MATCH, scores, cls, gt_cls))

    def compute(self, stats) -> Dict[str, float]:
        box, mask = self._ap_from(stats["box"]), self._ap_from(stats["task"])
        return {"mAP50": box["mAP50"], "mAP50-95": box["mAP50-95"], "mask_mAP50": mask["mAP50"],
                "mask_mAP50-95": mask["mAP50-95"],
                "fitness": 0.45 * box["mAP50-95"] + 0.45 * mask["mAP50-95"] + 0.1 * (box["mAP50"] + mask["mAP50"]) / 2}


class PoseValidator(_TaskValidator):
    """Box and OKS mAP (``pose_mAP50``, ``pose_mAP50-95``)."""

    dataset_cls = PoseDataset

    def __init__(self, model, *args, **kwargs):
        kwargs.setdefault("kpt_shape", model.head.kpt_shape)
        super().__init__(model, *args, **kwargs)

    def update(self, stats, out, batch, i):
        n, gt_n, _, scores, cls, gt_boxes, gt_cls = self._box_stats(stats, out["det"], batch, i)
        nk = batch["keypoints"].shape[2]
        pk = out["det"]["extra"][i, :n].reshape(n, nk, -1) if n else np.zeros((0, nk, 3))
        areas = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]) * 0.53
        oks = oks_np(batch["keypoints"][i, :gt_n], pk, areas) if n and gt_n else np.zeros((gt_n, n))
        stats["task"].append((match_predictions(cls, gt_cls, oks) if n else NO_MATCH, scores, cls, gt_cls))

    def compute(self, stats) -> Dict[str, float]:
        box, pose = self._ap_from(stats["box"]), self._ap_from(stats["task"])
        return {"mAP50": box["mAP50"], "mAP50-95": box["mAP50-95"], "pose_mAP50": pose["mAP50"],
                "pose_mAP50-95": pose["mAP50-95"],
                "fitness": 0.45 * box["mAP50-95"] + 0.45 * pose["mAP50-95"] + 0.1 * box["mAP50"]}


class OBBValidator(_TaskValidator):
    """probIoU-matched rotated-box mAP, after the rotated fast-NMS."""

    dataset_cls = OBBDataset

    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> dict:
        model = self.model
        return {"det": rotated_non_max_suppression(model.head.decode(model(x)), nc=model.nc, conf_thres=self.conf,
                                                   iou_thres=self.iou, max_det=self.max_det, max_nms=self.max_nms,
                                                   multi_label=True)}

    def update(self, stats, out, batch, i):
        det = out["det"]
        n = int(det["valid"][i].sum())
        gt_n = int(batch["mask"][i].sum())
        scores, cls = det["scores"][i, :n], det["classes"][i, :n]
        gt_cls = batch["classes"][i, :gt_n]
        iou = probiou_np(batch["rboxes"][i, :gt_n], det["rboxes"][i, :n]) if n and gt_n else np.zeros((gt_n, n))
        stats["box"].append((match_predictions(cls, gt_cls, iou) if n else NO_MATCH, scores, cls, gt_cls))

    def compute(self, stats) -> Dict[str, float]:
        box = self._ap_from(stats["box"])
        return {"mAP50": box["mAP50"], "mAP50-95": box["mAP50-95"],
                "fitness": 0.9 * box["mAP50-95"] + 0.1 * box["mAP50"]}


class ClassificationValidator(_TaskValidator):
    """Top-1 / top-5 accuracy over ``data``/val (a folder per class)."""

    def __init__(self, model, data=None, imgsz: int = 224, batch: int = 16,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(model, data=data, imgsz=imgsz, batch=batch, compute_dtype=compute_dtype)

    def dataset(self):
        return ClassificationDataset(str(Path(self.data) / "val"), imgsz=self.imgsz)

    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> dict:
        return {"probs": self.model.forward_predict(x)}

    def update(self, stats, out, batch, i):
        order = np.argsort(-out["probs"][i])
        y = int(batch["classes"][i])
        stats["box"].append((order[0] == y, y in order[:5]))

    def compute(self, stats) -> Dict[str, float]:
        seen = max(len(stats["box"]), 1)
        top1 = sum(int(a) for a, _ in stats["box"]) / seen
        return {"top1": top1, "top5": sum(int(b) for _, b in stats["box"]) / seen, "fitness": top1}


TASK_VALIDATORS = {"segment": SegmentationValidator, "pose": PoseValidator, "obb": OBBValidator,
                   "classify": ClassificationValidator}
