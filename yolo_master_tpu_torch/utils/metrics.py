"""Detection metrics (counterpart of ``yolo_master_tpu/utils/metrics.py``;
reference: ultralytics/utils/metrics.py:768-1000).

The port's own copy, numpy on the host: the device side produces fixed-shape
detections, matching happens here with exact reference semantics (greedy
unique matching over 10 IoU thresholds, 101-point AP).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)


def sigmoid_np(x: np.ndarray) -> np.ndarray:
    """Overflow-free sigmoid: exp only ever sees non-positive arguments."""
    x = np.asarray(x, np.float32)
    e = np.exp(-np.abs(x))
    return np.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def box_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU [N,M] of xyxy boxes (numpy)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def match_predictions(pred_classes: np.ndarray, true_classes: np.ndarray, iou: np.ndarray) -> np.ndarray:
    """Greedy unique matching at 10 IoU thresholds
    (reference engine/validator.py:296-333, non-scipy branch).

    Args:
        pred_classes [N], true_classes [M], iou [M, N] (labels x detections).

    Returns:
        correct [N, 10] bool.
    """
    correct = np.zeros((pred_classes.shape[0], len(IOUV)), dtype=bool)
    correct_class = true_classes[:, None] == pred_classes[None, :]
    iou = iou * correct_class
    for i, threshold in enumerate(IOUV):
        matches = np.nonzero(iou >= threshold)
        matches = np.array(matches).T  # [K, 2] (label, detection)
        if matches.shape[0]:
            if matches.shape[0] > 1:
                order = iou[matches[:, 0], matches[:, 1]].argsort()[::-1]
                matches = matches[order]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing (reference metrics.py smooth)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate([p * y[0], y, p * y[-1]])
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP (reference metrics.py:768-797)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] if len(recall) else 1.0], [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0], [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    trapz = np.trapezoid if hasattr(np, "trapezoid") else np.trapz
    ap = trapz(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


def ap_per_class(
    tp: np.ndarray,  # [D, 10] bool
    conf: np.ndarray,  # [D]
    pred_cls: np.ndarray,  # [D]
    target_cls: np.ndarray,  # [L]
    eps: float = 1e-16,
) -> Dict[str, np.ndarray]:
    """Per-class AP over IoU thresholds (reference metrics.py:800-900)."""
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    x = np.linspace(0, 1, 1000)

    ap = np.zeros((nc, tp.shape[1] if tp.ndim > 1 else 10))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = nt[ci]
        n_p = int(sel.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-x, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-x, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i_f1 = smooth(f1_curve.mean(0), 0.1).argmax() if nc else 0
    p, r, f1 = p_curve[:, i_f1], r_curve[:, i_f1], f1_curve[:, i_f1]
    return {
        "ap": ap,  # [nc, 10]
        "ap50": ap[:, 0] if ap.size else np.zeros(0),
        "precision": p,
        "recall": r,
        "f1": f1,
        "classes": unique_classes.astype(int),
        "nt": nt,
    }


class DetMetrics:
    """Accumulates per-image match stats and produces mAP metrics
    (reference utils/metrics.py DetMetrics + validator update_metrics)."""

    def __init__(self, nc: int, names: Optional[Dict[int, str]] = None):
        self.nc = nc
        self.names = names or {}
        self.stats: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []

    def update(self, pred_boxes, pred_conf, pred_cls, gt_boxes, gt_cls):
        """One image: preds (xyxy px, conf, cls) and GT (xyxy px, cls)."""
        if len(pred_boxes) == 0:
            correct = np.zeros((0, len(IOUV)), bool)
        elif len(gt_boxes) == 0:
            correct = np.zeros((len(pred_boxes), len(IOUV)), bool)
        else:
            iou = box_iou_np(np.asarray(gt_boxes), np.asarray(pred_boxes))
            correct = match_predictions(np.asarray(pred_cls), np.asarray(gt_cls), iou)
        self.stats.append((correct, np.asarray(pred_conf), np.asarray(pred_cls), np.asarray(gt_cls)))

    def compute(self) -> Dict[str, float]:
        if not self.stats:
            return {"mAP50": 0.0, "mAP50-95": 0.0, "precision": 0.0, "recall": 0.0}
        tp = np.concatenate([s[0] for s in self.stats])
        conf = np.concatenate([s[1] for s in self.stats])
        pcls = np.concatenate([s[2] for s in self.stats])
        tcls = np.concatenate([s[3] for s in self.stats])
        if tcls.size == 0:
            return {"mAP50": 0.0, "mAP50-95": 0.0, "precision": 0.0, "recall": 0.0}
        res = ap_per_class(tp, conf, pcls, tcls)
        out = {
            "mAP50": float(res["ap50"].mean()) if res["ap50"].size else 0.0,
            "mAP50-95": float(res["ap"].mean()) if res["ap"].size else 0.0,
            "precision": float(res["precision"].mean()) if res["precision"].size else 0.0,
            "recall": float(res["recall"].mean()) if res["recall"].size else 0.0,
        }
        out["fitness"] = 0.9 * out["mAP50-95"] + 0.1 * out["mAP50"]
        return out
