"""Self-contained COCO-style evaluation (counterpart of
``yolo_master_tpu/utils/coco.py``; reference: eval_json via faster_coco_eval,
models/yolo/detect/val.py:469-525). The port's own copy, numpy on the host.

Implements the COCOeval detection protocol: per-image/per-class greedy
matching sorted by score against 10 IoU thresholds, maxDets truncation, area
ranges (all/small/medium/large), 101-point precision interpolation, averaged
over classes and thresholds. Crowd/ignore regions match without penalty.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0, 1e10),
    "small": (0, 32**2),
    "medium": (32**2, 96**2),
    "large": (96**2, 1e10),
}


# fmt: off
COCO80_TO_COCO91 = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
    46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88,
    89, 90,
]
# fmt: on


def write_predictions_json(
    results, path: str, image_ids: Optional[List[int]] = None, class_map: Optional[List[int]] = None
) -> str:
    """Results list -> COCO predictions json (xywh, category_id, score)
    (the jdict writer, reference detect/val.py pred_to_json).

    class_map maps the contiguous model class index to dataset category ids
    (COCO80_TO_COCO91 for real COCO annotations, which use sparse ids 1-90)."""
    out = []
    for i, r in enumerate(results):
        img_id = image_ids[i] if image_ids else i
        if r.boxes is None:
            continue
        for j in range(len(r.boxes)):
            x1, y1, x2, y2 = r.boxes.xyxy[j]
            c = int(r.boxes.cls[j])
            out.append(
                {
                    "image_id": int(img_id),
                    "category_id": class_map[c] if class_map else c,
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "score": float(r.boxes.conf[j]),
                }
            )
    Path(path).write_text(json.dumps(out))
    return path


def _iou_xywh(d: np.ndarray, g: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """[D, G] IoU of xywh boxes; crowd GT uses intersection-over-det-area."""
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    da = (d[:, 2] * d[:, 3])[:, None]
    ga = (g[:, 2] * g[:, 3])[None]
    union = np.where(iscrowd[None], da, da + ga - inter)
    return inter / np.maximum(union, 1e-9)


class COCOEvaluator:
    """Detection AP over COCO-format GT + prediction dicts."""

    def __init__(self, gt: dict, max_dets: int = 100):
        self.max_dets = max_dets
        self.gt_by_img_cat = defaultdict(list)
        self.cat_ids = sorted({a["category_id"] for a in gt["annotations"]})
        self.img_ids = [im["id"] for im in gt.get("images", [])] or sorted(
            {a["image_id"] for a in gt["annotations"]}
        )
        for a in gt["annotations"]:
            self.gt_by_img_cat[(a["image_id"], a["category_id"])].append(a)

    def evaluate(self, preds: List[dict]) -> Dict[str, float]:
        preds_by_img_cat = defaultdict(list)
        for p in preds:
            preds_by_img_cat[(p["image_id"], p["category_id"])].append(p)

        results = {}
        ap_t = self._evaluate_area(preds_by_img_cat, AREA_RANGES["all"], per_threshold=True)
        results["AP"] = float(np.mean(ap_t)) if ap_t.size else 0.0
        results["AP50"] = float(np.mean(ap_t[0])) if ap_t.size else 0.0
        results["AP75"] = float(np.mean(ap_t[5])) if ap_t.size else 0.0
        for name, key in (("small", "APs"), ("medium", "APm"), ("large", "APl")):
            ap = self._evaluate_area(preds_by_img_cat, AREA_RANGES[name])
            results[key] = float(ap.mean()) if ap.size else 0.0
        return results

    def _evaluate_area(self, preds_by_img_cat, area_rng, per_threshold: bool = False):
        T = len(IOU_THRS)
        ap_per_cat = []
        for cat in self.cat_ids:
            tps, scores, n_gt = [], [], 0
            for img in self.img_ids:
                gts = self.gt_by_img_cat.get((img, cat), [])
                dts = sorted(preds_by_img_cat.get((img, cat), []), key=lambda d: -d["score"])[: self.max_dets]
                g = np.asarray([a["bbox"] for a in gts], np.float64).reshape(-1, 4)
                crowd = np.asarray([a.get("iscrowd", 0) for a in gts], bool)
                g_area = np.asarray([a.get("area", a["bbox"][2] * a["bbox"][3]) for a in gts], np.float64)
                g_ignore = crowd | (g_area < area_rng[0]) | (g_area > area_rng[1])
                # COCOeval sorts GTs by ignore flag (non-ignored first): the
                # greedy loop's early break assumes this ordering
                if len(g) and g_ignore.any():
                    order_g = np.argsort(g_ignore, kind="stable")
                    g, crowd, g_ignore = g[order_g], crowd[order_g], g_ignore[order_g]
                n_gt += int((~g_ignore).sum())
                if not dts:
                    continue
                d = np.asarray([p["bbox"] for p in dts], np.float64).reshape(-1, 4)
                d_area = d[:, 2] * d[:, 3]
                d_out_of_range = (d_area < area_rng[0]) | (d_area > area_rng[1])
                iou = _iou_xywh(d, g, crowd) if len(g) else np.zeros((len(d), 0))
                tp = np.zeros((T, len(d)), bool)
                ignore_det = np.zeros((T, len(d)), bool)
                for ti, thr in enumerate(IOU_THRS):
                    taken = np.zeros(len(g), bool)
                    for di in range(len(d)):
                        best, bj = thr, -1
                        for gj in range(len(g)):
                            if taken[gj] and not crowd[gj]:
                                continue
                            if bj >= 0 and not g_ignore[bj] and g_ignore[gj]:
                                break  # prefer non-ignored matches (COCOeval order)
                            if iou[di, gj] >= best:
                                best = iou[di, gj]
                                bj = gj
                        if bj >= 0:
                            taken[bj] = True
                            if g_ignore[bj]:
                                ignore_det[ti, di] = True
                            else:
                                tp[ti, di] = True
                        elif d_out_of_range[di]:
                            ignore_det[ti, di] = True
                for ti in range(T):
                    keep = ~ignore_det[ti]
                    tps.append((ti, tp[ti][keep], np.asarray([p["score"] for p in dts])[keep]))
            if n_gt == 0:
                continue
            ap_t = np.zeros(T)
            for ti in range(T):
                entries = [(t, s) for (tti, t, s) in tps if tti == ti]
                if not entries:
                    continue
                tp_cat = np.concatenate([t for t, _ in entries])
                if not tp_cat.size:
                    continue  # every detection ignored: precision 0 at every recall, as COCOeval
                sc = np.concatenate([s for _, s in entries])
                order = np.argsort(-sc)
                tp_sorted = tp_cat[order]
                tp_cum = np.cumsum(tp_sorted)
                fp_cum = np.cumsum(~tp_sorted)
                recall = tp_cum / n_gt
                precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
                # precision envelope + 101-point interpolation
                for i in range(len(precision) - 1, 0, -1):
                    precision[i - 1] = max(precision[i - 1], precision[i])
                idx = np.searchsorted(recall, RECALL_THRS, side="left")
                prec_at = np.where(idx < len(precision), precision[np.minimum(idx, max(len(precision) - 1, 0))], 0.0)
                ap_t[ti] = prec_at.mean()
            ap_per_cat.append(ap_t)
        if not ap_per_cat:
            return np.zeros((T, 0)) if per_threshold else np.zeros(0)
        stacked = np.stack(ap_per_cat, 1)  # [T, ncat]
        return stacked if per_threshold else stacked.mean(0)


def evaluate_coco(gt_json: str, pred_json: str, max_dets: int = 100) -> Dict[str, float]:
    gt = json.loads(Path(gt_json).read_text())
    preds = json.loads(Path(pred_json).read_text())
    return COCOEvaluator(gt, max_dets).evaluate(preds)
