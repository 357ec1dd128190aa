"""The port's copies of utils/metrics.py and utils/coco.py against the JAX
package's originals, on seeded stats (numpy only; no model, no compile).

Results must be equal: the same numpy code on the same arrays. The cases of
tests/test_nms_metrics.py (perfect, all wrong class) and tests/test_coco_eval.py
(perfect, dropped, jittered, crowd) are cases here, each also held to its
sanity bound. One difference is deliberate: where every detection of a class
falls outside an area range, the JAX evaluator raises IndexError and the
port's scores precision 0, as COCOeval does.
"""

import json

import numpy as np
import pytest

from yolo_master_tpu.utils import coco as jcoco
from yolo_master_tpu.utils import metrics as jmetrics
from yolo_master_tpu_torch.engine.results import Results
from yolo_master_tpu_torch.utils import coco as tcoco
from yolo_master_tpu_torch.utils import metrics as tmetrics


def _boxes(rng, n, lo=0, hi=500, wmin=10, wmax=120):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(wmin, wmax, (n, 2))], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_and_matching_equal_jax(seed):
    """box_iou_np and the greedy matching at 10 IoU thresholds, with jittered
    copies (matches at many thresholds), duplicates and several classes."""
    rng = np.random.default_rng(seed)
    gt = _boxes(rng, 12)
    pred = np.concatenate([gt + rng.normal(0, 4, gt.shape).astype(np.float32), gt, _boxes(rng, 20)])
    gcls, pcls = rng.integers(0, 3, 12), np.concatenate([rng.integers(0, 3, 32), rng.integers(0, 3, 12)])
    iou_t, iou_j = tmetrics.box_iou_np(gt, pred), jmetrics.box_iou_np(gt, pred)
    np.testing.assert_array_equal(iou_t, iou_j)
    corr = tmetrics.match_predictions(pcls, gcls, iou_t)
    np.testing.assert_array_equal(corr, jmetrics.match_predictions(pcls, gcls, iou_j))
    assert corr[:, 0].sum() > corr[:, -1].sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_per_class_equals_jax(seed):
    """ap_per_class (smooth and compute_ap inside) on seeded stats with tied
    confidences and a class that has labels but no predictions."""
    rng = np.random.default_rng(seed)
    d = 400
    tp = rng.random((d, 10)) < np.linspace(0.8, 0.2, 10)
    conf = np.round(rng.random(d), 2)
    pcls, tcls = rng.integers(0, 5, d), rng.integers(0, 6, 60)
    t, j = tmetrics.ap_per_class(tp, conf, pcls, tcls), jmetrics.ap_per_class(tp, conf, pcls, tcls)
    assert set(t) == set(j)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    for r, p in ((np.linspace(0, 1, 7), np.linspace(1, 0.3, 7)), (np.array([]), np.array([]))):
        assert tmetrics.compute_ap(r, p)[0] == jmetrics.compute_ap(r, p)[0]
    y = rng.random(1000)
    np.testing.assert_array_equal(tmetrics.smooth(y, 0.1), jmetrics.smooth(y, 0.1))


def _perfect(rng):
    out = []
    for _ in range(8):
        gt = _boxes(rng, 3, wmin=60, wmax=60)
        cls = rng.integers(0, 2, 3)
        out.append((gt, np.full(3, 0.9), cls, gt, cls))
    return out


def _wrong_class(rng):
    gt = np.array([[10, 10, 100, 100]], np.float32)
    return [(gt, np.array([0.9]), np.array([1]), gt, np.array([0]))]


def _jittered(rng):
    out = []
    for _ in range(6):
        gt = _boxes(rng, 4)
        cls = rng.integers(0, 3, 4)
        pred = np.concatenate([gt + rng.normal(0, 6, gt.shape).astype(np.float32), _boxes(rng, 5)])
        out.append((pred, rng.random(9), np.concatenate([cls, rng.integers(0, 3, 5)]), gt, cls))
    return out


def _empty_sides(rng):
    gt = _boxes(rng, 2)
    return [(np.zeros((0, 4), np.float32), np.zeros(0), np.zeros(0), gt, np.array([0, 1])),
            (gt, np.array([0.8, 0.7]), np.array([0, 1]), np.zeros((0, 4), np.float32), np.zeros(0, int)),
            (gt, np.array([0.6, 0.6]), np.array([0, 1]), gt, np.array([0, 1]))]


@pytest.mark.parametrize("case,check", [
    (_perfect, lambda m: m["mAP50"] > 0.99 and m["mAP50-95"] > 0.99),
    (_wrong_class, lambda m: m["mAP50"] == 0.0),
    (_jittered, lambda m: 0.1 < m["mAP50-95"] < m["mAP50"] < 1.0),
    (_empty_sides, lambda m: 0 < m["mAP50"] < 1.0),
], ids=["perfect", "all_wrong_class", "jittered", "empty_preds_or_gt"])
def test_det_metrics_equal_jax(case, check):
    """DetMetrics.update per image, then compute(): equal dicts, and each case's
    sanity bound (the gates of tests/test_nms_metrics.py)."""
    t, j = tmetrics.DetMetrics(nc=3), jmetrics.DetMetrics(nc=3)
    for args in case(np.random.default_rng(0)):
        t.update(*args)
        j.update(*args)
    mt, mj = t.compute(), j.compute()
    assert mt == mj and check(mt), mt
    assert tmetrics.DetMetrics(nc=3).compute() == jmetrics.DetMetrics(nc=3).compute()


def _coco_gt():
    anns = []
    rng = np.random.default_rng(0)
    for img in range(4):
        for _ in range(3):
            x, y = rng.uniform(0, 400, 2)
            w, h = rng.uniform(20, 120, 2)
            anns.append({"id": len(anns), "image_id": img, "category_id": int(rng.integers(0, 3)),
                         "bbox": [float(x), float(y), float(w), float(h)], "area": float(w * h), "iscrowd": 0})
    return {"images": [{"id": i} for i in range(4)], "annotations": anns}


def _coco_preds(gt, jitter=0.0, drop=0, crowd_extra=False):
    rng = np.random.default_rng(1)
    out = []
    for a in gt["annotations"][: len(gt["annotations"]) - drop]:
        if crowd_extra and a["iscrowd"]:
            continue
        b = np.asarray(a["bbox"], np.float64)
        b[:2] += rng.uniform(-jitter, jitter, 2)
        out.append({"image_id": a["image_id"], "category_id": a["category_id"], "bbox": b.tolist(),
                    "score": float(rng.uniform(0.5, 0.95))})
    if crowd_extra:  # a detection on the crowd region is ignored, not a false positive
        a = gt["annotations"][0]
        out.append({"image_id": a["image_id"], "category_id": a["category_id"], "bbox": a["bbox"], "score": 0.97})
    return out


def _crowd_gt():
    gt = _coco_gt()
    gt["annotations"][0]["iscrowd"] = 1
    return gt


@pytest.mark.parametrize("gt_fn,pred_kw,check", [
    (_coco_gt, {}, lambda r: r["AP"] > 0.99 and r["AP50"] > 0.99),
    (_coco_gt, {"drop": 6}, lambda r: r["AP"] < 0.8),
    (_coco_gt, {"jitter": 12.0}, lambda r: r["AP50"] > r["AP75"]),
    (_crowd_gt, {"crowd_extra": True}, lambda r: r["AP"] > 0.99),
], ids=["perfect", "dropped", "jittered", "crowd"])
def test_coco_evaluator_equals_jax(gt_fn, pred_kw, check):
    """COCOEvaluator on the cases of tests/test_coco_eval.py: equal results and
    each case's sanity bound; at max_dets 100 and 2."""
    gt = gt_fn()
    preds = _coco_preds(gt, **pred_kw)
    for max_dets in (100, 2):
        rt = tcoco.COCOEvaluator(gt, max_dets).evaluate(preds)
        assert rt == jcoco.COCOEvaluator(gt, max_dets).evaluate(preds)
    assert check(tcoco.COCOEvaluator(gt).evaluate(preds)), rt


def test_coco_evaluator_scores_a_class_whose_detections_are_all_ignored():
    """A class with a small GT box and one large detection elsewhere: in the
    small area range the detection is ignored and the GT missed. COCOeval gives
    precision 0 there (AP_small 0 for the class); the JAX evaluator raises."""
    gt = {"images": [{"id": 0}], "annotations": [
        {"id": 0, "image_id": 0, "category_id": 1, "bbox": [10, 10, 10, 10], "area": 100, "iscrowd": 0},
        {"id": 1, "image_id": 0, "category_id": 1, "bbox": [200, 200, 100, 100], "area": 1e4, "iscrowd": 0}]}
    preds = [{"image_id": 0, "category_id": 1, "bbox": [200, 200, 100, 100], "score": 0.9}]
    with pytest.raises(IndexError):
        jcoco.COCOEvaluator(gt).evaluate(preds)
    res = tcoco.COCOEvaluator(gt).evaluate(preds)
    assert res["APs"] == 0.0 and res["APl"] > 0.99 and 0 < res["AP"] < 1


def test_write_predictions_json_and_evaluate_coco_equal_jax(tmp_path):
    """write_predictions_json of the port's Results (with the 80 -> 91 map) gives
    JAX's file for the same detections; evaluate_coco reads it back alike."""
    from yolo_master_tpu.engine.results import Results as JaxResults

    rng = np.random.default_rng(5)
    dets = [np.concatenate([_boxes(rng, 4), rng.random((4, 1)), rng.integers(0, 80, (4, 1))], -1) for _ in range(3)]
    img = np.zeros((600, 700, 3), np.uint8)
    tr = [Results(img, boxes=d) for d in dets]
    jr = [JaxResults(img, boxes=d) for d in dets]
    tp = tcoco.write_predictions_json(tr, str(tmp_path / "t.json"), image_ids=[3, 5, 7],
                                      class_map=tcoco.COCO80_TO_COCO91)
    jp = jcoco.write_predictions_json(jr, str(tmp_path / "j.json"), image_ids=[3, 5, 7],
                                      class_map=jcoco.COCO80_TO_COCO91)
    assert open(tp).read() == open(jp).read()
    assert tcoco.COCO80_TO_COCO91 == jcoco.COCO80_TO_COCO91
    gt = {"images": [{"id": i} for i in (3, 5, 7)],
          "annotations": [{"id": k, "image_id": r["image_id"], "category_id": r["category_id"], "bbox": r["bbox"],
                           "area": r["bbox"][2] * r["bbox"][3], "iscrowd": 0}
                          for k, r in enumerate(json.loads(open(tp).read())[::2])]}
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    rt = tcoco.evaluate_coco(str(tmp_path / "gt.json"), tp)
    assert rt == jcoco.evaluate_coco(str(tmp_path / "gt.json"), jp) and rt["AP50"] > 0.4
