"""The task predictors of the port (engine/predictors_task.py) against the JAX
package's, on the CPU in fp32, on the same weights (tests/_torch_tasks.py: BN
calibrated on six noise images of 30-120 px, predicted at imgsz 64).

1. The host halves on shared detections: JAX's own device outputs (NMS
   detections, mask coefficients, prototypes, keypoints, rotated boxes,
   probabilities) through the port's ``_build_result`` and JAX's give the
   same ``Results``: boxes, scores and classes equal, keypoints and rotated
   boxes equal, and masks with 0 pixels apart (the same numpy and OpenCV
   calls).
2. The whole predictor, ``YOLO(...).predict`` unfused and fused, against
   JAX's predictor: the same detection counts and classes, boxes, keypoints
   and rotated boxes within 4x the port's own fp32-vs-fp64 decode error
   (floor 2e-3 px), scores within 1e-5 (floor) likewise, angles within 1e-4
   + 1e-4 |ref|; masks at most 0.01% of their pixels apart (a coefficient
   within the decode gate moves a pixel whose sigmoid is within that of 0.5);
   probabilities: JAX's predictor applies a second softmax to the eval
   forward's probabilities, the port does not; the port's equal JAX's model
   output within the scores' gate and their top-5 order JAX's predictor's.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from yolo_master_tpu.engine import predictors_task as jpt
from yolo_master_tpu_torch.engine import predictors_task as tpt

from _torch_tasks import IMGSZ, noise_images, task_weights  # noqa: E402

PREDICTORS = {"segment": "SegmentationPredictor", "pose": "PosePredictor", "obb": "OBBPredictor",
              "classify": "ClassificationPredictor"}
MASK_PIXEL_SHARE = 1e-4  # the share of mask pixels the two predictors may differ on (measured: 2e-6 to 4e-6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def images():
    return noise_images()


@pytest.fixture(scope="module", params=list(PREDICTORS))
def task_pair(request, images):
    """(task, the port's facade, JAX's predictor on the same weights, JAX's Results)."""
    task = request.param
    jm, params, y = task_weights(task, images)
    jp = getattr(jpt, PREDICTORS[task])(jm, params, names=y.names, imgsz=IMGSZ, batch=len(images))
    return task, y, jp, jp(list(images))


def _decode_noise(y, images):
    """max |fp32 - fp64| of the port's decoded outputs on these images: (boxes and
    extra columns, scores); Classify's: (0, probabilities)."""
    x, _ = y._predictor.preprocess(images)
    m, m64 = y.model, copy.deepcopy(y.model).double()
    x64 = x.double() if x.is_floating_point() else x
    with torch.no_grad():
        if y.task == "classify":
            return 0.0, (m(x) - m64(x64)).abs().max().item()
        e = np.abs(m.head.decode(m(x)).numpy() - m64.head.decode(m64(x64)).numpy())
    nc = m.nc
    return max(e[..., :4].max(), e[..., 4 + nc:].max()), e[..., 4:4 + nc].max()


def test_host_halves_on_shared_detections(task_pair, images):
    """JAX's device outputs through both packages' host halves give the same Results."""
    task, y, jp, _ = task_pair
    x, meta = jp.preprocess(images)
    det = jax.tree_util.tree_map(np.asarray, jp._get_fn(len(images))(jp.params, x))
    port = getattr(tpt, PREDICTORS[task])(y.model, names=y.names, imgsz=IMGSZ)
    apart = 0
    for i, im in enumerate(images):
        one = {k: v[i] for k, v in det.items()}
        ref = jp._build_result("array", im, meta[i], dict(one))
        got = port._build_result("array", im, meta[i], dict(one))
        for f in ("boxes", "keypoints", "obb", "probs", "masks"):
            a, b = getattr(got, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if a is None:
                continue
            if f == "masks":
                assert a.data.shape == b.data.shape and a.data.dtype == b.data.dtype == bool
                apart += int((a.data != b.data).sum())
            else:
                np.testing.assert_array_equal(a.data, b.data, err_msg=f)
        assert len(got) == len(ref)
    assert apart == 0


def test_task_predictor_matches_jax(task_pair, images):
    task, y, jp, ref = task_pair
    for fused in (False, True):
        if fused:
            y.fuse()
        got = y.predict(list(images), imgsz=IMGSZ, batch=len(images))
        box_tol, score_tol = _decode_noise(y, images)
        box_tol, score_tol = max(4 * box_tol, 2e-3), max(4 * score_tol, 1e-5)
        n_total = 0
        for g, r in zip(got, ref):
            if task == "classify":
                # JAX's predictor: softmax of the probabilities; the port: the probabilities
                np.testing.assert_allclose(g.probs.data, jp_model_probs(r), atol=score_tol, rtol=0)
                assert g.probs.top5 == r.probs.top5 and g.probs.top1 == r.probs.top1
                continue
            a, b = (g.obb, r.obb) if task == "obb" else (g.boxes, r.boxes)
            assert len(a) == len(b), (fused, len(a), len(b))
            n_total += len(a)
            np.testing.assert_array_equal(a.cls, b.cls)
            assert np.abs(a.conf - b.conf).max(initial=0) <= score_tol
            if task == "obb":
                assert np.abs(a.data[:, :4] - b.data[:, :4]).max(initial=0) <= box_tol
                r_ = b.data[:, 4]
                assert (np.abs(a.data[:, 4] - r_) <= 1e-4 + 1e-4 * np.abs(r_)).all()
                continue
            assert np.abs(a.xyxy - b.xyxy).max(initial=0) <= box_tol
            if task == "pose":
                assert np.abs(g.keypoints.data[..., :2] - r.keypoints.data[..., :2]).max(initial=0) <= box_tol
                assert np.abs(g.keypoints.data[..., 2] - r.keypoints.data[..., 2]).max(initial=0) <= 1e-4
            if task == "segment" and len(a):
                share = (g.masks.data != r.masks.data).mean()
                assert share <= MASK_PIXEL_SHARE, share
        assert task == "classify" or n_total > len(images)


def jp_model_probs(result):
    """JAX's eval-forward probabilities q from its predictor's softmax(q): log
    gives q up to a constant, and q sums to 1."""
    p = np.log(result.probs.data.astype(np.float64))
    return p - p.mean() + 1.0 / len(p)
