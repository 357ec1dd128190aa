"""The port's sparse SAHI (engine/sahi.py) and cluster-weighted NMS
(ops/nms.py:cluster_weighted_nms, ops/cuda_nms.py:batched_cw_nms) against the
JAX package's, on the same weights and inputs; the JAX CW-NMS kernel runs in
interpret mode, as its own tests run it on the CPU. Inputs come from numpy
seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine.sahi import SparseSAHIPredictor as JaxSAHI
from yolo_master_tpu.engine.sahi import tile_grid as jax_tile_grid
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.ops.nms import _greedy_cw_nms as jax_greedy_cw_nms
from yolo_master_tpu.ops.nms import cluster_weighted_nms as jax_cw_nms
from yolo_master_tpu.ops.pallas_nms import pallas_batched_cw_nms
from yolo_master_tpu_torch.engine.sahi import SparseSAHIPredictor, tile_grid
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.ops.cuda_nms import batched_cw_nms, batched_cw_nms_plain
from yolo_master_tpu_torch.ops.nms import cluster_weighted_nms
from yolo_master_tpu_torch.utils.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("h,w,s,ov", [(1300, 1900, 640, 0.2), (640, 640, 640, 0.2), (700, 701, 512, 0.25)])
def test_tile_grid_matches_jax(h, w, s, ov):
    assert tile_grid(h, w, s, ov) == jax_tile_grid(h, w, s, ov)


def _cw_case():
    """tests/test_pallas_kernels.py:test_pallas_batched_cw_nms_matches_scan_interpret's
    inputs: 4 images of 128 candidates, rows with 128, 5, 0 and 20 valid."""
    rng = np.random.default_rng(17)
    b, n = 4, 128
    xy = rng.uniform(0, 400, (b, n, 2))
    wh = rng.uniform(10, 90, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.zeros((b, n), np.float32)
    for i, nv in enumerate([n, 5, 0, 20]):
        if nv:
            scores[i, rng.choice(n, nv, replace=False)] = rng.uniform(0.1, 1.0, nv)
    return boxes, scores


@pytest.mark.parametrize("weighted", [True, False], ids=["gaussian_iou", "plain_iou"])
def test_batched_cw_nms_matches_jax(weighted):
    """Against the JAX kernel (interpret mode), and image by image against the
    JAX scan (_greedy_cw_nms): seeds, validity and scores equal; fused boxes
    within 1e-4."""
    boxes, scores = _cw_case()
    max_det = 32
    fb, fs, seed, valid = (t.numpy() for t in batched_cw_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                                              0.45, max_det, 0.1, weighted))
    kb, ks, kseed, kvalid = (np.asarray(t) for t in pallas_batched_cw_nms(
        jnp.asarray(boxes), jnp.asarray(scores), 0.45, max_det, sigma=0.1, weighted_iou=weighted, interpret=True))
    np.testing.assert_array_equal(valid, kvalid)
    np.testing.assert_array_equal(seed, kseed)  # zero-filled after each row's last pick, as the kernel
    np.testing.assert_array_equal(fs, ks)
    np.testing.assert_allclose(fb, kb, atol=1e-4, rtol=0)
    assert valid[0].sum() > 5 and not valid[2].any() and valid[1].sum() <= 5
    for i in range(len(boxes)):
        sb, ss, sseed, svalid = (np.asarray(t) for t in jax_greedy_cw_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.45, max_det, 0.1, weighted))
        pb, ps, pseed, pvalid = (t[0].numpy() for t in batched_cw_nms_plain(
            torch.from_numpy(boxes[i: i + 1]), torch.from_numpy(scores[i: i + 1]), 0.45, max_det, 0.1, weighted))
        np.testing.assert_array_equal(pvalid, svalid)
        np.testing.assert_array_equal(pseed[svalid], sseed[svalid])
        np.testing.assert_array_equal(ps[svalid], ss[svalid])
        np.testing.assert_allclose(pb[svalid], sb[svalid], atol=1e-4, rtol=0)


@pytest.mark.parametrize("agnostic", [False, True])
def test_cluster_weighted_nms_matches_jax(agnostic):
    """The public entry point on decoded predictions [B, A, 4+nc] with 8
    classes, against the JAX scan path (use_pallas=False). Class offsets reach
    7 * 7680 px, where sums in another order round differently, so boxes are
    held to 1e-4 + 5e-7 * |class-offset coordinate|."""
    rng = np.random.default_rng(13)
    pred = rng.uniform(0, 1, (3, 128, 4 + 8)).astype(np.float32)
    pred[..., :2] = rng.uniform(100, 500, (3, 128, 2))
    pred[..., 2:4] = rng.uniform(20, 80, (3, 128, 2))
    pred[1, :, 4:] *= 0.2  # fewer candidates above conf
    kw = dict(nc=8, conf_thres=0.3, iou_thres=0.5, max_det=16, max_nms=64, agnostic=agnostic)
    ours = {k: v.numpy() for k, v in cluster_weighted_nms(torch.from_numpy(pred), **kw).items()}
    ref = {k: np.asarray(v) for k, v in jax_cw_nms(jnp.asarray(pred), use_pallas=False, **kw).items()}
    np.testing.assert_array_equal(ours["valid"], ref["valid"])
    np.testing.assert_array_equal(ours["classes"], ref["classes"])
    np.testing.assert_array_equal(ours["scores"], ref["scores"])
    offset = 0.0 if agnostic else np.maximum(ref["classes"], 0)[..., None] * 7680.0
    assert (np.abs(ours["boxes"] - ref["boxes"]) <= 1e-4 + 5e-7 * np.abs(ref["boxes"] + offset)).all()
    assert ours["valid"].sum() > 10


def _toy_models():
    """tests/test_sahi_augment_cfg.py's 2-layer detector (nc=1) in both packages, on the JAX init."""
    cfg = {"nc": 1, "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]],
           "head": [[[1], 1, "Detect", ["nc"]]]}
    jm = JaxDetectionModel(cfg)
    p = jm.init_params(0)
    port = DetectionModel(cfg)
    port.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p)), strict=True)
    return jm, p, port.eval()


@pytest.mark.parametrize("threshold,active", [(0.999, 0), (1.95425e-4, 2)], ids=["no_tile", "two_tiles"])
@pytest.mark.parametrize("use_cw_nms", [True, False], ids=["cw_nms", "greedy_nms"])
def test_sparse_sahi_matches_jax(use_cw_nms, threshold, active):
    """tests/test_sahi_augment_cfg.py's 1280x1920 frame with one bright object:
    the same tiles skipped and the same detections (boxes within 1e-3 px).
    Its threshold, 0.999, skips every tile of the toy model; the second sits
    between two of the low-res pass's objectness values (1.95417e-4 and
    1.95434e-4, gaps ~600x an fp32 ulp there) and runs two tiles."""
    jm, p, port = _toy_models()
    img = np.full((1280, 1920, 3), 114, np.uint8)
    img[200:380, 300:520] = (0, 0, 230)
    kw = dict(imgsz=320, slice_size=640, overlap_ratio=0.2, objectness_threshold=threshold, conf=1e-6, max_det=32,
              use_cw_nms=use_cw_nms)
    jsahi = JaxSAHI(jm, p, **kw)
    ref = jsahi(img)
    sahi = SparseSAHIPredictor(port, **kw)
    out = sahi(img)
    assert sahi.last_stats == jsahi.last_stats
    assert sahi.last_stats["tiles"] == 12 and sahi.last_stats["active"] == active
    assert out.orig_shape == ref.orig_shape == (1280, 1920)
    assert len(out.boxes) == len(ref.boxes) > 0
    np.testing.assert_allclose(out.boxes.xyxy, ref.boxes.xyxy, atol=1e-3, rtol=0)
    np.testing.assert_allclose(out.boxes.conf, ref.boxes.conf, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out.boxes.cls, ref.boxes.cls)
