"""The port's host helpers against the JAX package's: the model-name helpers,
boxes and anchors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_master_tpu import utils as jutils
from yolo_master_tpu.ops import anchors as janchors
from yolo_master_tpu.ops.boxes import xywh2xyxy as jax_xywh2xyxy
from yolo_master_tpu_torch import utils
from yolo_master_tpu_torch.ops import anchors
from yolo_master_tpu_torch.ops.boxes import xywh2xyxy


@pytest.mark.parametrize("name", ["yolo-master-n", "yolo-master-s.yaml", "yolo-master-v0_10", "yolo26-master-x"])
def test_model_name_helpers_match_jax(name):
    assert utils.find_model_yaml(name) == jutils.find_model_yaml(name)
    assert utils.guess_scale(name) == jutils.guess_scale(name)


def test_make_divisible_and_coco_names_match_jax():
    from yolo_master_tpu.cfg import COCO_NAMES

    for x in (1.0, 15.9, 16.0, 63.75, 256 * 0.25):
        assert utils.make_divisible(x) == jutils.make_divisible(x)
    assert utils.coco_names() == COCO_NAMES


def test_boxes_and_anchors_match_jax():
    rng = np.random.default_rng(0)
    xywh = rng.uniform(1, 100, (3, 7, 6)).astype(np.float32)
    np.testing.assert_array_equal(xywh2xyxy(torch.from_numpy(xywh)).numpy(), np.asarray(jax_xywh2xyxy(xywh)))
    hw, strides = ((4, 6), (2, 3)), (8, 16)
    pts, st = anchors.make_anchors(hw, strides, "cpu")
    jpts, jst = janchors.make_anchors(hw, strides)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    logits = rng.standard_normal((2, 30, 64)).astype(np.float32)
    dist = anchors.dfl_decode(torch.from_numpy(logits), 16)
    np.testing.assert_allclose(dist.numpy(), np.asarray(janchors.dfl_decode(jnp.asarray(logits), 16)), atol=1e-5)
    ap = rng.uniform(0, 10, (30, 2)).astype(np.float32)
    for xywh_out in (True, False):
        np.testing.assert_allclose(
            anchors.dist2bbox(dist, torch.from_numpy(ap), xywh=xywh_out).numpy(),
            np.asarray(janchors.dist2bbox(jnp.asarray(dist.numpy()), jnp.asarray(ap), xywh=xywh_out)), atol=1e-5)
