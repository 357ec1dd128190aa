"""The port's host helpers against the JAX package's: the model-name helpers,
the port's own copies of the YAMLs, letterbox and Results, boxes and anchors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_master_tpu import utils as jutils
from yolo_master_tpu.data.letterbox import letterbox as jax_letterbox
from yolo_master_tpu.engine.results import Results as JaxResults
from yolo_master_tpu.ops import anchors as janchors
from yolo_master_tpu.ops.boxes import xywh2xyxy as jax_xywh2xyxy
from yolo_master_tpu_torch import utils
from yolo_master_tpu_torch.data.letterbox import letterbox
from yolo_master_tpu_torch.engine.results import Results
from yolo_master_tpu_torch.ops import anchors
from yolo_master_tpu_torch.ops.boxes import xywh2xyxy


@pytest.mark.parametrize("name", ["yolo-master-n", "yolo-master-s.yaml", "yolo-master-v0_10", "yolo26-master-latent-x",
                                  "yolo26-master-m", "yolo26-master-moa-mot-s", "yolo-master-uomoe-x"])
def test_model_name_helpers_match_jax(name):
    """A name resolves to the port's copy of the JAX package's YAML, at the same
    path under its cfg/ (yolo-master-v0_10: copied with its family); a graph the
    port holds no copy of yet raises, naming the ROADMAP item."""
    assert utils.guess_scale(name) == jutils.guess_scale(name)
    theirs = jutils.find_model_yaml(name)
    if "uomoe" not in name:
        ours = utils.find_model_yaml(name)
        assert ours.relative_to(utils.CFG_DIR) == theirs.relative_to(jutils.CFG_DIR)
        assert ours.read_bytes() == theirs.read_bytes()
    else:
        with pytest.raises(FileNotFoundError, match="ROADMAP.md"):
            utils.find_model_yaml(name)


@pytest.mark.parametrize("rel", ["models/yolo-master.yaml", "models/yolo-master-v0_1.yaml", "datasets/coco.yaml",
                                 *(f"models/yolo-master-v0_{v}.yaml" for v in range(4, 16)),
                                 "models/yolo26-master.yaml", "models/yolo26-master-latent.yaml",
                                 "models/yolo26-master-moa-mot.yaml"])
def test_copied_yamls_load_equal_to_jax(rel):
    """The port's cfg/ holds byte-for-byte copies, and they load equal."""
    ours, theirs = utils.CFG_DIR / rel, jutils.CFG_DIR / rel
    assert ours.read_bytes() == theirs.read_bytes()
    assert utils.yaml_load(ours) == jutils.yaml_load(theirs)


@pytest.mark.parametrize("shape,new", [((480, 640), 320), ((97, 131), (64, 96)), ((700, 300), 640), ((64, 64), 64)])
def test_letterbox_copy_matches_jax(shape, new):
    """Pixel for pixel, on seeded images that resize (and one that does not)."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    out, ratio, pad = letterbox(img, new)
    ref, rratio, rpad = jax_letterbox(img, new)
    np.testing.assert_array_equal(out, ref)
    assert ratio == rratio and pad == rpad


def test_results_fields_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    data = np.concatenate([rng.uniform(0, 50, (7, 4)), rng.uniform(0, 1, (7, 1)), rng.integers(0, 80, (7, 1))], -1)
    kw = dict(path="a.jpg", names={0: "person"}, boxes=data.astype(np.float32), speed={"inference": 1.5})
    ours, theirs = Results(img, **kw), JaxResults(img, **kw)
    for field in ("data", "xyxy", "conf", "cls"):
        np.testing.assert_array_equal(getattr(ours.boxes, field), getattr(theirs.boxes, field))
    assert len(ours) == len(theirs) == len(ours.boxes) == len(theirs.boxes) == 7
    assert ours.orig_img is theirs.orig_img
    assert (ours.orig_shape, ours.path, ours.names, ours.speed) == (theirs.orig_shape, theirs.path, theirs.names,
                                                                     theirs.speed)
    assert len(Results(img)) == len(JaxResults(img)) == 0


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
