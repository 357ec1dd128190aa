"""The port's facade, YOLO(...).fuse().predict(), against the JAX package's
YOLO(...).predict() on the same weights and image; and the port's import
boundary (no jax)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from yolo_master_tpu.models.yolo import YOLO as JaxYOLO
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu_torch import YOLO

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def facades():
    """Both facades on the port's seeded weights. The JAX facade is built with
    its init replaced by jax.eval_shape's tree of the same names and shapes
    (the eager JAX init takes most of a minute on the CPU), then takes the
    port's weights through its own load_state_dict."""
    port = YOLO("yolo-master-n", device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxDetectionModel, "init_params",
                   lambda self, seed=0: jax.eval_shape(self.init, jax.random.PRNGKey(seed)))
        jy = JaxYOLO("yolo-master-n")
    jy.load_state_dict(port.model.state_dict())
    return jy, port


@pytest.mark.parametrize("conf", [1e-4, 1e-5])
def test_fused_predict_matches_jax_facade(facades, conf):
    """Same detections within 0.1 px (the JAX package's facade gate,
    tests/test_pallas_stem.py), on an 80x70 image that letterbox resizes."""
    jy, port = facades
    img = (np.random.default_rng(2).random((80, 70, 3)) * 255).astype(np.uint8)
    ref = jy.predict(img, imgsz=64, conf=conf, max_det=20)[0]
    fused = YOLO("yolo-master-n", device="cpu")
    fused.load_state_dict(port.model.state_dict()).fuse()
    out = fused.predict(img, imgsz=64, conf=conf, max_det=20)[0]
    assert len(out.boxes) == len(ref.boxes) > 0
    np.testing.assert_allclose(out.boxes.xyxy, ref.boxes.xyxy, atol=0.1, rtol=0)
    np.testing.assert_allclose(out.boxes.conf, ref.boxes.conf, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out.boxes.cls, ref.boxes.cls)
    assert out.orig_shape == (80, 70) and out.names[0] == "person"


def test_fuse_takes_the_jax_facade_keywords(facades):
    """fuse(pallas_stem=True) (the JAX README's deploy line), fuse(s2d=True)
    and fuse(imgsz=...) predict exactly what fuse() predicts; an unknown
    keyword raises TypeError, as in the JAX facade."""
    _, port = facades
    img = (np.random.default_rng(4).random((72, 64, 3)) * 255).astype(np.uint8)

    def fused(**kw):
        y = YOLO("yolo-master-n", device="cpu").load_state_dict(port.model.state_dict())
        return y.fuse(**kw).predict(img, imgsz=64, conf=1e-5, max_det=20)[0]

    ref = fused()
    assert len(ref.boxes) > 0
    for kw in ({"pallas_stem": True}, {"s2d": True}, {"imgsz": 320}, {"s2d": True, "pallas_stem": True, "imgsz": 64}):
        out = fused(**kw)
        for field in ("xyxy", "conf", "cls"):
            np.testing.assert_array_equal(getattr(out.boxes, field), getattr(ref.boxes, field), err_msg=str(kw))
    with pytest.raises(TypeError):
        YOLO("yolo-master-n", device="cpu").fuse(blocked=True)


def test_unfused_predict_batch_and_class_filter(facades):
    """A batch of two (float /255 input, no stem kernel) with a class filter:
    the mask path decodes every anchor and must agree with the JAX facade."""
    jy, port = facades
    rng = np.random.default_rng(3)
    imgs = [(rng.random((64, 48, 3)) * 255).astype(np.uint8) for _ in range(2)]
    kw = dict(imgsz=64, conf=1e-5, max_det=10, classes=[0, 2, 5], batch=2)
    ref = jy.predict(imgs, **kw)
    out = port.predict(imgs, **kw)
    assert len(out) == 2
    for o, r in zip(out, ref):
        assert len(o.boxes) == len(r.boxes)
        assert set(np.unique(o.boxes.cls)) <= {0.0, 2.0, 5.0}
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, atol=0.1, rtol=0)


def test_device_is_required():
    """The facade runs on the card unless the caller asks for another device;
    without a card, the default is refused rather than moved to the CPU."""
    import inspect

    assert inspect.signature(YOLO).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            YOLO("yolo-master-n")


def test_import_leaves_jax_out():
    """Importing every module of the port brings in neither jax nor any module
    of the JAX package."""
    code = ("import importlib, pkgutil, sys, yolo_master_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert len(names) > 20, names; "
            "assert {p.__name__ + '.' + m for m in ('engine.trainer', 'engine.recovery', 'utils.checkpoint', "
            "'utils.callbacks', 'nn.moe.scheduler', 'nn.moe.analysis', 'nn.moe.pruning', 'nn.moe.quantize', "
            "'nn.moa', 'nn.mot', 'nn.latent_mixture')} "
            "<= set(names), names; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'yolo_master_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
