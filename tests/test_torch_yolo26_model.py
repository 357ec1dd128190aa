"""yolo26-master (the NMS-free end2end generation) in the port against the JAX
package, on the CPU in fp32.

1. Construction, no JAX compile: n, s and m have JAX's parameter count (n
   5,115,336, as tests/test_model_configs.py), the parser's rules reached the
   graph (A2C2fMoE at layers 4/6/8 with 4/8/16 experts, SPPF, C2PSA, the attn
   C3k2 at layer 22, C3k inner blocks from scale m, the end2end head at
   reg_max 1), and the weights go through ``import_state_dict`` and
   ``state_dict_from_jax`` both ways, strict, unchanged.
2. ``forward_predict`` at 64 px against JAX's on the same weights: at the
   init within 2e-3 px and 1e-5 on scores; with BN calibrated within 4x the
   port's own fp32-vs-fp64 error (floors 2e-3, 1e-5); BN folded against
   ``fuse_bn_params``' tree, and the fused stem on uint8, the same way.
3. The facade: ``YOLO("yolo26-master-n").fuse().predict()`` against the JAX
   facade's predictor (its end2end graph: decode, ``postprocess_end2end``,
   the conf mask, no NMS), with no NMS run in the port; ``classes=`` filters
   after the selection, as the upstream end2end postprocess does (the JAX
   predictor ignores it on this path).
4. Validation: the JAX validator hands the end2end head's xyxy decode to its
   NMS, which reads xywh (``yolo_master_tpu/engine/validator.py:86-91``,
   ``ops/nms.py:73-76``), so it scores boxes that are not the model's; the
   port's validator runs the predictor's end2end graph instead, and its
   metrics equal, within 1e-3, those of the JAX validator with its device
   function replaced by that graph assembled from JAX's own pieces.
5. What waits: SAHI over the end2end head, and its training, raise.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_master_tpu.models.yolo import YOLO as JaxYOLO
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.ops.boxes import xywh2xyxy as jax_xywh2xyxy
from yolo_master_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_master_tpu.utils import metrics as jmetrics
from yolo_master_tpu.utils.fuse import fuse_bn_params
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.data import dataset as tdataset
from yolo_master_tpu_torch.engine import predictor as tpredictor
from yolo_master_tpu_torch.engine import validator as tvalidator
from yolo_master_tpu_torch.engine.validator import DetectionValidator
from yolo_master_tpu_torch.nn import layers as tlayers
from yolo_master_tpu_torch.nn.moe import A2C2fMoE
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils import coco_names
from yolo_master_tpu_torch.utils import metrics as tmetrics
from yolo_master_tpu_torch.utils.fuse import fuse_bn, fused_stem_fuse
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_model import _fp32_noise, _np_tree, _trainable  # noqa: E402
from test_torch_validator import METRIC_TOL, METRICS, _counting  # noqa: E402

Y26 = "yolo26-master-n"
IMGSZ, BATCH = 64, 4
VAL_SHAPES = [(48, 64), (64, 40), (64, 64), (30, 64), (64, 52), (40, 40)]  # batches of 4 and 2 + 2 wrapped
BOX, SCORE = np.s_[..., :4], np.s_[..., 4:]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tols(port, x, setting):
    """(box, score) limits: at the init 2e-3 / 1e-5; calibrated, 4x the port's own fp32-vs-fp64 error."""
    if setting == "default":
        return 2e-3, 1e-5
    noise = _fp32_noise(port, x)
    return max(4 * noise[BOX].max(), 2e-3), max(4 * noise[SCORE].max(), 1e-5)


@pytest.fixture(scope="module")
def y26():
    """yolo26-master-n: the JAX model, its jitted forward_predict, two 64-px
    images, and for "default" and "calibrated" (BN calibrated on the images in
    the port) the port, the JAX tree and JAX's output."""
    jm = JaxDetectionModel(Y26)
    init = jax_params_of(jm, DetectionModel(Y26))
    forward = jax.jit(jm.forward_predict)
    x = np.random.default_rng(19).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    out = {}
    for setting in ("default", "calibrated"):
        port = DetectionModel(Y26)
        port.load_state_dict(state_dict_from_jax(init), strict=True)
        if setting == "calibrated":
            calibrate_bn(port, torch.from_numpy(x))
        port.eval()
        params = _np_tree(import_state_dict(init, port.state_dict(), strict=True))
        out[setting] = (port, params, np.asarray(forward(params, jnp.asarray(x))))
    return jm, forward, x, out


# -- 1. construction --------------------------------------------------------------------------------

@pytest.mark.parametrize("scale", ["n", "s", "m"])
def test_yolo26_builds_with_the_jax_parameter_count_and_round_trips(scale):
    name = f"yolo26-master-{scale}"
    port = DetectionModel(name)
    tree = jax_params_of(JaxDetectionModel(name), port)  # port -> JAX, strict
    assert sum(p.numel() for p in port.parameters()) == _trainable(tree)
    if scale == "n":
        assert _trainable(tree) == 5_115_336
    moe = [m for m in port.model if isinstance(m, A2C2fMoE)]
    assert [m.i for m in moe] == [4, 6, 8]
    assert [m.m[0][0].mlp.num_experts for m in moe] == [4, 8, 16]
    assert all(m.gamma is None and m.m[0][0].mlp.top_k == 2 and not m.m[0][0].mlp.add_residual for m in moe)
    assert isinstance(port.model[9], tlayers.SPPF) and isinstance(port.model[10], tlayers.C2PSA)
    attn = port.model[22].m[0]
    assert isinstance(attn[0], tlayers.Bottleneck) and isinstance(attn[1], tlayers.PSABlock)
    plain = [m for m in port.model if isinstance(m, tlayers.C3k2) and m.i != 22]
    assert all(isinstance(b, tlayers.C3k) == (scale == "m" or m.i != 2) for m in plain for b in m.m)
    head = port.head
    assert head.end2end and head.reg_max == 1 and len(head.one2one_cv2) == 3
    back = DetectionModel(name, seed=1)
    back.load_state_dict(state_dict_from_jax(tree), strict=True)  # JAX -> port, strict
    got = back.state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(got[k], v), k


# -- 2. forward_predict -----------------------------------------------------------------------------

@pytest.mark.parametrize("setting", ["default", "calibrated"])
def test_yolo26_forward_predict_matches_jax(y26, setting):
    _, _, x, out = y26
    port, _, ref = out[setting]
    with torch.no_grad():
        y = port.forward_predict(torch.from_numpy(x)).numpy()
    assert y.shape == ref.shape == (2, 84, 84)
    if setting == "calibrated":
        assert np.abs(ref[0] - ref[1]).max() > 1.0  # the output depends on the image
    box_tol, score_tol = _tols(port, x, setting)
    assert np.abs(y[BOX] - ref[BOX]).max() <= box_tol
    assert np.abs(y[SCORE] - ref[SCORE]).max() <= score_tol


def test_yolo26_fuse_folds_what_jax_folds(y26):
    """fuse_bn folds every Conv (the act=False ones of SPPF and the attention
    blocks, and the depthwise pe convs, too) and leaves the routers' and
    shared experts' [PlainConv, BatchNorm] pairs (3 a MoE block, 6 blocks), as
    fuse_bn_params does: the folded JAX tree loads strict into the folded
    port, and the two agree within 4x the folded port's own fp32-vs-fp64
    error; the fused stem's plain version on uint8 lands as close to the
    unfused JAX model."""
    _, forward, x, out = y26
    port, params, _ = out["calibrated"]
    fused = copy.deepcopy(port)
    fuse_bn(fused)
    assert sum(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules()) == 18
    jfused = _np_tree(fuse_bn_params(params))
    fused.load_state_dict(state_dict_from_jax(jfused), strict=True)
    ref_f = np.asarray(forward(jfused, jnp.asarray(x)))
    with torch.no_grad():
        y = fused.forward_predict(torch.from_numpy(x)).numpy()
    box_tol, score_tol = _tols(fused, x, "calibrated")
    assert np.abs(y[BOX] - ref_f[BOX]).max() <= box_tol
    assert np.abs(y[SCORE] - ref_f[SCORE]).max() <= score_tol
    fused_stem_fuse(fused)
    assert isinstance(fused.model[0], tlayers.FusedStem) and fused.uint8_input
    x_u8 = np.round(x * 255).astype(np.uint8)
    with torch.no_grad():
        y8 = fused.forward_predict(torch.from_numpy(x_u8)).numpy()
    ref8 = np.asarray(forward(params, jnp.asarray(x_u8 / np.float32(255))))
    box_tol, score_tol = _tols(fused, x_u8.astype(np.float32), "calibrated")
    assert np.abs(y8[BOX] - ref8[BOX]).max() <= box_tol
    assert np.abs(y8[SCORE] - ref8[SCORE]).max() <= score_tol


# -- 3. the facade ------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def facades():
    """Both facades on the port's seeded weights, BN calibrated on a batch of
    four letterboxed images and the class biases at 0 (so that the scores
    spread). The JAX facade is built on jax.eval_shape's tree, then takes the
    port's weights through its own load_state_dict."""
    rng = np.random.default_rng(23)
    imgs = [(rng.random((80, 70, 3)) * 255).astype(np.uint8) for _ in range(4)]
    port = YOLO(Y26, device="cpu")
    calibrate_bn(port.model, tpredictor.DetectionPredictor(port.model, imgsz=IMGSZ).preprocess(imgs)[0])
    with torch.no_grad():
        for branch in (*port.model.head.cv3, *port.model.head.one2one_cv3):
            branch[-1].bias.zero_()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxDetectionModel, "init_params",
                   lambda self, seed=0: jax.eval_shape(self.init, jax.random.PRNGKey(seed)))
        jy = JaxYOLO(Y26)
    jy.load_state_dict(port.model.state_dict())
    fused = YOLO(Y26, device="cpu").load_state_dict(port.model.state_dict()).fuse()
    return jy, port, fused, imgs


def _no_nms(mp):
    def refuse(*a, **k):
        raise AssertionError("an end2end head takes no NMS")
    mp.setattr(tpredictor, "non_max_suppression", refuse)
    mp.setattr(tvalidator, "non_max_suppression", refuse)


def test_yolo26_facade_predict_matches_the_jax_end2end_predictor(facades, monkeypatch):
    """Fused (BN folded, the stem's plain version on uint8) against the JAX
    facade, batch 1 and 2: the same detections, in order, within 0.1 px and
    1e-4 on scores; ``iou`` changes nothing; no NMS runs."""
    jy, _, fused, imgs = facades
    _no_nms(monkeypatch)
    kw = dict(imgsz=IMGSZ, conf=0.05, max_det=40)
    for batch in (1, 2):
        ref = jy.predict(imgs[:2], batch=batch, **kw)
        out = fused.predict(imgs[:2], batch=batch, **kw)
        again = fused.predict(imgs[:2], batch=batch, iou=0.01, **kw)
        for o, r, a in zip(out, ref, again):
            assert 0 < len(o.boxes) == len(r.boxes) <= 40
            np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, atol=0.1, rtol=0)
            np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, atol=1e-4, rtol=0)
            np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
            np.testing.assert_array_equal(a.boxes.data, o.boxes.data)


def test_yolo26_class_filter_applies_after_the_selection(facades, monkeypatch):
    """``classes=``: the detections of the other classes are dropped from the
    top-k selection, as the upstream end2end postprocess does, and the kept
    ones stay in their order: the unfiltered detections of those classes."""
    _, port, _, imgs = facades
    _no_nms(monkeypatch)
    kw = dict(imgsz=IMGSZ, conf=0.05, max_det=60, batch=2)
    full = port.predict(imgs[:2], **kw)
    keep = sorted({int(c) for r in full for c in r.boxes.cls[:20:3]})
    out = port.predict(imgs[:2], classes=keep, **kw)
    for o, f in zip(out, full):
        sel = np.isin(f.boxes.cls, keep)
        assert 0 < len(o.boxes) == sel.sum() < len(f.boxes)
        np.testing.assert_array_equal(o.boxes.data, f.boxes.data[sel])


# -- 4. validation --------------------------------------------------------------------------------------

def test_jax_validator_nms_reads_the_end2end_xyxy_decode_as_xywh(y26):
    """The fault of the JAX validator: JAX's end2end decode gives xyxy boxes
    (corner pairs: x2 > x1 on every anchor at the init), and JAX's
    ``non_max_suppression``, which the validator runs on it, converts them as
    if they were xywh: each kept box is xywh2xyxy of a decoded box, and of no
    decoded box is it the box itself."""
    jm, forward, x, out = y26
    _, params, _ = out["default"]
    decoded = forward(params, jnp.asarray(x))
    dec = np.asarray(decoded)
    assert (dec[..., 2] > dec[..., 0]).all() and (dec[..., 3] > dec[..., 1]).all()
    det = jax.tree_util.tree_map(np.asarray, jax_nms(decoded, nc=80, conf_thres=0.0, iou_thres=0.7, max_det=300,
                                                     max_nms=4096, multi_label=True))
    converted = np.asarray(jax_xywh2xyxy(jnp.asarray(dec[..., :4])))
    for i in range(2):
        kept = det["boxes"][i][det["valid"][i]]
        assert len(kept) > 10
        to_conv = np.abs(kept[:, None] - converted[i][None]).max(-1).min(1)
        to_own = np.abs(kept[:, None] - dec[i, :, :4][None]).max(-1).min(1)
        assert to_conv.max() < 1e-3 and to_own.min() > 1.0, (to_conv.max(), to_own.min())


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """6 noise PNGs with rectangles (long side 64, so no resize) and a yaml
    (names: the 80 COCO classes); labels come later (:func:`labelled`)."""
    root = tmp_path_factory.mktemp("y26val")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(37)
    for i, (h0, w0) in enumerate(VAL_SHAPES):
        im = rng.integers(0, 60, (h0, w0, 3)).astype(np.uint8)
        for _ in range(2):
            bw, bh = int(rng.integers(w0 // 5, w0 // 2)), int(rng.integers(h0 // 5, h0 // 2))
            x1, y1 = int(rng.integers(0, w0 - bw)), int(rng.integers(0, h0 - bh))
            im[y1:y1 + bh, x1:x1 + bw] = rng.integers(80, 255, 3)
        Image.fromarray(im).save(root / "images" / f"{i + 1:06d}.png")
    lines = [f"path: {root}", "train: images", "val: images", "names:"]
    (root / "data.yaml").write_text("\n".join(lines + [f"  {k}: {v}" for k, v in coco_names().items()]) + "\n")
    return root


@pytest.fixture(scope="module")
def val_weights(val_set):
    """(JAX model, JAX params, the port's facade): the seeded init with BN
    calibrated on the set's images and the class biases of both branches at
    0, carried into the JAX tree."""
    y = YOLO(Y26, device="cpu", seed=5)
    ds = tdataset.YOLODataset(str(val_set / "data.yaml"), imgsz=IMGSZ)
    images = next(tdataset.DataLoader(ds, len(ds)).epoch())["images"]
    calibrate_bn(y.model, torch.from_numpy(images).float() / 255.0)
    with torch.no_grad():
        for branch in (*y.model.head.cv3, *y.model.head.one2one_cv3):
            branch[-1].bias.zero_()
    jm = JaxDetectionModel(Y26)
    return jm, import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), y.model.state_dict(), strict=True), y


@pytest.fixture(scope="module")
def labelled(val_set, val_weights):
    """Labels from the port's own detections at batch 4 (each image's 3 best,
    jittered), so that the metrics compare real matches."""
    _, _, y = val_weights
    ds = tdataset.YOLODataset(str(val_set / "data.yaml"), imgsz=IMGSZ)
    v = DetectionValidator(y.model, imgsz=IMGSZ)
    rng = np.random.default_rng(8)
    seen = 0
    for b in tdataset.DataLoader(ds, BATCH).epoch():
        det = {k: t.numpy() for k, t in v.run(v.preprocess(b["images"])).items()}
        for i in range(min(BATCH, len(ds) - seen)):
            h0, w0 = ds.shapes[seen]
            boxes = v._to_original(det["boxes"][i, :3], *v._letterbox_params(h0, w0), w0, h0, clip=True)
            rows = []
            for box, c in zip(boxes, det["classes"][i, :3]):
                box = box + rng.uniform(-0.1, 0.1, 4) * np.tile(box[2:] - box[:2], 2)
                x1, x2 = np.clip(box[[0, 2]], 0, w0)
                y1, y2 = np.clip(box[[1, 3]], 0, h0)
                if x2 - x1 >= 1 and y2 - y1 >= 1:
                    rows.append(f"{int(c)} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} "
                                f"{(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
            (val_set / "labels" / f"{Path(ds.img_files[seen]).stem}.txt").write_text("\n".join(rows) + "\n")
            seen += 1
    return val_set / "data.yaml"


def test_yolo26_val_matches_the_end2end_reference(labelled, val_weights, monkeypatch):
    """The port's val (no NMS) against the JAX validator whose device function
    is the end2end graph from JAX's pieces: ``forward_predict``,
    ``head.postprocess_end2end`` at the validator's max_det, the conf mask.
    Per-image detection counts equal, each metric within 1e-3."""
    jm, params, y = val_weights
    with monkeypatch.context() as mp:
        _no_nms(mp)
        counts = _counting(mp, tmetrics.DetMetrics)
        m = y.val(data=str(labelled), imgsz=IMGSZ, batch=BATCH)

    def end2end(p, x, conf=0.001, max_det=300):
        out = jm.head.postprocess_end2end(jm.forward_predict(p, x, Context(training=False)), max_det)
        ok = out[..., 4] > conf
        return {"boxes": out[..., :4], "scores": out[..., 4] * ok, "classes": jnp.where(ok, out[..., 5], -1.0),
                "valid": ok}

    jv = JaxValidator(model=jm, params=params, data=str(labelled), imgsz=IMGSZ, batch=BATCH)
    jv._fn = jax.jit(end2end)
    with monkeypatch.context() as mp:
        jcounts = _counting(mp, jmetrics.DetMetrics)
        jmm = jv()
    assert m["images"] == jmm["images"] == len(VAL_SHAPES)
    assert counts == jcounts and min(counts) > 0
    assert m["mAP50"] > 0.1  # real matches, not 0 against 0
    for k in METRICS:
        assert np.isfinite(m[k]) and abs(m[k] - jmm[k]) <= METRIC_TOL, (k, m[k], jmm[k])


def test_sahi_refuses_an_end2end_head():
    """SparseSAHIPredictor reads the decode as xywh (its gate's anchor centres,
    the merge): over the end2end head's xyxy decode it would misplace every
    box, as the JAX package's does; the port refuses, naming ROADMAP item 16."""
    from yolo_master_tpu_torch.engine.sahi import SparseSAHIPredictor

    with pytest.raises(NotImplementedError, match="item 16"):
        SparseSAHIPredictor(DetectionModel(Y26).eval())


def test_yolo26_training_refuses_until_its_slice():
    """The end2end loss is computed (its slice has come): the train forward's
    two branches give a finite dual-assignment loss whose box, cls and L1
    terms exceed the one2many branch's alone, and the gradient reaches the
    one2one branches (tests/test_torch_yolo26_train.py holds it to JAX)."""
    port = DetectionModel(Y26).train()
    preds = port(torch.rand(2, IMGSZ, IMGSZ, 3))
    assert set(preds) == {"one2many", "one2one", "hw_shapes"}
    batch = {"boxes": torch.tensor([[[4.0, 4.0, 30.0, 30.0]]]).repeat(2, 1, 1), "classes": torch.zeros(2, 1),
             "mask": torch.ones(2, 1)}
    total, metrics = port.compute_loss(preds, batch, torch.zeros(()), {})
    assert torch.isfinite(total) and float(total.detach()) > 0
    one2many = {k: v for k, v in preds.items() if k != "one2one"}
    _, many = port.compute_loss(one2many, batch, torch.zeros(()), {})
    for k in ("box_loss", "cls_loss", "dfl_loss"):
        assert float(metrics[k]) > float(many[k]) > 0, k
    total.backward()
    assert port.head.one2one_cv3[0][-1].bias.grad.abs().sum() > 0
