"""The port's validation path, YOLO(...).val() / engine/validator.py, against the
JAX package's DetectionValidator on the CPU.

A synthetic set (10 PNGs of varied shapes, below and above imgsz=64, with
rectangles and YOLO labels, one image without labels) is written by the test.
The same weights go to both packages: the port's seeded init with BN
calibrated on a batch of the set, carried into the JAX tree
(``import_state_dict``) and back (``load_jax_params``). Gates:

1. the dataset: batches, ``shapes``, ``_letterbox_params`` and the tail's wrap
   padding equal JAX's bit for bit (the port's uint8 / 255 is JAX's float);
2. the host pipeline, exact: seeded decoded predictions (jittered GT copies
   under several classes, distractors, scores below conf 0.001 and exact ties)
   through the port's NMS and host half and through JAX's: keep sets equal,
   metrics equal to 1e-9, COCO rows equal row for row, and ``evaluate_coco``;
3. the whole validator, unfused and fused: per-image detection counts equal,
   the four metrics within :data:`METRIC_TOL` of JAX's;
4. bf16: the decoded outputs of the port's bf16 copy within the whole-model
   statistic of tests/test_torch_bf16.py (rel-RMS from JAX fp32 within 1.5x
   JAX bf16's own, on a batch of 8), and the
   host pipeline exact on those shared bf16 outputs;
5. the facade's keywords and the refusals.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from yolo_master_tpu.data.dataset import DataLoader as JaxDataLoader
from yolo_master_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yolo_master_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_master_tpu.utils import coco as jcoco
from yolo_master_tpu.utils import metrics as jmetrics
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.data import dataset as tdataset
from yolo_master_tpu_torch.engine.validator import DetectionValidator
from yolo_master_tpu_torch.ops.nms import non_max_suppression
from yolo_master_tpu_torch.utils import coco as tcoco
from yolo_master_tpu_torch.utils import coco_names
from yolo_master_tpu_torch.utils import metrics as tmetrics
from yolo_master_tpu_torch.utils.fuse import current_dtype_copy
from yolo_master_tpu_torch.utils.weights import calibrate_bn

IMGSZ = 64
BATCH = 4  # 10 images: batches of 4, 4 and 2 + 2 wrapped
# (h0, w0): long side below, at and above IMGSZ, portrait and landscape
SHAPES = [(40, 52), (64, 64), (120, 90), (70, 130), (33, 80), (96, 72), (150, 150), (60, 100), (48, 36), (100, 64)]
NMS_KW = dict(nc=80, conf_thres=0.001, iou_thres=0.7, max_det=300, max_nms=4096, multi_label=True)
# gate 3: |port - JAX| of each metric. Measured on this set: mAP50 and mAP50-95
# equal, precision and recall 1.2e-6 to 3.6e-6 apart (read at the best F1's
# confidence, which moves with an ulp of the scores). On the card at 640
# (chip_smoke.py's val phase) the port's validator and its CPU run agree exactly
# and fp32 against fp64 moves mAP50 by 3.1e-5; 1e-3 leaves room for a match
# that flips at one IoU threshold (PERF.md §7)
METRIC_TOL = 1e-3
METRICS = ("precision", "recall", "mAP50", "mAP50-95")
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The synthetic set's yaml (names: the 80 COCO classes, so COCO rows take
    the 80 -> 91 map) and its COCO-format GT json in original pixels."""
    root = tmp_path_factory.mktemp("synthval")
    img_dir, lbl_dir = root / "images" / "val", root / "labels" / "val"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    rng = np.random.default_rng(1234)
    palette = rng.integers(60, 255, (8, 3))
    anns = []
    for i, (h0, w0) in enumerate(SHAPES):
        im = rng.integers(0, 50, (h0, w0, 3)).astype(np.uint8)
        rows = []
        for _ in range(0 if i == 4 else int(rng.integers(1, 5))):
            c = int(rng.integers(0, 8))
            bw, bh = int(rng.integers(w0 // 6, w0 // 2)), int(rng.integers(h0 // 6, h0 // 2))
            x1, y1 = int(rng.integers(0, w0 - bw)), int(rng.integers(0, h0 - bh))
            im[y1: y1 + bh, x1: x1 + bw] = palette[c]
            rows.append(f"{c} {(x1 + bw / 2) / w0:.6f} {(y1 + bh / 2) / h0:.6f} {bw / w0:.6f} {bh / h0:.6f}")
            anns.append({"id": len(anns), "image_id": i + 1, "category_id": tcoco.COCO80_TO_COCO91[c],
                         "bbox": [x1, y1, bw, bh], "area": bw * bh, "iscrowd": 0})
        Image.fromarray(im).save(img_dir / f"{i + 1:06d}.png")
        if rows:  # image 5 has no label file
            (lbl_dir / f"{i + 1:06d}.txt").write_text("\n".join(rows) + "\n")
    yaml_path = root / "data.yaml"
    names = coco_names()
    lines = [f"path: {root}", "train: images/val", "val: images/val", "names:"]
    yaml_path.write_text("\n".join(lines + [f"  {k}: {v}" for k, v in names.items()]) + "\n")
    gt_json = root / "gt.json"
    gt_json.write_text(json.dumps({"images": [{"id": i + 1} for i in range(len(SHAPES))], "annotations": anns}))
    return yaml_path, gt_json


# -- 1. the dataset ------------------------------------------------------------------------

def test_dataset_batches_equal_jax_bit_for_bit(synth):
    yaml_path, _ = synth
    td = tdataset.YOLODataset(str(yaml_path), imgsz=IMGSZ, max_gt=16)
    jd = JaxYOLODataset(str(yaml_path), split="val", imgsz=IMGSZ, max_gt=16, augment=False)
    assert td.img_files == jd.img_files and td.names == jd.names and td.shapes == jd.shapes
    assert [h_w for h_w in td.shapes] == SHAPES
    tv, jv = DetectionValidator(YOLO("yolo-master-n", device="cpu").model, imgsz=IMGSZ), JaxValidator(imgsz=IMGSZ)
    for h0, w0 in td.shapes:
        assert tv._letterbox_params(h0, w0) == jv._letterbox_params(h0, w0)
    tb, jb = list(tdataset.DataLoader(td, BATCH).epoch()), list(JaxDataLoader(jd, BATCH, shuffle=False).epoch(0))
    assert len(tb) == len(jb) == 3
    for t, j in zip(tb, jb):
        assert t["images"].dtype == np.uint8 and t["images"].shape == (BATCH, IMGSZ, IMGSZ, 3)
        np.testing.assert_array_equal(t["images"].astype(np.float32) / 255.0, j["images"])
        np.testing.assert_array_equal(tv.preprocess(t["images"]).numpy(), j["images"])  # the validator's cast
        for k in ("boxes", "classes", "mask"):
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    assert sum(int(t["mask"].sum()) for t in tb[:2]) + int(tb[2]["mask"][:2].sum()) == sum(map(len, td.labels))
    # the tail batch: images 9, 10, then 1, 2 again
    first = tb[0]
    for k in ("images", "boxes", "classes", "mask"):
        np.testing.assert_array_equal(tb[2][k][2:], first[k][:2])


def test_dataset_reads_png_without_opencv_and_refuses_to_resize(synth, monkeypatch):
    """Without OpenCV a PNG decodes with PIL to the same BGR pixels, an image at
    long side imgsz needs no resize and loads, and one that needs a resize
    raises instead of resampling otherwise."""
    yaml_path, _ = synth
    td = tdataset.YOLODataset(str(yaml_path), imgsz=IMGSZ)
    with_cv2 = [td._imread(i) for i in range(len(td))]
    ref = td.load_sample(1)
    monkeypatch.setattr(tdataset, "cv2", None)
    for i, im in enumerate(with_cv2):
        np.testing.assert_array_equal(td._imread(i), im)
    im, lbl = td.load_sample(1)  # 64x64: no resize
    np.testing.assert_array_equal(im, ref[0])
    np.testing.assert_array_equal(lbl, ref[1])
    with pytest.raises(RuntimeError, match="OpenCV"):
        td.load_sample(0)


# -- 2. the host pipeline on shared detections --------------------------------------------------

def seeded_predictions(batch, seed, anchors=84, nc=80):
    """Decoded predictions [B, anchors, 4 + nc] (xywh letterboxed px, probabilities)
    for one loader batch: three jittered copies of each GT box (its class at
    0.55-0.95, another class at 0.2-0.5, one under both), distractor boxes, class
    noise on a 1/4096 grid spread over (0, 0.003) (a third below conf 0.001, many
    exact ties), and a run of rows copied from one (tied across anchors)."""
    rng = np.random.default_rng(seed)
    b = batch["images"].shape[0]
    xy = rng.uniform(0, IMGSZ, (b, anchors, 2))
    wh = rng.uniform(4, IMGSZ / 2, (b, anchors, 2))
    scores = np.round(rng.uniform(0, 0.003, (b, anchors, nc)) * 4096) / 4096
    for i in range(b):
        row = 0
        for box, c in zip(batch["boxes"][i][batch["mask"][i]], batch["classes"][i][batch["mask"][i]]):
            for _ in range(3):
                j = rng.uniform(-0.08, 0.08, 4) * np.tile(box[2:] - box[:2], 2)
                x1, y1, x2, y2 = box + j
                xy[i, row], wh[i, row] = ((x1 + x2) / 2, (y1 + y2) / 2), (x2 - x1, y2 - y1)
                scores[i, row, c] = rng.uniform(0.55, 0.95)
                scores[i, row, (c + 1 + rng.integers(0, nc - 1)) % nc] = rng.uniform(0.2, 0.5)
                row += 1
    scores[:, 60:70] = scores[:, 60:61]
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


def host_pipelines(synth, decoded, batch=BATCH):
    """Each package's validator over the set with its device step replaced by its
    own NMS of the given decoded batches: (port metrics, JAX metrics, port det,
    JAX det, port COCO rows, JAX COCO rows)."""
    yaml_path, _ = synth
    out = {}
    for pkg in ("port", "jax"):
        it, dets = iter(decoded), []
        json_path = yaml_path.parent / f"pred_{pkg}.json"
        if pkg == "port":
            v = DetectionValidator(YOLO("yolo-master-n", device="cpu").model, data=str(yaml_path), imgsz=IMGSZ,
                                   batch=batch, save_json=str(json_path))

            def run(x, it=it, dets=dets):
                dets.append(non_max_suppression(torch.from_numpy(next(it)), **NMS_KW))
                return dets[-1]
            v.run = run
            m = v()
        else:
            v = JaxValidator(model=JaxDetectionModel("yolo-master-n"), data=str(yaml_path), imgsz=IMGSZ,
                             batch=batch, save_json=str(json_path))

            def fn(params, x, it=it, dets=dets):
                dets.append(jax_nms(jnp.asarray(next(it)), **NMS_KW))
                return dets[-1]
            v._fn = fn
            m = v(params={})
        out[pkg] = (m, dets, json.loads(json_path.read_text()), json_path)
    return out


def assert_pipelines_equal(out, gt_json, coco=True):
    (tm, tdets, trows, tpath), (jm, jdets, jrows, jpath) = out["port"], out["jax"]
    for t, j in zip(tdets, jdets):
        np.testing.assert_array_equal(t["valid"].numpy(), np.asarray(j["valid"]))
        np.testing.assert_array_equal(t["classes"].numpy(), np.asarray(j["classes"]))
        np.testing.assert_array_equal(t["scores"].numpy(), np.asarray(j["scores"]))
        np.testing.assert_array_equal(t["boxes"].numpy(), np.asarray(j["boxes"]))
    assert tm["images"] == jm["images"] == len(SHAPES)
    for k in (*METRICS, "fitness"):
        assert abs(tm[k] - jm[k]) <= 1e-9, (k, tm[k], jm[k])
    assert trows == jrows and len(trows) > 0
    if coco:
        assert tcoco.evaluate_coco(str(gt_json), str(tpath)) == jcoco.evaluate_coco(str(gt_json), str(jpath))
    return tm


def test_host_pipeline_on_seeded_detections_equals_jax(synth):
    yaml_path, gt_json = synth
    batches = tdataset.DataLoader(tdataset.YOLODataset(str(yaml_path), imgsz=IMGSZ), BATCH).epoch()
    decoded = [seeded_predictions(b, seed) for seed, b in enumerate(batches)]
    out = host_pipelines(synth, decoded)
    m = assert_pipelines_equal(out, gt_json)
    # real matches, not 0 against 0 (measured: mAP50-95 0.53)
    assert m["mAP50-95"] > 0.3 and m["mAP50"] > 0.6, m
    rows = out["port"][2]
    assert {r["category_id"] for r in rows} - set(tcoco.COCO80_TO_COCO91) == set()  # mapped to COCO ids
    assert {r["image_id"] for r in rows} == set(range(1, len(SHAPES) + 1))
    assert int(out["port"][1][0]["valid"].sum(1).max()) == 300  # max_det reached: most candidates pass conf 0.001


# -- 3. the whole validator ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(synth):
    """(JAX params, the port's unfused facade): the port's seeded init with BN
    calibrated on the set's first batch of 8, carried into the JAX tree and
    back into a second facade."""
    yaml_path, _ = synth
    seeded = YOLO("yolo-master-n", device="cpu", seed=3)
    batch = next(tdataset.DataLoader(tdataset.YOLODataset(str(yaml_path), imgsz=IMGSZ), 8).epoch())
    calibrate_bn(seeded.model, torch.from_numpy(batch["images"]).float() / 255.0)
    with torch.no_grad():  # the init's class bias puts nearly every score below conf 0.001
        for branch in seeded.model.head.cv3:
            branch[-1].bias.zero_()
    jm = JaxDetectionModel("yolo-master-n")
    params = import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seeded.model.state_dict(),
                               strict=True)
    port = YOLO("yolo-master-n", device="cpu").load_jax_params(params)
    for k, v in seeded.model.state_dict().items():
        assert k.endswith("num_batches_tracked") or torch.equal(port.model.state_dict()[k], v), k
    return jm, params, port, batch


@pytest.fixture(scope="module")
def labelled(synth, weights, tmp_path_factory):
    """The set's images with labels drawn from the port's own fp32 detections at
    conf 0.001 (each image's 4 best, each box jittered by up to 10% of its
    size), so that the whole-validator gate compares real matches at every IoU
    threshold (random weights find none of the drawn rectangles)."""
    yaml_path, _ = synth
    _, _, port, _ = weights
    root = tmp_path_factory.mktemp("labelled")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    ds = tdataset.YOLODataset(str(yaml_path), imgsz=IMGSZ)
    v = DetectionValidator(port.model, imgsz=IMGSZ)
    rng = np.random.default_rng(7)
    seen = 0
    for b in tdataset.DataLoader(ds, BATCH).epoch():
        det = {k: t.numpy() for k, t in v.run(v.preprocess(b["images"])).items()}
        for i in range(min(BATCH, len(ds) - seen)):
            src = Path(ds.img_files[seen])
            (root / "images" / src.name).write_bytes(src.read_bytes())
            h0, w0 = ds.shapes[seen]
            boxes = v._to_original(det["boxes"][i, :4], *v._letterbox_params(h0, w0), w0, h0, clip=True)
            rows = []
            for box, c in zip(boxes, det["classes"][i, :4]):
                box = box + rng.uniform(-0.1, 0.1, 4) * np.tile(box[2:] - box[:2], 2)
                x1, x2 = np.clip(box[[0, 2]], 0, w0)
                y1, y2 = np.clip(box[[1, 3]], 0, h0)
                if x2 - x1 >= 1 and y2 - y1 >= 1:
                    rows.append(f"{int(c)} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} "
                                f"{(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
            (root / "labels" / f"{src.stem}.txt").write_text("\n".join(rows) + "\n")
            seen += 1
    out = root / "data.yaml"
    out.write_text(yaml_path.read_text().replace(str(yaml_path.parent), str(root)).replace("images/val", "images"))
    return out


def _counting(monkeypatch, cls):
    """Record each image's prediction count as ``cls.update`` (DetMetrics) sees it."""
    counts, orig = [], cls.update

    def update(self, pred_boxes, *args):
        counts.append(len(pred_boxes))
        return orig(self, pred_boxes, *args)
    monkeypatch.setattr(cls, "update", update)
    return counts


@pytest.fixture(scope="module")
def jax_val(labelled, weights):
    jm, params, _, _ = weights
    mp = pytest.MonkeyPatch()
    counts = _counting(mp, jmetrics.DetMetrics)
    try:
        m = JaxValidator(model=jm, params=params, data=str(labelled), imgsz=IMGSZ, batch=BATCH)()
    finally:
        mp.undo()
    return m, counts


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_whole_validator_matches_jax(labelled, weights, jax_val, monkeypatch, fused):
    """The port's YOLO.val on the CPU (fused: BN folded and the fused stem's plain
    version on uint8) against the JAX DetectionValidator: per-image detection
    counts equal, each metric within METRIC_TOL."""
    _, _, port, _ = weights
    y = YOLO("yolo-master-n", device="cpu").load_state_dict(port.model.state_dict())
    if fused:
        y.fuse()
        assert y.model.uint8_input
    counts = _counting(monkeypatch, tmetrics.DetMetrics)
    m = y.val(data=str(labelled), imgsz=IMGSZ, batch=BATCH)
    jm, jcounts = jax_val
    assert m["images"] == jm["images"] == len(SHAPES)
    assert counts == jcounts and min(counts) > 0
    for k in METRICS:
        assert np.isfinite(m[k]) and abs(m[k] - jm[k]) <= METRIC_TOL, (k, m[k], jm[k])
    assert set(m["speed"]) == {"load", "device", "match"} and all(v > 0 for v in m["speed"].values())


# -- 4. bf16 ----------------------------------------------------------------------------------

def _rel_rms(a, ref):
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_val_runs_the_current_copy_within_the_bf16_statistic(labelled, weights, fused):
    """val(compute_dtype=bf16) runs the model's one current bf16 copy; that copy's
    decoded outputs on a batch of 8 lie within the whole-model bf16 statistic of
    tests/test_torch_bf16.py: rel-RMS from JAX fp32 within 1.5x that of JAX's own
    bf16 program, boxes and scores apart."""
    jm, params, port, batch = weights
    y = YOLO("yolo-master-n", device="cpu").load_state_dict(port.model.state_dict())
    if fused:
        y.fuse()
    m = y.val(data=str(labelled), imgsz=IMGSZ, batch=BATCH, compute_dtype=BF16)
    assert m["images"] == len(SHAPES) and all(np.isfinite(m[k]) for k in METRICS)
    v = DetectionValidator(y.model, imgsz=IMGSZ, compute_dtype=BF16)
    copy16 = v.model
    assert copy16 is current_dtype_copy(y.model, BF16) and copy16 is not y.model
    with torch.inference_mode():
        port16 = copy16.forward_predict(v.preprocess(batch["images"])).numpy()
    assert port16.dtype == np.float32
    ref32, ref16 = _jax_decoded(jm, params, batch["images"])
    for sl in (np.s_[..., :4], np.s_[..., 4:]):
        own = _rel_rms(ref16[sl], ref32[sl])
        assert 0 < own < 0.5 and _rel_rms(port16[sl], ref32[sl]) <= 1.5 * own, (_rel_rms(port16[sl], ref32[sl]), own)


_JAX_DECODED = {}


def _jax_decoded(jm, params, images):
    """JAX's fp32 and bf16 decoded outputs of one uint8 batch (one compile for both)."""
    if "fn" not in _JAX_DECODED:
        ctx = Context(training=False)
        _JAX_DECODED["fn"] = jax.jit(lambda p, a, b: (jm.forward_predict(p, a, ctx), jm.forward_predict(p, b, ctx)))
    x = jnp.asarray(images.astype(np.float32) / 255.0)
    a, b = _JAX_DECODED["fn"](params, x, x.astype(jnp.bfloat16))
    return np.asarray(a, np.float32), np.asarray(jnp.asarray(b).astype(jnp.float32))


def test_host_pipeline_on_shared_bf16_detections_equals_jax(synth, weights):
    """The port's bf16 decoded outputs of every val batch through both packages'
    NMS and host half: exact, as gate 2. (``evaluate_coco`` is left out: JAX's
    raises on these rows, where a class's every detection lies outside an area
    range; the port's answers as COCOeval, tests/test_torch_metrics.py.)"""
    yaml_path, gt_json = synth
    _, _, port, _ = weights
    v = DetectionValidator(port.model, imgsz=IMGSZ, compute_dtype=BF16)
    decoded = []
    for b in tdataset.DataLoader(tdataset.YOLODataset(str(yaml_path), imgsz=IMGSZ), BATCH).epoch():
        with torch.inference_mode():
            decoded.append(v.model.forward_predict(v.preprocess(b["images"])).numpy())
    out = host_pipelines(synth, decoded)
    assert_pipelines_equal(out, gt_json, coco=False)
    assert np.isfinite(list(tcoco.evaluate_coco(str(gt_json), str(out["port"][3])).values())).all()


# -- 5. the facade and the refusals ----------------------------------------------------------------

def test_val_rejects_unknown_keywords_and_datasets_it_cannot_load(synth):
    yaml_path, _ = synth
    y = YOLO("yolo-master-n", device="cpu")
    with pytest.raises(TypeError, match="unknown val arguments"):
        y.val(data=str(yaml_path), imgsz=IMGSZ, augment=True)
    with pytest.raises(ValueError, match="compute_dtype"):
        y.val(data=str(yaml_path), compute_dtype=torch.float16)
    assert tdataset.YOLODataset(str(yaml_path), split="val", augment=True).augment  # the train half is ported
    with pytest.raises(ValueError, match="cache must be"):
        tdataset.YOLODataset(str(yaml_path), split="val", cache="gpu")
    with pytest.raises(NotImplementedError, match="§1.E item 13"):
        tdataset.SemanticDataset  # noqa: B018
    with pytest.raises(FileNotFoundError):
        tdataset.resolve_data_yaml("no-such-set.yaml")
    assert tdataset.resolve_data_yaml("coco.yaml") == tdataset.DATASETS_DIR / "coco.yaml"
