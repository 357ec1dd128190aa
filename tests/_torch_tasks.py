"""Shared by tests/test_torch_task_predict.py and test_torch_task_val.py: the
task models at n in both packages on the same weights, and synthetic task
sets labelled from the port's own detections.

Weights: the port's seeded init with BN calibrated on the set's images and the
head's class biases at 0 (the init's prior puts nearly every score below the
validator's conf 0.001), carried into JAX's ``jax.eval_shape`` tree (strict).
Sets: noise PNGs with bright rectangles at sizes below, at and above 64 px
(the dataset's rect resize runs), one yaml each for segment, pose and obb,
and a folder per class for classify; labels are the port's predictions,
jittered and unclipped: the box or the mask's contour as polygons, the box
with its keypoints, the rotated box's corners, and the top-1 or top-3 class.
"""

from pathlib import Path

import cv2
import numpy as np
import torch
from PIL import Image

import jax

from yolo_master_tpu.nn import tasks as jtasks
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.data.letterbox import letterbox
from yolo_master_tpu_torch.nn.heads import Classify
from yolo_master_tpu_torch.utils.weights import calibrate_bn

IMGSZ = 64
SHAPES = [(48, 64), (64, 40), (64, 64), (30, 64), (96, 72), (80, 120)]  # (h0, w0)
NAMES = {"segment": "yolo-master-seg-n", "pose": "yolo-master-pose-n", "obb": "yolo-master-obb-n",
         "classify": "yolo-master-cls-n"}
JAX_MODELS = {"segment": jtasks.SegmentationModel, "pose": jtasks.PoseModel, "obb": jtasks.OBBModel,
              "classify": jtasks.ClassificationModel}


_LAYER_SHAPES = {}  # (generation, layer index, module type, head's graph) -> the layer's parameter shapes


def jax_tree_of(jm, port):
    """The port's weights in the JAX model's tree (numpy leaves; ``import_state_dict``,
    strict), the tree's shapes from ``jax.eval_shape`` of each layer's init (JAX's
    tree is {"layers": {i: layer.init(key_i)}}) rather than of the model's: a layer
    that the task graphs of a generation share (the backbone, and seg, pose and
    obb's neck) is traced once a process. Graphs at one scale only."""
    name = jm.yaml_file.stem  # e.g. yolo-master-v0_10-seg
    gen = name.rsplit("-", 1)[0]
    shapes = {}
    for i, layer in enumerate(jm.layers):
        kind = type(layer).__name__
        key = (gen, i, kind, name if kind in ("Segment", "Pose", "OBB", "Classify") else "")
        if key not in _LAYER_SHAPES:
            _LAYER_SHAPES[key] = jax.eval_shape(layer.init, jax.random.PRNGKey(0))
        shapes[str(i)] = _LAYER_SHAPES[key]
    return jax.tree_util.tree_map(np.asarray, import_state_dict({"layers": shapes}, port.state_dict(), strict=True))


def noise_images(seed: int = 31):
    rng = np.random.default_rng(seed)
    out = []
    for h0, w0 in SHAPES:
        im = rng.integers(0, 60, (h0, w0, 3)).astype(np.uint8)
        for _ in range(2):
            bw, bh = int(rng.integers(w0 // 5, w0 // 2)), int(rng.integers(h0 // 5, h0 // 2))
            x1, y1 = int(rng.integers(0, w0 - bw)), int(rng.integers(0, h0 - bh))
            im[y1:y1 + bh, x1:x1 + bw] = rng.integers(80, 255, 3)
        out.append(im)  # BGR, as cv2 reads it back
    return out


def write_images(root: Path, images) -> None:
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i, im in enumerate(images):
        Image.fromarray(im[..., ::-1]).save(root / "images" / f"{i + 1:06d}.png")
    (root / "data.yaml").write_text(f"path: {root}\nval: images\nnames:\n" +
                                    "".join(f"  {c}: c{c}\n" for c in range(80)))


def task_weights(task: str, images, seed: int = 5):
    """(JAX model, its params, the port's facade on the same weights)."""
    y = YOLO(NAMES[task], device="cpu", seed=seed)
    size = (IMGSZ, IMGSZ)
    x = np.stack([cv2.resize(im, size) if task == "classify" else letterbox(im, size, scaleup=False)[0]
                  for im in images])
    calibrate_bn(y.model, torch.from_numpy(np.ascontiguousarray(x[..., ::-1])).float() / 255.0)
    if not isinstance(y.model.head, Classify):
        with torch.no_grad():
            for branch in y.model.head.cv3:
                branch[-1].bias.zero_()
    jm = JAX_MODELS[task](NAMES[task])
    return jm, jax_tree_of(jm, y.model), y


def _jitter(rng, pts, scale):
    return pts + rng.uniform(-0.08, 0.08, pts.shape) * scale


def label_task_set(root: Path, task: str, y, images, seed: int = 8) -> Path:
    """Write each image's labels from the port's predictions (conf 0.25, its 3
    best), unclipped: the task validators match in letterboxed pixels without
    clipping, and random weights give boxes larger than the image."""
    rng = np.random.default_rng(seed)
    y.predict(list(images), imgsz=IMGSZ, conf=0.25, batch=len(images))
    pred = y._predictor
    x, meta = pred.preprocess(images)
    det = {k: v.numpy() for k, v in pred.run(x).items()}
    for i, im in enumerate(images):
        (h0, w0), ratio, pad = meta[i]
        wh = np.array([w0, h0], np.float64)
        r = pred._build_result("array", im, meta[i], {k: v[i] for k, v in det.items()})
        rows = []
        for j in range(min(3, len(r))):
            if task == "obb":
                pts = _jitter(rng, r.obb.xyxyxyxy[j].astype(np.float64), r.obb.data[j, 2:4].max())
                rows.append(f"{int(r.obb.cls[j])} " + " ".join(f"{v:.6f}" for v in (pts / wh).ravel()))
                continue
            box = (det["boxes"][i, j].astype(np.float64) - np.tile(pad, 2)) / np.tile(ratio, 2)
            size = box[2:] - box[:2]
            box = _jitter(rng, box, np.tile(size, 2))
            c = int(det["classes"][i, j])
            if task == "segment":  # the box (mask matches then fail), or the mask's contour (box matches fail)
                seg = r.masks.xy[j] if r.masks is not None and j % 2 else np.zeros((0, 2))
                if len(seg) < 3:
                    seg = np.array([box[[0, 1]], box[[2, 1]], box[[2, 3]], box[[0, 3]]])
                rows.append(f"{c} " + " ".join(f"{v:.6f}" for v in (seg / wh).ravel()))
            else:  # pose: the box, then each keypoint (x, y, visible)
                k = det["extra"][i, j].reshape(-1, 3).astype(np.float64)
                k[:, :2] = (_jitter(rng, (k[:, :2] - pad) / ratio, size.max() / 4)) / wh
                k[:, 2] = np.where(rng.random(len(k)) < 0.8, 2, 0)
                xc, yc = (box[:2] + box[2:]) / 2 / wh
                bw, bh = (box[2:] - box[:2]) / wh
                rows.append(f"{c} {xc:.6f} {yc:.6f} {bw:.6f} {bh:.6f} " + " ".join(f"{v:.6f}" for v in k.ravel()))
        (root / "labels" / f"{i + 1:06d}.txt").write_text("\n".join(rows) + "\n")
    return root / "data.yaml"


def write_class_set(root: Path, y, images) -> Path:
    """``root/val/<class>/``: a folder per class of the model's 1000 (named so that
    they sort by index); each image in its top-1 class or its 3rd."""
    square = [cv2.resize(im, (IMGSZ, IMGSZ)) for im in images]  # what the dataset feeds the validator
    probs = [r.probs.data for r in y.predict(square, imgsz=IMGSZ, batch=len(images))]
    val = root / "val"
    for c in range(len(probs[0])):
        (val / f"{c:04d}").mkdir(parents=True)
    for i, (p, im) in enumerate(zip(probs, images)):
        c = int(np.argsort(-p)[0 if i % 2 == 0 else 2])
        Image.fromarray(im[..., ::-1]).save(val / f"{c:04d}" / f"{i:03d}.png")
    return root
