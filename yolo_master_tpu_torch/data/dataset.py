"""YOLO-format detection dataset and its loader, the validation part
(counterpart of ``yolo_master_tpu/data/dataset.py``; reference:
ultralytics/data/dataset.py:52 YOLODataset, data/base.py load_image).

The loader yields fixed-shape numpy batches: images ``[B, H, W, 3]`` RGB
**uint8** (the JAX package's collate divides by 255 here; the port's
validator casts on the device, so that a fused model's stem kernel reads the
uint8 image as on the predict path), GT padded to ``max_gt`` per image as xyxy
pixel boxes in letterboxed space, class ids and a validity mask. A short last
batch is padded by wrapping to the first images, as in the JAX package.

Images are decoded with OpenCV, or with PIL where OpenCV is missing (lossless
for PNG; JPEG decoders may differ by a rounding). The rect resize needs
OpenCV's INTER_LINEAR for pixel parity and raises without it.

Training augmentations (mosaic, mixup, HSV, flips) come with the train step
(ROADMAP.md §1.C item 7) and the task datasets with the task heads (§1.E
item 13): both raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..utils import DATASETS_DIR, yaml_load
from .letterbox import cv2, letterbox

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}
TRAIN_ITEM = "ROADMAP.md §1.C item 7 (the train step and its augmentations)"
TASK_ITEM = "ROADMAP.md §1.E item 13 (task heads and their datasets)"
TASK_DATASETS = ("SegmentDataset", "PoseDataset", "OBBDataset", "SemanticDataset", "ClassificationDataset")


def __getattr__(name: str):
    if name in TASK_DATASETS:
        raise NotImplementedError(f"{name} is not ported yet: {TASK_ITEM}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve_data_yaml(data: str | Path) -> Path:
    """A dataset yaml by path, or by the name of a config the port holds under
    ``cfg/datasets`` (``data="coco.yaml"``)."""
    p = Path(data)
    if p.exists():
        return p
    zoo = DATASETS_DIR / p.name
    if p.suffix in (".yaml", ".yml") and len(p.parts) == 1 and zoo.exists():
        return zoo
    raise FileNotFoundError(
        f"dataset yaml '{data}' not found (not a file, and no bundled config named "
        f"'{p.name}' under {DATASETS_DIR})"
    )


def resolve_dataset_root(cfg: dict, yaml_path: Path) -> Path:
    """Dataset root: an absolute ``path:`` as it is; a relative one against the
    yaml's directory. (The JAX package then tries its settings file's
    ``datasets_dir``; the port reads no settings file, so a bundled config's
    data is named by an absolute ``path:`` in a yaml of one's own.)"""
    root = Path(cfg.get("path", yaml_path.parent))
    return root if root.is_absolute() else yaml_path.parent / root


def img2label_path(img_path: str) -> str:
    """images/... -> labels/... with .txt (reference data/utils.py)."""
    p = Path(img_path)
    parts = list(p.parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            break
    return str(Path(*parts).with_suffix(".txt"))


class YOLODataset:
    """The val split of a dataset yaml ({path, val, names})."""

    def __init__(self, data: str | Path, imgsz: int = 640, max_gt: int = 128, augment: bool = False):
        if augment:
            raise NotImplementedError(f"augment=True (mosaic, mixup, HSV, flips) is not ported yet: {TRAIN_ITEM}")
        yaml_path = resolve_data_yaml(data)
        cfg = yaml_load(yaml_path)
        self.names = cfg.get("names", {})
        if isinstance(self.names, list):
            self.names = dict(enumerate(self.names))
        self.nc = len(self.names)
        img_dir = resolve_dataset_root(cfg, yaml_path) / cfg["val"]
        self.img_files = sorted(str(f) for f in Path(img_dir).rglob("*") if f.suffix.lower().lstrip(".") in IMG_FORMATS)
        if not self.img_files:
            raise FileNotFoundError(f"no images found in {img_dir}")
        self.labels = [self._load_label(img2label_path(f)) for f in self.img_files]
        self.imgsz = imgsz
        self.max_gt = max_gt
        self._shapes = None

    @property
    def shapes(self):
        """[(h0, w0)] original image shapes, read lazily from headers (PIL)
        — lets the validator unletterbox without re-decoding images."""
        if self._shapes is None:
            from PIL import Image

            shapes = []
            for f in self.img_files:
                with Image.open(f) as im:
                    w, h = im.size
                shapes.append((h, w))
            self._shapes = shapes
        return self._shapes

    @staticmethod
    def _load_label(path: str) -> np.ndarray:
        """[N, 5] rows of (cls, xc, yc, w, h) normalized."""
        p = Path(path)
        if not p.exists():
            return np.zeros((0, 5), np.float32)
        rows = []
        for line in p.read_text().splitlines():
            vals = line.split()
            if len(vals) >= 5:
                rows.append([float(v) for v in vals[:5]])
        return np.asarray(rows, np.float32) if rows else np.zeros((0, 5), np.float32)

    def __len__(self):
        return len(self.img_files)

    def _imread(self, idx: int) -> np.ndarray:
        """Decoded BGR image for img_files[idx], as ``cv2.imread``; with PIL where
        OpenCV is missing."""
        path = self.img_files[idx]
        if cv2 is not None:
            im = cv2.imread(path)
            if im is None:
                raise FileNotFoundError(path)
            return im
        from PIL import Image

        with Image.open(path) as im:
            return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])

    def _rect_resize(self, im: np.ndarray) -> np.ndarray:
        """Reference base.load_image rect_mode resize: long side -> imgsz with
        CEIL dims, INTER_LINEAR, both up- and down-scaling (base.py:250-262).
        The letterbox after it sees r == 1 and only pads. Needs OpenCV where a
        resize is needed: another resampler would change the pixels."""
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            if cv2 is None:
                raise RuntimeError(f"resizing a {w0}x{h0} image to imgsz={self.imgsz} needs OpenCV "
                                   f"(cv2.INTER_LINEAR), which is not installed")
            w1 = min(math.ceil(w0 * r), self.imgsz)
            h1 = min(math.ceil(h0 * r), self.imgsz)
            im = cv2.resize(im, (w1, h1), interpolation=cv2.INTER_LINEAR)
        return im

    def load_sample(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (letterboxed image HWC RGB uint8, labels [N,5] cls+xyxy px)."""
        im = self._rect_resize(self._imread(idx))
        h1, w1 = im.shape[:2]
        # cls,xc,yc,w,h normalized -> xyxy px in RESIZED space (the reference
        # denormalizes by the resized shape)
        lbl = self.labels[idx]
        cls = lbl[:, 0]
        xc, yc, w, h = lbl[:, 1] * w1, lbl[:, 2] * h1, lbl[:, 3] * w1, lbl[:, 4] * h1
        if len(lbl):
            boxes_px = np.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], -1)
        else:
            boxes_px = np.zeros((0, 4), np.float32)

        im_lb, ratio, pad = letterbox(im, self.imgsz, scaleup=False)
        boxes_px = boxes_px * ratio[0]
        boxes_px[:, [0, 2]] += pad[0]
        boxes_px[:, [1, 3]] += pad[1]

        im_rgb = im_lb[..., ::-1].astype(np.uint8)
        out = np.concatenate([cls[:, None], boxes_px], -1) if len(cls) else np.zeros((0, 5), np.float32)
        return im_rgb, out


def collate(samples: List[Tuple[np.ndarray, np.ndarray]], max_gt: int) -> Dict[str, np.ndarray]:
    """Stack into a fixed-shape batch (images uint8); pad GT to max_gt."""
    B = len(samples)
    H, W = samples[0][0].shape[:2]
    images = np.zeros((B, H, W, 3), np.uint8)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    classes = np.zeros((B, max_gt), np.int32)
    mask = np.zeros((B, max_gt), bool)
    for i, (im, lbl) in enumerate(samples):
        images[i] = im
        n = min(len(lbl), max_gt)
        if n:
            boxes[i, :n] = lbl[:n, 1:5]
            classes[i, :n] = lbl[:n, 0].astype(np.int32)
            mask[i, :n] = True
    return {"images": images, "boxes": boxes, "classes": classes, "mask": mask}


class DataLoader:
    """Single-pass fixed-shape batch iterator over the dataset in order
    (shuffling and drop_last come with the trainer, ROADMAP.md §1.C item 8;
    multi-process sharding with data parallelism, §1.H item 19)."""

    def __init__(self, dataset: YOLODataset, batch_size: int):
        self.ds = dataset
        self.bs = batch_size

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.ds)))
        for start in range(0, len(order), self.bs):
            idxs = order[start : start + self.bs]
            if len(idxs) < self.bs:
                idxs = idxs + order[: self.bs - len(idxs)]  # wrap to keep static shape
            yield collate([self.ds.load_sample(i) for i in idxs], self.ds.max_gt)
