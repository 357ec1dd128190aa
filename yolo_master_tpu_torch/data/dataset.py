"""YOLO-format detection dataset and its loaders (counterpart of
``yolo_master_tpu/data/dataset.py``; reference: ultralytics/data/dataset.py:52
YOLODataset, data/base.py load_image, data/augment.py, data/build.py).

The loaders yield fixed-shape numpy batches: images ``[B, H, W, 3]`` RGB, GT
padded to ``max_gt`` per image as xyxy pixel boxes in letterboxed space, class
ids and a validity mask. A short last batch is padded by wrapping to the first
images of the epoch's order, as in the JAX package. Images come as loaded,
**uint8** (``images=np.uint8``, the default: the validator casts on the
device, so that a fused model's stem kernel reads the uint8 image as on the
predict path), or as the train step takes them, float32 divided by 255 on
the host (``images=np.float32``: the JAX package's collate, bit for bit).

``augment=True`` is the train half: mosaic (4 or 9 images), random
perspective, mixup, cutmix, copy-paste, HSV and flips, each drawn from the
``random.Random`` the loader passes to ``load_sample``, in the JAX package's
order, with its OpenCV calls, so that a sample of ``(idx, Random(s))`` is the
JAX package's byte for byte. ``cache="ram"`` keeps decoded images in the
process, ``cache="disk"`` beside each image as ``.ymt_cache_<stem>.npy`` (the
JAX package's files).

Images are decoded with OpenCV, or with PIL where OpenCV is missing (lossless
for PNG; JPEG decoders may differ by a rounding). The rect resize needs
OpenCV's INTER_LINEAR for pixel parity and raises without it; so does
``augment=True``.

The task datasets are the val half of the JAX package's
(``data/dataset.py:583-889``): :class:`SegmentDataset` (polygons resampled to
1000 points and rasterised at the letterboxed size, then resized to the mask
grid), :class:`PoseDataset` (keypoints), :class:`OBBDataset` (corner points
-> xywhr) and :class:`ClassificationDataset` (a folder per class, square
resize). Each sample is the JAX package's byte for byte and each batch too
with ``images=np.float32``; their train half raises (ROADMAP.md §1.E item
13), and so does ``SemanticDataset``.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils import DATASETS_DIR, yaml_load
from .letterbox import cv2, letterbox

LOGGER = logging.getLogger(__name__)
IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}
TASK_ITEM = "ROADMAP.md §1.E item 13 (task heads and their datasets)"
TASK_TRAIN_ITEM = "ROADMAP.md §1.E item 13 (the task heads' training: augmentation, losses, trainers)"
TASK_DATASETS = ("SemanticDataset",)
SHARD_ITEMS = {"sharding": "ROADMAP.md §1.H item 19 (data parallelism)",
               "process_shard": "ROADMAP.md §1.H items 19-20 (data and expert parallelism)"}
HYP_DEFAULTS = {"fliplr": 0.5, "flipud": 0.0, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
                "mosaic": 1.0, "scale": 0.5, "translate": 0.1, "degrees": 0.0, "shear": 0.0,
                "mixup": 0.0, "cutmix": 0.0, "copy_paste": 0.0}


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
    """Detection dataset over a dataset yaml ({path, train, val, names}).

    ``split`` names the yaml key of the image directory (a split the yaml
    lacks falls back to ``val``); ``hyp`` overrides :data:`HYP_DEFAULTS`
    (``mosaic9``, ``bgr`` and ``albumentations`` are off unless set);
    ``cache``: None, ``"ram"`` or ``"disk"``.
    """

    _warned_album = False

    def __init__(self, data: str | Path, split: str = "train", imgsz: int = 640, max_gt: int = 128,
                 augment: bool = False, hyp: Optional[dict] = None, cache: Optional[str] = None):
        if augment and cv2 is None:
            raise RuntimeError("augment=True needs OpenCV (the JAX package's resize, warp and HSV calls), "
                               "which is not installed")
        yaml_path = resolve_data_yaml(data)
        cfg = yaml_load(yaml_path)
        self.names = cfg.get("names", {})
        if isinstance(self.names, list):
            self.names = dict(enumerate(self.names))
        self.nc = len(self.names)
        img_dir = resolve_dataset_root(cfg, yaml_path) / (cfg.get(split) or cfg["val"])
        self.img_files = sorted(str(f) for f in Path(img_dir).rglob("*") if f.suffix.lower().lstrip(".") in IMG_FORMATS)
        if not self.img_files:
            raise FileNotFoundError(f"no images found in {img_dir}")
        self.labels = [self._load_label(img2label_path(f)) for f in self.img_files]
        self.imgsz = imgsz
        self.max_gt = max_gt
        self.augment = augment
        self.hyp = {**HYP_DEFAULTS, **(hyp or {})}
        self.mosaic_enabled = True  # the trainer turns it off for close_mosaic
        self._shapes = None
        self.cache = None if cache in (None, False, "false", "") else str(cache).lower()
        if self.cache not in (None, "ram", "disk"):
            raise ValueError(f"cache must be ram|disk|None, got {cache!r}")
        self._ram: dict = {}

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

    @staticmethod
    def _decode(path: str) -> np.ndarray:
        """BGR HWC uint8, as ``cv2.imread``; with PIL where OpenCV is missing."""
        if cv2 is not None:
            im = cv2.imread(path)
            if im is None:
                raise FileNotFoundError(path)
            return im
        from PIL import Image

        with Image.open(path) as im:
            return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])

    def _imread(self, idx: int) -> np.ndarray:
        """Decoded BGR image for img_files[idx], through the cache where one is set."""
        if self.cache == "ram":
            im = self._ram.get(idx)
            if im is None:
                im = self._decode(self.img_files[idx])
                self._ram[idx] = im
            return im.copy()  # augmentations write in place
        if self.cache == "disk":
            p = Path(self.img_files[idx])
            npy = p.parent / f".ymt_cache_{p.stem}.npy"
            if npy.exists():
                return np.load(npy)
            im = self._decode(str(p))
            tmp = npy.with_name(f"{npy.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            try:  # written whole, then renamed: a loader thread never reads half a file
                with open(tmp, "wb") as f:
                    np.save(f, im)
                os.replace(tmp, npy)
            except OSError:  # a read-only dataset directory: no cache
                tmp.unlink(missing_ok=True)
            return im
        return self._decode(self.img_files[idx])

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

    # -- one sample ----------------------------------------------------------------------------
    def load_sample(self, idx: int, rng: Optional[random.Random] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(letterboxed image HWC RGB uint8, labels [N,5] cls+xyxy px). With
        ``augment`` every random choice is drawn from ``rng``, in the JAX
        package's order; without it ``rng`` is not read."""
        if self.augment and rng is None:
            raise ValueError("augment=True draws from rng: pass a random.Random")
        im = self._imread(idx)
        lbl = self.labels[idx].copy()

        use_mosaic = self.augment and self.mosaic_enabled and self.hyp["mosaic"] > 0 and rng.random() < self.hyp["mosaic"]
        if use_mosaic:
            if self.hyp.get("mosaic9", 0) > 0 and rng.random() < self.hyp["mosaic9"]:
                im, lbl = self._mosaic9(idx, rng)
            else:
                im, lbl = self._mosaic4(idx, rng)
            boxes_px = lbl[:, 1:5]  # mosaic labels are pixel xyxy already
            cls = lbl[:, 0]
        else:
            im = self._rect_resize(im)
            h1, w1 = im.shape[:2]
            # cls,xc,yc,w,h normalized -> xyxy px in RESIZED space (the reference
            # denormalizes by the resized shape)
            cls = lbl[:, 0]
            xc, yc, w, h = lbl[:, 1] * w1, lbl[:, 2] * h1, lbl[:, 3] * w1, lbl[:, 4] * h1
            if len(lbl):
                boxes_px = np.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], -1)
            else:
                boxes_px = np.zeros((0, 4), np.float32)

        im_lb, ratio, pad = letterbox(im, self.imgsz, scaleup=self.augment)
        boxes_px = boxes_px * ratio[0]
        boxes_px[:, [0, 2]] += pad[0]
        boxes_px[:, [1, 3]] += pad[1]

        if self.augment:
            h = self.hyp
            if h.get("degrees") or h.get("shear") or h.get("translate") or h.get("scale"):
                im_lb, boxes_px, cls = random_perspective(
                    im_lb, boxes_px, cls, rng, degrees=h["degrees"], translate=h["translate"],
                    scale=h["scale"], shear=h["shear"])
            for name, fn in (("mixup", mixup), ("cutmix", cutmix), ("copy_paste", copy_paste)):
                if h.get(name, 0) > 0 and rng.random() < h[name]:
                    im2, lbl2 = self._plain_sample(rng.randrange(len(self)))  # BGR donor
                    im_lb, boxes_px, cls = fn(im_lb, boxes_px, cls, im2, lbl2[:, 1:5], lbl2[:, 0], rng)
            im_lb, boxes_px = self._augment_hsv_flip(im_lb, boxes_px, rng)

        im_rgb = im_lb[..., ::-1].astype(np.uint8)
        out = np.concatenate([cls[:, None], boxes_px], -1) if len(cls) else np.zeros((0, 5), np.float32)
        return im_rgb, out

    def _plain_sample(self, idx: int):
        """Donor sample for mixup/cutmix/copy-paste: letterboxed (up-scaling
        allowed), labels denormalized by the ORIGINAL shape, no augmentation."""
        im = self._imread(idx)
        h0, w0 = im.shape[:2]
        lbl = self.labels[idx]
        cls = lbl[:, 0] if len(lbl) else np.zeros((0,), np.float32)
        xc, yc, w, h = (lbl[:, 1] * w0, lbl[:, 2] * h0, lbl[:, 3] * w0, lbl[:, 4] * h0) if len(lbl) else (0, 0, 0, 0)
        boxes = np.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], -1) if len(lbl) else np.zeros((0, 4), np.float32)
        im_lb, ratio, pad = letterbox(im, self.imgsz, scaleup=True)
        boxes = boxes * ratio[0]
        if len(boxes):
            boxes[:, [0, 2]] += pad[0]
            boxes[:, [1, 3]] += pad[1]
        out = np.concatenate([cls[:, None], boxes], -1) if len(cls) else np.zeros((0, 5), np.float32)
        return im_lb, out

    def _mosaic_labels(self, ix: int, w: int, h: int, offsets_x: tuple, offsets_y: tuple) -> Optional[np.ndarray]:
        """Image ``ix``'s labels as cls + xyxy px of a (w, h) image placed at
        sum(offsets), each offset added in turn (the float32 rounding of the JAX package's sums)."""
        lbl = self.labels[ix]
        if not len(lbl):
            return None
        bw, bh = lbl[:, 3] * w, lbl[:, 4] * h
        bxc, byc = lbl[:, 1] * w, lbl[:, 2] * h
        for ox, oy in zip(offsets_x, offsets_y):
            bxc, byc = bxc + ox, byc + oy
        xyxy = np.stack([bxc - bw / 2, byc - bh / 2, bxc + bw / 2, byc + bh / 2], -1)
        return np.concatenate([lbl[:, 0:1], xyxy], -1)

    @staticmethod
    def _mosaic_finish(all_labels: list, side: int) -> np.ndarray:
        """Concatenate, clip to the canvas, and drop boxes of a side of 2 px or less."""
        if not all_labels:
            return np.zeros((0, 5), np.float32)
        lbl = np.concatenate(all_labels, 0)
        lbl[:, 1:5] = lbl[:, 1:5].clip(0, side)
        wh = lbl[:, 3:5] - lbl[:, 1:3]
        return lbl[(wh > 2).all(1)]

    def _mosaic4(self, idx: int, rng: random.Random):
        """4-image mosaic (reference data/augment.py:422 Mosaic) on a 2*imgsz
        canvas; the later letterbox brings it to imgsz."""
        s = self.imgsz
        yc = int(rng.uniform(s * 0.5, s * 1.5))
        xc = int(rng.uniform(s * 0.5, s * 1.5))
        idxs = [idx] + [rng.randrange(len(self)) for _ in range(3)]
        canvas = np.full((s * 2, s * 2, 3), 114, np.uint8)
        all_labels = []
        for i, ix in enumerate(idxs):
            im = self._imread(ix)
            h0, w0 = im.shape[:2]
            r = s / max(h0, w0)
            if r != 1:
                im = cv2.resize(im, (int(w0 * r), int(h0 * r)), interpolation=cv2.INTER_LINEAR)
            h, w = im.shape[:2]
            if i == 0:
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
            else:
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            canvas[y1a:y2a, x1a:x2a] = im[y1b:y2b, x1b:x2b]
            placed = self._mosaic_labels(ix, w, h, (x1a - x1b,), (y1a - y1b,))
            if placed is not None:
                all_labels.append(placed)
        return canvas, self._mosaic_finish(all_labels, 2 * s)

    def _mosaic9(self, idx: int, rng: random.Random):
        """9-image mosaic (reference data/augment.py Mosaic n=9): a 3x3 grid of
        images fitted to their cells on a 3*imgsz canvas, each placed at a
        random offset inside its cell."""
        s = self.imgsz
        idxs = [idx] + [rng.randrange(len(self)) for _ in range(8)]
        canvas = np.full((s * 3, s * 3, 3), 114, np.uint8)
        all_labels = []
        for i, ix in enumerate(idxs):
            im = self._imread(ix)
            h0, w0 = im.shape[:2]
            r = s / max(h0, w0)
            im = cv2.resize(im, (int(w0 * r), int(h0 * r)), interpolation=cv2.INTER_LINEAR)
            h, w = im.shape[:2]
            ox, oy = (i % 3) * s, (i // 3) * s  # the cell's origin
            dx = rng.randrange(max(s - w, 0) + 1)
            dy = rng.randrange(max(s - h, 0) + 1)
            canvas[oy + dy: oy + dy + h, ox + dx: ox + dx + w] = im
            placed = self._mosaic_labels(ix, w, h, (ox, dx), (oy, dy))
            if placed is not None:
                all_labels.append(placed)
        return canvas, self._mosaic_finish(all_labels, 3 * s)

    def _augment_hsv_flip(self, im: np.ndarray, boxes: np.ndarray, rng: random.Random):
        """RandomHSV + RandomFlip (reference augment.py:1403,1480). im is BGR."""
        h = self.hyp
        if h.get("albumentations"):
            im = self._albumentations(im)
        if h.get("bgr", 0) and rng.random() < h["bgr"]:
            im = im[..., ::-1]  # channel flip (reference augment.py bgr)
        if h["hsv_h"] or h["hsv_s"] or h["hsv_v"]:
            r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [h["hsv_h"], h["hsv_s"], h["hsv_v"]] + 1
            hue, sat, val = cv2.split(cv2.cvtColor(im, cv2.COLOR_BGR2HSV))
            x = np.arange(256)
            lut_h = ((x * r[0]) % 180).astype(im.dtype)
            lut_s = np.clip(x * r[1], 0, 255).astype(im.dtype)
            lut_v = np.clip(x * r[2], 0, 255).astype(im.dtype)
            im = cv2.cvtColor(cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s), cv2.LUT(val, lut_v))),
                              cv2.COLOR_HSV2BGR)
        if rng.random() < h["fliplr"]:
            im = im[:, ::-1]
            if len(boxes):
                w = im.shape[1]
                boxes = boxes.copy()
                boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        if rng.random() < h["flipud"]:
            im = im[::-1]
            if len(boxes):
                hgt = im.shape[0]
                boxes = boxes.copy()
                boxes[:, [1, 3]] = hgt - boxes[:, [3, 1]]
        return np.ascontiguousarray(im), boxes

    def _albumentations(self, im: np.ndarray) -> np.ndarray:
        """Blur/MedianBlur/ToGray/CLAHE at p=0.01 through albumentations where it
        is installed (reference augment.py:1184); skipped, with one warning, where
        it is not."""
        try:
            import albumentations as A  # noqa: N812
        except ImportError:
            if not YOLODataset._warned_album:
                LOGGER.warning("albumentations not installed; albumentations=True ignored")
                YOLODataset._warned_album = True
            return im
        if not hasattr(self, "_album_tf"):
            self._album_tf = A.Compose([
                A.Blur(p=0.01), A.MedianBlur(p=0.01), A.ToGray(p=0.01), A.CLAHE(p=0.01),
                A.RandomBrightnessContrast(p=0.0), A.ImageCompression(quality_range=(75, 100), p=0.0),
            ])
        return self._album_tf(image=im)["image"]


# -- batches -----------------------------------------------------------------------------------

def collate(samples: List[Tuple[np.ndarray, np.ndarray]], max_gt: int, images=np.uint8) -> Dict[str, np.ndarray]:
    """Stack into a fixed-shape batch; pad GT to max_gt. ``images``: np.uint8
    (as loaded) or np.float32 (``im.astype(np.float32) / 255.0``, the JAX package's)."""
    B = len(samples)
    H, W = samples[0][0].shape[:2]
    if images not in (np.uint8, np.float32):
        raise ValueError(f"images must be np.uint8 or np.float32, got {images!r}")
    out = np.zeros((B, H, W, 3), images)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    classes = np.zeros((B, max_gt), np.int32)
    mask = np.zeros((B, max_gt), bool)
    for i, (im, lbl) in enumerate(samples):
        out[i] = im if images is np.uint8 else im.astype(np.float32) / 255.0
        n = min(len(lbl), max_gt)
        if n:
            boxes[i, :n] = lbl[:n, 1:5]
            classes[i, :n] = lbl[:n, 0].astype(np.int32)
            mask[i, :n] = True
    return {"images": out, "boxes": boxes, "classes": classes, "mask": mask}


def collate_for(ds, samples: list, images=np.uint8) -> Dict[str, np.ndarray]:
    """A batch of ``ds``'s samples: its own ``collate_batch`` (the task datasets'), else :func:`collate`."""
    if hasattr(ds, "collate_batch"):
        return ds.collate_batch(samples, images)
    return collate(samples, ds.max_gt, images)


def _refuse_sharding(**kw) -> None:
    for name, value in kw.items():
        if value is not None:
            raise NotImplementedError(f"{name}= is not ported yet: {SHARD_ITEMS[name]}")


class DataLoader:
    """Fixed-shape batches of one epoch, decoded and augmented on the calling
    thread: ``random.Random(seed + epoch)`` shuffles the order (``shuffle``)
    and then draws every sample's augmentation, one sample after another.
    The last batch wraps to the first images of the order, or is dropped with
    ``drop_last``. ``shuffle`` defaults to False here (the val path's order;
    the JAX package's default is True), and ``images`` to uint8 (see the
    module docstring)."""

    def __init__(self, dataset: YOLODataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, images=np.uint8, process_shard=None):
        _refuse_sharding(process_shard=process_shard)
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.images = images

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else math.ceil(n / self.bs)

    def _batch_indices(self, rng: random.Random) -> List[List[int]]:
        order = list(range(len(self.ds)))
        if self.shuffle:
            rng.shuffle(order)
        out = []
        for start in range(0, len(order), self.bs):
            idxs = order[start: start + self.bs]
            if len(idxs) < self.bs:
                if self.drop_last:
                    break
                idxs = idxs + order[: self.bs - len(idxs)]  # wrap to keep static shape
            out.append(idxs)
        return out

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed + epoch)
        for idxs in self._batch_indices(rng):
            yield collate_for(self.ds, [self.ds.load_sample(i, rng) for i in idxs], self.images)


class PrefetchLoader(DataLoader):
    """The batches of :class:`DataLoader` decoded and augmented by ``workers``
    threads (OpenCV and numpy release the GIL for the heavy parts), with up
    to ``prefetch`` batches built ahead of the consumer (reference
    InfiniteDataLoader + workers, data/build.py:43-126).

    The order is the same; each sample draws from its own
    ``random.Random((seed + epoch) * 1_000_003 + batch_index * batch_size + j)``
    instead of the one stream :class:`DataLoader` threads through, so the
    batches are the same at any worker count and any timing. ``sharding``
    and ``process_shard`` (device placement and multi-process slices, the
    JAX package's) raise ``NotImplementedError``.
    """

    def __init__(self, dataset: YOLODataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, workers: int = 4, prefetch: int = 3, images=np.uint8, sharding=None,
                 process_shard=None):
        _refuse_sharding(sharding=sharding, process_shard=process_shard)
        super().__init__(dataset, batch_size, shuffle=shuffle, seed=seed, drop_last=drop_last, images=images)
        self.workers = max(1, workers)
        self.prefetch = max(1, prefetch)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batch_indices(random.Random(self.seed + epoch))
        base = (self.seed + epoch) * 1_000_003

        def build(bi_idxs):
            bi, idxs = bi_idxs
            samples = list(sample_pool.map(
                lambda j_i: self.ds.load_sample(j_i[1], random.Random(base + bi * self.bs + j_i[0])),
                enumerate(idxs)))
            return collate_for(self.ds, samples, self.images)

        with ThreadPoolExecutor(self.workers) as sample_pool, ThreadPoolExecutor(self.prefetch) as batch_pool:
            it = iter(enumerate(batches))
            futs = collections.deque(batch_pool.submit(build, b) for _, b in zip(range(self.prefetch), it))
            while futs:
                f = futs.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    futs.append(batch_pool.submit(build, nxt))
                yield f.result()


# -- task datasets ------------------------------------------------------------------------------

class _TaskDataset(YOLODataset):
    """The val half of a task dataset: letterbox only (no up-scaling), as the
    JAX package's ``augment=False``; ``augment=True`` raises."""

    def __init__(self, *args, **kw):
        if kw.get("augment") or (len(args) > 4 and args[4]):
            raise NotImplementedError(f"augment=True on {type(self).__name__}: {TASK_TRAIN_ITEM}")
        if cv2 is None:
            raise RuntimeError(f"{type(self).__name__} needs OpenCV (the JAX package's rasteriser and rect "
                               "geometry), which is not installed")
        super().__init__(*args, **kw)

    @staticmethod
    def _images(samples, images):
        if images not in (np.uint8, np.float32):
            raise ValueError(f"images must be np.uint8 or np.float32, got {images!r}")
        out = np.stack([s[0] for s in samples])
        return out if images is np.uint8 else out.astype(np.float32) / 255.0


class SegmentDataset(_TaskDataset):
    """Instance segmentation: label rows "cls x1 y1 x2 y2 ..." (a normalised
    polygon) -> boxes and binary masks at 1/``mask_ratio`` of the letterboxed
    size."""

    def __init__(self, *args, mask_ratio: int = 4, **kw):
        self.mask_ratio = mask_ratio
        super().__init__(*args, **kw)

    @staticmethod
    def _load_label(path: str) -> list:
        p = Path(path)
        if not p.exists():
            return []
        rows = []
        for line in p.read_text().splitlines():
            vals = [float(v) for v in line.split()]
            if len(vals) >= 7:  # cls + >= 3 points
                rows.append(np.asarray(vals, np.float32))
        return rows  # variable-length rows

    @staticmethod
    def _resample_polygon(poly: np.ndarray, n: int = 1000) -> np.ndarray:
        """Close the ring and interpolate it linearly to ``n`` points, keeping the
        original vertices (the reference's ``resample_segments``): rasterising
        the dense ring with int32-truncated points places boundary pixels as the
        reference's ``polygon2mask`` does."""
        s = np.concatenate([poly, poly[0:1]], 0)
        if len(poly) >= n:
            x = np.linspace(0, len(s) - 1, n)
        else:
            xp0 = np.arange(len(s))
            x = np.linspace(0, len(s) - 1, n - len(s))
            x = np.insert(x, np.searchsorted(x, xp0), xp0)
        xp = np.arange(len(s))
        return np.stack([np.interp(x, xp, s[:, 0]), np.interp(x, xp, s[:, 1])], -1).astype(np.float32)

    def load_sample(self, idx: int, rng: Optional[random.Random] = None):
        """(letterboxed RGB uint8 image, labels [N, 5] cls + xyxy px, masks [N, mh, mw] uint8)."""
        im = self._rect_resize(self._imread(idx))
        h0, w0 = im.shape[:2]  # the resized size: labels denormalise against it
        im_lb, ratio, pad = letterbox(im, self.imgsz, scaleup=False)
        size = self.imgsz
        mh, mw = size // self.mask_ratio, size // self.mask_ratio
        boxes, cls, masks = [], [], []
        for row in self.labels[idx]:
            poly = row[1:].reshape(-1, 2) * [w0, h0]
            poly = self._resample_polygon(poly) * ratio[0] + [pad[0], pad[1]]
            boxes.append([*poly.min(0), *poly.max(0)])
            cls.append(row[0])
            # rasterised at the full letterboxed size with int32-truncated points,
            # then resized (INTER_LINEAR) to the mask grid, as the reference's polygon2mask
            m = np.zeros((size, size), np.uint8)
            cv2.fillPoly(m, [poly.astype(np.int32)], 1)
            if self.mask_ratio != 1:
                m = cv2.resize(m, (mw, mh))
            masks.append(m)
        lbl = (np.concatenate([np.asarray(cls, np.float32)[:, None], np.asarray(boxes, np.float32)], -1)
               if cls else np.zeros((0, 5), np.float32))
        mk = np.stack(masks) if masks else np.zeros((0, mh, mw), np.uint8)
        return im_lb[..., ::-1].astype(np.uint8), lbl, mk

    def collate_batch(self, samples, images=np.uint8) -> Dict[str, np.ndarray]:
        """images, boxes [B, max_gt, 4], classes, mask, masks [B, max_gt, mh, mw] float32."""
        b, mh = len(samples), self.imgsz // self.mask_ratio
        out = {"images": self._images(samples, images), "boxes": np.zeros((b, self.max_gt, 4), np.float32),
               "classes": np.zeros((b, self.max_gt), np.int32), "mask": np.zeros((b, self.max_gt), bool),
               "masks": np.zeros((b, self.max_gt, mh, mh), np.float32)}
        for i, (_, lbl, mk) in enumerate(samples):
            n = min(len(lbl), self.max_gt)
            out["boxes"][i, :n] = lbl[:n, 1:5]
            out["classes"][i, :n] = lbl[:n, 0].astype(np.int32)
            out["mask"][i, :n] = True
            out["masks"][i, :n] = mk[:n]
        return out


class PoseDataset(_TaskDataset):
    """Keypoints: label rows "cls xc yc w h kx ky kv ..." (normalised) -> boxes
    and keypoints [nk, nd] in letterboxed pixels."""

    def __init__(self, *args, kpt_shape=(17, 3), **kw):
        self.kpt_shape = tuple(kpt_shape)
        super().__init__(*args, **kw)

    @staticmethod
    def _load_label(path: str) -> list:
        p = Path(path)
        if not p.exists():
            return []
        return [np.asarray([float(v) for v in line.split()], np.float32)
                for line in p.read_text().splitlines() if line.strip()]

    def load_sample(self, idx: int, rng: Optional[random.Random] = None):
        """(letterboxed RGB uint8 image, labels [N, 5] cls + xyxy px, keypoints [N, nk, nd])."""
        im = self._rect_resize(self._imread(idx))
        h0, w0 = im.shape[:2]
        nk, nd = self.kpt_shape
        im_lb, ratio, pad = letterbox(im, self.imgsz, scaleup=False)
        boxes, cls, kpts = [], [], []
        for row in self.labels[idx]:
            c, xc, yc, w, h = row[:5]
            bx = np.array([(xc - w / 2) * w0, (yc - h / 2) * h0, (xc + w / 2) * w0, (yc + h / 2) * h0])
            boxes.append(bx * ratio[0] + [pad[0], pad[1], pad[0], pad[1]])
            k = row[5: 5 + nk * nd].reshape(nk, nd).copy() if len(row) >= 5 + nk * nd else np.zeros((nk, nd), np.float32)
            k[:, 0] = k[:, 0] * w0 * ratio[0] + pad[0]
            k[:, 1] = k[:, 1] * h0 * ratio[1] + pad[1]
            cls.append(c)
            kpts.append(k)
        lbl = (np.concatenate([np.asarray(cls, np.float32)[:, None], np.asarray(boxes, np.float32)], -1)
               if cls else np.zeros((0, 5), np.float32))
        kp = np.stack(kpts) if kpts else np.zeros((0, nk, nd), np.float32)
        return im_lb[..., ::-1].astype(np.uint8), lbl, kp

    def collate_batch(self, samples, images=np.uint8) -> Dict[str, np.ndarray]:
        """images, boxes [B, max_gt, 4], classes, mask, keypoints [B, max_gt, nk, nd]."""
        b = len(samples)
        out = {"images": self._images(samples, images), "boxes": np.zeros((b, self.max_gt, 4), np.float32),
               "classes": np.zeros((b, self.max_gt), np.int32), "mask": np.zeros((b, self.max_gt), bool),
               "keypoints": np.zeros((b, self.max_gt, *self.kpt_shape), np.float32)}
        for i, (_, lbl, kp) in enumerate(samples):
            n = min(len(lbl), self.max_gt)
            out["boxes"][i, :n] = lbl[:n, 1:5]
            out["classes"][i, :n] = lbl[:n, 0].astype(np.int32)
            out["mask"][i, :n] = True
            out["keypoints"][i, :n] = kp[:n]
        return out


class OBBDataset(_TaskDataset):
    """Oriented boxes: label rows "cls x1 y1 x2 y2 x3 y3 x4 y4" (normalised
    corners) -> xywhr in letterboxed pixels by ``cv2.minAreaRect``, w >= h."""

    @staticmethod
    def _load_label(path: str) -> np.ndarray:
        p = Path(path)
        if not p.exists():
            return np.zeros((0, 9), np.float32)
        rows = [[float(v) for v in line.split()[:9]] for line in p.read_text().splitlines() if len(line.split()) >= 9]
        return np.asarray(rows, np.float32) if rows else np.zeros((0, 9), np.float32)

    def load_sample(self, idx: int, rng: Optional[random.Random] = None):
        """(letterboxed RGB uint8 image, classes [N] float32, rboxes [N, 5] xywhr)."""
        im = self._rect_resize(self._imread(idx))
        h0, w0 = im.shape[:2]
        im_lb, ratio, pad = letterbox(im, self.imgsz, scaleup=False)
        rboxes, cls = [], []
        for row in self.labels[idx]:
            pts = row[1:9].reshape(4, 2) * [w0, h0] * ratio[0] + [pad[0], pad[1]]
            (cx, cy), (w, h), ang = cv2.minAreaRect(pts.astype(np.float32))
            r = np.deg2rad(ang)
            if h > w:  # canonical xywhr: w >= h
                w, h = h, w
                r += np.pi / 2
            rboxes.append([cx, cy, w, h, r])
            cls.append(row[0])
        rb = np.asarray(rboxes, np.float32) if rboxes else np.zeros((0, 5), np.float32)
        return im_lb[..., ::-1].astype(np.uint8), np.asarray(cls, np.float32), rb

    def collate_batch(self, samples, images=np.uint8) -> Dict[str, np.ndarray]:
        """images, rboxes [B, max_gt, 5], classes, mask."""
        b = len(samples)
        out = {"images": self._images(samples, images), "rboxes": np.zeros((b, self.max_gt, 5), np.float32),
               "classes": np.zeros((b, self.max_gt), np.int32), "mask": np.zeros((b, self.max_gt), bool)}
        for i, (_, cls, rb) in enumerate(samples):
            n = min(len(cls), self.max_gt)
            out["rboxes"][i, :n] = rb[:n]
            out["classes"][i, :n] = cls[:n].astype(np.int32)
            out["mask"][i, :n] = True
        return out


class ClassificationDataset:
    """A folder per class under ``root`` (classes sorted by name); each image
    resized to ``imgsz`` x ``imgsz`` (INTER_LINEAR, no letterbox), RGB."""

    def __init__(self, root: str, imgsz: int = 224, augment: bool = False):
        if augment:
            raise NotImplementedError(f"augment=True on ClassificationDataset: {TASK_TRAIN_ITEM}")
        if cv2 is None:
            raise RuntimeError("ClassificationDataset needs OpenCV (the JAX package's resize), which is not installed")
        self.root = Path(root)
        self.imgsz = imgsz
        self.augment = False
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.names = dict(enumerate(classes))
        self.samples = [(str(f), ci) for ci, name in enumerate(classes) for f in sorted((self.root / name).rglob("*"))
                        if f.suffix.lower().lstrip(".") in IMG_FORMATS]
        self.max_gt = 0

    def __len__(self):
        return len(self.samples)

    def load_sample(self, idx: int, rng: Optional[random.Random] = None):
        """(RGB uint8 [imgsz, imgsz, 3], class index)."""
        path, ci = self.samples[idx]
        im = cv2.resize(cv2.imread(path), (self.imgsz, self.imgsz), interpolation=cv2.INTER_LINEAR)
        return np.ascontiguousarray(im[..., ::-1]), ci

    def collate_batch(self, samples, images=np.uint8) -> Dict[str, np.ndarray]:
        """images, classes [B] int32."""
        return {"images": _TaskDataset._images(samples, images),
                "classes": np.asarray([ci for _, ci in samples], np.int32)}


# ---------------------------------------------------------------------------------------------
# Augmentations (reference data/augment.py: RandomPerspective:1036, MixUp:762, CutMix:863,
# CopyPaste:1856), on (BGR image, boxes [N,4] xyxy px, classes [N]).

def random_perspective(im, boxes, cls, rng, degrees=0.0, translate=0.1, scale=0.5, shear=0.0, border=114):
    """Affine warp + box transform (reference augment.py:1036 RandomPerspective)."""
    h, w = im.shape[:2]
    C = np.eye(3)
    C[0, 2], C[1, 2] = -w / 2, -h / 2
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    S = np.eye(3)
    S[0, 1] = np.tan(np.deg2rad(rng.uniform(-shear, shear)))
    S[1, 0] = np.tan(np.deg2rad(rng.uniform(-shear, shear)))
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h
    M = T @ S @ R @ C
    im = cv2.warpAffine(im, M[:2], dsize=(w, h), borderValue=(border, border, border))
    if len(boxes):
        n = len(boxes)
        pts = np.ones((n * 4, 3))
        pts[:, :2] = boxes[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(n * 4, 2)
        pts = pts @ M.T
        pts = pts[:, :2].reshape(n, 8)
        new = np.stack([pts[:, 0::2].min(1), pts[:, 1::2].min(1), pts[:, 0::2].max(1), pts[:, 1::2].max(1)], -1)
        new = new.clip([0, 0, 0, 0], [w, h, w, h])
        # candidates: area and aspect sanity (reference box_candidates)
        w1 = boxes[:, 2] - boxes[:, 0]
        h1 = boxes[:, 3] - boxes[:, 1]
        w2 = new[:, 2] - new[:, 0]
        h2 = new[:, 3] - new[:, 1]
        ar = np.maximum(w2 / (h2 + 1e-9), h2 / (w2 + 1e-9))
        keep = (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 * s * s + 1e-9) > 0.1) & (ar < 100)
        boxes, cls = new[keep], cls[keep]
    return im, boxes, cls


def mixup(im1, boxes1, cls1, im2, boxes2, cls2, rng):
    """Beta(32,32) image blend + label union (reference augment.py:762 MixUp)."""
    r = rng.betavariate(32.0, 32.0)
    im = (im1.astype(np.float32) * r + im2.astype(np.float32) * (1 - r)).astype(np.uint8)
    return im, np.concatenate([boxes1, boxes2], 0), np.concatenate([cls1, cls2], 0)


def cutmix(im1, boxes1, cls1, im2, boxes2, cls2, rng):
    """Paste a random window of image 2 into image 1, with the labels whose
    centers fall inside it (reference augment.py:863 CutMix)."""
    h, w = im1.shape[:2]
    lam = rng.betavariate(1.0, 1.0)
    cw, ch = int(w * np.sqrt(1 - lam)), int(h * np.sqrt(1 - lam))
    if cw < 2 or ch < 2:
        return im1, boxes1, cls1
    x1 = rng.randrange(max(w - cw, 1))
    y1 = rng.randrange(max(h - ch, 1))
    im = im1.copy()
    im[y1: y1 + ch, x1: x1 + cw] = im2[y1: y1 + ch, x1: x1 + cw]
    if len(boxes2):
        cx = (boxes2[:, 0] + boxes2[:, 2]) / 2
        cy = (boxes2[:, 1] + boxes2[:, 3]) / 2
        inside = (cx >= x1) & (cx < x1 + cw) & (cy >= y1) & (cy < y1 + ch)
        b2 = boxes2[inside].clip([x1, y1, x1, y1], [x1 + cw, y1 + ch, x1 + cw, y1 + ch])
        boxes1 = np.concatenate([boxes1, b2], 0)
        cls1 = np.concatenate([cls1, cls2[inside]], 0)
    return im, boxes1, cls1


def copy_paste(im, boxes, cls, src_im, src_boxes, src_cls, rng, p=0.5):
    """Copy box crops from a donor image (the box-level form of the reference's
    mask-based CopyPaste, augment.py:1856)."""
    h, w = im.shape[:2]
    im = im.copy()
    new_boxes, new_cls = [], []
    for b, c in zip(src_boxes, src_cls):
        if rng.random() > p:
            continue
        x1, y1, x2, y2 = [int(v) for v in b]
        bw, bh = x2 - x1, y2 - y1
        if bw < 4 or bh < 4 or bw >= w or bh >= h:
            continue
        nx = rng.randrange(max(w - bw, 1))
        ny = rng.randrange(max(h - bh, 1))
        crop = src_im[y1:y2, x1:x2]
        im[ny: ny + crop.shape[0], nx: nx + crop.shape[1]] = crop
        new_boxes.append([nx, ny, nx + bw, ny + bh])
        new_cls.append(c)
    if new_boxes:
        boxes = np.concatenate([boxes, np.asarray(new_boxes, np.float32)], 0)
        cls = np.concatenate([cls, np.asarray(new_cls, np.float32)], 0)
    return im, boxes, cls
