"""Inference results (counterpart of ``yolo_master_tpu/engine/results.py``).

The port's own :class:`Results` with :class:`Boxes`, and the task heads'
:class:`Masks`, :class:`Keypoints`, :class:`Probs` and :class:`OBB` (copied
from the JAX package): ``boxes.data`` / ``xyxy`` / ``conf`` / ``cls``,
``masks.data`` / ``xy``, ``keypoints.xy`` / ``conf``, ``probs.top1`` /
``top5``, ``obb.xywhr`` / ``xyxyxyxy``, and ``orig_img``, ``orig_shape``,
``path``, ``names``, ``speed``. Host-side numpy containers; the device-to-host
copy happens once, when the fixed-shape NMS output is trimmed by its validity
mask. Plotting, saving and the summary exports are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Boxes:
    """Detection boxes: data [N, 6] = (x1, y1, x2, y2, conf, cls), pixel units
    of the original image."""

    def __init__(self, data: np.ndarray, orig_shape):
        data = np.asarray(data, np.float32)
        self.data = data.reshape(-1, data.shape[-1] if data.ndim > 1 else 6)
        self.orig_shape = tuple(orig_shape)

    def __len__(self):
        return len(self.data)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]


class Masks:
    """Instance masks: data [N, H, W] bool/float in original-image resolution
    (reference results.py:1071)."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data)
        self.orig_shape = tuple(orig_shape)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return Masks(self.data[i][None] if np.isscalar(i) or isinstance(i, (int, np.integer)) else self.data[i], self.orig_shape)

    @property
    def xy(self) -> List[np.ndarray]:
        """Polygon segments (pixel coords) per mask — largest external contour
        (the reference's masks2segments 'largest' strategy)."""
        import cv2

        segs = []
        for m in self.data:
            cnts, _ = cv2.findContours((m > 0.5).astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
            if cnts:
                seg = max(cnts, key=cv2.contourArea).reshape(-1, 2).astype(np.float32)
            else:
                seg = np.zeros((0, 2), np.float32)
            segs.append(seg)
        return segs

    @property
    def xyn(self) -> List[np.ndarray]:
        h, w = self.orig_shape
        return [s / np.array([w, h], np.float32) if len(s) else s for s in self.xy]


class Keypoints:
    """Pose keypoints: data [N, K, 2|3] (x, y[, conf]) in original-image pixels
    (reference results.py:1175)."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, np.float32)
        if self.data.ndim == 2:
            self.data = self.data[None]
        self.orig_shape = tuple(orig_shape)
        self.has_visible = self.data.shape[-1] == 3

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return Keypoints(self.data[i], self.orig_shape)

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        h, w = self.orig_shape
        return self.xy / np.array([w, h], np.float32)

    @property
    def conf(self):
        return self.data[..., 2] if self.has_visible else None


class Probs:
    """Classification probabilities: data [nc] (reference results.py:1269)."""

    def __init__(self, data: np.ndarray, orig_shape=None):
        self.data = np.asarray(data, np.float32).reshape(-1)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self) -> List[int]:
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data[self.top1])

    @property
    def top5conf(self):
        return self.data[self.top5]


class OBB:
    """Oriented boxes: data [N, 7] = (cx, cy, w, h, angle, conf, cls), pixels
    of the original image, angle in radians (reference results.py:1355)."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, np.float32).reshape(-1, 7)
        self.orig_shape = tuple(orig_shape)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return OBB(self.data[i], self.orig_shape)

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def conf(self):
        return self.data[:, 5]

    @property
    def cls(self):
        return self.data[:, 6]

    @property
    def xyxyxyxy(self):
        """Corner points [N, 4, 2] (reference ops.xywhr2xyxyxyxy)."""
        cx, cy, w, h, r = (self.data[:, i] for i in range(5))
        cos, sin = np.cos(r), np.sin(r)
        dx1, dy1 = w / 2 * cos, w / 2 * sin
        dx2, dy2 = -h / 2 * sin, h / 2 * cos
        c = np.stack([cx, cy], -1)[:, None]  # [N,1,2]
        v1 = np.stack([dx1, dy1], -1)[:, None]
        v2 = np.stack([dx2, dy2], -1)[:, None]
        signs = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]], np.float32)[None]  # [1,4,2]
        return c + signs[..., :1] * v1 + signs[..., 1:] * v2

    @property
    def xyxy(self):
        """Axis-aligned enclosing boxes [N, 4]."""
        pts = self.xyxyxyxy
        return np.concatenate([pts.min(1), pts.max(1)], -1)




class Results:
    """Per-image inference result."""

    def __init__(self, orig_img: np.ndarray, path: str = "", names: Optional[Dict[int, str]] = None,
                 boxes: Optional[np.ndarray] = None, probs: Optional[np.ndarray] = None,
                 masks: Optional[np.ndarray] = None, keypoints: Optional[np.ndarray] = None,
                 obb: Optional[np.ndarray] = None, speed: Optional[Dict[str, float]] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = str(path)
        self.names = names or {}
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.probs = Probs(probs, self.orig_shape) if probs is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.obb = OBB(obb, self.orig_shape) if obb is not None else None
        self.speed = speed or {}

    def __len__(self):
        for v in (self.boxes, self.obb, self.masks, self.keypoints):
            if v is not None:
                return len(v)
        return 0
