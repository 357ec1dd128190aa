"""Detection results (counterpart of ``yolo_master_tpu/engine/results.py``).

The port's own :class:`Results` and :class:`Boxes`, with what detection needs:
``boxes.data`` / ``xyxy`` / ``conf`` / ``cls`` / ``len`` and ``orig_img``,
``orig_shape``, ``path``, ``names``, ``speed``. Host-side numpy containers;
the device-to-host copy happens once, when the fixed-shape NMS output is
trimmed by its validity mask. Masks, keypoints, probabilities and oriented
boxes come with the task heads (ROADMAP.md §1.E item 13).
"""

from __future__ import annotations

from typing import Dict, Optional

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


class Results:
    """Per-image detection result."""

    def __init__(self, orig_img: np.ndarray, path: str = "", names: Optional[Dict[int, str]] = None,
                 boxes: Optional[np.ndarray] = None, speed: Optional[Dict[str, float]] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = str(path)
        self.names = names or {}
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes) if self.boxes is not None else 0
