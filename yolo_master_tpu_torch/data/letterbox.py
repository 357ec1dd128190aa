"""Letterbox preprocessing — the canonical preprocess contract.

The port's own copy of ``yolo_master_tpu/data/letterbox.py``, pixel for pixel:
cv2.INTER_LINEAR resize to the aspect-preserving size, pad with 114 gray,
center placement with the round(±0.1) tie-breaking (reference
ultralytics/data/augment.py LetterBox). Pixel-exact preprocessing is required
for mAP parity.

Host-side (numpy + cv2); the device graph consumes the stacked NHWC batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover - cv2 is present where the port runs
    cv2 = None


def letterbox(
    img: np.ndarray,
    new_shape: int | Tuple[int, int] = (640, 640),
    scaleup: bool = True,
    center: bool = True,
    padding_value: int = 114,
    scale_fill: bool = False,
):
    """Resize + pad one HWC image.

    Returns:
        (padded image, ratio (rw, rh), (left, top) padding) — the metadata
        needed to map boxes back to the original image.
    """
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (round(shape[1] * r), round(shape[0] * r))  # (w, h)
    dw = new_shape[1] - new_unpad[0]
    dh = new_shape[0] - new_unpad[1]
    if scale_fill:
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])
    if center:
        dw /= 2
        dh /= 2

    top, bottom = (round(dh - 0.1) if center else 0), round(dh + 0.1)
    left, right = (round(dw - 0.1) if center else 0), round(dw + 0.1)

    if shape[::-1] != new_unpad:
        if cv2 is not None:
            img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
        else:  # fallback: PIL bilinear (not pixel-exact with cv2)
            from PIL import Image

            img = np.asarray(Image.fromarray(img).resize(new_unpad, Image.BILINEAR))
        if img.ndim == 2:
            img = img[..., None]

    out = np.full((new_shape[0], new_shape[1], img.shape[2]), padding_value, dtype=img.dtype)
    out[top : top + img.shape[0], left : left + img.shape[1]] = img
    return out, ratio, (left, top)
