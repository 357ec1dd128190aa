"""Sparse SAHI: sliced inference on large frames with blank tiles skipped
(counterpart of ``yolo_master_tpu/engine/sahi.py``).

    SparseSAHIPredictor(model, names=...)(frame_bgr) -> Results

  1. a low-res pass over the whole frame, letterboxed to ``imgsz``: the
     objectness of each anchor is its highest class probability;
  2. a covering grid of ``slice_size`` tiles with ``overlap_ratio`` overlap;
     a tile runs only if an anchor centre with objectness >= the threshold
     falls inside it;
  3. the active tiles run at full resolution, ``tile_batch`` at a time;
  4. the low-res and tile detections, in frame coordinates, merge through
     cluster-weighted NMS (``ops/nms.py:cluster_weighted_nms``, CUDA kernel
     ``csrc/cw_nms.cu``), or greedy NMS with ``use_cw_nms=False``.

The model is the port's :class:`~..nn.tasks.DetectionModel`, deploy-fused or
not: tiles go in as uint8 when its layer 0 takes uint8, else as float /255.
PyTorch runs eagerly, so a ragged last tile batch needs no padding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.letterbox import letterbox
from ..ops.nms import cluster_weighted_nms, non_max_suppression
from .results import Results

MAX_NMS = 4096  # candidates that enter the merge


def tile_grid(h: int, w: int, slice_size: int, overlap_ratio: float) -> List[Tuple[int, int]]:
    """Top-left corners (x, y) of a grid of ``slice_size`` tiles that covers an h x w frame."""
    stride = max(1, int(slice_size * (1 - overlap_ratio)))
    xs = list(range(0, max(w - slice_size, 0) + 1, stride))
    ys = list(range(0, max(h - slice_size, 0) + 1, stride))
    if not xs or xs[-1] + slice_size < w:
        xs.append(max(w - slice_size, 0))
    if not ys or ys[-1] + slice_size < h:
        ys.append(max(h - slice_size, 0))
    return [(x, y) for y in sorted(set(ys)) for x in sorted(set(xs))]


class SparseSAHIPredictor:
    """Sliced inference with objectness-gated tile skipping."""

    def __init__(self, model, names: Optional[Dict[int, str]] = None, imgsz: int = 640, slice_size: int = 640,
                 overlap_ratio: float = 0.2, objectness_threshold: float = 0.15, conf: float = 0.25,
                 iou: float = 0.45, max_det: int = 300, use_cw_nms: bool = True, sigma: float = 0.1,
                 tile_batch: int = 8):
        if model.head.end2end:  # its decode gives xyxy boxes, which the gate and the merge would read as xywh
            raise NotImplementedError("SAHI over an end2end (NMS-free) head is not ported "
                                      "(ROADMAP.md §1.G item 16, §3)")
        self.model = model
        self.device = next(model.parameters()).device
        self.names = names or {}
        self.imgsz = imgsz
        self.slice_size = slice_size
        self.overlap_ratio = overlap_ratio
        self.objectness_threshold = objectness_threshold
        self.conf, self.iou, self.max_det = conf, iou, max_det
        self.use_cw_nms = use_cw_nms
        self.sigma = sigma
        self.tile_batch = tile_batch
        self.last_stats: dict = {}

    @torch.inference_mode()
    def _decode(self, rgb_u8: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] uint8 RGB -> decoded [N, A, 4+nc] (xywh px, class probabilities), on the host."""
        x = torch.from_numpy(rgb_u8).to(self.device)
        if not getattr(self.model, "uint8_input", False):
            x = x.float() / 255.0
        return self.model.forward_predict(x).cpu().numpy()

    # -- stage 1: low-res objectness ----------------------------------------
    def _lowres_pass(self, img: np.ndarray):
        lb, ratio, pad = letterbox(img, self.imgsz)
        decoded = self._decode(np.ascontiguousarray(lb[None, ..., ::-1]))[0]  # [A, 4+nc]
        obj = decoded[:, 4:].max(-1)
        cx = (decoded[:, 0] - pad[0]) / ratio[0]  # anchor centres in frame coordinates
        cy = (decoded[:, 1] - pad[1]) / ratio[1]
        return decoded, obj, cx, cy, (ratio, pad)

    # -- stage 3: batched tile inference ---------------------------------------
    def _run_tiles(self, img: np.ndarray, tiles: List[Tuple[int, int]]) -> np.ndarray:
        s = self.slice_size
        all_det = []
        for start in range(0, len(tiles), self.tile_batch):
            chunk = tiles[start: start + self.tile_batch]
            crops = np.zeros((len(chunk), s, s, 3), np.uint8)  # zero-padded where the frame ends
            for i, (x0, y0) in enumerate(chunk):
                crop = img[y0: y0 + s, x0: x0 + s]
                crops[i, : crop.shape[0], : crop.shape[1]] = crop[..., ::-1]
            decoded = self._decode(crops)
            for i, (x0, y0) in enumerate(chunk):
                d = decoded[i].copy()
                d[:, 0] += x0  # xywh centres to frame coordinates
                d[:, 1] += y0
                all_det.append(d)
        return np.concatenate(all_det, 0)

    def candidates(self, img: np.ndarray) -> torch.Tensor:
        """Stages 1-3: the merged detections [1, M, 4+nc] in frame coordinates, on the
        model's device; sets ``last_stats``."""
        h, w = img.shape[:2]
        decoded_low, obj, cx, cy, (ratio, pad) = self._lowres_pass(img)
        tiles = tile_grid(h, w, self.slice_size, self.overlap_ratio)
        hot = obj >= self.objectness_threshold
        hx, hy = cx[hot], cy[hot]
        s = self.slice_size
        active = [(x0, y0) for x0, y0 in tiles
                  if ((hx >= x0) & (hx < x0 + s) & (hy >= y0) & (hy < y0 + s)).any()]
        self.last_stats = {"tiles": len(tiles), "active": len(active),
                           "skip_ratio": 1 - len(active) / max(len(tiles), 1)}
        low = decoded_low.copy()
        low[:, 0] = (low[:, 0] - pad[0]) / ratio[0]
        low[:, 1] = (low[:, 1] - pad[1]) / ratio[1]
        low[:, 2] /= ratio[0]
        low[:, 3] /= ratio[1]
        merged = np.concatenate([low, self._run_tiles(img, active)], 0) if active else low
        return torch.from_numpy(merged)[None].to(self.device)

    def __call__(self, img: np.ndarray, path: str = "sahi") -> Results:
        h, w = img.shape[:2]
        pred = self.candidates(img)
        nc = self.model.nc
        if self.use_cw_nms:
            det = cluster_weighted_nms(pred, nc=nc, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
                                       max_nms=MAX_NMS, sigma=self.sigma)
        else:
            det = non_max_suppression(pred, nc=nc, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
                                      max_nms=MAX_NMS)
        det = {k: v[0].cpu().numpy() for k, v in det.items() if k != "extra"}
        n = int(det["valid"].sum())
        boxes = det["boxes"][:n].copy()
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        data = np.concatenate([boxes, det["scores"][:n, None], det["classes"][:n, None]], -1)
        return Results(img, path=path, names=self.names, boxes=data)
