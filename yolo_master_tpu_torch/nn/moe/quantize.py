"""Router-aware MoE quantization (counterpart of
``yolo_master_tpu/nn/moe/quantize.py``; reference: ultralytics/nn/modules/moe/
quantize.py:40-251): experts quantize to int8, routers stay full precision,
as quantizing the tiny routing MLPs destabilizes top-k selection for
negligible size savings.

    qsd = quantize_state_dict(model.state_dict(), min_size=512)
    model.load_state_dict(dequantize_state_dict(qsd))
    quantization_report(model.state_dict(), qsd)

Per-output-channel symmetric int8 of the conv and Linear weights (a state_dict
entry ``*.weight`` of ndim >= 2, the JAX tree's ``w`` leaves) of at least
``min_size`` elements: a quantized entry becomes ``{"q": int8, "scale":
float32}`` in the port's layout (output channels first; ``scale`` [O, 1, ...]).
The scale search runs on the weight in the JAX layout (HWIO, Linear [in, out]),
so the int8 values and scales are the JAX package's, transposed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

ROUTER_KEYS = ("routing", "router", "se_gate", "complexity_estimator", "global_fc", "expert_prior")


def _is_router_name(name: str) -> bool:
    return any(seg in ROUTER_KEYS for seg in name.split("."))


def _to_jax_layout(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T  # OIHW -> HWIO; Linear [out, in] -> [in, out]


def _from_jax_layout(w: np.ndarray) -> np.ndarray:
    return w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T


def quantize_leaf(w: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-output-channel symmetric int8 of a weight in the JAX layout (output
    channels last): the scale per channel is MSE-optimal over clip ratios 1.0
    to 0.7 of the channel's abs-max, not abs-max itself, so that one outlier
    weight does not stretch the grid of its whole channel (the JAX package's
    ``quantize_leaf``; 1-D leaves share one scale)."""
    w = np.asarray(w, np.float32)
    flat = w.reshape(-1, w.shape[-1]) if w.ndim > 1 else w.reshape(-1, 1)
    amax = np.maximum(np.abs(flat).max(axis=0, keepdims=True), 1e-8)  # [1, C]
    best_scale = amax / 127.0
    best_err = None
    for ratio in (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7):
        scale = np.maximum(amax * ratio, 1e-8) / 127.0
        q = np.clip(np.round(flat / scale), -127, 127)
        err = ((q * scale - flat) ** 2).sum(0, keepdims=True)
        if best_err is None:
            best_err = err
        else:
            better = err < best_err
            best_scale = np.where(better, scale, best_scale)
            best_err = np.minimum(err, best_err)
    kd_shape = (1,) * (w.ndim - 1) + (w.shape[-1],) if w.ndim > 1 else (1,)
    scale = best_scale.reshape(kd_shape)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(np.float32)}


def quantize_tensor(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """:func:`quantize_leaf` of a conv [O, I, kh, kw] or Linear [O, I] weight, in the port's layout."""
    leaf = quantize_leaf(_to_jax_layout(w.detach().float().cpu().numpy()))
    return {k: torch.from_numpy(np.ascontiguousarray(_from_jax_layout(v))) for k, v in leaf.items()}


def _quantizable(name: str, t, min_size: int, router_aware: bool) -> bool:
    return (torch.is_tensor(t) and name.rsplit(".", 1)[-1] == "weight" and t.ndim >= 2 and t.is_floating_point()
            and t.numel() >= min_size and not (router_aware and _is_router_name(name)))


def quantize_state_dict(state_dict, min_size: int = 512, router_aware: bool = True) -> dict:
    """Quantize the conv and Linear weights of ``state_dict`` to int8, the routers'
    left as they are when ``router_aware`` (the reference's node-exclusion plan)."""
    return {k: quantize_tensor(v) if _quantizable(k, v, min_size, router_aware) else v
            for k, v in state_dict.items()}


def dequantize_state_dict(qsd) -> Dict[str, torch.Tensor]:
    """The state_dict back in float32 (``q * scale``) for the quantized entries."""
    return {k: v["q"].float() * v["scale"] if isinstance(v, dict) else v for k, v in qsd.items()}


def _nbytes(v) -> Tuple[int, int]:
    """(bytes, quantized tensors) of one entry: floating tensors and int8 + scale pairs."""
    if isinstance(v, dict):
        return v["q"].numel() * v["q"].element_size() + v["scale"].numel() * v["scale"].element_size(), 1
    return (v.numel() * v.element_size(), 0) if v.is_floating_point() else (0, 0)


def quantization_report(state_dict, qsd) -> dict:
    """Size accounting of the quantization plan: the bytes of the floating
    entries (the weights; the BatchNorms' integer counters are not counted,
    as the JAX tree has none) before and after."""
    orig = sum(_nbytes(v)[0] for v in state_dict.values())
    sizes = [_nbytes(v) for v in qsd.values()]
    quant = sum(b for b, _ in sizes)
    n_q = sum(n for _, n in sizes)
    return {"original_bytes": orig, "quantized_bytes": quant, "ratio": quant / max(orig, 1), "quantized_tensors": n_q}
