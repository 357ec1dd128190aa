"""Deploy-time surgery on a :class:`~..nn.tasks.DetectionModel` (counterpart of
``yolo_master_tpu/utils/fuse.py``).

Where the JAX package rewrites a parameter tree, the port rewrites modules in
place: BN folds into the preceding conv, the /255 input scale folds into layer
0, and the two stem convs become one :class:`~..nn.layers.FusedStem` over the
letterboxed uint8 image. The TPU's space-to-depth blob and lane padding have
no counterpart: the CUDA stem reads the NHWC image directly. Opt-in, as in the
JAX package: :func:`fused_esmoe_fuse` swaps the dense ES_MOE blocks for the
fused ES_MOE kernel. :func:`compute_dtype_copy` makes the bf16 copy that a
predictor runs in (the JAX package casts per op instead), and
:func:`current_dtype_copy` keeps it while the model stays as it was.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn
from torch.utils.weak import WeakIdKeyDictionary

from ..nn.latent_mixture import LatentRouter
from ..nn.layers import Conv, FusedStem, LayerNorm, Linear, Passthrough
from ..nn.moa import GlobalAttnHead
from ..nn.moe import gated
from ..nn.moe.es_moe import ES_MOE, FusedESMOE
from ..nn.moe.experts import DepthwiseSeparableConv
from ..nn.moe.routers import DynamicRoutingLayer

# modules whose parameters and buffers stay fp32 in a low-precision copy: the
# BatchNorm statistics (folded in fp32 when applied), the GroupNorm and
# LayerNorm affines, the ES_MOE router and the gated blocks' Linears (JAX
# reduces and projects them in fp32), and the kernel modules, whose kernels
# widen their weights to fp32 as the TPU kernels do
KEEP_FP32 = (nn.BatchNorm2d, nn.GroupNorm, LayerNorm, Linear, DynamicRoutingLayer, FusedStem, FusedESMOE)
# modules whose own parameters and buffers (not their children's) stay fp32: the gated
# family's scalars, expert prior and fused experts' affines, which JAX reads in
# fp32 (tanh, sigmoid, the experts' normalisation) before any cast, the latent
# router's scale embedding (added to fp32 tokens) and MoA's random features (fp32
# linear attention)
KEEP_FP32_OWN = (gated.AdaptiveGateMoE, gated.DualStreamGateRouter, gated.FusedExpertGroup, gated.VisualDetailGate,
                 gated.PyramidContextMixer, gated.CrossPathGate, LatentRouter, GlobalAttnHead)


def fuse_bn(model) -> None:
    """Fold every Conv+BN and every expert's pointwise+BN pair (``fuse_bn_params``).

    Standalone BatchNorms (the ES_MOE output ``norm.0``, and the
    [PlainConv, BatchNorm] sequences of the MoE routers and shared experts)
    stay as they are, as in the JAX package.
    """
    for m in model.modules():
        if isinstance(m, (Conv, DepthwiseSeparableConv)):
            m.fuse()


def _is_stem_conv(m) -> bool:
    c = getattr(m, "conv", None)
    return (type(m) is Conv and c.kernel_size == (3, 3) and c.stride == (2, 2) and c.groups == 1
            and c.dilation == (1, 1) and c.padding == (1, 1))


@torch.no_grad()
def fold_uint8_input(model) -> None:
    """Scale layer 0's conv weights by 1/255 so the model takes raw uint8 pixels."""
    conv = model.model[0].conv
    conv.weight.div_(255.0)
    model.uint8_input = True


@torch.no_grad()
def fused_stem_fuse(model) -> None:
    """Replace layers 0 and 1 (two k3/s2 Convs, BN folded) by one :class:`FusedStem`
    over the uint8 image (``pallas_stem_fuse``): the /255 folds into ``w0``."""
    l0, l1 = model.model[0], model.model[1]
    if not (_is_stem_conv(l0) and _is_stem_conv(l1)):
        raise ValueError("fused_stem_fuse needs two leading k3/s2 dense Convs")
    if l0.conv.bias is None or l1.conv.bias is None:
        raise ValueError("run fuse_bn first (the stem kernel consumes conv biases)")
    stem = FusedStem(l0.conv.weight / 255.0, l0.conv.bias.clone(), l1.conv.weight, l1.conv.bias.clone())
    skip = Passthrough()
    for new, old in ((stem, l0), (skip, l1)):
        new.i, new.f = old.i, old.f
    model.model[0], model.model[1] = stem, skip
    model.uint8_input = True


@torch.no_grad()
def fused_esmoe_fuse(model, layers=None) -> None:
    """Swap every fusable ES_MOE layer (``layers``: only those layer indices) for a
    :class:`FusedESMOE` over the same weights (``pallas_esmoe_fuse``).

    Works before or after :func:`fuse_bn`: the expert and output-norm BNs are
    folded into the kernel's banks either way. Inference only.
    """
    for pos, m in enumerate(model.model):
        if type(m) is not ES_MOE or not m.fusable() or (layers is not None and m.i not in layers):
            continue
        fused = FusedESMOE(m)
        fused.i, fused.f = m.i, m.f
        model.model[pos] = fused


@torch.no_grad()
def compute_dtype_copy(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` that runs in ``dtype`` (bf16), as the JAX package's
    ``predict(compute_dtype=...)`` does with fp32 parameters and per-op casts.

    Every floating parameter and buffer becomes ``dtype`` (the JAX package's
    ``w.astype(x.dtype)`` of each conv, done once), except those under the
    :data:`KEEP_FP32` modules and those of the :data:`KEEP_FP32_OWN` modules
    themselves (their own parameters and buffers); a :class:`FusedStem` gives its output in
    ``dtype``. ``model`` itself is left as it is.
    """
    out = copy.deepcopy(model)
    kept = {id(t) for m in out.modules() if isinstance(m, KEEP_FP32) for t in (*m.parameters(), *m.buffers())}
    kept |= {id(t) for m in out.modules() if isinstance(m, KEEP_FP32_OWN)
             for t in (*m.parameters(recurse=False), *m.buffers(recurse=False))}
    for m in out.modules():
        for t in (*m.parameters(recurse=False), *m.buffers(recurse=False)):
            if t.is_floating_point() and id(t) not in kept:
                t.data = t.data.to(dtype)
        if isinstance(m, FusedStem):
            m.out_dtype = dtype
    return out


def model_key(model: nn.Module):
    """What a copy of ``model`` depends on, as one tuple that is cheap to compare:
    each module's identity and type and its MoE switches (``sparse_inference``,
    ``use_sparse_inference``), and each parameter's and buffer's address and
    version counter. An in-place write (``calibrate_bn``, ``load_state_dict``,
    an edit under ``torch.no_grad()``), a module swapped in
    (``fused_esmoe_fuse``) or a switch flipped changes it; a write through
    ``.data`` does not, as ``ops/stem.py:stem_bank`` and
    ``nn/moe/dispatch.py:expert_bank`` do not see one. None where a tensor is
    an inference tensor, which has no version counter."""
    key, stack = [], [model]
    try:
        while stack:  # the module tree by its own dicts: model.modules() builds a name for each module
            d = stack.pop().__dict__  # not getattr: a Module's __getattr__ raises (slowly) for a missing switch
            key += (id(d), d.get("sparse_inference"), d.get("use_sparse_inference"))
            for t in d["_parameters"].values():
                if t is not None:
                    key += (t.data_ptr(), t._version)
            for t in d["_buffers"].values():
                if t is not None:
                    key += (t.data_ptr(), t._version)
            for m in d["_modules"].values():
                if m is not None:
                    key.append(type(m))
                    stack.append(m)
    except RuntimeError:  # an inference tensor's _version
        return None
    return tuple(key)


# model -> {dtype: (model_key, copy)}: dropped with the model
_dtype_copies = WeakIdKeyDictionary()


def current_dtype_copy(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``model``'s :func:`compute_dtype_copy` as ``model`` is now: made at the
    first call, then kept (its stem's weight bank with it) while
    :func:`model_key` stays the same, and made anew after any change, so that a
    bf16 predict follows the model as an fp32 one does. Every predictor of the
    model shares the copy."""
    key = model_key(model)
    copies = _dtype_copies.setdefault(model, {})
    cached = copies.get(dtype)
    if key is None or cached is None or cached[0] != key:
        with torch.inference_mode(False):  # the copy's tensors keep version counters (its stem bank is kept)
            cached = copies[dtype] = (key, compute_dtype_copy(model, dtype))
    return cached[1]
