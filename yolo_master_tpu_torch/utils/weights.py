"""Carry weights from the JAX package to the port.

:func:`state_dict_from_jax` is the inverse of
``yolo_master_tpu/utils/torch_import.py`` (``_torch_key`` and ``convert``)
for the modules of the yolo-master-n, yolo-master-v0_1, v0_4-v0_15 and
yolo26-master graphs (ES_MOE with or without top_k, OptimizedMOEImproved and
A2C2fMoE, the gated blocks, the PSA family, the end2end head's ``one2one_*``
branches, A2C2f's ``gamma``; yolo26-master-latent's LatentMixture and
yolo26-master-moa-mot's C2fMoA and C2fMoT, NeckMoAFusion and
MultiScaleLatentMixture, with their ``residual_gain``,
``scale_embedding``, layer scales and MoA's ``_rf_matrix`` under their own
names, MoT's ``ffn_gate`` wrapped at ``ffn_gate.0`` and its experts' FFN at
indices 0 and 3): it
maps the JAX parameter tree's paths to ultralytics state_dict keys, HWIO conv
kernels to OIHW and ``Linear`` matrices [in, out] to [out, in]. The gated
blocks' parameter-free ``nn.Sequential`` slots of the reference shift the
indices after them (``se_gate.0`` -> ``se_gate.2``) or wrap a lone conv
(``complexity_estimator`` -> ``complexity_estimator.1``), as in
``yolo_master_tpu/utils/torch_import.py``; their scalars, ``expert_prior``
and ``expert_norm_weight/bias`` keep their names and shapes. A layer that
``pallas_esmoe_fuse`` rewrote (``{"routing", "banks"}``) maps to the port's
:class:`~..nn.moe.es_moe.FusedESMOE`, whose banks keep the JAX layout.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}
_BN_LEAVES = {"scale", "bias", "mean", "var"}
# the reference's parameter-free Sequential slots (pooling, flatten) before the
# gated blocks' layers: the index shift of the layers after them, and the lone
# convs the reference wraps (their torch index)
_SEQ_SHIFT = {"se_gate": 2, "feature_gate": 1, "refine_gate": 1, "gate_net": 2}
_WRAPPED = {"complexity_estimator": "1", "context_gate": "0", "ffn_gate": "0"}
# index remaps where the reference interposes a parameter-free Dropout (MoT's transformer experts'
# ffn: Linear, GELU, Dropout, Linear)
_SEQ_REMAP = {"ffn": {"2": "3"}}


def _torch_key(path: List[str]) -> List[str]:
    """Our module path -> torch module path (the ``_torch_key`` subset of the slice)."""
    parts: List[str] = []
    i = 0
    while i < len(path):
        seg = path[i]
        if seg == "layers" and i == 0:
            parts.append("model")
        elif seg == "norm_bn":
            parts.extend(["norm", "0"])
        elif seg in ("fc1", "fc2") and parts and parts[-1] == "routing":
            parts.extend(["routing_network", "0" if seg == "fc1" else "2"])
        elif seg in _SEQ_REMAP and i + 1 < len(path) and path[i + 1] in _SEQ_REMAP[seg]:
            parts.extend([seg, _SEQ_REMAP[seg][path[i + 1]]])
            i += 1
        elif seg in _SEQ_SHIFT and i + 1 < len(path) and path[i + 1].isdigit():
            parts.extend([seg, str(int(path[i + 1]) + _SEQ_SHIFT[seg])])
            i += 1
        elif seg in _WRAPPED and (i + 1 == len(path) or not path[i + 1].isdigit()):
            parts.extend([seg, _WRAPPED[seg]])
        else:
            parts.append(seg)
        i += 1
    return parts


def _to_torch_layout(v: np.ndarray, path: List[str]) -> np.ndarray:
    if v.ndim == 4:  # HWIO -> OIHW
        return v.transpose(3, 2, 0, 1)
    if v.ndim == 2 and path[-1] == "w":
        if len(path) > 2 and path[-2] in ("fc1", "fc2") and path[-3] == "routing":
            return v.T[:, :, None, None]  # ES_MOE router matrix [in, out] -> 1x1 conv [out, in, 1, 1]
        return v.T  # Linear [in, out] -> [out, in]
    return v


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves, unfused or ES_MOE-fused) -> the port's state_dict.

    BatchNorms also get ``num_batches_tracked = 0`` so that
    ``load_state_dict(strict=True)`` accepts the result.
    """
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if not isinstance(node, dict):
            arr = np.asarray(node, np.float32)
            if len(path) > 1 and path[-2] == "banks":  # FusedESMOE: the JAX layout, dw [E,k,k,C] as [E,k*k,C]
                key = ".".join(_torch_key(path))
                if path[-1] == "dw":
                    arr = arr.reshape(arr.shape[0], -1, arr.shape[-1])
            else:
                key = ".".join(_torch_key(path[:-1]) + [_LEAF.get(path[-1], path[-1])])
                arr = _to_torch_layout(arr, path)
            sd[key] = torch.from_numpy(np.array(arr, order="C"))
            return
        if _BN_LEAVES <= set(node):
            sd[".".join(_torch_key(path) + ["num_batches_tracked"])] = torch.tensor(0)
        for k, v in node.items():
            walk(v, path + [k])

    walk(params, [])
    return sd


@torch.no_grad()
def calibrate_bn(model, x_nhwc: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to those of one batch.

    At PyTorch's default init, activations shrink about threefold per conv, so
    by the neck of yolo-master-n they are ~0 and the detections no longer
    depend on the image. One train-mode pass with momentum 1 makes each BN
    normalise its layer to unit scale on ``x_nhwc``: random weights then give
    image-dependent outputs, and BN folding has real statistics to fold. The
    routed blocks (OptimizedMOEImproved) route in that pass as in eval (their
    top_k, no router noise, no expert dropout), so that the statistics are
    those the eval graph sees.
    The gated blocks (AdaptiveGateMoE and its family) run their eval forward
    in that pass (no temperature anneal, noise, expert dropout or drop-path).
    So do the MoA, MoT and latent mixtures and their routers (no exploration
    floor, no noise, no aux record): their own ``training`` flag is off in
    that pass, while the BatchNorms inside them train.
    For tests and smoke runs on random weights; trained weights need none of it.
    """
    from ..nn.latent_mixture import LatentMixture, LatentRouter, MultiScaleLatentMixture
    from ..nn.moa import MoABlock, NeckMoAFusion
    from ..nn.moe import AdaptiveGateMoE, OptimizedMOEImproved
    from ..nn.mot import MoTBlock, MoTRouter

    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [bn.momentum for bn in bns]
    routed = [(m, (m.noise_std, m.progressive_sparsity, m.expert_dropout_rate))
              for m in model.modules() if isinstance(m, OptimizedMOEImproved)]
    gated = [m for m in model.modules() if isinstance(m, AdaptiveGateMoE)]
    mixtures = (MoABlock, NeckMoAFusion, MoTBlock, MoTRouter, LatentMixture, MultiScaleLatentMixture, LatentRouter)
    was_training = model.training
    for bn in bns:
        bn.momentum = 1.0
    for m, _ in routed:
        m.noise_std, m.progressive_sparsity, m.expert_dropout_rate = 0.0, False, 0.0
    for m in gated:
        m.calibrating = True
    model.train()
    for m in model.modules():
        if isinstance(m, mixtures):
            m.training = False
    try:
        model(x_nhwc)
    finally:
        model.train(was_training)
        for bn, m in zip(bns, momenta):
            bn.momentum = m
        for m in gated:
            m.calibrating = False
        for m, saved in routed:
            m.noise_std, m.progressive_sparsity, m.expert_dropout_rate = saved
            m.aux_record = None


@torch.no_grad()
def wake_mixtures(model, seed: int = 0) -> None:
    """Set the parts of the latent, MoA and MoT mixtures that start at zero to
    non-zero values, in place, drawn on the host from ``seed``: each
    LatentMixture's ``residual_gain`` U(0.3, 0.8) and its router head N(0,
    0.5), the MoA and MoT routers' last layers (NeckMoAFusion's too) and the
    deformable experts' offset and point-weight projections
    U(+-1/sqrt(fan_in)). At the init the latent experts add nothing and every
    router is uniform, so a check on seeded weights would not see them. For
    tests and smoke runs on random weights, as :func:`calibrate_bn` (run it
    after this)."""
    from ..nn.latent_mixture import LatentMixture
    from ..nn.moa import MoARouter
    from ..nn.mot import DeformableTransformerExpert, MoTRouter

    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, LatentMixture):
            m.residual_gain.copy_(0.3 + 0.5 * torch.rand((), generator=g))
            for t in (m.router.expert_head.weight, m.router.expert_head.bias):
                t.copy_(0.5 * torch.randn(t.shape, generator=g))
        layers = []
        if isinstance(m, (MoARouter, MoTRouter)):
            layers = [m.router[-1]]
        elif isinstance(m, DeformableTransformerExpert):
            layers = [m.offset_proj, m.attn_proj]
        for lin in layers:
            bound = 1.0 / lin.weight[0].numel() ** 0.5
            for t in (lin.weight, lin.bias):
                t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=g))


def _array_leaves(tree, path=()):
    """(path, array) of every numpy leaf of a nested dict; optax's masked-out
    entries (empty tuples) are skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _array_leaves(v, path + (k,))
    elif isinstance(tree, np.ndarray) or np.isscalar(tree):
        yield path, np.asarray(tree)


def _nest(leaves) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, arr in leaves:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def _opt_fields(node, found):
    """Collect the optimizer state's counts and per-parameter buffers from an
    optax state (NamedTuples, tuples and dicts with numpy leaves)."""
    fields = getattr(node, "_fields", None)
    if fields is not None:
        for f in fields:
            v = getattr(node, f)
            if f == "count":
                found["count"].append(int(np.asarray(v)))
            elif f in ("trace", "mu", "nu") and isinstance(v, dict):
                found[f].extend(_array_leaves(v))
            else:
                _opt_fields(v, found)
    elif isinstance(node, dict):
        for v in node.values():
            _opt_fields(v, found)
    elif isinstance(node, (tuple, list)):
        for v in node:
            _opt_fields(v, found)


def train_state_from_jax(jax_state, model, tx):
    """The port's :class:`~..engine.train_step.TrainState` from a JAX
    ``TrainState`` whose leaves are numpy arrays (``jax.tree_util.tree_map(np.asarray, state)``),
    for the same graph and an optimizer ``tx`` of the same kind as the one that made it.

    The model takes ``params`` (strict); the state takes ``ema_params``,
    ``step``, ``ema_updates``, ``aux_ema``, the optimizer's count and its
    per-parameter buffers (SGD's momentum traces; Adam's mu and nu).
    """
    from ..engine.train_step import make_train_state

    model.load_state_dict(state_dict_from_jax(jax_state.params), strict=True)
    state = make_train_state(model, tx)
    device = next(model.parameters()).device
    ema = state_dict_from_jax(jax_state.ema_params)
    for k in state.ema_params:
        state.ema_params[k] = ema[k].to(device)
    state.step = int(np.asarray(jax_state.step))
    state.ema_updates = float(np.asarray(jax_state.ema_updates))
    state.aux_ema = torch.from_numpy(np.array(jax_state.aux_ema, np.float32)).to(device)
    found = {"count": [], "trace": [], "mu": [], "nu": []}
    _opt_fields(jax_state.opt_state, found)
    if len(set(found["count"])) > 1:
        raise ValueError(f"the optimizer's groups disagree on the count: {sorted(set(found['count']))}")
    state.opt_state.count = found["count"][0] if found["count"] else 0
    for kind, bufs in state.opt_state.buffers.items():
        carried = state_dict_from_jax(_nest(found[kind]))
        missing = set(bufs) - set(carried)
        if missing:
            raise ValueError(f"the JAX optimizer state has no '{kind}' for {sorted(missing)[:5]}")
        for name, buf in bufs.items():
            buf.copy_(carried[name].reshape(buf.shape))
    return state
