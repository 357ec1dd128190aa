"""One optimizer step of detection training (counterpart of
``yolo_master_tpu/engine/train_step.py``): forward in train mode, the v8 loss
with task-aligned assignment, the MoE balance aux composed per family,
backward, gradient accumulation, the reference optimizer policy, EMA, and
BatchNorm running statistics, with the JAX package's finite guard; in fp32,
or in bf16 with fp32 parameters, loss and state (``compute_dtype``).

    model = DetectionModel("yolo-master-n").to(device)
    policy = TrainPolicy(nc=model.nc, epochs=100, nb=len_of_loader, batch=16)
    tx = policy.build_optimizer(model)
    state = make_train_state(model, tx)
    step = make_train_step(model, tx, accumulate=policy.accumulate, compute_dtype=torch.bfloat16)
    state, metrics = step(state, batch)  # batch: images [B,H,W,3] /255, boxes, classes, mask

The model holds the live parameters and BatchNorm statistics (JAX:
``state.params``); the state holds the optimizer's buffers, the EMA of every
floating entry of the model's state_dict, and the counters. The step updates
them in place and returns the state with the step's metrics.

What follows the JAX package exactly, where PyTorch's own tools differ:

  * the optimizer is optax's chain: clip by global norm (g * max/|g| once
    |g| >= max, no epsilon), then coupled weight decay (g + wd * p) on the
    decay and router groups, then the base optimizer per group (nesterov SGD
    with the momentum schedule, Adam with L2 decay for "AdamW"/"Adam", or
    RMSProp), each group at its own learning rate, every schedule read at the
    optimizer's own count;
  * under accumulation the BatchNorm statistics take ONE update, from the last
    micro-batch, against the step's starting statistics (each JAX micro-step
    reads the step's parameters);
  * a non-finite loss restores the parameters, BatchNorm statistics and the
    optimizer (its count too); ``step`` still counts, ``ema_updates`` does not,
    the EMA is still blended (at the unchanged decay) and ``aux_ema`` moves on;
  * bf16 (``yolo_master_tpu/engine/trainer.py:13-14``, ``train_step.py:197``):
    the forward and the backward in bf16, the loss in fp32 and no loss scaling
    (bf16 has fp32's range), the finite guard on the fp32 loss.

yolo26-master trains with its end2end head's dual-assignment loss
(``nn/losses.py:composite_loss``). Routed blocks (OptimizedMOEImproved with
every expert and router type: yolo-master-v0_1's, yolo26-master's inside
A2C2fMoE; the AdaptiveGate family of v0_4-v0_15) train at ``state.step``, which every micro-batch of
the step reads, as JAX's ``step_idx``: their router noise, progressive
sparsity, expert dropout, temperature anneal and drop-path are JAX's for
that step (``nn/moe/mixtures.py``, ``nn/moe/gated.py``); each micro-batch's
complexity gate averages over that micro-batch, as each JAX micro-step does.
The MoA, MoT and latent mixtures (yolo26-master-moa-mot, -latent) train as
JAX's: their aux losses in the ``moa``, ``mot`` and ``latent`` families, MoT's
exploration floor, and the latent routers' logit noise keyed by the router's
JAX path and ``state.step`` (``nn/moa.py``, ``nn/mot.py``,
``nn/latent_mixture.py``). MoA's random features stay a fixed buffer, where
JAX's step trains them (fault 4 of the reference, ROADMAP.md §3).
Refused: fused models and Muon / MuSGD.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..nn.mixture_loss import compose_aux, init_aux_ema
from ..nn.tasks import jax_module_path as moe_stats_path

Schedule = Union[float, Callable[[int], float]]
_HYP_DEFAULTS = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "moe": 0.01}
_AUX_GAINS = ("moe", "moa", "mot", "latent", "molora")
_UNPORTED_OPTIMIZER = "ROADMAP.md §1.I item 23 (the Muon optimizers)"
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)  # the train step's forward and backward


# -- parameter groups ------------------------------------------------------------------------

def _is_router(name: str) -> bool:
    low = name.lower()
    return "router" in low or "routing" in low


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def weight_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Decay only conv and linear weights (a ``weight`` with ndim >= 2): :func:`make_optimizer`'s mask."""
    return {n: _leaf(n) == "weight" and p.ndim >= 2 for n, p in model.named_parameters()}


def param_group_labels(model: torch.nn.Module) -> Dict[str, str]:
    """The reference optimizer policy's group of each parameter, by state_dict name:

    * ``router``: "router" or "routing" anywhere in the name, biases included
      (decayed, lr x ``router_lr_scale``);
    * ``decay``: weights with ndim >= 2 (conv kernels);
    * ``bias``: conv and BatchNorm biases (no decay, their own warmup lr);
    * ``other``: the rest, BatchNorm scales (no decay), and the parameters
      the gated blocks hold themselves (scalars, ``expert_prior``,
      ``expert_norm_weight`` / ``expert_norm_bias``: JAX labels by the leaf's
      name, and theirs are neither ``w`` nor ``b``).

    The JAX tree's ``w`` / ``b`` / ``scale`` leaves are the port's ``weight`` /
    ``bias`` / BatchNorm ``weight``: the group is read from the name's last part.
    """
    labels = {}
    for name, p in model.named_parameters():
        if _is_router(name):
            labels[name] = "router"
        elif _leaf(name) == "weight" and p.ndim >= 2:
            labels[name] = "decay"
        elif _leaf(name) == "bias":
            labels[name] = "bias"
        else:
            labels[name] = "other"
    return labels


# -- the optimizer ---------------------------------------------------------------------------

def _at(schedule: Schedule, count: int) -> float:
    return float(schedule(count)) if callable(schedule) else float(schedule)


def _f32_pow(base: float, count: int) -> float:
    """``base ** count`` in fp32, as optax's bias correction computes it."""
    return float(np.float32(base) ** np.float32(count))


@dataclass
class OptState:
    """The optimizer's count (every group steps together) and its per-parameter
    buffers by kind: ``trace`` (SGD, RMSProp momentum), ``mu`` / ``nu`` (Adam),
    ``nu`` (RMSProp)."""
    count: int
    buffers: Dict[str, Dict[str, torch.Tensor]]


class Optimizer:
    """clip -> per group: [coupled weight decay] -> base optimizer (optax's chain).

    ``labels`` maps each trained parameter's name to decay / other / bias /
    router; decay and router take ``g + weight_decay * p``. Learning rates:
    ``lr_fn`` (decay, other), ``bias_lr_fn`` (bias), ``lr_fn * router_lr_scale``
    (router). ``momentum_fn`` is SGD's momentum; Adam's b1 and RMSProp's
    momentum are ``momentum``.
    """

    def __init__(self, name: str, labels: Dict[str, str], lr_fn: Schedule, momentum: float = 0.937,
                 weight_decay: float = 5e-4, clip_norm: float = 10.0, momentum_fn: Optional[Schedule] = None,
                 bias_lr_fn: Optional[Schedule] = None, router_lr_scale: float = 0.5):
        self.name = name.lower()
        if self.name in ("muon", "musgd"):
            raise NotImplementedError(f"optimizer '{name}' is not ported yet: {_UNPORTED_OPTIMIZER}")
        if self.name not in ("sgd", "adamw", "adam", "rmsprop"):
            raise ValueError(f"unknown optimizer '{name}'")
        self.labels = dict(labels)
        self.lr_fn = lr_fn
        self.bias_lr_fn = lr_fn if bias_lr_fn is None else bias_lr_fn
        self.router_lr_scale = router_lr_scale
        self.momentum = momentum
        self.momentum_fn = momentum if momentum_fn is None else momentum_fn
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def _kinds(self) -> List[str]:
        return {"sgd": ["trace"], "adamw": ["mu", "nu"], "adam": ["mu", "nu"], "rmsprop": ["nu", "trace"]}[self.name]

    def init(self, model: torch.nn.Module) -> OptState:
        params = dict(model.named_parameters())
        missing = set(self.labels) ^ set(params)
        if missing:
            raise ValueError(f"the optimizer's groups and the model's parameters differ: {sorted(missing)[:5]}")
        return OptState(0, {kind: {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                                   for n, p in params.items()} for kind in self._kinds()})

    def group_lr(self, label: str, count: int) -> float:
        if label == "bias":
            return _at(self.bias_lr_fn, count)
        lr = _at(self.lr_fn, count)
        return self.router_lr_scale * lr if label == "router" else lr

    @torch.no_grad()
    def apply(self, model: torch.nn.Module, state: OptState) -> None:
        """Update the model's parameters in place from their ``.grad``; the count advances."""
        params = dict(model.named_parameters())
        names = list(self.labels)
        grads = [params[n].grad if params[n].grad is not None else torch.zeros_like(params[n]) for n in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm), self.clip_norm / norm)
        grads = torch._foreach_mul(grads, factor)
        count = state.count
        for label in ("decay", "other", "bias", "router"):
            idx = [i for i, n in enumerate(names) if self.labels[n] == label]
            if not idx:
                continue
            ns = [names[i] for i in idx]
            p = [params[n] for n in ns]
            g = [grads[i] for i in idx]
            if label in ("decay", "router") and self.weight_decay:
                g = torch._foreach_add(g, p, alpha=self.weight_decay)
            self._base(ns, p, g, state, self.group_lr(label, count), count)
        state.count = count + 1

    def _base(self, names, p, g, state: OptState, lr: float, count: int) -> None:
        buf = state.buffers
        if self.name == "sgd":  # optax trace(nesterov) then scale(-lr)
            m = _at(self.momentum_fn, count)
            tr = [buf["trace"][n] for n in names]
            torch._foreach_mul_(tr, m)
            torch._foreach_add_(tr, g)  # trace = g + m * trace
            u = torch._foreach_add(g, tr, alpha=m)  # g + m * trace
            torch._foreach_add_(p, torch._foreach_mul(u, -lr))
        elif self.name in ("adamw", "adam"):  # optax scale_by_adam then scale(-lr)
            b1, b2, eps = (self.momentum if self.momentum < 1 else 0.9), 0.999, 1e-8
            mu, nu = [buf["mu"][n] for n in names], [buf["nu"][n] for n in names]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
            bc1, bc2 = 1 - _f32_pow(b1, count + 1), 1 - _f32_pow(b2, count + 1)
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
            torch._foreach_add_(p, torch._foreach_mul(u, -lr))
        else:  # rmsprop: optax scale_by_rms, scale(-lr), then trace(momentum)
            d, eps = 0.9, 1e-8
            nu, tr = [buf["nu"][n] for n in names], [buf["trace"][n] for n in names]
            torch._foreach_mul_(nu, d)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - d))
            u = torch._foreach_mul(torch._foreach_mul(g, torch._foreach_rsqrt(torch._foreach_add(nu, eps))), -lr)
            torch._foreach_mul_(tr, self.momentum)
            torch._foreach_add_(tr, u)
            torch._foreach_add_(p, tr)


def build_optimizer(name: str, lr_fn: Schedule, model: torch.nn.Module, momentum: float = 0.937,
                    weight_decay: float = 5e-4, clip_norm: float = 10.0, momentum_fn: Optional[Schedule] = None,
                    bias_lr_fn: Optional[Schedule] = None, router_lr_scale: float = 0.5) -> Optimizer:
    """The reference optimizer policy: groups of :func:`param_group_labels`, clip
    10.0, coupled decay on the decay and router groups. ``name``: SGD | AdamW |
    Adam | RMSProp (Muon and MuSGD raise)."""
    return Optimizer(name, param_group_labels(model), lr_fn, momentum=momentum, weight_decay=weight_decay,
                     clip_norm=clip_norm, momentum_fn=momentum_fn, bias_lr_fn=bias_lr_fn,
                     router_lr_scale=router_lr_scale)


def make_optimizer(lr_schedule: Schedule, model: torch.nn.Module, momentum: float = 0.937,
                   weight_decay: float = 5e-4, clip_norm: float = 10.0) -> Optimizer:
    """Nesterov SGD at one lr for every parameter, decay on :func:`weight_decay_mask`, clip 10.0."""
    labels = {n: "decay" if m else "other" for n, m in weight_decay_mask(model).items()}
    return Optimizer("sgd", labels, lr_schedule, momentum=momentum, weight_decay=weight_decay,
                     clip_norm=clip_norm, router_lr_scale=1.0)


def resolve_auto_optimizer(nc: int, iterations: float, lr0: float, momentum: float):
    """``optimizer: auto``: SGD for runs of more than 10,000 iterations, else AdamW
    at an nc-scaled lr and momentum 0.9."""
    if iterations > 10000:
        return "SGD", lr0, momentum
    return "AdamW", round(0.002 * 5 / (4 + nc), 6), 0.9


# -- the trainer's schedules -----------------------------------------------------------------

@dataclass
class TrainPolicy:
    """What the trainer derives from its arguments (``yolo_master_tpu/engine/trainer.py``):
    accumulation toward the nominal batch, the warmup length, the resolved
    optimizer and the schedules, each a plain function of the optimizer's count."""
    nc: int
    epochs: int
    nb: int  # loader batches per epoch
    batch: int
    nbs: int = 64
    optimizer: str = "auto"
    lr0: float = 0.01
    lrf: float = 0.01
    cos_lr: bool = False
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    router_lr_scale: float = 0.5
    accumulate: int = field(init=False)
    nb_opt: int = field(init=False)
    warmup_steps: int = field(init=False)
    opt_name: str = field(init=False)
    opt_lr0: float = field(init=False)
    opt_momentum: float = field(init=False)

    def __post_init__(self):
        nb = max(self.nb, 1)
        self.accumulate = max(1, min(round(self.nbs / self.batch), nb))
        self.nb_opt = max(nb // self.accumulate, 1)
        self.warmup_steps = max(round(self.warmup_epochs * self.nb_opt), 100) if self.warmup_epochs > 0 else 0
        if self.optimizer == "auto":
            self.opt_name, self.opt_lr0, self.opt_momentum = resolve_auto_optimizer(
                self.nc, self.epochs * self.nb_opt, self.lr0, self.momentum)
        else:
            self.opt_name, self.opt_lr0, self.opt_momentum = self.optimizer, self.lr0, self.momentum

    @property
    def scaled_weight_decay(self) -> float:
        """weight_decay * batch * accumulate / nbs."""
        return self.weight_decay * self.batch * self.accumulate / self.nbs

    def decay_frac(self, step: int) -> float:
        frac = min(max(step / max(self.nb_opt * max(self.epochs, 1), 1), 0.0), 1.0)
        if self.cos_lr:
            return self.lrf + (1.0 - self.lrf) * (1.0 + math.cos(math.pi * frac)) / 2.0
        return (1.0 - frac) * (1.0 - self.lrf) + self.lrf

    def lr_schedule(self, step: int) -> float:
        """0 at step 0, rising linearly to lr0 over the warmup, then the decay."""
        if step < self.warmup_steps:
            return self.opt_lr0 * min(step / max(self.warmup_steps, 1), 1.0)
        return self.opt_lr0 * self.decay_frac(step)

    def bias_lr_schedule(self, step: int) -> float:
        """warmup_bias_lr at step 0, falling linearly to lr0 over the warmup, then the decay."""
        if step < self.warmup_steps:
            t = min(max(step / max(self.warmup_steps, 1), 0.0), 1.0)
            return self.warmup_bias_lr + t * (self.opt_lr0 - self.warmup_bias_lr)
        return self.opt_lr0 * self.decay_frac(step)

    def momentum_schedule(self, step: int) -> float:
        t = min(max(step / max(self.warmup_steps, 1), 0.0), 1.0)
        return self.warmup_momentum + t * (self.opt_momentum - self.warmup_momentum)

    def build_optimizer(self, model: torch.nn.Module) -> Optimizer:
        warm = bool(self.warmup_steps)
        return build_optimizer(self.opt_name, self.lr_schedule, model, momentum=self.opt_momentum,
                               weight_decay=self.scaled_weight_decay,
                               momentum_fn=self.momentum_schedule if warm and self.opt_name.lower() == "sgd" else None,
                               bias_lr_fn=self.bias_lr_schedule if warm else None,
                               router_lr_scale=self.router_lr_scale)


# -- the state and the step ------------------------------------------------------------------

@dataclass
class TrainState:
    """``model`` holds the parameters and BatchNorm statistics (JAX: ``params``);
    ``ema_params``: every floating entry of its state_dict."""
    model: torch.nn.Module
    opt_state: OptState
    ema_params: Dict[str, torch.Tensor]
    step: int
    ema_updates: float  # finite steps taken (the EMA decay's ramp)
    aux_ema: torch.Tensor  # [F] per-family aux magnitudes (nn/mixture_loss.py)


def _float_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in model.state_dict().items() if v.is_floating_point()}


def make_train_state(model: torch.nn.Module, tx: Optional[Optimizer] = None, lr: Schedule = 0.01) -> TrainState:
    """The state at step 0 of the model's current weights (default optimizer: :func:`make_optimizer`)."""
    tx = tx or make_optimizer(lr, model)
    ema = {k: v.detach().clone() for k, v in _float_state(model).items()}
    device = next(model.parameters()).device
    return TrainState(model, tx.init(model), ema, 0, 0.0, init_aux_ema(device))


def ema_decay(updates: float, decay: float = 0.9999, tau: float = 2000.0) -> float:
    """The ramped EMA decay ``decay * (1 - exp(-updates / tau))``: 0 at 0 updates."""
    return decay * (1.0 - math.exp(-updates / tau))


@torch.no_grad()
def ema_blend(ema_params: Dict[str, torch.Tensor], model: torch.nn.Module, d: float) -> None:
    """ema = d * ema + (1 - d) * the model's entry, for every entry of ``ema_params``, in place."""
    cur = _float_state(model)
    keys = list(ema_params)
    e = [ema_params[k] for k in keys]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, torch._foreach_mul([cur[k] for k in keys], 1.0 - d))


def _check_trainable(model: torch.nn.Module) -> None:
    from ..nn.layers import FusedStem
    from ..nn.moe import FusedESMOE

    if getattr(model, "task", "detect") != "detect":
        raise NotImplementedError(f"training a {model.task} model is not ported yet: ROADMAP.md §1.E item 13 "
                                  "(the task heads' losses and trainers)")
    for m in model.modules():
        if isinstance(m, (FusedStem, FusedESMOE)):
            raise ValueError("a fused (deploy) model cannot be trained: train the unfused model")
        if isinstance(getattr(m, "bn", None), torch.nn.Identity):
            raise ValueError("a model with BatchNorm folded (fuse_bn) cannot be trained: train the unfused model")


def make_train_step(model: torch.nn.Module, tx: Optional[Optimizer] = None, hyp: Optional[dict] = None,
                    accumulate: int = 1, ema_on: bool = True, compute_dtype: torch.dtype = torch.float32,
                    return_stats: bool = False):
    """Build ``step(state, batch, moe_gain=None) -> (state, metrics)``.

    ``batch``: images [B, H, W, 3] float in 0..1, boxes [B, M, 4] xyxy px,
    classes [B, M], mask [B, M] bool, on the model's device; B a multiple of
    ``accumulate``. ``compute_dtype``: float32, or bfloat16 for the JAX
    package's mixed precision: the images cast to bf16, the fp32 parameters
    cast per op (``nn/layers.py``), the loss and the aux in fp32, no loss
    scaling; the gradients reach the fp32 parameters through the casts, and
    the optimizer, EMA and BN statistics stay fp32. ``hyp``: loss gains box /
    cls / dfl / moe (7.5, 0.5, 1.5, 0.01), mixture_aux_budget,
    mixture_aux_normalize. ``moe_gain`` overrides ``hyp["moe"]`` for this step. Metrics: loss, box_loss, cls_loss,
    dfl_loss, aux_loss (and aux_<family>, aux_isolated where the model
    publishes aux losses), each the mean over the micro-batches, and finite.
    With ``return_stats`` also ``moe_stats``: for each routed block, by its
    JAX path (:func:`moe_stats_path`), ``expert_usage`` [E] (the batch-mean
    routing weights, or probabilities) and ``balance_loss`` (ES_MOE) or
    ``aux_loss`` (OptimizedMOEImproved; the gated, MoA and MoT blocks publish
    the usage alone, the latent mixtures and NeckMoAFusion nothing), means
    over the micro-batches as the JAX step's.
    """
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    _check_trainable(model)
    hyp = {**_HYP_DEFAULTS, **(hyp or {})}
    tx = tx or make_optimizer(0.01, model)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]

    def loss_fn(mb: dict, h: dict, aux_ema: torch.Tensor, step_idx: int):
        preds, aux = model.forward_train(mb["images"].to(compute_dtype), step_idx)
        if aux:
            gains = {f: h[f] for f in _AUX_GAINS if f in h}
            aux_total, new_ema, aux_metrics = compose_aux(aux, gains, aux_ema,
                                                          budget=h.get("mixture_aux_budget", 0.0),
                                                          normalize=bool(h.get("mixture_aux_normalize", True)))
            base, metrics = model.compute_loss(preds, mb, torch.zeros((), device=aux_ema.device), {**h, "moe": 0.0})
            total = base + aux_total
            metrics = {**metrics, **aux_metrics, "aux_loss": aux_total, "loss": total}
            return total, metrics, new_ema, aux
        total, metrics = model.compute_loss(preds, mb, torch.zeros((), device=aux_ema.device), h)
        return total, metrics, aux_ema, aux

    def step(state: TrainState, batch: dict, moe_gain: Optional[float] = None):
        h = hyp if moe_gain is None else {**hyp, "moe": moe_gain}
        b = batch["images"].shape[0]
        if b % accumulate:
            raise ValueError(f"batch {b} is not a multiple of accumulate={accumulate}")
        model.train()
        start = [(bn.running_mean.clone(), bn.running_var.clone(), bn.num_batches_tracked.clone()) for bn in bns]
        for p in model.parameters():
            p.grad = None
        aux_ema, total, sums, stats = state.aux_ema, 0.0, {}, {}
        for i in range(accumulate):
            if i:  # every micro-batch's BN update starts from the step's statistics
                _restore_bn(bns, start)
            mb = {k: v[i * (b // accumulate):(i + 1) * (b // accumulate)] for k, v in batch.items()}
            t_i, m_i, aux_ema, aux = loss_fn(mb, h, aux_ema, state.step)
            t_i.backward()
            total = total + t_i.detach()
            for k, v in m_i.items():
                sums[k] = sums[k] + v.detach() if k in sums else v.detach()
            if return_stats:  # summed over the micro-batches in order, then / accumulate: the JAX step's tree_map
                for name, rec in aux.items():
                    for k, v in (("expert_usage", rec.usage), (rec.stat, rec.value.detach())):
                        if k is None or v is None:
                            continue
                        key = (moe_stats_path(name), k)
                        stats[key] = stats[key] + v if key in stats else v
        if accumulate > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accumulate)
            total = total / accumulate
            sums = {k: v / accumulate for k, v in sums.items()}
            stats = {k: v / accumulate for k, v in stats.items()}
        finite = bool(torch.isfinite(total))
        if finite:
            tx.apply(model, state.opt_state)
            if ema_on:
                state.ema_updates += 1.0
        else:  # the parameters and the optimizer are untouched; the forward moved the BN statistics
            _restore_bn(bns, start)
        for p in model.parameters():
            p.grad = None
        if ema_on:
            ema_blend(state.ema_params, model, ema_decay(state.ema_updates))
        state.step += 1
        state.aux_ema = aux_ema
        metrics = {**sums, "finite": torch.tensor(float(finite))}
        if return_stats:
            metrics["moe_stats"] = {}
            for (path, k), v in stats.items():
                metrics["moe_stats"].setdefault(path, {})[k] = v
        return state, metrics

    return step


@torch.no_grad()
def _restore_bn(bns, stats) -> None:
    for bn, (mean, var, n) in zip(bns, stats):
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
        bn.num_batches_tracked.copy_(n)
