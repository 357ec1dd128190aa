"""yolo26-master-n's training in the port against the JAX package, on the CPU
at 64 px: the end2end dual-assignment loss (the one2many branch at TAL top-10
plus the one2one branch, on detached maps, at top-1; L1 on the distances at
reg_max 1), the six OptimizedMOEImproved blocks inside layers 4, 6 and 8's
A2C2fMoE (router noise, progressive sparsity, expert dropout, aux loss), and
the attention of AAttn and the PSA family under autograd.

The JAX package's ``_det_loss`` passes no ``reg_max`` and so cannot compute
yolo26's loss (fault 2 of the reference, ROADMAP §3); every JAX reference here
binds ``compute_loss`` on its own JAX *instance* (``types.MethodType``) to
``composite_loss(..., reg_max=head.reg_max, end2end=True)``, as the port's
``DetectionModel.compute_loss`` does, and runs JAX's real loss and step with
it. Nothing in the JAX package changes.

Both packages take warmup_steps 4 and dropout_interval 4 on every routed
block (k falls from E to 2 over steps 0-4; step 4 drops experts). Weights:
the port's seeded init with BN calibrated on the first batch, carried to the
JAX tree (tests/_torch_scale.py:jax_params_of). Gates, as in
tests/test_torch_moe_train_model.py and _steps.py: the loss terms within 1e-5
relative; gradients within 8x the port's own fp32-vs-fp64 error of each
tensor or 1e-6 x the tree's largest |g|; five steps within 1e-6 + 2e-5 x each
tensor's move or 8x its own fp32-vs-fp64 distance; the draws bit for bit;
bf16 by PERF.md §7's statistic with the routing pinned to JAX bf16's picks.

The loop: the JAX trainer cannot run yolo26 (fault 2), so the port's loop is
held to the port's own step, which the tests above hold to JAX's; the loop's
other behaviour (schedules, accumulation, the EMA's val, checkpoints) is held
to the JAX trainer on yolo-master-n and v0_1/v0_10-n in
tests/test_torch_trainer*.py, _moe_trainer.py and _gated_trainer.py.
"""

import copy
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine import train_step as jts
from yolo_master_tpu.nn import assigner as jassigner
from yolo_master_tpu.nn import losses as jlosses
from yolo_master_tpu.nn.mixture_loss import compose_aux as jax_compose_aux
from yolo_master_tpu.nn.mixture_loss import init_aux_ema as jax_init_aux_ema
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import mixtures as jmix
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.data.dataset import DataLoader, YOLODataset
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.engine.trainer import DetectionTrainer
from yolo_master_tpu_torch.nn import assigner as tassigner
from yolo_master_tpu_torch.nn import losses as tlosses
from yolo_master_tpu_torch.nn.moe import OptimizedMOEImproved
from yolo_master_tpu_torch.nn.moe import mixtures as tmix
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils import jax_random as jr
from yolo_master_tpu_torch.utils.checkpoint import load_weights_npz
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_moe_train_model import (HYP, _batch, _flips, _np, _port_grads64, _port_step_grads,  # noqa: E402
                                        _routing)
from test_torch_moe_train_steps import _held  # noqa: E402
from test_torch_multitrainer import _other_set  # noqa: E402
from test_torch_train_step import _jax_schedules, _jb, _tb  # noqa: E402
from test_torch_trainer import VAL_METRICS, _assert_bitwise, _full_state  # noqa: E402
from test_torch_yolo26 import module_pair  # noqa: E402
from test_train import synth_dataset  # noqa: F401 (fixture reuse: 16 train, 8 val 96-px images)

NAME = "yolo26-master-n"
WARMUP, INTERVAL = 4, 4
METRICS = ("loss", "box_loss", "cls_loss", "dfl_loss", "aux_loss", "aux_moe")
K = 5  # steps of the trajectory
BF16 = torch.bfloat16
STAT = 1.5
BF16_STEP = 4
BF16_BATCHES = 8  # batches of 4 in the bf16 statistic (tests/test_torch_moe_train_model.py's)
PATHS = [f"layers.{i}.m.0.{j}.mlp" for i in (4, 6, 8) for j in (0, 1)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _end2end_compute_loss(self, preds, batch, aux_total, hyp):
    """JAX's ``_det_loss`` with the head's reg_max passed, as upstream's and the port's."""
    lb = jlosses.composite_loss(preds, preds["hw_shapes"], self.head_strides, batch["boxes"], batch["classes"],
                                batch["mask"], nc=self.nc, aux_total=aux_total, reg_max=self.head.reg_max,
                                box_gain=hyp.get("box", 7.5), cls_gain=hyp.get("cls", 0.5),
                                dfl_gain=hyp.get("dfl", 1.5), moe_gain=hyp.get("moe", 0.01),
                                end2end=self.head.end2end)
    return lb.total, {"loss": lb.total, "box_loss": lb.box, "cls_loss": lb.cls, "dfl_loss": lb.dfl, "aux_loss": lb.aux}


def _jax_blocks(jm):
    return [jm.layers[i].m[0][j].mlp for i in (4, 6, 8) for j in (0, 1)]


def _port_blocks(model):
    return [m for m in model.modules() if isinstance(m, OptimizedMOEImproved)]


def _short_schedule(blocks):
    for m in blocks:
        m.warmup_steps, m.dropout_interval = WARMUP, INTERVAL


def _jax_value_and_grad(jm, dtype):
    """JAX's step loss at a traced step (engine/train_step.py's loss_fn: the aux
    composed from a fresh aux_ema) under value_and_grad, jitted; its aux: the
    metrics, each routed block's rank mask in forward order, and the head's
    training outputs."""
    def loss(params, batch, step):
        masks = []
        orig = jmix.process_logits

        def recorded(*a, **k):
            out = orig(*a, **k)
            masks.append(out[0] > 0)
            return out

        jmix.process_logits = recorded
        try:
            ctx = Context(training=True, compute_dtype=dtype, step=step)
            preds = jm.forward_train(params, batch["images"].astype(dtype), ctx)
        finally:
            jmix.process_logits = orig
        aux_total, _, aux_metrics = jax_compose_aux(ctx, {"moe": HYP["moe"]}, jax_init_aux_ema(), budget=0.0,
                                                    normalize=True)
        base, metrics = jm.compute_loss(preds, batch, jnp.zeros(()), {**HYP, "moe": 0.0})
        total = base + aux_total
        return total, ({**metrics, **aux_metrics, "aux_loss": aux_total, "loss": total}, masks, preds)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.fixture(scope="module")
def y26():
    base = DetectionModel(NAME)
    _short_schedule(_port_blocks(base))
    batches = [_batch(seed, 4) for seed in range(50, 50 + K)]
    calibrate_bn(base, torch.from_numpy(batches[0]["images"]))
    jm = JaxDetectionModel(NAME)
    jm.compute_loss = types.MethodType(_end2end_compute_loss, jm)
    _short_schedule(_jax_blocks(jm))
    return {"base": base, "jm": jm, "params": jax_params_of(jm, base), "batches": batches,
            "loss32": _jax_value_and_grad(jm, jnp.float32)}


def test_routed_blocks_key_their_draws_by_the_jax_path(y26):
    """The six routed blocks sit at ABlockMoE.mlp inside each A2C2fMoE's
    ``m`` list of block pairs; the port's ``jax_path`` is JAX's module path,
    letter for letter, and so is every key of their draws."""
    ours = [m.jax_path for m in _port_blocks(y26["base"])]
    theirs = [m.path for m in _jax_blocks(y26["jm"])]
    print("port:", ours, "\nJAX: ", theirs)
    assert ours == theirs == PATHS
    assert [(m.num_experts, m.progressive_sparsity, m.add_residual, m.expert_dropout_rate)
            for m in _port_blocks(y26["base"])] == [(e, True, False, 0.15) for e in (4, 4, 8, 8, 16, 16)]


# -- the loss -----------------------------------------------------------------------------------------

def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree)) if hasattr(tree, "shape") else tree


def test_end2end_loss_matches_jax(y26):
    """composite_loss(..., reg_max=1, end2end=True) of both packages on JAX's
    own forward_train outputs (step 2): box, cls and L1 each within 1e-5
    relative; the one2one branch (at top-1 assignment) adds a share of each."""
    batch = y26["batches"][0]
    (_, (_, _, preds)), _ = y26["loss32"](y26["params"], _jb(batch), jnp.int32(2))
    preds = jax.tree_util.tree_map(np.asarray, {k: v for k, v in preds.items() if k != "hw_shapes"})
    hw = ((8, 8), (4, 4), (2, 2))  # P3-P5 at 64 px
    strides = y26["jm"].head_strides
    args = lambda b: (b["boxes"], b["classes"], b["mask"])  # noqa: E731
    kw = dict(nc=80, reg_max=1, end2end=True)
    ref = jax.jit(lambda p, b: jlosses.composite_loss(p, hw, strides, *args(b), aux_total=jnp.ones(()), **kw))(
        {**preds, "hw_shapes": hw}, _jb(batch))
    out = tlosses.composite_loss({**_to_torch(preds), "hw_shapes": hw}, hw, strides, *args(_tb(batch)),
                                 aux_total=torch.ones(()), **kw)
    for name in ("total", "box", "cls", "dfl", "aux"):
        r, o = float(getattr(ref, name)), float(getattr(out, name))
        assert abs(o - r) <= 1e-5 * abs(r), (name, o, r)
    many = tlosses.composite_loss({**_to_torch(preds), "hw_shapes": hw}, hw, strides, *args(_tb(batch)),
                                  aux_total=torch.ones(()), nc=80, reg_max=1, end2end=False)
    for name in ("box", "cls", "dfl"):
        assert float(getattr(out, name)) > float(getattr(many, name)) > 0, name


@pytest.mark.parametrize("topk", [1, 10])
def test_tal_matches_jax_on_tied_scores(topk):
    """TAL on a batch where most candidates tie: every class score 0.5 and
    whole rows of anchors predicting the same box, so the align metric ties
    across many anchors of a GT. At top-1 (the one2one branch) each GT keeps
    one anchor, the lowest index among the tied best, as ``jax.lax.top_k``;
    the assignment equals JAX's exactly, the target scores within 1e-6."""
    rng = np.random.default_rng(topk)
    hw, strides = ((8, 8), (4, 4), (2, 2)), (8, 16, 32)
    anchors = np.concatenate([np.stack(np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5), -1).reshape(-1, 2) * s
                              for (h, w), s in zip(hw, strides)]).astype(np.float32)
    a = anchors.shape[0]
    scores = np.full((2, a, 80), 0.5, np.float32)
    scores[1, ::3, 7] = 0.9
    boxes = np.tile(np.array([8.0, 8.0, 40.0, 40.0], np.float32), (2, a, 1))
    boxes[:, 40:] = rng.uniform(0, 32, (2, a - 40, 1)).astype(np.float32) + np.array([0, 0, 24, 24], np.float32)
    gt = np.array([[[6, 6, 42, 42], [0, 0, 60, 60], [20, 20, 50, 44]]] * 2, np.float32)
    labels = np.array([[7, 3, 7], [7, 7, 1]], np.int32)
    mask = np.array([[True, True, True], [True, False, True]])
    ref = jassigner.task_aligned_assign(jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(anchors),
                                        jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask), num_classes=80,
                                        topk=topk, strides=strides)
    out = tassigner.task_aligned_assign(torch.from_numpy(scores), torch.from_numpy(boxes), torch.from_numpy(anchors),
                                        torch.from_numpy(labels), torch.from_numpy(gt), torch.from_numpy(mask),
                                        num_classes=80, topk=topk, strides=strides)
    for name in ("fg_mask", "target_gt_idx", "target_labels"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(out.target_scores.numpy(), np.asarray(ref.target_scores), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.target_bboxes.numpy(), np.asarray(ref.target_bboxes))
    if topk == 1:
        assert 0 < int(out.fg_mask.sum()) <= int(mask.sum())


# -- the modules under autograd ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SPPF_shortcut", "Attention_long", "AAttn_long", "C2PSA_n2", "C3k2_attn",
                                  "ABlockMoE", "ABlockMoE_area_ghost"])
def test_module_trains_like_jax(name):
    """Each of yolo26's attention, pooling and MoE-attention modules in train
    mode (BN on batch statistics; the ABlockMoE's router noise, k and dropout
    at step 4 of a 4-step warmup), loss sum(out * ct) + aux: the output and
    the input's gradient within 1e-5 of the tensor's largest |JAX|, every
    parameter's gradient within that or 1e-6 of the module's largest
    parameter gradient (the whole-model gate's floor: a BN bias whose shift a
    later train-mode BN removes, such as SPPF's cv1 through its max pools, has
    a gradient of rounding noise in both packages). The long cases attend over
    1,296 and 1,600 keys, where the port sums the product with V in chunks of
    1,024 under autograd."""
    jm, p, tm, shapes = module_pair(name)
    tm = copy.deepcopy(tm).train()
    moe = _port_blocks(tm)
    jmoe = [m for m in _walk(jm) if isinstance(m, jmix.OptimizedMOEImproved)]
    _short_schedule(moe + jmoe)
    for m, j in zip(moe, jmoe):
        m.jax_path, m.step = j.path, 4
    rng = np.random.default_rng(len(name) + 100)
    x = rng.standard_normal(shapes[0]).astype(np.float32)

    def jloss(params, x, ct):
        ctx = Context(training=True, step=4)
        y = jm(params, x, ctx)
        return jnp.sum(y * ct) + ctx.total_aux(), y

    y_shape = jax.eval_shape(lambda p, x: jm(p, x, Context(training=True, step=4)), p, x).shape
    ct = rng.standard_normal(y_shape).astype(np.float32)
    (_, jy), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(p, x, ct)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).requires_grad_()
    ty = tm(tx)
    aux = sum(m.aux_record.value for m in moe) if moe else 0.0
    ((ty.permute(0, 2, 3, 1) * torch.from_numpy(ct)).sum() + aux).backward()
    pairs = [(ty.detach().permute(0, 2, 3, 1), jy, "out"), (tx.grad.permute(0, 2, 3, 1), gx, "input grad")]
    ref = state_dict_from_jax({"layers": {"0": _np(gp)}})
    pairs += [(prm.grad, ref[f"model.0.{n}"], n) for n, prm in tm.named_parameters()]
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in ref.values())
    for got, want, what in pairs:
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        assert got.shape == want.shape and np.isfinite(got).all(), what
        scale = max(float(np.abs(want).max()), 1e-30)
        floor = 1e-6 * gmax if what not in ("out", "input grad") else 0.0
        assert np.abs(got - want).max() <= max(1e-5 * scale, floor), (what, float(np.abs(got - want).max()), scale)


def _walk(m):
    yield m
    for child in getattr(m, "_children", {}).values():
        if hasattr(child, "mods"):
            for c in child.mods:
                yield from _walk(c)
        else:
            yield from _walk(child)


# -- the whole model, one step and five ---------------------------------------------------------------

@pytest.mark.parametrize("step", [2, 4], ids=["annealing", "dropout"])
def test_one_step_loss_and_gradients_match_jax(y26, step):
    """One fp32 step at ``step`` (2: k = 3, 5 and 9 of 4, 8 and 16, with noise;
    4: k = 2 and a dropout step), B=4: the loss terms and the aux within 1e-5
    relative, the routing (every block's rank mask) JAX's, every gradient
    within max(8 x own, 1e-6 x gmax); the one2one branches' gradients reach
    their own weights and no further (the maps are detached)."""
    batch = y26["batches"][0]
    (_, (jmet, jmasks, _)), jgrad = y26["loss32"](y26["params"], _jb(batch), jnp.int32(step))
    port = copy.deepcopy(y26["base"])
    seen = []
    tmix.process_logits, plain = _routing(seen=seen), tmix.process_logits
    try:
        grads, met = _port_step_grads(port, batch, step)
    finally:
        tmix.process_logits = plain
    assert _flips(seen, [np.asarray(m) for m in jmasks]) == 0
    assert [m.adaptive_top_k() for m in _port_blocks(port)] == ([3, 3, 5, 5, 9, 9] if step == 2 else [2] * 6)
    assert all((m.dropped_experts().size > 0) == (step == 4) for m in _port_blocks(port))
    for k in METRICS:
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), (k, float(met[k]), float(jmet[k]))
    own64 = _port_grads64(y26["base"], batch, step)
    ref = state_dict_from_jax(_np(jgrad))
    gmax = max(g.abs().max().item() for g in ref.values())
    for name, g in grads.items():
        own = (g.double() - own64[name]).abs().max().item()
        err = (g - ref[name]).abs().max().item()
        assert err <= max(8 * own, 1e-6 * gmax), (name, err, own, gmax)
    assert all(grads[n].abs().max() > 0 for n in grads if ".one2one_cv3." in n and n.endswith("bias"))


def test_router_draws_match_jax_bit_for_bit(y26):
    """After a train step at step 4 (a dropout step) on a batch of 4 in two
    micro-batches of 2, each block's draws, the noise normal(key, [2, E]) x
    noise_std and the keep mask from permutation(fold_in(key, 1), E), equal
    jax.random's at JAX's path key, bit for bit."""
    port = copy.deepcopy(y26["base"])
    tx = ts.make_optimizer(0.0, port)
    state = ts.make_train_state(port, tx)
    state.step = 4
    ts.make_train_step(port, tx, hyp=HYP, accumulate=2)(state, _tb(y26["batches"][1]))
    for m in _port_blocks(port):
        key = jmix._path_key(4, m.jax_path)
        noise = np.asarray(jax.random.normal(key, (2, m.num_experts)) * m.noise_std)
        drop = np.asarray(jax.random.permutation(jax.random.fold_in(key, 1), m.num_experts))[:max(1, int(
            m.num_experts * m.expert_dropout_rate))]
        host = m._draws[1].numpy()
        np.testing.assert_array_equal(host[:2], noise, err_msg=m.jax_path)
        np.testing.assert_array_equal(host[2], np.isin(np.arange(m.num_experts), drop, invert=True).astype(np.float32))
        np.testing.assert_array_equal(m.dropped_experts(), drop)
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(key)), tmix.path_key(m.jax_path, 4))
        assert jr.fold_in(tmix.path_key(m.jax_path, 4), 1).tolist() == np.asarray(
            jax.random.key_data(jax.random.fold_in(key, 1))).tolist()


def _run_port(base, pol, batches, dtype):
    """The port's five steps from ``base``'s weights in ``dtype`` (float64: the
    own-rounding reference, through the same train step)."""
    port = copy.deepcopy(base).to(dtype)
    ptx = pol.build_optimizer(port)
    state = ts.make_train_state(port, ptx)
    allowed = ts.COMPUTE_DTYPES
    ts.COMPUTE_DTYPES = allowed + (torch.float64,)
    try:
        step = ts.make_train_step(port, ptx, hyp=HYP, accumulate=pol.accumulate, compute_dtype=dtype)
    finally:
        ts.COMPUTE_DTYPES = allowed
    losses = []
    for b in batches:
        state, met = step(state, {k: v.to(dtype) if v.is_floating_point() else v for k, v in _tb(b).items()})
        losses.append({k: float(met[k]) for k in METRICS})
    return port, state, losses


@pytest.fixture(scope="module")
def five(y26):
    """Five steps of both packages (SGD inside the trainer's warmup, batches of
    4, no accumulation: tests/test_torch_train_step.py and
    _moe_train_steps.py hold accumulation to JAX's; JAX's step over two
    micro-batches compiles in 2-3 minutes here), one compiled JAX step; the
    port's also in float64."""
    pol = ts.TrainPolicy(nc=80, epochs=10, nb=100, batch=4, nbs=4, optimizer="SGD")
    assert pol.accumulate == 1
    lr, bias_lr, momentum = _jax_schedules(pol)
    params = y26["params"]
    tx = jts.build_optimizer(pol.opt_name, lr, params, momentum=pol.opt_momentum,
                             weight_decay=pol.scaled_weight_decay, momentum_fn=momentum, bias_lr_fn=bias_lr)
    jstate = jts.TrainState(params, tx.init(params), jax.tree_util.tree_map(jnp.copy, params),
                            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32), jax_init_aux_ema())
    jstep = jts.make_train_step(y26["jm"], tx=tx, hyp=HYP, accumulate=1)
    jlosses_ = []
    for b in y26["batches"]:
        jstate, jmet = jstep(jstate, _jb(b))
        jlosses_.append({k: float(jmet[k]) for k in METRICS})
    port, state, losses = _run_port(y26["base"], pol, y26["batches"], torch.float32)
    port64, state64, losses64 = _run_port(y26["base"], pol, y26["batches"], torch.float64)
    own = {k: (v.double() - port64.state_dict()[k]).abs().max().item()
           for k, v in port.state_dict().items() if v.is_floating_point()}
    own_ema = {k: (v.double() - state64.ema_params[k]).abs().max().item() for k, v in state.ema_params.items()}
    return dict(port=port, state=state, jstate=jstate, losses=losses, jlosses=jlosses_, losses64=losses64, own=own,
                own_ema=own_ema,
                start=state_dict_from_jax(_np(params)))


def test_five_steps_match_jax_make_train_step(five):
    """Steps 0-4 (k anneals, step 4 drops experts), batches of 4: the losses
    within 1e-5 relative at every step, or 8x the port's own distance from its
    float64 run where that is larger (the tensors' rule; at step 3 the total
    lies 1.05e-5 relative from JAX's, measured); the parameters (the one2one
    branches included), BN statistics and EMA after five steps within the
    module's gate; aux_ema within 1e-6 relative; the counters equal."""
    for i, (ref, out, o64) in enumerate(zip(five["jlosses"], five["losses"], five["losses64"])):
        for k in METRICS:
            assert abs(out[k] - ref[k]) <= max(1e-5 * abs(ref[k]) + 1e-9, 8 * abs(out[k] - o64[k])), (
                i, k, out[k], ref[k], o64[k])
    _held(five["port"].state_dict(), five["jstate"].params, five["start"], five["own"], "params")
    _held(five["state"].ema_params, five["jstate"].ema_params, five["start"], five["own_ema"], "ema")
    np.testing.assert_allclose(five["state"].aux_ema.numpy(), np.asarray(five["jstate"].aux_ema), rtol=1e-6)
    assert five["state"].step == int(five["jstate"].step) == K


# -- bf16 ----------------------------------------------------------------------------------------------

def test_bf16_step_with_jax_bf16_picks_follows_jax(y26):
    """One bf16 step at step 4 on BF16_BATCHES batches of 4, the port's routing
    pinned to JAX bf16's picks: the gradient tree's rel-RMS from JAX fp32
    (squared distances summed over the batches) within 1.5x JAX bf16's own;
    the loss terms' RMS distance from JAX fp32 within max(1.5x JAX bf16's,
    2^-8 of their RMS). Per batch the loss terms of either bf16 program lie
    0.01-1.4 (box) and 0.01-0.66 (cls) from JAX fp32's; over 6 batches the
    port's cls term measured 1.8x JAX bf16's, over 8 (these) 1.15x and over 12
    1.2x (box 1.15x): the statistic needs the batches, as PERF.md §7 says."""
    loss16 = _jax_value_and_grad(y26["jm"], jnp.bfloat16)
    sums, terms = np.zeros(3), []
    names = None
    for seed in range(70, 70 + BF16_BATCHES):
        batch = _batch(seed, 4)
        run = {}
        for key, fn in (("jax32", y26["loss32"]), ("jax16", loss16)):
            (_, (metrics, masks, _)), grads = fn(y26["params"], _jb(batch), jnp.int32(BF16_STEP))
            run[key] = ({k: float(metrics[k]) for k in METRICS}, state_dict_from_jax(_np(grads)),
                        [np.asarray(m) for m in masks])
        tmix.process_logits, plain = _routing(masks=run["jax16"][2]), tmix.process_logits
        try:
            grads, metrics = _port_step_grads(copy.deepcopy(y26["base"]), batch, BF16_STEP, BF16)
        finally:
            tmix.process_logits = plain
        run["port"] = ({k: float(metrics[k]) for k in METRICS}, grads)
        names = names or sorted(grads)
        gp, g16, g32 = (torch.cat([g[n].float().flatten() for n in names]).numpy()
                        for g in (run["port"][1], run["jax16"][1], run["jax32"][1]))
        assert np.isfinite(gp).all() and all(g.dtype == torch.float32 for g in grads.values())
        sums += [np.sum((gp - g32) ** 2), np.sum((g16 - g32) ** 2), np.sum(g32 ** 2)]
        terms.append(run)
    port, own = np.sqrt(sums[0] / sums[2]), np.sqrt(sums[1] / sums[2])
    assert 0 < own < 2 and port <= STAT * own, (port, own)
    for k in METRICS:
        d = np.array([(r["port"][0][k] - r["jax32"][0][k], r["jax16"][0][k] - r["jax32"][0][k], r["jax32"][0][k])
                      for r in terms])
        port_d, own_d, ref = np.sqrt(np.mean(d ** 2, 0))
        assert port_d <= max(STAT * own_d, 2.0 ** -8 * ref), (k, port_d, own_d, ref)


# -- the loop ------------------------------------------------------------------------------------------

RUN = dict(epochs=1, batch=4, nbs=8, imgsz=64, max_gt=16, amp=False, close_mosaic=0, moe_schedule="gini",
           val=True, save_period=1, workers=0, seed=0, optimizer="SGD")


@pytest.fixture(scope="module")
def start(synth_dataset):  # noqa: F811
    """The port's seeded init, BN calibrated on the first train batch, class biases of both branches at 0."""
    y = YOLO(NAME, device="cpu")
    ds = YOLODataset(synth_dataset, split="train", imgsz=64, max_gt=16)
    calibrate_bn(y.model, torch.from_numpy(next(DataLoader(ds, 8, images=np.float32).epoch())["images"]))
    with torch.no_grad():
        for branch in (*y.model.head.cv3, *y.model.head.one2one_cv3):
            branch[-1].bias.zero_()
    return {k: v.clone() for k, v in y.model.state_dict().items()}


def _yolo(start):
    return YOLO(NAME, device="cpu").load_state_dict(start)


def test_yolo26_loop_is_its_own_step(synth_dataset, start, tmp_path):  # noqa: F811
    """YOLO("yolo26-master-n").train(...) in fp32 (amp=False), one epoch of two
    optimizer steps with the Gini schedule and the EMA's val (the end2end
    validator, no NMS): its parameters and EMA, bitwise, those of the port's
    make_train_step fed the same batches at the same MoE gain from the same
    weights; finite losses and val metrics; last.npz reloads and predicts."""
    y = _yolo(start)
    trainer = DetectionTrainer(y, data=synth_dataset, save_dir=str(tmp_path / "run"), **RUN)
    fed, inner = [], trainer.step_fn

    def recording(state, batch, gain=None):
        fed.append(({k: v.clone() for k, v in batch.items()}, gain))
        return inner(state, batch, gain)

    trainer.step_fn = recording
    vals = []
    validator = trainer.validator
    trainer.validator = lambda **kw: vals.append(validator(**kw)) or vals[-1]
    trainer.train()
    assert trainer.state.step == 2 and len(fed) == 2 and trainer.compute_dtype == torch.float32
    assert len(vals) == 1 and all(np.isfinite(vals[0][k]) for k in VAL_METRICS)
    model = _yolo(start).model
    tx = trainer.policy.build_optimizer(model)
    state = ts.make_train_state(model, tx)
    step = ts.make_train_step(model, tx, hyp=trainer.hyp, accumulate=trainer.accumulate)
    for batch, gain in fed:
        state, met = step(state, batch, gain)
        assert float(met["finite"]) == 1.0 and np.isfinite(float(met["loss"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, trainer.last_weights[k]), k
    for k, v in state.ema_params.items():
        assert torch.equal(v, trainer.state.ema_params[k]), k
    sd, meta = load_weights_npz(tmp_path / "run" / "last.npz")
    assert meta["model"] == NAME and set(sd) >= {k for k in start if "one2one_cv2" in k}
    res = YOLO(str(tmp_path / "run" / "last.npz"), device="cpu").fuse().predict(
        [np.zeros((64, 64, 3), np.uint8)], imgsz=64, conf=0.0, max_det=30)
    assert res[0].boxes.data.shape == (30, 6)


def test_yolo26_amp_run_resumes_bitwise(synth_dataset, start, tmp_path):  # noqa: F811
    """``amp`` at its default (bf16), 2 epochs saved every epoch, interrupted in
    epoch 2 and resumed from epoch 1: the parameters (the one2one branches
    included), EMA, optimizer buffers, counters and aux_ema bitwise those of
    the uninterrupted run (the routed blocks draw anew at the resumed steps);
    fp32 weights in last.npz."""
    kw = dict(epochs=2, batch=4, nbs=8, imgsz=64, max_gt=16, save_period=1, val=False, close_mosaic=0,
              moe_schedule=None, workers=0, seed=0)
    full = DetectionTrainer(_yolo(start), data=synth_dataset, save_dir=str(tmp_path / "full"), **kw)
    assert full.compute_dtype == torch.bfloat16
    full.train()
    part = DetectionTrainer(_yolo(start), data=synth_dataset, save_dir=str(tmp_path / "part"), **kw)
    fire = part.callbacks.fire

    def crash(event, *a):
        fire(event, *a)
        if event == "on_fit_epoch_end" and a[0] == 1:
            raise KeyboardInterrupt("interrupted in epoch 2")

    part.callbacks.fire = crash
    with pytest.raises(KeyboardInterrupt):
        part.train()
    resumed = DetectionTrainer(_yolo(start), data=synth_dataset, save_dir=str(tmp_path / "part"), resume=True, **kw)
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    resumed.train()
    assert resumed.state.step == full.state.step == 4
    assert torch.equal(resumed.state.aux_ema, full.state.aux_ema)
    _assert_bitwise(_full_state(resumed), _full_state(full))
    sd, _ = load_weights_npz(tmp_path / "full" / "last.npz")
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())


def test_yolo26_multitrainer_runs_and_restores_the_base(synth_dataset, start, tmp_path):  # noqa: F811
    """YOLO("yolo26-master-n").train(data=[a, b]) with the loop's settings: two
    runs from the base weights, finite val metrics (the end2end validator),
    and the facade's model the base again, bitwise."""
    y = _yolo(start)
    res = y.train(data=[synth_dataset, _other_set(tmp_path / "other")], save_dir=str(tmp_path / "multi"), **RUN)
    assert list(res) == ["data", "other"]
    assert all(np.isfinite(res[n][k]) for n in res for k in VAL_METRICS)
    assert not y.model.training
    for k, v in y.model.state_dict().items():
        assert torch.equal(v, start[k]), k
