"""The port's bf16 training (engine/train_step.py with compute_dtype=torch.bfloat16,
the trainer's default) against the JAX package's bf16 training, on the CPU.

The JAX package trains in bf16 with fp32 parameters and per-op casts
(``make_train_step(compute_dtype=jnp.bfloat16)``: the images cast to bf16, each
conv's weight cast to the activation's dtype, BatchNorm and the loss in fp32);
the port casts the same way (``nn/layers.py:Conv2d``, BatchNorm2d). Inputs and
weights come from numpy seeds. Tolerances:

1. each module in training: the forward element by element, within
   4 * 2^-8 * max |JAX| of the tensor (tests/test_torch_bf16.py's module gate: four bf16
   roundings of the largest value); the gradients with respect to the input
   and to each parameter by error statistics, rel-RMS(port bf16 - JAX fp32)
   within 1.5 x rel-RMS(JAX bf16 - JAX fp32) on the same bf16 input: a
   gradient carries the roundings of the whole backward chain (a weight's
   also sums a whole map of bf16 products), and JAX's own bf16 gradients lie
   further from fp32 than the module gate on most tensors of C3k2, A2C2f and
   Detect, and on the input gradients of C3k2 and A2C2f (the BN biases that feed another BN have a gradient of 0 up to
   rounding, and JAX's bf16 ES_MOE router gradient is 39 bf16 roundings from
   fp32), while the port's lie 0.75-1.21x as far as JAX's (measured); the
   BatchNorm running statistics on each BatchNorm's own input within 1e-5
   relative of JAX's BatchNorm, and the batch statistics they took within the
   module gate;
2. the loss on shared inputs: JAX's bf16 head outputs into both packages' v8
   loss (fp32): every term within 1e-5 relative, the TAL foreground mask equal;
3. the whole model (yolo-master-n at 64 px, batch 8, calibrated BN), one
   step, and five steps of a small graph: by error statistics, as the bf16
   inference path (tests/test_torch_bf16.py): on calibrated random weights
   two bf16 programs land percents apart and no element-wise gate can hold,
   so the port's distance from JAX's fp32 is held within 1.5 x JAX's own bf16
   distance from it. Gradients by rel-RMS over the tree (and over the
   backbone and the head apart), loss terms by |port16 - jax32| <=
   max(1.5 x |jax16 - jax32|, 2^-8 |jax32|), parameters and BN statistics
   after five steps by their distance from JAX fp32's (the distances share
   the RMS of JAX fp32's move, which cancels).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine import train_step as jts
from yolo_master_tpu.nn import heads as jheads
from yolo_master_tpu.nn import layers as jlayers
from yolo_master_tpu.nn.losses import detection_loss as jax_detection_loss
from yolo_master_tpu.nn.mixture_loss import compose_aux as jax_compose_aux
from yolo_master_tpu.nn.mixture_loss import init_aux_ema as jax_init_aux_ema
from yolo_master_tpu.nn.module import Context, apply_updates
from yolo_master_tpu.nn.moe import ES_MOE as JaxESMOE
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.nn import heads as theads
from yolo_master_tpu_torch.nn import layers as tlayers
from yolo_master_tpu_torch.nn.assigner import task_aligned_assign
from yolo_master_tpu_torch.nn.moe import ES_MOE
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.ops.anchors import dfl_decode, dist2bbox, make_anchors
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax, train_state_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_model import _load_module, _np_tree, _perturb_bn  # noqa: E402
from test_torch_bf16 import _bf16, _rel_rms  # noqa: E402
from test_torch_train_step import CASES, METRICS, _jax_schedules, _jb, _setup, _tb  # noqa: E402

BF16 = torch.bfloat16
MODULE_TOL = 4 * 2.0 ** -8  # of max |JAX|
HYP = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "moe": 0.01}
STAT = 1.5  # the port's distance from JAX fp32 within 1.5x JAX bf16's own
WHOLE_BATCHES = 4  # batches of 8 in the whole-model statistic


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _f32(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a, jnp.float32))


# -- 1. each module in training -------------------------------------------------------------------

def _module_cases():
    def detect():
        ch = (16, 32, 64)
        j = jheads.Detect(nc=80, reg_max=16, ch=ch)
        j.set_strides((8, 16, 32))
        t = theads.Detect(nc=80, reg_max=16, ch=ch)
        t.set_strides((8, 16, 32))
        return j, t, [(2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 64)]

    return {
        "Conv_BN": lambda: (jlayers.Conv(16, 32, 3, 2), tlayers.Conv(16, 32, 3, 2), [(2, 16, 16, 16)]),
        "C3k2": lambda: (jlayers.C3k2(32, 64, n=1, c3k=True, e=0.5), tlayers.C3k2(32, 64, n=1, c3k=True, e=0.5),
                         [(2, 8, 12, 32)]),
        "A2C2f_residual": lambda: (jlayers.A2C2f(64, 64, n=1, a2=True, area=4, residual=True, mlp_ratio=1.2),
                                   tlayers.A2C2f(64, 64, n=1, a2=True, area=4, residual=True, mlp_ratio=1.2),
                                   [(2, 8, 8, 64)]),
        "ES_MOE": lambda: (JaxESMOE(32, 32), ES_MOE(32, 32), [(2, 10, 10, 32)]),
        "Detect": detect,
    }


@pytest.mark.parametrize("name", list(_module_cases()))
def test_module_trains_like_jax_in_bf16(name):
    """A train-mode module of the bf16 training path, fp32 parameters and bf16
    input, against the JAX module under jax.value_and_grad on the same input,
    weights and cotangent: the forward (bf16) within 4 * 2^-8 * max |JAX|; the
    input's gradient (bf16) and each parameter's (fp32) within 1.5x JAX
    bf16's rel-RMS from JAX fp32 (module docstring); the BatchNorm running
    statistics (ES_MOE: its balance loss too) within 1e-5 relative."""
    rng = np.random.default_rng(21)
    jm, tm, shapes = _module_cases()[name]()
    jm = jm.finalize("")
    p = _perturb_bn(_np_tree(jax.jit(jm.init)(jax.random.PRNGKey(3))), rng)
    if "gamma" in p:
        p["gamma"] = rng.uniform(0.5, 1.5, p["gamma"].shape).astype(np.float32)
    tm = _load_module(tm, p).train()
    xs = [_bf16(rng.standard_normal(s).astype(np.float32)) for s in shapes]

    def outputs(y):  # the module's output as [B, ..., C]: Detect's training dict's two branches concatenated
        if isinstance(y, dict):
            b = y["one2many"]
            return jnp.concatenate([b["boxes"], b["scores"]], -1) if not isinstance(b["boxes"], torch.Tensor) \
                else torch.cat([b["boxes"], b["scores"]], -1)
        return y

    def jloss(params, x, ct, dtype):
        ctx = Context(training=True, compute_dtype=dtype)
        x = [a.astype(dtype) for a in x]
        y = outputs(jm(params, x if name == "Detect" else x[0], ctx))
        return jnp.sum(y.astype(jnp.float32) * ct), (y, ctx.updates, ctx.total_aux())

    jx = [x for x, _ in xs]
    y0 = jax.eval_shape(lambda params, x: outputs(jm(params, x if name == "Detect" else x[0],
                                                     Context(training=True))), p, jx)
    ct = rng.standard_normal(y0.shape).astype(np.float32)
    grad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True), static_argnums=3)
    (_, (jy, updates, jaux)), (gp, gx) = grad(p, jx, ct, jnp.bfloat16)
    _, (gp32, gx32) = grad(p, jx, ct, jnp.float32)  # the same bf16 input, widened

    tx = [t.detach().clone().contiguous(memory_format=torch.channels_last).requires_grad_() for _, t in xs]
    bns = {n: m for n, m in tm.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    before = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in bns.items()}
    seen = {}
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: seen.__setitem__(n, i[0].detach())) for n, m in bns.items()]
    ty = tm(tx) if name == "Detect" else tm(tx[0])
    for h in hooks:
        h.remove()
    ty = outputs(ty)
    if name != "Detect":
        ty = ty.permute(0, 2, 3, 1)
    (ty.float() * torch.from_numpy(ct)).sum().backward()

    def close(a, ref, what):
        a, ref = _f32(a), _f32(ref)
        assert a.shape == ref.shape and np.isfinite(a).all(), what
        assert np.abs(a - ref).max() <= MODULE_TOL * np.abs(ref).max(), (what, np.abs(a - ref).max(),
                                                                          np.abs(ref).max())

    assert ty.dtype == BF16 and jy.dtype == jnp.bfloat16
    close(ty, jy, "forward")
    for jgx, jgx32, t in zip(gx, gx32, tx):
        assert t.grad.dtype == BF16
        got, own, ref32 = _f32(t.grad.permute(0, 2, 3, 1)), _f32(jgx), _f32(jgx32)
        assert np.isfinite(got).all() and _rel_rms(got, ref32) <= STAT * _rel_rms(own, ref32), \
            ("input gradient", _rel_rms(got, ref32), _rel_rms(own, ref32))
    g16, g32 = (state_dict_from_jax({"layers": {"0": _np_tree(g)}}) for g in (gp, gp32))
    for n, prm in tm.named_parameters():
        assert prm.dtype == prm.grad.dtype == torch.float32, n
        ref32, own = g32[f"model.0.{n}"].numpy(), g16[f"model.0.{n}"].numpy()
        assert np.isfinite(prm.grad.numpy()).all(), n
        assert _rel_rms(prm.grad.numpy(), ref32) <= STAT * _rel_rms(own, ref32), \
            (n, _rel_rms(prm.grad.numpy(), ref32), _rel_rms(own, ref32))
    # the running statistics: on each BatchNorm's own bf16 input, JAX's BatchNorm update within 1e-5
    # relative; end to end, the batch statistics they took (their inputs carry the module's bf16
    # rounding) within the module gate
    ref_stats = state_dict_from_jax({"layers": {"0": _np_tree(apply_updates(p, updates))}})
    assert bns and set(seen) == set(bns)
    for n, m in bns.items():
        assert seen[n].dtype == BF16, n
        jbn = jlayers.BatchNorm(m.num_features, eps=m.eps, momentum=m.momentum).finalize("bn")
        ctx = Context(training=True, compute_dtype=jnp.bfloat16)
        jbn({"scale": m.weight.detach().numpy(), "bias": m.bias.detach().numpy(), "mean": before[n][0].numpy(),
             "var": before[n][1].numpy()}, jnp.asarray(_f32(seen[n].permute(0, 2, 3, 1))).astype(jnp.bfloat16), ctx)
        for stat, key, old_v in (("mean", "running_mean", before[n][0]), ("var", "running_var", before[n][1])):
            got, ref = getattr(m, key).numpy(), np.asarray(ctx.updates["bn"][stat])
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), (n, stat)
            batch = lambda v: (v - (1 - m.momentum) * old_v.numpy()) / m.momentum  # noqa: E731
            close(batch(got), batch(ref_stats[f"model.0.{n}.{key}"].numpy()), f"{n} batch {stat}")
    if name == "ES_MOE":
        assert abs(tm.aux_record.value.item() - float(jaux)) <= 1e-5 * abs(float(jaux))


# -- 2-3. the whole model, one step ----------------------------------------------------------------

def _jax_loss_fn(jm, dtype):
    """The JAX step's loss (yolo_master_tpu/engine/train_step.py:loss_fn, the aux
    composed per family from a fresh aux_ema): (total, (metrics, head outputs))."""

    def loss(params, batch):
        ctx = Context(training=True, compute_dtype=dtype)
        preds = jm.forward_train(params, batch["images"].astype(dtype), ctx)
        aux_total, _, _ = jax_compose_aux(ctx, {"moe": HYP["moe"]}, jax_init_aux_ema(), budget=0.0, normalize=True)
        base, metrics = jm.compute_loss(preds, batch, jnp.zeros(()), {**HYP, "moe": 0.0})
        total = base + aux_total
        return total, ({**metrics, "aux_loss": aux_total, "loss": total}, preds["one2many"])

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _capture_step_grads(model, tx, batch, dtype):
    """The gradient tree one port train step hands its optimizer (by name), and the step's metrics."""
    grads, apply = {}, tx.apply

    def capture(m, opt_state):
        grads.update({n: p.grad.detach().clone() for n, p in m.named_parameters()})
        apply(m, opt_state)

    tx.apply = capture
    state = ts.make_train_state(model, tx)
    _, metrics = ts.make_train_step(model, tx, hyp=HYP, compute_dtype=dtype)(state, batch)
    del tx.apply
    return grads, metrics


def _whole_batch(seed: int, b: int = 8):
    """A batch of ``b`` at 64 px: noise images, GT boxes 16-40 px, 1-6 an image."""
    rng = np.random.default_rng(seed)
    xy, wh = rng.uniform(0, 30, (b, 6, 2)), rng.uniform(16, 40, (b, 6, 2))
    return {"images": rng.random((b, 64, 64, 3), np.float32),
            "boxes": np.concatenate([xy, np.minimum(xy + wh, 63)], -1).astype(np.float32),
            "classes": rng.integers(0, 80, (b, 6)).astype(np.int32),
            "mask": np.arange(6)[None] < rng.integers(1, 7, (b, 1))}


@pytest.fixture(scope="module")
def whole():
    """yolo-master-n at 64 px, the port's seeded init with BN calibrated on the
    first batch: for each of WHOLE_BATCHES batches of 8, one step's loss and
    gradients from the same weights in JAX fp32 and bf16 (one jit each) and
    in the port's bf16 train step, and JAX's bf16 head outputs of the first."""
    batches = [_whole_batch(seed) for seed in range(8, 8 + WHOLE_BATCHES)]
    base = DetectionModel("yolo-master-n")
    calibrate_bn(base, torch.from_numpy(batches[0]["images"]))
    jm = JaxDetectionModel("yolo-master-n")
    params = jax_params_of(jm, base)
    jax_fns = {key: _jax_loss_fn(jm, dtype) for key, dtype in (("jax32", jnp.float32), ("jax16", jnp.bfloat16))}
    runs = []
    for batch in batches:
        run = {}
        for key, fn in jax_fns.items():
            (_, (metrics, preds)), grads = fn(params, _jb(batch))
            run[key] = ({k: float(v) for k, v in metrics.items()}, state_dict_from_jax(_np_tree(grads)), preds)
        port = copy.deepcopy(base)
        pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=8, nbs=8, optimizer="SGD")
        grads, metrics = _capture_step_grads(port, pol.build_optimizer(port), _tb(batch), BF16)
        run["port16"] = ({k: float(metrics[k]) for k in METRICS}, grads)
        runs.append(run)
    return {"batches": batches, "base": base, "jm": jm, "runs": runs}


def test_whole_model_bf16_step_gradients_and_losses_follow_jax(whole):
    """One bf16 train step of yolo-master-n from the same weights on each of
    WHOLE_BATCHES batches of 8: the gradient trees' rel-RMS from JAX's fp32
    (the squared distances summed over the batches) within 1.5x JAX bf16's
    own, over every parameter and over the backbone (with the neck) and the
    head apart; each loss term's RMS distance from JAX fp32 over the batches
    within max(1.5 x JAX bf16's, 2^-8 of the term's RMS). Several batches:
    deep in the backbone a bf16 gradient is mostly rounding noise (the two
    bf16 programs' gradients are uncorrelated there, cosine -0.03 on the
    first batch, while each keeps a cosine of 0.3-0.4 with fp32), so one
    batch's statistic spreads 0.9-1.7x between correct programs (measured)."""
    head = f"model.{len(whole['base'].model) - 1}."
    names = sorted(whole["runs"][0]["port16"][1])
    for part in ("all", "backbone", "head"):
        sel = [n for n in names if part == "all" or n.startswith(head) == (part == "head")]
        sums = np.zeros(3)  # |port16 - jax32|^2, |jax16 - jax32|^2, |jax32|^2
        for run in whole["runs"]:
            gp, g16, g32 = (torch.cat([g[n].float().flatten() for n in sel]).numpy()
                            for g in (run["port16"][1], run["jax16"][1], run["jax32"][1]))
            assert np.isfinite(gp).all()
            sums += [np.sum((gp - g32) ** 2), np.sum((g16 - g32) ** 2), np.sum(g32 ** 2)]
        port, own = np.sqrt(sums[0] / sums[2]), np.sqrt(sums[1] / sums[2])
        assert 0 < own and port <= STAT * own, (part, port, own)
    assert all(g.dtype == torch.float32 for g in whole["runs"][0]["port16"][1].values())
    for k in METRICS:
        d = np.array([(run["port16"][0][k] - run["jax32"][0][k], run["jax16"][0][k] - run["jax32"][0][k],
                       run["jax32"][0][k]) for run in whole["runs"]])
        port, own, ref = np.sqrt(np.mean(d ** 2, 0))
        assert port <= max(STAT * own, 2.0 ** -8 * ref), (k, port, own, ref)


def test_loss_on_jax_bf16_head_outputs_matches_jax(whole):
    """JAX's bf16 forward_train outputs of the first batch into the port's
    compute_loss and JAX's: every loss term within 1e-5 relative; the TAL
    foreground masks of the two assigners on those outputs equal."""
    jm, port, batch = whole["jm"], whole["base"], whole["batches"][0]
    jpreds = whole["runs"][0]["jax16"][2]
    assert jpreds["boxes"].dtype == jnp.bfloat16
    hw = ((8, 8), (4, 4), (2, 2))
    jb = _jb(batch)
    _, jmet = jax.jit(lambda pr, bb: jm.compute_loss({"one2many": pr, "hw_shapes": hw}, bb, jnp.zeros(()),
                                                      HYP))(jpreds, jb)
    tpreds = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(BF16) for k, v in jpreds.items()}
    _, tmet = port.compute_loss({"one2many": tpreds, "hw_shapes": hw}, _tb(batch), torch.zeros(()), HYP)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        ref = float(jmet[k])
        assert tmet[k].dtype == torch.float32 and abs(float(tmet[k]) - ref) <= 1e-5 * abs(ref), (k, tmet[k], ref)
    strides = port.head.strides
    _, jassign = jax_detection_loss(jpreds, hw, strides, jb["boxes"], jb["classes"], jb["mask"], nc=80,
                                    return_assign=True)
    anchors, stride_t = make_anchors(hw, strides, torch.device("cpu"))
    boxes = dist2bbox(dfl_decode(tpreds["boxes"], 16), anchors[None], xywh=False)
    tb = _tb(batch)
    tassign = task_aligned_assign(torch.sigmoid(tpreds["scores"].float()), boxes.float() * stride_t[None],
                                  anchors * stride_t, tb["classes"], tb["boxes"], tb["mask"], num_classes=80,
                                  topk=10, strides=strides)
    fg = np.asarray(jassign.fg_mask)
    assert fg.sum() > 0
    np.testing.assert_array_equal(tassign.fg_mask.numpy(), fg)


# -- 4. five steps, and a JAX bf16 state carried mid-run -------------------------------------------

def _jax_bf16_setup(pol, jm, params):
    lr, bias_lr, momentum = _jax_schedules(pol)
    tx = jts.build_optimizer(pol.opt_name, lr, params, momentum=pol.opt_momentum,
                             weight_decay=pol.scaled_weight_decay,
                             momentum_fn=momentum if pol.opt_name == "SGD" else None, bias_lr_fn=bias_lr)
    state = jts.TrainState(params, tx.init(params), jax.tree_util.tree_map(jnp.copy, params),
                           jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32), jax_init_aux_ema())
    steps = {dt: jts.make_train_step(jm, tx=tx, accumulate=pol.accumulate, compute_dtype=dt)
             for dt in (jnp.float32, jnp.bfloat16)}
    return tx, state, steps


def _flat(sd, pick):
    return np.concatenate([np.asarray(v, np.float32).ravel() for k, v in sorted(sd.items()) if pick(k)])


def _is_stat(k):
    return k.endswith(("running_mean", "running_var"))


@pytest.mark.parametrize("case", ["sgd_accumulate2"])
def test_five_bf16_steps_follow_jax_by_error_statistics(case):
    """Five bf16 steps (SGD inside the warmup; and accumulate=2) of the small
    ES_MOE graph at 64 px from the same weights and batches, the port against
    JAX in fp32 and bf16: the final parameters' distance from JAX fp32's within
    1.5x JAX bf16's, and the same for the BN running statistics. Then JAX's
    bf16 TrainState after step 2, carried into the port (train_state_from_jax),
    takes step 3: its parameters within 1.5x the distance of JAX's own bf16
    step 3 from JAX's fp32 step 3 from that same state."""
    port, pol, jm, params, batches = _setup(case)
    tx, s0, steps = _jax_bf16_setup(pol, jm, params)
    jstates = {}
    for dt in (jnp.float32, jnp.bfloat16):
        st = jax.tree_util.tree_map(jnp.array, s0)  # the step donates its state
        for i, b in enumerate(batches):
            st, met = steps[dt](st, _jb(b))
            assert all(np.isfinite(float(met[k])) for k in METRICS)
            if i == 1 and dt == jnp.bfloat16:
                mid = _np_tree(st)
        jstates[dt] = _np_tree(st)
    ptx = pol.build_optimizer(port)
    state = ts.make_train_state(port, ptx)
    step = ts.make_train_step(port, ptx, accumulate=pol.accumulate, compute_dtype=BF16)
    for b in batches:
        state, met = step(state, _tb(b))
        assert float(met["finite"]) == 1.0
    port_sd = port.state_dict()
    j32, j16 = (state_dict_from_jax(jstates[dt].params) for dt in (jnp.float32, jnp.bfloat16))
    for what, pick in (("parameters", lambda k: k in dict(port.named_parameters())), ("BN statistics", _is_stat)):
        ref = _flat(j32, pick)
        own, dist = np.linalg.norm(_flat(j16, pick) - ref), np.linalg.norm(_flat(port_sd, pick) - ref)
        assert 0 < own and dist <= STAT * own, (what, dist, own)

    # the carried state: step 3 from JAX's bf16 state after step 2
    nxt = _jb(batches[2])
    after = {dt: state_dict_from_jax(_np_tree(steps[dt](jax.tree_util.tree_map(jnp.asarray, mid), nxt)[0].params))
             for dt in (jnp.float32, jnp.bfloat16)}
    carried = DetectionModel(CASES[case][0])
    ctx_ = pol.build_optimizer(carried)
    cstate = train_state_from_jax(mid, carried, ctx_)
    assert cstate.step == 2 and cstate.opt_state.count == 2
    ts.make_train_step(carried, ctx_, accumulate=pol.accumulate, compute_dtype=BF16)(cstate, _tb(batches[2]))
    for what, pick in (("parameters", lambda k: k in dict(carried.named_parameters())), ("BN statistics", _is_stat)):
        ref = _flat(after[jnp.float32], pick)
        own = np.linalg.norm(_flat(after[jnp.bfloat16], pick) - ref)
        dist = np.linalg.norm(_flat(carried.state_dict(), pick) - ref)
        assert 0 < own and dist <= STAT * own, ("carried", what, dist, own)
