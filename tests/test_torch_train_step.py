"""The port's train step (yolo_master_tpu_torch/engine/train_step.py) against the
JAX package's build_optimizer + make_train_step, on the CPU in fp32.

Two small graphs (Conv, Conv, then Conv or ES_MOE, then Detect; nc 4; the
graphs of tests/test_train_trajectory_parity.py) at 64 px take five steps in
each package from the same weights (BatchNorm calibrated in the port and
carried to the JAX tree) on the same seeded batches. The schedules are the
trainer's: inside the warmup, where every group's lr and the momentum move.

Tolerances. Losses: 1e-5 relative at every step. Parameters, BatchNorm
statistics and the EMA after five steps: within 1e-6 + 2e-5 x the largest
move of the tensor over the five steps (measured: at most 3e-6 on moves of
0.5; the two programs round fp32 differently, and a five-step trajectory
carries that rounding along; a wrong rule, such as Adam's decoupled decay,
a clip epsilon, a second BN update or the bias lr on the wrong group, moves
a tensor by a large share of its move). aux_ema within 1e-6 relative.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine import train_step as jts
from yolo_master_tpu.nn.mixture_loss import init_aux_ema as jax_init_aux_ema
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax, train_state_from_jax

from test_train_trajectory_parity import CFG_MOE, CFG_PLAIN, _batches  # noqa: E402 (tests/ is on the path)

K = 5
METRICS = ("loss", "box_loss", "cls_loss", "dfl_loss", "aux_loss")
CASES = {  # graph, optimizer, accumulate
    "sgd_warmup": (CFG_MOE, "SGD", 1),
    "auto_adamw": (CFG_PLAIN, "auto", 1),
    "sgd_accumulate2": (CFG_MOE, "SGD", 2),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_schedules(pol: ts.TrainPolicy):
    """yolo_master_tpu/engine/trainer.py's lr, bias-lr and momentum schedules, in jnp."""
    w, lr0 = pol.warmup_steps, pol.opt_lr0

    def decay_frac(s):
        frac = jnp.clip(s / max(pol.nb_opt * max(pol.epochs, 1), 1), 0.0, 1.0)
        return (1.0 - frac) * (1.0 - pol.lrf) + pol.lrf

    def lr(s):
        return jnp.where(s < w, lr0 * jnp.minimum(s / jnp.maximum(w, 1), 1.0), lr0 * decay_frac(s))

    def bias_lr(s):
        t = jnp.clip(s / jnp.maximum(w, 1), 0.0, 1.0)
        return jnp.where(s < w, pol.warmup_bias_lr + t * (lr0 - pol.warmup_bias_lr), lr0 * decay_frac(s))

    def momentum(s):
        t = jnp.clip(s / jnp.maximum(w, 1), 0.0, 1.0)
        return pol.warmup_momentum + t * (pol.opt_momentum - pol.warmup_momentum)

    return lr, bias_lr, momentum


def _setup(case: str):
    """(port model, its policy, JAX model, JAX params of the same weights, batches)."""
    cfg, opt, acc = CASES[case]
    batches = _batches(4, steps=K)
    if acc > 1:  # two micro-batches of B=2 per step
        more = _batches(4, steps=K, seed=1)
        batches = [{k: np.concatenate([a[k], b[k]]) for k in a} for a, b in zip(batches, more)]
    port = DetectionModel(cfg)
    calibrate_bn(port, torch.from_numpy(batches[0]["images"]))
    jm = JaxDetectionModel(cfg)
    params = import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), port.state_dict(), strict=True)
    pol = ts.TrainPolicy(nc=4, epochs=10, nb=50 * acc, batch=2, nbs=2 * acc, optimizer=opt)
    assert pol.accumulate == acc
    return port, pol, jm, params, batches


def _jax_step(pol, jm, params):
    lr, bias_lr, momentum = _jax_schedules(pol)
    tx = jts.build_optimizer(pol.opt_name, lr, params, momentum=pol.opt_momentum,
                             weight_decay=pol.scaled_weight_decay,
                             momentum_fn=momentum if pol.opt_name == "SGD" else None, bias_lr_fn=bias_lr)
    state = jts.TrainState(params, tx.init(params), jax.tree_util.tree_map(jnp.copy, params),
                           jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32), jax_init_aux_ema())
    return tx, state, jts.make_train_step(jm, tx=tx, accumulate=pol.accumulate)


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def runs():
    """Each case: both packages' five steps (losses per step, states after),
    with the compiled JAX step kept for the tests that go on from there."""
    out = {}
    for case in CASES:
        port, pol, jm, params, batches = _setup(case)
        tx, jstate, jstep = _jax_step(pol, jm, params)
        ptx = pol.build_optimizer(port)
        state = ts.make_train_state(port, ptx)
        step = ts.make_train_step(port, ptx, accumulate=pol.accumulate)
        losses = []
        for i, b in enumerate(batches):
            jstate, jmet = jstep(jstate, _jb(b))
            state, pmet = step(state, _tb(b))
            losses.append(({k: float(jmet[k]) for k in METRICS}, {k: float(pmet[k]) for k in METRICS}))
            if i == 1:
                jstate2 = _np(jstate)
        out[case] = dict(port=port, pol=pol, params=params, batches=batches, jstep=jstep, jstate=jstate,
                         state=state, step=step, losses=losses, jstate2=jstate2)
    return out


def _held(port_sd, jax_tree, start_sd, what):
    """Every floating tensor within 1e-6 + 2e-5 x its largest move over the run."""
    ref = state_dict_from_jax(_np(jax_tree))
    for k, v in port_sd.items():
        if not v.is_floating_point():
            continue
        move = (ref[k] - start_sd[k]).abs().max().item()
        err = (v - ref[k]).abs().max().item()
        assert err <= 1e-6 + 2e-5 * move, (what, k, err, move)


@pytest.mark.parametrize("case", list(CASES))
def test_five_steps_match_jax(runs, case):
    """Losses per step within 1e-5 relative; parameters, BN statistics and the
    EMA after five steps within the module's tolerance; aux_ema within 1e-6
    relative; ema_updates 5 in both."""
    r = runs[case]
    for i, (ref, out) in enumerate(r["losses"]):
        for k in METRICS:
            assert abs(out[k] - ref[k]) <= 1e-5 * abs(ref[k]) + 1e-9, (i, k, out[k], ref[k])
    start = state_dict_from_jax(_np(r["params"]))
    _held(r["port"].state_dict(), r["jstate"].params, start, "params")
    _held(r["state"].ema_params, r["jstate"].ema_params, start, "ema")
    np.testing.assert_allclose(r["state"].aux_ema.numpy(), np.asarray(r["jstate"].aux_ema), rtol=1e-6)
    assert r["state"].ema_updates == float(r["jstate"].ema_updates) == K and r["state"].step == K
    assert r["state"].opt_state.count == K
    moved = [k for k, v in r["port"].state_dict().items() if k.endswith("running_mean") and not torch.equal(v, start[k])]
    assert moved  # the BN statistics took their updates
    if case == "sgd_warmup":
        assert r["losses"][0][1]["aux_loss"] > 0  # the ES_MOE block's balance aux reached the loss


def test_accumulation_gives_one_bn_update_from_the_last_micro_batch(runs):
    """accumulate=2: after a step each running mean is (1-m) x the step's start
    + m x the LAST micro-batch's batch mean, as in JAX (not two chained updates)."""
    r = runs["sgd_accumulate2"]
    port = r["port"]
    step, state = r["step"], r["state"]
    bn = port.model[0].bn
    before = bn.running_mean.clone()
    b = r["batches"][0]
    captured = []
    hook = port.model[0].conv.register_forward_hook(lambda m, i, o: captured.append(o.detach().mean((0, 2, 3))))
    step(state, _tb(b))
    hook.remove()
    assert len(captured) == 2
    m = bn.momentum
    torch.testing.assert_close(bn.running_mean, (1 - m) * before + m * captured[1], rtol=1e-6, atol=1e-7)
    assert not torch.allclose(bn.running_mean, (1 - m) * ((1 - m) * before + m * captured[0]) + m * captured[1])


def test_nan_batch_checks_every_point_of_the_finite_guard(runs):
    """A batch with a NaN box (a finite forward, a NaN loss), after five steps, in both packages: parameters,
    BN statistics and the optimizer (buffers and count) stay as they were;
    step counts on; ema_updates does not; the EMA is still blended at the
    unchanged decay; aux_ema takes its new value; the metrics say not finite.
    The port's state then equals JAX's as after the five steps."""
    r = runs["sgd_warmup"]
    port, state = r["port"], r["state"]
    b = {k: v.copy() for k, v in r["batches"][0].items()}
    b["boxes"][0, 0, 2] = np.nan
    before = {k: v.clone() for k, v in port.state_dict().items()}
    bufs = {n: t.clone() for n, t in state.opt_state.buffers["trace"].items()}
    ema_before = {k: v.clone() for k, v in state.ema_params.items()}
    aux_before = state.aux_ema.clone()
    jstate, jmet = r["jstep"](r["jstate"], _jb(b))
    state, met = r["step"](state, _tb(b))
    assert float(met["finite"]) == float(jmet["finite"]) == 0.0
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(torch.equal(t, bufs[n]) for n, t in state.opt_state.buffers["trace"].items())
    assert state.opt_state.count == K and state.step == K + 1 and state.ema_updates == K
    assert int(jstate.step) == K + 1 and float(jstate.ema_updates) == K
    d = ts.ema_decay(K)
    for k, v in state.ema_params.items():
        torch.testing.assert_close(v, d * ema_before[k] + (1 - d) * before[k], rtol=1e-6, atol=1e-7)
    assert not torch.equal(state.aux_ema, aux_before)
    np.testing.assert_allclose(state.aux_ema.numpy(), np.asarray(jstate.aux_ema), rtol=1e-6)
    start = state_dict_from_jax(_np(r["params"]))
    _held(port.state_dict(), jstate.params, start, "params")
    _held(state.ema_params, jstate.ema_params, start, "ema")
    counts = [int(np.asarray(c)) for c in jax.tree_util.tree_leaves(jstate.opt_state) if np.asarray(c).dtype == np.int32]
    assert set(counts) == {K}  # JAX's optimizer counts were restored too
    r["jstate"], r["state"] = jstate, state


def test_train_state_from_jax_continues_in_step(runs):
    """The port starts from JAX's state after two steps (params, EMA, counters,
    aux_ema, SGD traces and count) and both take the last three steps: in step
    with the first run's JAX state after five."""
    r = runs["sgd_warmup"]
    port = DetectionModel(CFG_MOE)
    ptx = r["pol"].build_optimizer(port)
    state = train_state_from_jax(r["jstate2"], port, ptx)
    assert state.step == 2 and state.opt_state.count == 2 and state.ema_updates == 2.0
    step = ts.make_train_step(port, ptx)
    jstate = jax.tree_util.tree_map(jnp.asarray, r["jstate2"])
    for b in r["batches"][2:]:
        jstate, jmet = r["jstep"](jstate, _jb(b))
        state, pmet = step(state, _tb(b))
        for k in METRICS:
            assert abs(float(pmet[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])) + 1e-9, k
    start = state_dict_from_jax(_np(r["params"]))
    _held(port.state_dict(), jstate.params, start, "params")
    _held(state.ema_params, jstate.ema_params, start, "ema")
    np.testing.assert_allclose(state.aux_ema.numpy(), np.asarray(jstate.aux_ema), rtol=1e-6)


def test_policy_schedules_match_the_jax_trainer():
    """TrainPolicy against trainer.py's formulas: accumulate, warmup length,
    'auto' resolution, decay scaling, and the four schedules over the warmup
    and the decay (linear and cosine), within 1e-6 relative or 1e-8 (JAX
    evaluates them in fp32: the bias lr's 0.1 - t * (0.1 - lr0) near the end
    of the warmup cancels to a few fp32 ulps of 0.1, 7.5e-9 each); at step 0
    the lr is 0 and the bias lr is warmup_bias_lr."""
    for kw, acc, warm, name, lr0 in (
            (dict(nc=80, epochs=3, nb=400, batch=16), 4, 300, "AdamW", round(0.002 * 5 / 84, 6)),
            (dict(nc=4, epochs=300, nb=2000, batch=16, optimizer="auto"), 4, 1500, "SGD", 0.01),
            (dict(nc=4, epochs=10, nb=8, batch=64, optimizer="SGD", cos_lr=True), 1, 100, "SGD", 0.01),
            (dict(nc=4, epochs=10, nb=3, batch=8, optimizer="RMSProp", warmup_epochs=0), 3, 0, "RMSProp", 0.01)):
        pol = ts.TrainPolicy(**kw)
        assert (pol.accumulate, pol.warmup_steps, pol.opt_name, pol.opt_lr0) == (acc, warm, name, lr0)
        assert pol.scaled_weight_decay == pytest.approx(5e-4 * kw["batch"] * acc / 64)
        lr, bias_lr, momentum = _jax_schedules(pol)
        if pol.cos_lr:
            def lr(s, pol=pol):  # trainer.py's one-cycle decay
                frac = jnp.clip(s / max(pol.nb_opt * pol.epochs, 1), 0.0, 1.0)
                dec = pol.lrf + (1.0 - pol.lrf) * (1.0 + jnp.cos(jnp.pi * frac)) / 2.0
                return jnp.where(s < pol.warmup_steps, pol.opt_lr0 * s / pol.warmup_steps, pol.opt_lr0 * dec)
        for s in (0, 1, 7, warm // 2, max(warm - 1, 0), warm, warm + 3, pol.nb_opt * pol.epochs + 5):
            assert pol.lr_schedule(s) == pytest.approx(float(lr(jnp.int32(s))), rel=1e-6, abs=1e-8)
            assert pol.momentum_schedule(s) == pytest.approx(float(momentum(jnp.int32(s))), rel=1e-6, abs=1e-8)
            if not pol.cos_lr:
                assert pol.bias_lr_schedule(s) == pytest.approx(float(bias_lr(jnp.int32(s))), rel=1e-6, abs=1e-8)
        if warm:
            assert pol.lr_schedule(0) == 0.0 and pol.bias_lr_schedule(0) == pol.warmup_bias_lr
    tx = ts.TrainPolicy(nc=4, epochs=10, nb=50, batch=2, nbs=2).build_optimizer(DetectionModel(CFG_MOE))
    assert tx.group_lr("decay", 0) == tx.group_lr("router", 0) == 0.0 and tx.group_lr("bias", 0) == 0.1
    assert tx.group_lr("router", 50) == pytest.approx(0.5 * tx.group_lr("decay", 50))
    assert tx.group_lr("router", 50) > 0


def test_param_group_labels_match_jax_for_yolo_master_n():
    """Every parameter of yolo-master-n gets the group JAX's param_group_labels
    gives its counterpart (router, decay, bias, other), and JAX's
    weight_decay_mask likewise; the four groups are all there."""
    port = DetectionModel("yolo-master-n")
    shapes = jax.eval_shape(JaxDetectionModel("yolo-master-n").init, jax.random.PRNGKey(0))
    codes = {"router": 1.0, "decay": 2.0, "bias": 3.0, "other": 4.0}
    jlabels = jts.param_group_labels(shapes)
    coded = jax.tree_util.tree_map(lambda lab, s: np.full(s.shape, codes[lab], np.float32), jlabels, shapes)
    ref = state_dict_from_jax(coded)
    labels = ts.param_group_labels(port)
    assert set(labels.values()) == set(codes)
    for name, lab in labels.items():
        assert float(ref[name].flatten()[0]) == codes[lab], name
    jmask = jax.tree_util.tree_map(lambda m, s: np.full(s.shape, float(m), np.float32), jts.weight_decay_mask(shapes),
                                   shapes)
    ref_mask = state_dict_from_jax(jmask)
    for name, m in ts.weight_decay_mask(port).items():
        assert bool(ref_mask[name].flatten()[0]) == m, name


def test_refusals_name_their_roadmap_items():
    """A fused model, a compute dtype other than fp32 and bf16, the Muon
    optimizers and a task model's training are refused, naming what is
    missing, and a graph whose mixture blocks are not ported (yolo-master-v0_2's
    UltimateOptimizedMoE) names item 14; routed blocks of every expert type
    (ghost, inverted and spatial included) and router, yolo-master-v0_1,
    yolo26-master (its end2end loss) and the MoA, MoT and latent mixtures
    (yolo26-master-moa-mot and -latent, their aux losses) build a step, and
    both mixture graphs take one at 64 px (tests/test_torch_moe_train*.py,
    tests/test_torch_yolo26_train.py, tests/test_torch_mixture_train.py,
    tests/test_torch_latent_train.py, tests/test_torch_moa_mot_train.py)."""
    from yolo_master_tpu_torch.nn.latent_mixture import LatentMixture
    from yolo_master_tpu_torch.nn.moa import MoABlock
    from yolo_master_tpu_torch.nn.moe import OptimizedMOEImproved
    from yolo_master_tpu_torch.nn.mot import MoTBlock

    for expert in ("ghost", "inverted", "spatial"):
        ts.make_train_step(torch.nn.Sequential(OptimizedMOEImproved(32, 32, expert_type=expert)))
    ts.make_train_step(DetectionModel("yolo26-master-n"))
    for block in (MoABlock(48, 3), MoTBlock(32, 4), LatentMixture([32, 16], 32)):
        ts.make_train_step(torch.nn.Sequential(block))
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.random((2, 64, 64, 3), np.float32)),
             "boxes": torch.tensor([[[8.0, 8.0, 40.0, 40.0]]] * 2), "classes": torch.zeros(2, 1, dtype=torch.int32),
             "mask": torch.ones(2, 1, dtype=torch.bool)}
    for name, families in (("yolo26-master-latent-n", ("aux_moe", "aux_latent")),
                           ("yolo26-master-moa-mot-n", ("aux_moa", "aux_mot"))):
        model = DetectionModel(name)
        tx = ts.make_optimizer(0.01, model)
        _, met = ts.make_train_step(model, tx)(ts.make_train_state(model, tx), batch)
        assert float(met["finite"]) == 1.0 and all(float(met[f]) > 0 for f in families), (name, met)
    with pytest.raises(FileNotFoundError, match=r"§1\.F item 14"):
        DetectionModel("yolo-master-v0_2-n")
    from yolo_master_tpu_torch.nn.tasks import SegmentationModel

    with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
        ts.make_train_step(SegmentationModel("yolo-master-seg-n"))
    ts.make_train_step(DetectionModel("yolo-master-v0_1-n"))
    from yolo_master_tpu_torch.utils.fuse import fuse_bn

    fused = DetectionModel(CFG_PLAIN)
    fuse_bn(fused)
    with pytest.raises(ValueError, match="unfused"):
        ts.make_train_step(fused)
    with pytest.raises(ValueError, match="compute_dtype"):
        ts.make_train_step(DetectionModel(CFG_PLAIN), compute_dtype=torch.float16)
    for name in ("Muon", "MuSGD"):
        with pytest.raises(NotImplementedError, match=r"§1\.I item 23"):
            ts.build_optimizer(name, 0.01, DetectionModel(CFG_PLAIN))


def test_yolo_master_n_loss_and_gradients_match_jax():
    """yolo-master-n at 64 px, B=2, BN calibrated, GT boxes of 24-40 px (at the
    init the predicted boxes are ~100 px wide; smaller GTs leave the box and
    DFL terms at the 1e-5 level): the loss components within 1e-5 relative,
    and each parameter's gradient within 8x the port's own fp32-vs-fp64 error
    of that tensor or 1e-6 x the model's largest |g| (the gradients of biases
    of BNs that feed another BN are 0 up to rounding in both packages; the
    largest measured error is 6.5x the own error), against
    jax.value_and_grad (one jit: cheaper than eager here, 17 s against 90 s
    on the CPU)."""
    rng = np.random.default_rng(7)
    xy, wh = rng.uniform(0, 24, (2, 6, 2)), rng.uniform(24, 40, (2, 6, 2))
    b = {"images": rng.random((2, 64, 64, 3), np.float32),
         "boxes": np.concatenate([xy, np.minimum(xy + wh, 63)], -1).astype(np.float32),
         "classes": rng.integers(0, 80, (2, 6)).astype(np.int32), "mask": rng.random((2, 6)) < 0.8}
    port = DetectionModel("yolo-master-n")
    calibrate_bn(port, torch.from_numpy(b["images"]))
    jm = JaxDetectionModel("yolo-master-n")
    params = import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), port.state_dict(), strict=True)
    hyp = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "moe": 0.01}

    def jloss(p, batch):
        ctx = Context(training=True)
        preds = jm.forward_train(p, batch["images"], ctx)
        return jm.compute_loss(preds, batch, ctx.total_aux(), hyp)

    (_, jmet), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params, _jb(b))

    def port_grads(model, dtype):
        model.train()
        preds, aux = model.forward_train(torch.from_numpy(b["images"]).to(dtype))
        assert len(aux) == 4 and all(rec.family == "moe" for rec in aux.values())  # the four ES_MOE blocks
        total, met = model.compute_loss(preds, _tb(b), sum(rec.value for rec in aux.values()), hyp)
        total.backward()
        return met, {n: p.grad.float() for n, p in model.named_parameters()}

    own64 = port_grads(copy.deepcopy(port).double(), torch.float64)[1]
    met, grads = port_grads(port, torch.float32)
    for k in METRICS:
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    ref = state_dict_from_jax(_np(jgrad))
    gmax = max(g.abs().max().item() for g in ref.values())
    for name, g in grads.items():
        own = (g - own64[name]).abs().max().item()
        assert (g - ref[name]).abs().max().item() <= max(8 * own, 1e-6 * gmax), name
