"""Shared whole-model gates of yolo26-master-latent-n and yolo26-master-moa-mot-n
in training (tests/test_torch_latent_train.py, tests/test_torch_moa_mot_train.py),
at 64 px on the CPU, against the JAX package's ``make_train_step``.

JAX's ``_det_loss`` cannot compute the end2end loss (fault 2 of the
reference); its instance's ``compute_loss`` is bound to the end2end form, as
in tests/test_torch_yolo26_train.py. One compiled JAX step per graph and
dtype (``make_train_step(..., return_stats=True)``, SGD), traced with two
recorders that leave its numbers as they are: each MoT router's and routed
block's kept experts go into ``ctx.stats`` under ``keep`` (left out where the
stats are compared). The gradient the step hands its optimizer (clipped at
global norm 10, with the coupled decay) is read from the SGD momentum trace
after the first step, in both packages; each of the three steps of the
trajectory starts the port from JAX's state before it (``check_trajectory``),
and the port also runs the steps on its own state (``check_free_run``, which
says how far each graph's free run is held). Weights: the port's seeded init after
``wake_mixtures`` (routers, deformable offsets and residual gains non-zero),
BN calibrated on the first batch, carried to JAX's tree; the latent routers
at ``noise_std`` 0.5 and the routed blocks at warmup 2 and dropout interval
2 on both packages' instances.
"""

import copy
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine import train_step as jts
from yolo_master_tpu.nn import latent_mixture as jlat
from yolo_master_tpu.nn import mot as jmot
from yolo_master_tpu.nn.mixture_loss import init_aux_ema as jax_init_aux_ema
from yolo_master_tpu.nn.moe import mixtures as jmix
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.nn import latent_mixture as tlat
from yolo_master_tpu_torch.nn import mot as tmot
from yolo_master_tpu_torch.nn.moe import OptimizedMOEImproved
from yolo_master_tpu_torch.nn.moe import mixtures as tmix
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils.weights import _nest, _opt_fields, calibrate_bn, state_dict_from_jax, \
    train_state_from_jax, wake_mixtures

from _torch_scale import jax_params_of
from test_torch_moe_train_model import HYP, _batch, _np, _routing
from test_torch_train_step import _jax_schedules, _jb, _tb
from test_torch_yolo26_train import _end2end_compute_loss

K = 3  # steps of the trajectory
NOISE = 0.5
WARMUP, INTERVAL = 2, 2
BF16_STEP = 2
BF16_BATCHES = 8
STAT = 1.5
BF16 = torch.bfloat16


def metric_names(name):
    fams = ("aux_moe", "aux_latent") if "latent" in name else ("aux_moa", "aux_mot")
    return ("loss", "box_loss", "cls_loss", "dfl_loss", "aux_loss") + fams


def _jax_routed(jm):
    return [m for spec in jm.specs for m in _walk(spec.module) if isinstance(m, jmix.OptimizedMOEImproved)]


def _walk(m):
    yield m
    for child in getattr(m, "_children", {}).values():
        for c in (child.mods if hasattr(child, "mods") else [child]):
            yield from _walk(c)


def _jax_latent_routers(jm):
    return [m for spec in jm.specs for m in _walk(spec.module) if isinstance(m, jlat.LatentRouter)]


def _recording_step(jstep_fn):
    """Wrap a JAX step so that, while it is traced, the MoT routers and routed
    blocks add their kept experts to ``ctx.stats[path]["keep"]``."""
    def step(state, batch):
        plain_router, plain_block, plain_pl = jmot._MoTRouter.__call__, jmix.OptimizedMOEImproved.__call__, \
            jmix.process_logits
        masks = []

        def router(self, p, x, ctx):
            out = plain_router(self, p, x, ctx)
            ctx.stats[self.path] = {"keep": out[1] >= jax.lax.top_k(out[1], self.top_k)[0][..., -1:]}
            return out

        def recorded(*a, **k):
            out = plain_pl(*a, **k)
            masks.append(out[0] > 0)
            return out

        def block(self, p, x, ctx):
            out = plain_block(self, p, x, ctx)
            ctx.stats.setdefault(self.path, {})["keep"] = masks[-1]
            return out

        jmot._MoTRouter.__call__, jmix.OptimizedMOEImproved.__call__, jmix.process_logits = router, block, recorded
        try:
            return jstep_fn(state, batch)
        finally:
            jmot._MoTRouter.__call__, jmix.OptimizedMOEImproved.__call__, jmix.process_logits = \
                plain_router, plain_block, plain_pl

    return step


def setup(name):
    """The shared state of one graph's gates: the port's base model, the JAX
    model and params, K batches of 4, the policy, and the compiled JAX fp32 step."""
    base = DetectionModel(name)
    wake_mixtures(base)
    for m in base.modules():
        if isinstance(m, tlat.LatentRouter):
            m.noise_std = NOISE
        if isinstance(m, OptimizedMOEImproved):
            m.warmup_steps, m.dropout_interval = WARMUP, INTERVAL
    batches = [_batch(seed, 4) for seed in range(60, 60 + K)]
    calibrate_bn(base, torch.from_numpy(batches[0]["images"]))
    jm = JaxDetectionModel(name)
    jm.compute_loss = types.MethodType(_end2end_compute_loss, jm)
    for m in _jax_latent_routers(jm):
        m.noise_std = NOISE
    for m in _jax_routed(jm):
        m.warmup_steps, m.dropout_interval = WARMUP, INTERVAL
    params = jax_params_of(jm, base)
    pol = ts.TrainPolicy(nc=80, epochs=10, nb=100, batch=4, nbs=4, optimizer="SGD")
    assert pol.accumulate == 1
    lr, bias_lr, momentum = _jax_schedules(pol)
    tx = jts.build_optimizer(pol.opt_name, lr, params, momentum=pol.opt_momentum,
                             weight_decay=pol.scaled_weight_decay, momentum_fn=momentum, bias_lr_fn=bias_lr)
    steps = {dt: _recording_step(jts.make_train_step(jm, tx=tx, hyp=HYP, compute_dtype=dt, return_stats=True))
             for dt in (jnp.float32, jnp.bfloat16)}
    return dict(name=name, base=base, jm=jm, params=params, batches=batches, pol=pol, tx=tx, steps=steps)


def jax_state(g, step=0):
    p = g["params"]
    return jts.TrainState(p, g["tx"].init(p), jax.tree_util.tree_map(jnp.copy, p), jnp.asarray(step, jnp.int32),
                          jnp.zeros((), jnp.float32), jax_init_aux_ema())


def jax_trace(g, jstate_np):
    """The SGD momentum trace of a JAX state (numpy leaves), every leaf JAX's
    optimizer updates, by the port's state_dict names."""
    found = {"count": [], "trace": [], "mu": [], "nu": []}
    _opt_fields(jstate_np.opt_state, found)
    return state_dict_from_jax(_nest(found["trace"]))


def split_stats(stats):
    """(JAX moe_stats without the recorders' "keep" entries, the kept-expert masks in path order)."""
    kept = {p: np.asarray(s["keep"]) for p, s in stats.items() if "keep" in s}
    rest = {p: {k: np.asarray(v) for k, v in s.items() if k != "keep"} for p, s in stats.items()}
    return {p: s for p, s in rest.items() if s}, kept


def _mot_routing(pin, seen):
    """MoTRouter.forward recording its own kept experts ([B, H, W, E], in forward
    order) into ``seen`` and, with ``pin`` (an iterator of JAX's masks), keeping
    those instead over its own probabilities, renormalised, the floor applied."""
    plain = tmot.MoTRouter.forward

    def routing(self, x):
        w, probs, logits = plain(self, x)
        seen.append((probs >= probs.topk(self.top_k, 1).values[:, -1:]).permute(0, 2, 3, 1).numpy())
        if pin is None:
            return w, probs, logits
        w = probs * torch.from_numpy(np.array(next(pin))).permute(0, 3, 1, 2)
        w = w / w.sum(1, keepdim=True).clamp_min(1e-9)
        if self.training and self.eps > 0:
            w = (1 - self.eps) * w + self.eps / self.num_experts
        return w, probs, logits

    return routing


def _routed_routing(pin, seen):
    """process_logits recording each routed block's own kept experts ([B, E])
    into ``seen`` and, with ``pin``, keeping JAX's instead (the rest as
    tests/test_torch_moe_train_model.py's ``_routing``)."""
    pinned = _routing(masks=pin) if pin is not None else None

    def routing(logits, top_k, noise=None):
        out = tmix_plain(logits, top_k, noise)
        seen.append((out[0] > 0).numpy())
        return out if pinned is None else pinned(logits, top_k, noise)

    return routing


tmix_plain = tmix.process_logits
_MOT_FORWARD = tmot.MoTRouter.forward


def _model_and_step(g, dtype, return_stats=False):
    """A copy of the base model in fp32 (or float64, the own-rounding reference, through the same step), its
    optimizer under the shared policy, and its train step in ``dtype``."""
    model = copy.deepcopy(g["base"]).to(dtype if dtype == torch.float64 else torch.float32)
    ptx = g["pol"].build_optimizer(model)
    allowed = ts.COMPUTE_DTYPES
    ts.COMPUTE_DTYPES = allowed + (torch.float64,)
    try:
        step = ts.make_train_step(model, ptx, hyp=HYP, compute_dtype=dtype, return_stats=return_stats)
    finally:
        ts.COMPUTE_DTYPES = allowed
    return model, ptx, step


def _pinned_step(step, state, batch, dtype, pin, mot, routed):
    """One step on ``batch`` in ``dtype``, the port's own picks recorded into ``mot`` / ``routed`` and, with
    ``pin`` (JAX's (MoT masks, routed masks), either None), JAX's kept instead."""
    tb = {k: v.to(dtype) if v.is_floating_point() else v for k, v in _tb(batch).items()}
    mot_pin, routed_pin = pin
    tmix.process_logits = _routed_routing(routed_pin or None, routed)
    tmot.MoTRouter.forward = _mot_routing(iter(mot_pin) if mot_pin else None, mot)
    try:
        return step(state, tb)
    finally:
        tmix.process_logits, tmot.MoTRouter.forward = tmix_plain, _MOT_FORWARD


def port_run(g, dtype, batches, start_step=0, pins=None):
    """The port's steps from the base weights under the shared policy:
    (model, state, {"metrics", "stats", "mot", "routed": per step; "trace":
    after the first step}); ``mot`` and ``routed`` hold the port's own kept
    experts. ``pins``: per step, JAX's (MoT masks, routed masks) to keep
    instead."""
    port, ptx, step = _model_and_step(g, dtype, return_stats=True)
    state = ts.make_train_state(port, ptx)
    state.step = start_step
    out = dict(metrics=[], stats=[], trace=None, mot=[], routed=[])
    for i, b in enumerate(batches):
        mot, routed = [], []
        state, met = _pinned_step(step, state, b, dtype, pins[i] if pins is not None else (None, None), mot, routed)
        out["mot"].append(mot)
        out["routed"].append(routed)
        out["stats"].append({p: {k: v.double().numpy() for k, v in s.items()} for p, s in met.pop("moe_stats").items()})
        out["metrics"].append({k: float(v) for k, v in met.items()})
        if i == 0:
            out["trace"] = {k: v.clone() for k, v in state.opt_state.buffers["trace"].items()}
    return port, state, out


def kept_lists(kept):
    """JAX's kept masks of one step by path -> (MoT routers' in forward order, routed blocks' in forward order)."""
    mot = [kept[p] for p in sorted(p for p in kept if p.endswith(".router"))]
    routed = [kept[p] for p in sorted(p for p in kept if not p.endswith(".router"))]
    return mot, routed


def jax_run(g, dtype=jnp.float32, batches=None, start_step=0):
    """JAX's steps from the same weights: (the states before and after each step, numpy copies; per-step
    metrics; the trace after the first step; per-step (stats, kept masks))."""
    jstate = jax_state(g, start_step)
    metrics, stats, trace, states = [], [], None, [_copy_np(jstate)]
    for i, b in enumerate(batches if batches is not None else g["batches"]):
        jstate, met = g["steps"][dtype](jstate, _jb(b))
        states.append(_copy_np(jstate))
        stats.append(split_stats(met.pop("moe_stats")))
        metrics.append({k: float(v) for k, v in met.items()})
        if i == 0:
            trace = jax_trace(g, states[-1])
    return states, metrics, trace, stats


def _copy_np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def flips(a, b):
    """Sample-and-position entries whose kept-expert sets differ, over the blocks."""
    return sum(int((np.asarray(x) != np.asarray(y)).any(-1).sum()) for x, y in zip(a, b))


def carried_run(g, dtype, jstates, pins):
    """Each step of the port from JAX's state before it (``train_state_from_jax``:
    parameters, BN statistics, EMA, optimizer buffers and count, counters,
    aux_ema; the first from the start weights), on that step's batch, keeping
    JAX's picks: per step the model, its state_dict, EMA, aux_ema, step,
    metrics, moe_stats, the port's own picks (MoT, routed) and the optimizer's
    trace."""
    out = []
    for i, b in enumerate(g["batches"]):
        model, ptx, step = _model_and_step(g, dtype, return_stats=True)
        state = train_state_from_jax(jstates[i], model, ptx)
        state.ema_params = {k: v.to(model.state_dict()[k].dtype) for k, v in state.ema_params.items()}
        mot, routed = [], []
        state, met = _pinned_step(step, state, b, dtype, pins[i], mot, routed)
        stats = {p: {k: v.double().numpy() for k, v in s.items()} for p, s in met.pop("moe_stats").items()}
        out.append(dict(model=model, sd=model.state_dict(), ema=state.ema_params, aux_ema=state.aux_ema,
                        step=state.step, metrics={k: float(v) for k, v in met.items()}, stats=stats, mot=mot,
                        routed=routed, trace={k: v.clone() for k, v in state.opt_state.buffers["trace"].items()}))
    return out


def free_run(g, dtype, pins):
    """The port's K steps on its own state from the start weights, keeping
    JAX's picks: per step the state_dict, EMA, aux_ema, step and metrics after it."""
    model, ptx, step = _model_and_step(g, dtype, return_stats=True)
    state = ts.make_train_state(model, ptx)
    out = []
    for i, b in enumerate(g["batches"]):
        state, met = _pinned_step(step, state, b, dtype, pins[i], [], [])
        met.pop("moe_stats")
        out.append(dict(sd={k: v.clone() for k, v in model.state_dict().items()},
                        ema={k: v.clone() for k, v in state.ema_params.items()}, aux_ema=state.aux_ema.clone(),
                        step=state.step, metrics={k: float(v) for k, v in met.items()}))
    return out


def trajectory(g):
    """JAX's K steps, each of them in the port from JAX's state before it, and
    the port's K steps on its own state, in fp32 and float64."""
    jstates, jmet, jtrace, jstats = jax_run(g)
    pins = [kept_lists(kept) for _, kept in jstats]
    return dict(jstates=jstates, jmet=jmet, jtrace=jtrace, jstats=jstats, pins=pins,
                carried=carried_run(g, torch.float32, jstates, pins),
                carried64=carried_run(g, torch.float64, jstates, pins),
                free=free_run(g, torch.float32, pins), free64=free_run(g, torch.float64, pins))


def check_first_step(g, run):
    """Step 0: the loss terms and each family's aux within 1e-5 relative; every
    kept-expert set JAX's; the gradient (the optimizer's trace) within
    max(8x own, 1e-6 x gmax); moe_stats JAX's keys and values; the latent noise JAX's draw."""
    names = metric_names(g["name"])
    first, first64 = run["carried"][0], run["carried64"][0]
    ref, got = run["jmet"][0], first["metrics"]
    for k in names:
        assert abs(got[k] - ref[k]) <= 1e-5 * abs(ref[k]) + 1e-9, (k, got[k], ref[k])
    assert all(got[k] > 0 for k in names[-2:]), {k: got[k] for k in names[-2:]}
    jstats, jkept = run["jstats"][0]
    jmot, jrouted = run["pins"][0]
    mot, routed = first["mot"], first["routed"]
    assert len(jmot) == len(mot) and len(jrouted) == len(routed) == (6 if "latent" in g["name"] else 0)
    assert flips(jmot, mot) == 0 and flips(jrouted, routed) == 0
    if "moa" in g["name"]:
        assert sorted(p for p in jkept if p.endswith(".router")) == [f"layers.{i}.m.0.router" for i in (13, 19, 22)]
        assert sum(int(k.all(-1).sum()) for k in mot) < sum(k[..., 0].size for k in mot)  # not every expert kept
    stats = first["stats"]
    assert sorted(stats) == sorted(jstats) and all(sorted(stats[p]) == sorted(jstats[p]) for p in stats)
    for p, s in stats.items():
        for k, v in s.items():
            np.testing.assert_allclose(v, jstats[p][k], rtol=1e-5, atol=1e-7, err_msg=f"{p} {k}")
    tr, tr64, jtr = first["trace"], first64["trace"], run["jtrace"]
    rf = {k for k in first["sd"] if k.endswith("_rf_matrix")}
    extra = set(jtr) - set(tr)  # JAX's trace also has a slot for each BN statistic of its tree
    bn = {k for k in extra if k.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked")}
    assert extra - bn == rf and set(tr) <= set(jtr)  # JAX alone updates the random features (fault 4)
    assert bool(rf) == ("moa" in g["name"])
    gmax = max(jtr[k].abs().max().item() for k in tr)
    for k, v in tr.items():
        own = (v.double() - tr64[k]).abs().max().item()
        err = (v - jtr[k].reshape(v.shape)).abs().max().item()
        assert err <= max(8 * own, 1e-6 * gmax), (k, err, own, gmax)


def check_trajectory(g, run):
    """Each of the K steps from JAX's state before it (the step index, the
    optimizer's count and buffers, the schedules, the latent noise and the
    routed blocks' k and dropout of that step): the loss terms within 1e-5
    relative or 8x the port's own float64 distance; parameters, BN statistics
    and EMA after it within 1e-6 + 2e-5 x the step's move or 8x their own
    distance; aux_ema within 1e-6 relative; the counters JAX's. Starting each
    step from JAX's state keeps every step of yolo26-master-latent-n off the
    knife edge of its step 1 (``check_free_run``). ``_rf_matrix``
    is among the compared entries: at 64 px MoA takes the exact path and JAX's
    copy keeps the port's value (fault 4 shows only from 512 tokens)."""
    from test_torch_moe_train_steps import _held

    for i, (ref, got, own) in enumerate(zip(run["jmet"], run["carried"], run["carried64"])):
        for k in metric_names(g["name"]):
            out, o64 = got["metrics"][k], own["metrics"][k]
            assert abs(out - ref[k]) <= max(1e-5 * abs(ref[k]) + 1e-9, 8 * abs(out - o64)), (i, k, out, ref[k], o64)
        before, after = run["jstates"][i], run["jstates"][i + 1]
        dist = {k: (v.double() - own["sd"][k]).abs().max().item()
                for k, v in got["sd"].items() if v.is_floating_point()}
        dist_ema = {k: (v.double() - own["ema"][k]).abs().max().item() for k, v in got["ema"].items()}
        _held(got["sd"], after.params, state_dict_from_jax(before.params), dist, f"params after step {i}")
        _held(got["ema"], after.ema_params, state_dict_from_jax(before.ema_params), dist_ema, f"ema after step {i}")
        np.testing.assert_allclose(got["aux_ema"].numpy(), np.asarray(after.aux_ema), rtol=1e-6)
        assert got["step"] == int(after.step) == i + 1


def check_free_run(g, run, held):
    """The port's K steps on its own state (its own parameters, EMA, optimizer
    buffers, aux_ema, counters and caches from step to step), JAX's picks kept,
    against JAX's K steps: after each of the first ``held`` steps the
    parameters, BN statistics and EMA within ``check_trajectory``'s gate, the
    float64 free run giving the port's own distance; at each step whose state
    is held so far (``held`` + 1 of them, at most K) the loss terms within 1e-5
    relative or 8x the own distance, aux_ema within 1e-6 relative and the
    counters JAX's. yolo26-master-moa-mot-n is held through its K steps. On
    yolo26-master-latent-n step 1's gradient sits on a knife edge that is JAX's
    own: from states 1e-6 apart on one line, JAX's fp32 gradient takes one of two
    values 14% apart, and so does the port's, fp32 or float64, with the
    assignment unchanged (tests/_torch_latent_knife_edge.py measures it; PERF.md
    §7). So its free run is held through step 0's state and step 1's forward."""
    from test_torch_moe_train_steps import _held

    for i in range(min(held + 1, K)):
        got, own = run["free"][i], run["free64"][i]
        ref = run["jmet"][i]
        for k in metric_names(g["name"]):
            out, o64 = got["metrics"][k], own["metrics"][k]
            assert abs(out - ref[k]) <= max(1e-5 * abs(ref[k]) + 1e-9, 8 * abs(out - o64)), (i, k, out, ref[k], o64)
        before, after = run["jstates"][i], run["jstates"][i + 1]
        np.testing.assert_allclose(got["aux_ema"].numpy(), np.asarray(after.aux_ema), rtol=1e-6)
        assert got["step"] == int(after.step) == i + 1
        if i < held:
            dist = {k: (v.double() - own["sd"][k]).abs().max().item()
                    for k, v in got["sd"].items() if v.is_floating_point()}
            dist_ema = {k: (v.double() - own["ema"][k]).abs().max().item() for k, v in got["ema"].items()}
            _held(got["sd"], after.params, state_dict_from_jax(before.params), dist, f"free params after step {i}")
            _held(got["ema"], after.ema_params, state_dict_from_jax(before.ema_params), dist_ema,
                  f"free ema after step {i}")


def check_bf16(g):
    """One bf16 step at BF16_STEP on BF16_BATCHES batches of 4, the port's MoT
    and routed picks pinned to JAX bf16's: the trace tree's rel-RMS from JAX
    fp32 (squared distances summed over the batches) within 1.5x JAX bf16's
    own; each loss term's RMS distance from JAX fp32 within max(1.5x JAX
    bf16's, 2^-8 of its RMS). Returns (the port's statistic, JAX bf16's, the
    flips of the port's own bf16 picks from JAX bf16's per batch)."""
    names = metric_names(g["name"])
    sums, terms, bf16_flips = np.zeros(3), [], []
    keys = None
    for seed in range(80, 80 + BF16_BATCHES):
        batch = [_batch(seed, 4)]
        _, m32, t32, _ = jax_run(g, jnp.float32, batch, BF16_STEP)
        _, m16, t16, s16 = jax_run(g, jnp.bfloat16, batch, BF16_STEP)
        mot, routed = kept_lists(s16[0][1])
        _, _, out = port_run(g, BF16, batch, BF16_STEP, pins=[(mot or None, routed or None)])
        bf16_flips.append(flips(mot, out["mot"][0]) + flips(routed, out["routed"][0]))
        keys = keys or sorted(out["trace"])
        gp, j16, j32 = (torch.cat([t[k].float().flatten() for k in keys]).numpy() for t in (out["trace"], t16, t32))
        assert np.isfinite(gp).all()
        sums += [np.sum((gp - j32) ** 2), np.sum((j16 - j32) ** 2), np.sum(j32 ** 2)]
        terms.append((out["metrics"][0], m16[0], m32[0]))
    port, own = np.sqrt(sums[0] / sums[2]), np.sqrt(sums[1] / sums[2])
    assert 0 < own < 2 and port <= STAT * own, (port, own)  # own ~1: a bf16 step's gradient is mostly rounding
    for k in names:
        d = np.array([(p[k] - r[k], j[k] - r[k], r[k]) for p, j, r in terms])
        port_d, own_d, ref = np.sqrt(np.mean(d ** 2, 0))
        assert port_d <= max(STAT * own_d, 2.0 ** -8 * ref), (k, port_d, own_d, ref)
    return port, own, bf16_flips


# -- the loop of yolo26-master-moa-mot-n: held to the port's own step (the JAX trainer cannot run the
# end2end graphs, fault 2) ------------------------------------------------------------------------------

def start_weights(name, data):
    """The port's seeded init after wake_mixtures, BN calibrated on the first
    train batch, the class biases of both branches at 0."""
    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.data.dataset import DataLoader, YOLODataset

    y = YOLO(name, device="cpu")
    wake_mixtures(y.model)
    ds = YOLODataset(data, split="train", imgsz=64, max_gt=16)
    calibrate_bn(y.model, torch.from_numpy(next(DataLoader(ds, 8, images=np.float32).epoch())["images"]))
    with torch.no_grad():
        for branch in (*y.model.head.cv3, *y.model.head.one2one_cv3):
            branch[-1].bias.zero_()
    return {k: v.clone() for k, v in y.model.state_dict().items()}


def _yolo(name, start):
    from yolo_master_tpu_torch import YOLO

    return YOLO(name, device="cpu").load_state_dict(start)


def check_loop(name, data, start, tmp_path):
    """``YOLO(name).train(...)`` in fp32 (amp=False), one epoch of two
    optimizer steps with the Gini schedule reading the mixtures' usage and the
    EMA's val (the end2end validator): parameters and EMA bitwise those of the
    port's make_train_step fed the same batches at the same MoE gain; finite
    losses and val metrics; the routing history holds the MoA/MoT blocks;
    last.npz reloads and predicts."""
    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.trainer import DetectionTrainer
    from yolo_master_tpu_torch.utils.checkpoint import load_weights_npz
    from test_torch_trainer import VAL_METRICS
    from test_torch_yolo26_train import RUN

    y = _yolo(name, start)
    trainer = DetectionTrainer(y, data=data, save_dir=str(tmp_path / "run"), **RUN)
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
    paths = set(_history_blocks(trainer))
    assert paths == {f"layers.{i}.m.0" for i in (13, 16, 19, 22)}, sorted(paths)
    model = _yolo(name, start).model
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
    assert meta["model"] == name
    res = YOLO(str(tmp_path / "run" / "last.npz"), device="cpu").fuse().predict(
        [np.zeros((64, 64, 3), np.uint8)], imgsz=64, conf=0.0, max_det=30)
    assert res[0].boxes.data.shape == (30, 6)


def _history_blocks(trainer):
    """The block paths of the routing history's rows."""
    return [row["block"] for row in trainer.routing_history.rows]


def check_amp_resume(name, data, start, tmp_path):
    """``amp`` at its default (bf16), 2 epochs saved every epoch, interrupted in
    epoch 2 and resumed from epoch 1: parameters, EMA, optimizer buffers,
    counters and aux_ema bitwise those of the uninterrupted run; fp32 weights
    in last.npz; the live model's ``_rf_matrix`` the init's, bit for bit (the
    EMA's copy moves by the blend's rounding, d * x + (1 - d) * x, as JAX's
    EMA of its copy does)."""
    from yolo_master_tpu_torch.engine.trainer import DetectionTrainer
    from yolo_master_tpu_torch.utils.checkpoint import load_weights_npz
    from test_torch_trainer import _assert_bitwise, _full_state

    kw = dict(epochs=2, batch=4, nbs=8, imgsz=64, max_gt=16, save_period=1, val=False, close_mosaic=0,
              moe_schedule=None, workers=0, seed=0)
    full = DetectionTrainer(_yolo(name, start), data=data, save_dir=str(tmp_path / "full"), **kw)
    assert full.compute_dtype == torch.bfloat16
    full.train()
    part = DetectionTrainer(_yolo(name, start), data=data, save_dir=str(tmp_path / "part"), **kw)
    fire = part.callbacks.fire

    def crash(event, *a):
        fire(event, *a)
        if event == "on_fit_epoch_end" and a[0] == 1:
            raise KeyboardInterrupt("interrupted in epoch 2")

    part.callbacks.fire = crash
    try:
        part.train()
    except KeyboardInterrupt:
        pass
    else:
        raise AssertionError("the run was not interrupted")
    resumed = DetectionTrainer(_yolo(name, start), data=data, save_dir=str(tmp_path / "part"), resume=True, **kw)
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    resumed.train()
    assert resumed.state.step == full.state.step == 4
    assert torch.equal(resumed.state.aux_ema, full.state.aux_ema)
    _assert_bitwise(_full_state(resumed), _full_state(full))
    sd, _ = load_weights_npz(tmp_path / "full" / "last.npz")
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    rf = [k for k in start if k.endswith("_rf_matrix")]
    assert all(torch.equal(full.last_weights[k], start[k]) for k in rf)
    assert all(torch.allclose(sd[k], start[k], rtol=1e-6, atol=0) for k in rf)


def check_multitrainer(name, data, start, tmp_path):
    """``YOLO(name).train(data=[a, b])``: two runs from the base weights, finite
    val metrics, and the facade's model the base again, bitwise."""
    from test_torch_multitrainer import _other_set
    from test_torch_trainer import VAL_METRICS
    from test_torch_yolo26_train import RUN

    y = _yolo(name, start)
    res = y.train(data=[data, _other_set(tmp_path / "other")], save_dir=str(tmp_path / "multi"), **RUN)
    assert list(res) == ["data", "other"]
    assert all(np.isfinite(res[n][k]) for n in res for k in VAL_METRICS)
    assert not y.model.training
    for k, v in y.model.state_dict().items():
        assert torch.equal(v, start[k]), k
