"""yolo-master-v0_10-n's train step in the port against the JAX package's, on
the CPU: three VisualEnhancedAdaptiveGateMoE blocks (E = 4, 8, 16, top-2)
with their temperature anneal, complexity gate and aux loss.

Weights: the port's seeded init with BN calibrated on the first batch,
carried to the JAX tree (tests/_torch_scale.py:jax_params_of); 64 px images,
batches of 4 (tests/test_torch_moe_train_model.py's).

fp32 (tests/test_torch_train_step.py's gates): one step's loss terms within 1e-5 relative and each
parameter's gradient within 8x the port's own fp32-vs-fp64 error of that
tensor or 1e-6 x the tree's largest |g|, at step 0 and in the middle of the
anneal. The own error is the largest over the port's fp32 runs at 1, 2 and
4 threads (each sums in another order): the gradient of a block's scalar
(``refine_scale``) sums a whole map, and one run's rounding of it can land
far closer to fp64 than another's (v0_13-n's layer 8: 5.0e-6 at 2 threads,
1.7e-5 at 4, and JAX's fp32 3.5e-5 from the port's fp64, measured). (The five-step trajectory, v0_13-n and v0_15-n are in
tests/test_torch_gated_train_steps.py.)

bf16 (PERF.md §7's statistic): two correct bf16 programs may pick
different experts, or keep a different count, so the port's routing is
pinned to JAX bf16's picks and kept counts (tests/test_torch_cuda.py:
_gated_routing) and its gradient tree's rel-RMS from JAX fp32 is held within
1.5x JAX bf16's own, summed over eight batches of 4; unpinned, the routings
that differ are counted as measured.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.mixture_loss import compose_aux as jax_compose_aux
from yolo_master_tpu.nn.mixture_loss import init_aux_ema as jax_init_aux_ema
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import gated as jg
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.nn.mixture_loss import compose_aux, init_aux_ema
from yolo_master_tpu_torch.nn.moe import gated as tg
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_cuda import _gated_routing  # noqa: E402
from test_torch_moe_train_model import HYP, _batch, _np  # noqa: E402
from test_torch_train_step import _jb, _tb  # noqa: E402

NAME = "yolo-master-v0_10-n"
GATED = (5, 8, 11)
METRICS = ("loss", "box_loss", "cls_loss", "dfl_loss", "aux_loss", "aux_moe")
BF16 = torch.bfloat16
STAT = 1.5  # the port's distance from JAX fp32 within 1.5x JAX bf16's own
BF16_STEP = 700  # inside the temperature anneal
BF16_BATCHES = 8  # batches of 4 in the bf16 statistic
# (sample, block) top-k sets that differ, plus blocks whose kept count differs, over the eight bf16 batches,
# at layers 5, 8, 11 (measured): the port's bf16 against JAX's bf16, and JAX's bf16 against JAX's fp32
FLIPS = [0, 0, 7]
JAX_FLIPS = [0, 0, 4]  # the 16 experts of layer 11 leave little margin between the 2nd and 3rd pick


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_gated_loss(jm, dtype, hyp=HYP):
    """The JAX step's loss at a traced step (yolo_master_tpu/engine/train_step.py:
    loss_fn, the aux composed from a fresh aux_ema), jitted under
    value_and_grad, with each gated block's routing in forward order: (top-k
    indices [B, k], kept count)."""
    def loss(params, batch, step):
        picks = []
        gate, publish = jg.AdaptiveGateMoE._complexity_gate, jg.AdaptiveGateMoE._publish_aux

        def recorded_gate(self, w, complexity):
            k = w.shape[1]
            picks.append([None, jnp.clip(jnp.round(complexity * k), 1, k)])
            return gate(self, w, complexity)

        def recorded_publish(self, ctx, stats, w, idx):
            picks[-1][0] = idx
            return publish(self, ctx, stats, w, idx)

        jg.AdaptiveGateMoE._complexity_gate, jg.AdaptiveGateMoE._publish_aux = recorded_gate, recorded_publish
        try:
            ctx = Context(training=True, compute_dtype=dtype, step=step)
            preds = jm.forward_train(params, batch["images"].astype(dtype), ctx)
        finally:
            jg.AdaptiveGateMoE._complexity_gate, jg.AdaptiveGateMoE._publish_aux = gate, publish
        aux_total, _, aux_metrics = jax_compose_aux(ctx, {"moe": hyp["moe"]}, jax_init_aux_ema(), budget=0.0,
                                                    normalize=True)
        base, metrics = jm.compute_loss(preds, batch, jnp.zeros(()), {**hyp, "moe": 0.0})
        total = base + aux_total
        return total, ({**metrics, **aux_metrics, "aux_loss": aux_total, "loss": total}, [tuple(p) for p in picks])

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def gated_pair(name, settings=()):
    """(port with BN calibrated on the first batch, the JAX model, its tree, five
    batches of 4); ``settings`` ((submodule, attribute, value), ...) set on every
    gated block of both."""
    base = DetectionModel(name)
    jm = JaxDetectionModel(name)
    for owner, attr, value in settings:
        for b in [base.model[i] for i in GATED] + [jm.layers[i] for i in GATED]:
            setattr(getattr(b, owner), attr, value)
    batches = [_batch(seed, 4) for seed in range(30, 35)]
    calibrate_bn(base, torch.from_numpy(batches[0]["images"]))
    assert all(isinstance(jm.layers[i], jg.AdaptiveGateMoE) for i in GATED)
    assert [base.model[i].jax_path for i in GATED] == [jm.layers[i].path for i in GATED]
    assert [base.model[i].routing.jax_path for i in GATED] == [jm.layers[i].routing.path for i in GATED]
    return base, jm, jax_params_of(jm, base), batches


def _grad(p):
    """A parameter's gradient; complexity_estimator's, behind a round, is none (0, as JAX's)."""
    return torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()


def port_step_grads(model, batch, step, dtype=torch.float32):
    """The gradients one port train step (accumulate 1) at ``step`` hands its optimizer, and its metrics."""
    tx = ts.make_optimizer(0.0, model)
    grads, apply = {}, tx.apply

    def capture(m, opt_state):
        grads.update({n: _grad(p) for n, p in m.named_parameters()})
        apply(m, opt_state)

    tx.apply = capture
    state = ts.make_train_state(model, tx)
    state.step = step
    _, metrics = ts.make_train_step(model, tx, hyp=HYP, compute_dtype=dtype)(state, _tb(batch))
    return grads, metrics


def port_grads64(model, batch, step):
    """The same gradients from a float64 copy of the model (the port's own rounding reference)."""
    model = copy.deepcopy(model).double().train()
    preds, aux = model.forward_train(torch.from_numpy(batch["images"]).double(), step)
    aux_total, _, _ = compose_aux(aux, {"moe": HYP["moe"]}, init_aux_ema())
    base, _ = model.compute_loss(preds, _tb(batch), torch.zeros(()), {**HYP, "moe": 0.0})
    (base + aux_total).backward()
    return {n: _grad(p) for n, p in model.named_parameters()}


def check_one_step(base, jm, params, loss32, batch, step):
    """One fp32 port step at ``step`` against JAX's: the loss terms within 1e-5
    relative, every gradient within max(8 x own, 1e-6 x gmax); returns the port model."""
    (_, (jmet, _)), jgrad = loss32(params, _jb(batch), jnp.int32(step))
    port = copy.deepcopy(base)
    grads, met = port_step_grads(port, batch, step)
    threads = torch.get_num_threads()
    others = []
    for n in (1, 4):
        torch.set_num_threads(n)
        try:
            others.append(port_step_grads(copy.deepcopy(base), batch, step)[0])
        finally:
            torch.set_num_threads(threads)
    for k in METRICS:
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), (k, float(met[k]), float(jmet[k]))
    assert float(met["aux_moe"]) > 0
    own64 = port_grads64(base, batch, step)
    ref = state_dict_from_jax(_np(jgrad))
    gmax = max(g.abs().max().item() for g in ref.values())
    for name, g in grads.items():
        own = max((r[name].double() - own64[name]).abs().max().item() for r in (grads, *others))
        err = (g - ref[name]).abs().max().item()
        assert err <= max(8 * own, 1e-6 * gmax), (name, err, own, gmax)
    return port


@pytest.fixture(scope="module")
def v10():
    base, jm, params, batches = gated_pair(NAME)
    return {"base": base, "jm": jm, "params": params, "batches": batches, "loss32": jax_gated_loss(jm, jnp.float32)}


@pytest.mark.parametrize("step", [0, BF16_STEP], ids=["start", "annealing"])
def test_one_step_loss_and_gradients_match_jax(v10, step):
    port = check_one_step(v10["base"], v10["jm"], v10["params"], v10["loss32"], v10["batches"][0], step)
    assert all(port.model[i].step == port.model[i].routing.step == step for i in GATED)


# -- bf16: pinned to JAX bf16's routing, and the flips unpinned -----------------------------------------

def _torch_picks(picks):
    return [(torch.from_numpy(np.array(i)).long(), float(k)) for i, k in picks]


def _flips(a, b):
    """Per block: the samples whose top-k set differs, plus one where the kept count differs."""
    return [sum(set(np.asarray(x).tolist()) != set(np.asarray(y).tolist()) for x, y in zip(ia, ib))
            + int(float(ka) != float(kb)) for (ia, ka), (ib, kb) in zip(a, b)]


@pytest.fixture(scope="module")
def bf16(v10):
    """BF16_BATCHES batches of 4 at BF16_STEP: JAX's fp32 and bf16 gradients with
    their routing, and the port's bf16 step's gradients with its routing pinned
    to JAX bf16's, and unpinned (its own routing recorded)."""
    jm, params = v10["jm"], v10["params"]
    loss16 = jax_gated_loss(jm, jnp.bfloat16)
    runs = []
    for seed in range(40, 40 + BF16_BATCHES):
        batch = _batch(seed, 4)
        run = {}
        for key, fn in (("jax32", v10["loss32"]), ("jax16", loss16)):
            (_, (metrics, picks)), grads = fn(params, _jb(batch), jnp.int32(BF16_STEP))
            run[key] = ({k: float(metrics[k]) for k in METRICS}, state_dict_from_jax(_np(grads)),
                        [(np.asarray(i), float(k)) for i, k in picks])
        for key, routing in (("pinned", {"picks": _torch_picks(run["jax16"][2])}), ("free", {"seen": []})):
            patches = _gated_routing(**routing)
            plain = {k: getattr(tg, k) for k in patches}
            for k, v in patches.items():
                setattr(tg, k, v)
            try:
                grads, metrics = port_step_grads(copy.deepcopy(v10["base"]), batch, BF16_STEP, BF16)
            finally:
                for k, v in plain.items():
                    setattr(tg, k, v)
            seen = [(i.numpy(), float(k)) for i, k in routing.get("seen", [])]
            run[key] = ({k: float(metrics[k]) for k in METRICS}, grads, seen)
        runs.append(run)
    return runs


def test_bf16_step_with_jax_bf16_routing_follows_jax(bf16):
    """One bf16 step of v0_10-n in the anneal, the port's routing pinned to JAX
    bf16's: the gradient tree's rel-RMS from JAX fp32 (squared distances summed
    over the batches) within 1.5x JAX bf16's own; every loss term's RMS distance
    from JAX fp32 within max(1.5x JAX bf16's, 2^-8 of its RMS)."""
    names = sorted(bf16[0]["pinned"][1])
    sums = np.zeros(3)  # |port16 - jax32|^2, |jax16 - jax32|^2, |jax32|^2
    for run in bf16:
        gp, g16, g32 = (torch.cat([g[n].float().flatten() for n in names]).numpy()
                        for g in (run["pinned"][1], run["jax16"][1], run["jax32"][1]))
        assert np.isfinite(gp).all()
        sums += [np.sum((gp - g32) ** 2), np.sum((g16 - g32) ** 2), np.sum(g32 ** 2)]
    port, own = np.sqrt(sums[0] / sums[2]), np.sqrt(sums[1] / sums[2])
    assert 0 < own and port <= STAT * own, (port, own)
    assert all(g.dtype == torch.float32 for g in bf16[0]["pinned"][1].values())
    for k in METRICS:
        d = np.array([(run["pinned"][0][k] - run["jax32"][0][k], run["jax16"][0][k] - run["jax32"][0][k],
                       run["jax32"][0][k]) for run in bf16])
        port_d, own_d, ref = np.sqrt(np.mean(d ** 2, 0))
        assert port_d <= max(STAT * own_d, 2.0 ** -8 * ref), (k, port_d, own_d, ref)


def test_bf16_routing_flips_between_the_bf16_programs(bf16):
    """Unpinned, per block, summed over the batches: the routings that differ
    between the port's bf16 step and JAX's bf16 step, and between JAX's bf16 and
    fp32 steps, are the counts measured."""
    assert all(len(run["free"][2]) == len(run["jax16"][2]) == 3 for run in bf16)
    counts = np.sum([_flips(run["free"][2], run["jax16"][2]) for run in bf16], 0).tolist()
    jax_own = np.sum([_flips(run["jax16"][2], run["jax32"][2]) for run in bf16], 0).tolist()
    assert counts == FLIPS and jax_own == JAX_FLIPS, (counts, jax_own)
