"""yolo-master-v0_1-n's train step in the port against the JAX package's, on the
CPU: three OptimizedMOEImproved blocks (E = 4, 8, 16, top_k 2) with their
router noise, progressive sparsity, expert dropout and aux loss.

Both packages take warmup_steps 4 and dropout_interval 4 on every routed
block, so that over steps 0-4 k falls from E to 2 and step 4 drops experts.
Weights: the port's seeded init with BN calibrated on the first batch,
carried to the JAX tree (tests/_torch_scale.py:jax_params_of); 64 px images.

fp32 (PR 13's gates): one step's loss terms within 1e-5 relative and each
parameter's gradient within 8x the port's own fp32-vs-fp64 error of that
tensor or 1e-6 x the tree's largest |g| (the five-step trajectory and the
carried JAX states are in tests/test_torch_moe_train_steps.py).

bf16 (PR 15's statistic): two correct bf16 programs pick different experts
for some (sample, block) pairs, so the port's routing is pinned to JAX
bf16's picks and its gradient tree's rel-RMS from JAX fp32 is held within
1.5x JAX bf16's own, summed over eight batches of 4; unpinned, the count of
pairs whose top-k set differs is asserted as measured.
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
from yolo_master_tpu.nn.moe import mixtures as jmix
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.nn.mixture_loss import compose_aux, init_aux_ema
from yolo_master_tpu_torch.nn.moe import mixtures as tmix
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_train_step import _jb, _tb  # noqa: E402

NAME = "yolo-master-v0_1-n"
ROUTED = (5, 8, 11)
WARMUP, INTERVAL = 4, 4
HYP = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "moe": 0.01}
METRICS = ("loss", "box_loss", "cls_loss", "dfl_loss", "aux_loss", "aux_moe")
K = 5
BF16 = torch.bfloat16
STAT = 1.5  # the port's distance from JAX fp32 within 1.5x JAX bf16's own
BF16_STEP = 4  # top-2 in every block, and a dropout step
BF16_BATCHES = 8  # batches of 4 in the bf16 statistic


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(seed: int, b: int):
    """A batch of ``b`` at 64 px: noise images, GT boxes 16-40 px, 1-6 an image."""
    rng = np.random.default_rng(seed)
    xy, wh = rng.uniform(0, 30, (b, 6, 2)), rng.uniform(16, 40, (b, 6, 2))
    return {"images": rng.random((b, 64, 64, 3), np.float32),
            "boxes": np.concatenate([xy, np.minimum(xy + wh, 63)], -1).astype(np.float32),
            "classes": rng.integers(0, 80, (b, 6)).astype(np.int32),
            "mask": np.arange(6)[None] < rng.integers(1, 7, (b, 1))}


def _short_schedule(blocks) -> None:
    for m in blocks:
        m.warmup_steps, m.dropout_interval = WARMUP, INTERVAL


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_loss(jm, dtype, seen=None):
    """The JAX step's loss at a traced step (yolo_master_tpu/engine/train_step.py:
    loss_fn, the aux composed from a fresh aux_ema), jitted under
    value_and_grad; with ``seen``, each routed block's rank mask in forward order too."""
    def loss(params, batch, step):
        masks = []
        if seen is not None:
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
            if seen is not None:
                jmix.process_logits = orig
        aux_total, _, aux_metrics = jax_compose_aux(ctx, {"moe": HYP["moe"]}, jax_init_aux_ema(), budget=0.0,
                                                    normalize=True)
        base, metrics = jm.compute_loss(preds, batch, jnp.zeros(()), {**HYP, "moe": 0.0})
        total = base + aux_total
        return total, ({**metrics, **aux_metrics, "aux_loss": aux_total, "loss": total}, masks)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.fixture(scope="module")
def v01():
    base = DetectionModel(NAME)
    _short_schedule(base.model[i] for i in ROUTED)
    batches = [_batch(seed, 4) for seed in range(30, 30 + K)]
    calibrate_bn(base, torch.from_numpy(batches[0]["images"]))
    jm = JaxDetectionModel(NAME)
    _short_schedule(jm.layers[i] for i in ROUTED)
    assert all(isinstance(jm.layers[i], jmix.OptimizedMOEImproved) for i in ROUTED)
    assert [base.model[i].jax_path for i in ROUTED] == [jm.layers[i].path for i in ROUTED]
    return {"base": base, "jm": jm, "params": jax_params_of(jm, base), "batches": batches,
            "loss32": _jax_loss(jm, jnp.float32, seen=True)}


def _port_step_grads(model, batch, step, dtype=torch.float32):
    """The gradients one port train step (accumulate 1) at ``step`` hands its optimizer, and its metrics."""
    tx = ts.make_optimizer(0.0, model)
    grads, apply = {}, tx.apply

    def capture(m, opt_state):
        grads.update({n: p.grad.detach().clone() for n, p in m.named_parameters()})
        apply(m, opt_state)

    tx.apply = capture
    state = ts.make_train_state(model, tx)
    state.step = step
    _, metrics = ts.make_train_step(model, tx, hyp=HYP, compute_dtype=dtype)(state, _tb(batch))
    return grads, metrics


def _port_grads64(model, batch, step):
    """The same gradients from a float64 copy of the model (the port's own rounding reference)."""
    model = copy.deepcopy(model).double().train()
    preds, aux = model.forward_train(torch.from_numpy(batch["images"]).double(), step)
    aux_total, _, _ = compose_aux(aux, {"moe": HYP["moe"]}, init_aux_ema())
    base, _ = model.compute_loss(preds, _tb(batch), torch.zeros(()), {**HYP, "moe": 0.0})
    (base + aux_total).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("step", [2, 4], ids=["annealing", "dropout"])
def test_one_step_loss_and_gradients_match_jax(v01, step):
    """One fp32 step at ``step`` (2: k = 3, 5 and 9 of 4, 8 and 16, with noise; 4:
    k = 2 and a dropout step): the loss terms and the aux within 1e-5
    relative, every gradient within max(8 x own, 1e-6 x gmax)."""
    batch = v01["batches"][0]
    (_, (jmet, _)), jgrad = v01["loss32"](v01["params"], _jb(batch), jnp.int32(step))
    port = copy.deepcopy(v01["base"])
    grads, met = _port_step_grads(port, batch, step)
    assert [port.model[i].adaptive_top_k() for i in ROUTED] == ([3, 5, 9] if step == 2 else [2, 2, 2])
    assert all((port.model[i].dropped_experts().size > 0) == (step == 4) for i in ROUTED)
    for k in METRICS:
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), (k, float(met[k]), float(jmet[k]))
    assert float(met["aux_moe"]) > 0
    own64 = _port_grads64(v01["base"], batch, step)
    ref = state_dict_from_jax(_np(jgrad))
    gmax = max(g.abs().max().item() for g in ref.values())
    for name, g in grads.items():
        own = (g.double() - own64[name]).abs().max().item()
        err = (g - ref[name]).abs().max().item()
        assert err <= max(8 * own, 1e-6 * gmax), (name, err, own, gmax)


# -- bf16: pinned to JAX bf16's picks, and the flips unpinned ---------------------------------------

def _routing(masks=None, seen=None):
    """process_logits for the port's blocks in forward order: with ``masks``
    (JAX's [B, E] rank masks) each block keeps those experts over its own
    noisy probabilities, renormalised; with ``seen`` its own masks are recorded."""
    it = iter(masks or [])

    def routing(logits, top_k, noise=None):
        if masks is None:
            out = _PROCESS_LOGITS(logits, top_k, noise)
            seen.append((out[0] > 0).numpy())
            return out
        logits = logits.float() + noise if noise is not None else logits.float()
        probs = torch.softmax(logits.clamp(-30.0, 30.0), dim=-1)
        w = probs * torch.from_numpy(np.array(next(it)))
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), probs, logits

    return routing


_PROCESS_LOGITS = tmix.process_logits


@pytest.fixture(scope="module")
def bf16(v01):
    """BF16_BATCHES batches of 4 at BF16_STEP: JAX's fp32 and bf16 gradients (one
    jit each, the step traced) with their rank masks, and the port's bf16 step's
    gradients with its routing pinned to JAX bf16's masks, and unpinned."""
    jm, params = v01["jm"], v01["params"]
    loss16 = _jax_loss(jm, jnp.bfloat16, seen=True)
    runs = []
    for seed in range(40, 40 + BF16_BATCHES):
        batch = _batch(seed, 4)
        run = {}
        for key, fn in (("jax32", v01["loss32"]), ("jax16", loss16)):
            (_, (metrics, masks)), grads = fn(params, _jb(batch), jnp.int32(BF16_STEP))
            run[key] = ({k: float(metrics[k]) for k in METRICS}, state_dict_from_jax(_np(grads)),
                        [np.asarray(m) for m in masks])
        seen = []
        for key, routing in (("pinned", _routing(masks=run["jax16"][2])), ("free", _routing(seen=seen))):
            tmix.process_logits = routing
            try:
                grads, metrics = _port_step_grads(copy.deepcopy(v01["base"]), batch, BF16_STEP, BF16)
            finally:
                tmix.process_logits = _PROCESS_LOGITS
            run[key] = ({k: float(metrics[k]) for k in METRICS}, grads, seen)
        runs.append(run)
    return runs


def test_bf16_step_with_jax_bf16_picks_follows_jax(bf16):
    """One bf16 step of v0_1-n at step 4, the port's routing pinned to JAX
    bf16's picks: the gradient tree's rel-RMS from JAX fp32 (squared distances
    summed over the batches) within 1.5x JAX bf16's own; every loss term's RMS
    distance from JAX fp32 within max(1.5x JAX bf16's, 2^-8 of its RMS)."""
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


def _flips(a, b) -> int:
    """(sample, block) pairs whose kept-expert sets differ."""
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))


def test_bf16_routing_flips_between_the_bf16_programs(bf16):
    """Unpinned, the port's bf16 step keeps a different top-2 set from JAX
    bf16's for 4 of the 96 (sample, block) pairs (8 batches x 4 samples x 3
    blocks), all in layers.11 (E=16), and from JAX fp32's for the same 4; JAX's
    bf16 and fp32 keep the same sets for all 96 (measured). Not a cast: the
    router logits of the port's bf16 lie 0.90-0.97x as far from JAX fp32's as
    JAX bf16's do (rel-RMS per block over these batches: 2-12%), and a flipped
    pair's second and third noisy logits lie within those errors of each
    other (the third batch's two flips: 0.07 and 0.14 apart in JAX fp32,
    against bf16 logit errors of up to 0.08 in either program)."""
    pairs = (("free", "jax16"), ("free", "jax32"), ("jax16", "jax32"))
    counts = tuple(sum(_flips(run[a][2], run[b][2]) for run in bf16) for a, b in pairs)
    assert all(len(run["free"][2]) == len(run["jax16"][2]) == 3 for run in bf16)
    assert counts == (4, 4, 0), counts
    assert sum(_flips(run["free"][2][:2], run["jax16"][2][:2]) for run in bf16) == 0  # layers.5 and .8: none
