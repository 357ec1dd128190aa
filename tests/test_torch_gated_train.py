"""The AdaptiveGate family's training form in the port (nn/moe/gated.py,
utils/jax_random.py:randint) against the JAX package, on the CPU in fp32.

1. ``randint`` bit for bit ``jax.random.randint`` across shapes, spans 1-17
   (and int32's whole range) and many keys.
2. The draws bit for bit JAX's: the V2/V3 router noise
   ``normal(_path_key(step, router path)) * noise_std * decay`` (decay in
   XLA's float32, a fused multiply-subtract), V3's dropout flags and slots
   and v0_15's drop-path mask, at the router's path (``m.routing``), not the
   block's; the temperature anneal within 1 fp32 ulp of XLA's (its cos).
3. Each of the thirteen blocks alone (C = 32, E = 4, top-2, [3, 8, 8] maps)
   in train mode at steps 0, 1, 999, 1000 and 2500 (the noise at full, just
   above 0 and 0; the anneal at its start, its middle and its end), loss
   sum(out * ct) + aux, on test_torch_gated.py's weights (every constant
   leaf drawn at random): the output, the aux value, the usage (mean of the
   router's probabilities), the router's probabilities and logits and the
   BatchNorm running statistics within 1e-5 (tests/test_torch_gated.py's fp32 gate), the top-k
   picks equal, and the gradient of the input and of every parameter
   within 1e-6 + 2e-5 x the tensor's largest |JAX| (tests/test_torch_train_step.py's trajectory gate;
   complexity_estimator, behind a round, has none in either package).
   V3's ``expert_dropout`` and v0_15's ``drop_prob`` are set to 0.5 on both
   packages' instances, so that both fire in the batch at some steps.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import gated as jg
from yolo_master_tpu.nn.moe.mixtures import _path_key
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.nn.moe import gated as tg
from yolo_master_tpu_torch.nn.tasks import init_weights
from yolo_master_tpu_torch.utils import jax_random as jr

from test_torch_gated import randomize_constants  # noqa: E402 (tests/ is on the path)
from test_torch_model import _load_module  # noqa: E402
from test_torch_moe_train import _grads_by_name  # noqa: E402

C, E, K = 32, 4, 2
SHAPE = (3, 8, 8, C)  # NHWC
STEPS = (0, 1, 999, 1000, 2500)
TOL = 1e-5
G_ABS, G_REL = 1e-6, 2e-5
HIGH = 0.5  # expert_dropout (V3) and drop_prob (v0_15) in these tests, so that both fire


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- 1. randint -------------------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_randint_matches_jax_random(seed):
    """Bit for bit, over 24 keys a seed, three shapes and the bounds below."""
    bounds = [(0, s) for s in range(1, 18)] + [(-5, 12), (7, 7), (9, 2), (-2**31, 2**31 - 1), (3, 2**31 - 1)]
    rng = np.random.default_rng(seed)
    differ = 0
    for _ in range(24):
        s, step = int(rng.integers(0, 2**31)), int(rng.integers(0, 2**32))
        key = jr.fold_in(jr.PRNGKey(s), step)
        jkey = jax.random.fold_in(jax.random.PRNGKey(s), jnp.asarray(step, jnp.uint32))
        for shape in ((3, 1), (16,), (2, 5, 3)):
            for lo, hi in bounds:
                got, ref = jr.randint(key, shape, lo, hi), np.asarray(jax.random.randint(jkey, shape, lo, hi))
                assert got.dtype == np.int32 and got.shape == ref.shape
                differ += int((got != ref).sum())
    assert differ == 0


# -- 2. the draws --------------------------------------------------------------------------------------

@jax.jit
def _jax_draws(step):
    """The draws of gated.py:159-163, :688-691 and :841 for the paths of test 3."""
    decay = jnp.clip(1.0 - jnp.asarray(step, jnp.float32) / 1000.0, 0.0, 1.0)
    noise = jax.random.normal(_path_key(step, "m.routing"), (3, E)) * 0.1 * decay
    k1, k2 = jax.random.split(_path_key(step + 1, "m.routing"))
    drop = jax.random.uniform(k1, (3, 1)) < HIGH
    slot = jax.random.randint(k2, (3, 1), 0, K)
    path_drop = jax.random.uniform(_path_key(step + 2, "m"), (3, 1, 1, 1)) < HIGH
    return noise, drop, slot, path_drop


def test_draws_match_jax_bit_for_bit():
    """At every step of 0..2100 in strides and at test 3's: the noise, the dropout
    flags and slots and the drop-path mask equal JAX's; the anneal within 1 ulp."""
    v3 = tg.MultiHeadRouterMoE(C, C, E, K, expert_dropout=HIGH)
    v15 = tg.GatedFusionMoE(C, C, E, K, drop_prob=HIGH)
    v3.jax_path, v3.routing.jax_path, v15.jax_path = "m", "m.routing", "m"
    jm = jg.AdaptiveGateMoE(C, C, E, K)
    temps = jax.jit(jax.vmap(lambda s: jm._temperature(Context(training=True, step=s))))
    steps = sorted(set(range(0, 2101, 7)) | set(STEPS))
    ref_t = np.asarray(temps(np.asarray(steps, np.int32)))
    port = tg.AdaptiveGateMoE(C, C, E, K)
    for step, rt in zip(steps, ref_t):
        noise, drop, slot, path_drop = (np.asarray(a) for a in _jax_draws(jnp.int32(step)))
        v3.step = v3.routing.step = v15.step = step
        host = v3.routing.host_draws(3)
        np.testing.assert_array_equal(host[:, :E], noise, err_msg=f"noise, step {step}")
        d, s = v3.routing.dropout_draws(3)
        np.testing.assert_array_equal(d, drop)
        np.testing.assert_array_equal(s, slot)
        np.testing.assert_array_equal(host[:, E:], np.where(drop & (np.arange(K) == slot), 0.5, 1.0))
        scale = v15.drop_path_scale(3)
        np.testing.assert_array_equal(scale == 0, path_drop.reshape(3))
        assert np.all(scale[scale > 0] == np.float32(1 / (1 - HIGH)))
        port.step = step
        assert abs(port.temperature() - float(rt)) <= float(np.spacing(np.float32(rt))), (step, port.temperature(), rt)


# -- 3. the blocks --------------------------------------------------------------------------------------

def _settings(name):
    if name == "MultiHeadRouterMoE":
        return ("routing", "expert_dropout")
    if name == "GatedFusionMoE":
        return ("cross_gate", "drop_prob")
    return None


def block_pair(name, seed=0):
    """(JAX block at path "m", its params, the port's block with them), the port's
    seeded init carried into jax.eval_shape's tree, its constant leaves drawn at
    random (test_torch_gated.py's weights), and the dropout set HIGH on both."""
    jm, tm = getattr(jg, name)(C, C, E, K), getattr(tg, name)(C, C, E, K)
    jm = jm.finalize("m")
    init_weights(tm, torch.Generator().manual_seed(seed))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    p = jax.tree_util.tree_map(np.asarray, import_state_dict(shapes, tm.state_dict(), strict=True))
    p = randomize_constants(p, np.random.default_rng(seed))
    tm = _load_module(tm, p).train()
    tm.jax_path, tm.routing.jax_path = "m", "m.routing"
    setting = _settings(name)
    if setting:
        for mod in (jm, tm):
            setattr(getattr(mod, setting[0]), setting[1], HIGH)
    return jm, p, tm


def _capture(monkeypatch, seen):
    """Record the JAX block's picks and router stats (its aux inputs) as it publishes them."""
    orig = jg.AdaptiveGateMoE._publish_aux

    def publish(self, ctx, stats, w, idx):
        seen.update(idx=idx, probs=stats["router_probs"], logits=stats["router_logits"])
        return orig(self, ctx, stats, w, idx)

    monkeypatch.setattr(jg.AdaptiveGateMoE, "_publish_aux", publish)


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    assert np.abs(got - ref).max() <= tol, (what, float(np.abs(got - ref).max()))


def _grad_close(got, ref, what):
    got = np.zeros_like(ref) if got is None else np.asarray(got, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= G_ABS + G_REL * scale, (what, err, scale)


@pytest.mark.parametrize("name", list(tg.GATED_BLOCKS))
def test_block_trains_like_jax(name, monkeypatch):
    jm, p, tm = block_pair(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.standard_normal(SHAPE).astype(np.float32)
    ct = rng.standard_normal(SHAPE).astype(np.float32)
    seen = {}
    _capture(monkeypatch, seen)

    def jloss(params, x, step):
        ctx = Context(training=True, step=step)
        y = jm(params, x, ctx)
        aux = ctx.total_aux()
        return jnp.sum(y * ct) + aux, (y, aux, ctx.stats["m"]["expert_usage"], ctx.updates, dict(seen))

    grad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    port_seen = {}
    route = tm.routing.forward

    def recorded(*a, **k):
        out = route(*a, **k)
        port_seen.update(idx=out[1], probs=out[2], logits=out[3])
        return out

    tm.routing.forward = recorded
    bns = {n: m for n, m in tm.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    start = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in bns.items()}
    fired = set()
    for step in STEPS:
        (_, (jy, jaux, jusage, jupd, js)), (gp, gx) = grad(p, x, jnp.int32(step))
        with torch.no_grad():
            for n, m in bns.items():  # each step's update from the same statistics, as JAX's from p
                m.running_mean.copy_(start[n][0])
                m.running_var.copy_(start[n][1])
        tm.step = step
        for prm in tm.parameters():
            prm.grad = None
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).requires_grad_()
        ty = tm(tx)
        rec = tm.aux_record
        ((ty.permute(0, 2, 3, 1) * torch.from_numpy(ct)).sum() + rec.value).backward()
        _close(ty.detach().permute(0, 2, 3, 1), jy, f"forward, step {step}")
        _close(rec.value.detach(), jaux, f"aux, step {step}")
        _close(rec.usage, jusage, f"usage, step {step}")
        np.testing.assert_array_equal(port_seen["idx"].numpy(), np.asarray(js["idx"]), err_msg=f"picks, step {step}")
        _close(port_seen["probs"].detach(), js["probs"], f"router probabilities, step {step}")
        _close(port_seen["logits"].detach(), js["logits"], f"router logits, step {step}")
        assert rec.family == "moe" and rec.stat is None
        for n, m in bns.items():
            upd = jupd[f"m.{n}"]
            _close(m.running_mean, upd["mean"], f"{n} running mean, step {step}")
            _close(m.running_var, upd["var"], f"{n} running var, step {step}")
        router, own = tm.draws(SHAPE[0], "cpu")
        if name == "MultiHeadRouterMoE":
            fired.update(bool(v) for v in (router[:, E:] == 0.5).any(1))
        if name == "GatedFusionMoE":
            fired.update(bool(v) for v in (own[:, 0] == 0))
        _grad_close(tx.grad.permute(0, 2, 3, 1), np.asarray(gx), f"input gradient, step {step}")
        ref = _grads_by_name(gp)
        for n, prm in tm.named_parameters():
            _grad_close(prm.grad, ref[n], f"{n} gradient, step {step}")
    if _settings(name):
        assert fired == {True, False}, fired  # the dropout fired on some samples and spared others


def test_a_gated_block_trains_and_evaluates_as_before():
    """A block in train mode trains (aux published, its draws at its step); in eval
    its forward is the eval form, whatever step it last trained at; with
    ``calibrating`` (calibrate_bn's pass) a train-mode block runs the eval form
    on batch statistics, draws nothing and publishes nothing."""
    m = tg.VisualEnhancedAdaptiveGateMoE(C, C, E, K).train()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, C, 8, 8)).astype(np.float32))
    m.step = 1500
    y = m(x)
    assert m.aux_record is not None and y.shape == x.shape
    m.aux_record, m._draws = None, None
    m.calibrating = True
    with torch.no_grad():
        m(x)
    assert m.aux_record is None and m._draws is None
    m.calibrating = False
    m.eval()
    with torch.no_grad():
        ref = m(x)
        m.step = 0
        assert torch.equal(m(x), ref) and m.aux_record is None
