"""yolo-master-v0_1's training form in the port (nn/moe/mixtures.py,
utils/jax_random.py) against the JAX package, on the CPU in fp32.

1. The generator: keys, fold_in, split, bits and permutations bit for bit
   against ``jax.random`` on v0_1-n's block keys; ``normal`` too (0 of the
   draws differ: the port follows the erfinv of XLA's CPU backend, log1p and
   fused multiply-adds included).
2. OptimizedMOEImproved in train mode at c = 32, E = 4, 8 and 16, at steps
   covering k = E, the middle of the warmup, a dropout step and a step after
   the warmup without dropout, detach_routing on and off: the rank mask and
   the dropout mask exactly equal; the output, the routing weights and
   probabilities, the aux loss and the gradients with respect to the input
   and every parameter within 1e-5 of the tensor's largest |JAX| value (the
   port's own fp32 rounding against fp64 is ~1e-7 of it; a wrong rule, such as
   the noise on the clamped logits or the counts taken before dropout, moves
   them by a large share).
3. Progressive sparsity: JAX's compiled value at every step of the warmup.

Both packages take the same short schedule, warmup_steps 10 and
dropout_interval 5, set on their instances.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import mixtures as jmix
from yolo_master_tpu_torch.nn.moe import mixtures as tmix
from yolo_master_tpu_torch.utils import jax_random as jr

from test_torch_model import _load_module, _np_tree, _perturb_bn  # noqa: E402 (tests/ is on the path)

PATHS = ("layers.5", "layers.8", "layers.11")  # v0_1-n's three routed blocks in the JAX package
STEPS = (0, 1, 99, 100, 5000, 123457)
WARMUP, INTERVAL = 10, 5
MODULE_STEPS = (0, 5, 10, 13)  # k = E; mid-warmup; after it, a dropout step; after it, none
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _seed(path: str) -> int:
    return zlib.crc32(path.encode()) & 0x7FFFFFFF


# -- 1. the generator --------------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_keys_bits_and_permutations_match_jax_random(path):
    """PRNGKey, fold_in (the block key and its dropout key), split, random bits
    and the permutations of 4, 8 and 16 (and of 5000, two sort rounds), bit for bit."""
    for step in STEPS:
        key = tmix.path_key(path, step)
        jkey = jax.random.fold_in(jax.random.PRNGKey(_seed(path)), jnp.asarray(step, jnp.uint32))
        np.testing.assert_array_equal(jr.PRNGKey(_seed(path)), np.asarray(jax.random.PRNGKey(_seed(path))))
        np.testing.assert_array_equal(key, np.asarray(jkey))
        np.testing.assert_array_equal(jr.split(key, 3), np.asarray(jax.random.split(jkey, 3)))
        np.testing.assert_array_equal(jr.random_bits(key, (3, 7)), np.asarray(jax.random.bits(jkey, (3, 7))))
        np.testing.assert_array_equal(jr.uniform(key, (5, 4)), np.asarray(jax.random.uniform(jkey, (5, 4))))
        for n in (4, 8, 16, 5000):
            np.testing.assert_array_equal(jr.permutation(jr.fold_in(key, 1), n),
                                          np.asarray(jax.random.permutation(jax.random.fold_in(jkey, 1), n)))


@pytest.mark.parametrize("path", PATHS)
def test_normal_matches_jax_random(path):
    """normal of [B, E] at each step, and 65,536 draws, equal jax.random.normal
    bit for bit: the count of differing values and the largest difference
    are both 0."""
    differ, largest = 0, 0.0
    for step in STEPS:
        key = tmix.path_key(path, step)
        jkey = jax.random.fold_in(jax.random.PRNGKey(_seed(path)), jnp.asarray(step, jnp.uint32))
        for shape in ((4, 16), (2, 8), (65536,)):
            got, ref = jr.normal(key, shape), np.asarray(jax.random.normal(jkey, shape))
            assert got.dtype == np.float32 and got.shape == ref.shape
            differ += int((got != ref).sum())
            largest = max(largest, float(np.abs(got - ref).max()))
    assert differ == 0 and largest == 0.0, (differ, largest)


# -- 3. progressive sparsity ------------------------------------------------------------------------

def test_adaptive_top_k_matches_jax():
    """tests/test_model_configs.py's values (E=4, warmup 100: steps 0, 50, 99,
    1000 -> 4, 3, 2, 2), eval and progressive_sparsity=False give top_k, and
    JAX's compiled value at every step 0..warmup+1 of several schedules,
    among them E=16, top_k=2, warmup 7, step 4, where a float64 quotient
    floors to 8 and JAX's float32 to 7."""
    m = tmix.OptimizedMOEImproved(32, 32, num_experts=4, top_k=2, warmup_steps=100)
    for step, k in ((0, 4), (50, 3), (99, 2), (1000, 2)):
        m.step = step
        assert m.adaptive_top_k() == k
    m.progressive_sparsity = False
    assert m.adaptive_top_k() == 2
    assert tmix.adaptive_top_k(4, 16, 2, 7) == 7 and int(np.floor(16 - 4 / 7 * 14)) == 8
    for e, k, w in ((4, 2, 10), (8, 2, 10), (16, 2, 10), (16, 2, 7), (16, 2, 777), (16, 1, 30), (8, 2, 5000)):
        jm = jmix.OptimizedMOEImproved(32, 32, num_experts=e, top_k=k, warmup_steps=w)
        steps = np.arange(w + 2)
        ref = jax.jit(jax.vmap(lambda s: jm._adaptive_top_k(Context(training=True, step=s))))(steps.astype(np.int32))
        got = [tmix.adaptive_top_k(int(s), e, k, w) for s in steps]
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=f"E={e} top_k={k} warmup={w}")


# -- 2. the block in train mode ----------------------------------------------------------------------

def _capture(monkeypatch, module, seen):
    """Record process_logits' and moe_aux_loss' inputs and outputs in ``module``'s namespace."""
    pl, aux = module.process_logits, module.moe_aux_loss

    def process_logits(*a, **k):
        out = pl(*a, **k)
        seen["w0"], seen["probs"], seen["logits"] = out
        return out

    def moe_aux_loss(probs, logits, keep_mask, *a, **k):
        seen["keep"] = keep_mask
        out = aux(probs, logits, keep_mask, *a, **k)
        seen["aux"] = out
        return out

    monkeypatch.setattr(module, "process_logits", process_logits)
    monkeypatch.setattr(module, "moe_aux_loss", moe_aux_loss)


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert np.abs(got - ref).max() <= REL * scale, (what, float(np.abs(got - ref).max()), scale)


@pytest.mark.parametrize("detach", [False, True], ids=["routed", "detached"])
@pytest.mark.parametrize("num_experts", [4, 8, 16])
def test_block_trains_like_jax(monkeypatch, num_experts, detach):
    """One OptimizedMOEImproved (c=32, top_k 2, 8x12 maps, B=4) in train mode,
    loss sum(out * ct) + aux, at each step of MODULE_STEPS: the masks exactly,
    the rest within 1e-5 of max |JAX| (module docstring)."""
    _block_trains_like_jax(monkeypatch, np.random.default_rng(16 + num_experts),
                           dict(num_experts=num_experts, top_k=2, detach_routing=detach))


@pytest.mark.parametrize("expert_type,router_type", [("ghost", "efficient"), ("inverted", "efficient"),
                                                     ("spatial", "efficient"), ("simple", "local"),
                                                     ("simple", "adaptive"), ("ghost", "local"),
                                                     ("spatial", "adaptive")])
def test_expert_and_router_types_train_like_jax(monkeypatch, expert_type, router_type):
    """The ghost, inverted-residual and spatial experts (their GroupNorms and
    depthwise convs in training) and the local and adaptive routers (their
    BatchNorms on batch statistics), E = 8, router noise on, every draw JAX's:
    the test above's gates, at each step of MODULE_STEPS. The norm affines and
    BN biases are drawn at random (``randomize_constants``), so that no
    gradient is 0 by symmetry."""
    from test_torch_gated import randomize_constants

    _block_trains_like_jax(monkeypatch, np.random.default_rng(len(expert_type) * 7 + len(router_type)),
                           dict(num_experts=8, top_k=2, expert_type=expert_type, router_type=router_type),
                           randomize=randomize_constants)


def _block_trains_like_jax(monkeypatch, rng, kw, randomize=None):
    kw = dict(kw, warmup_steps=WARMUP, dropout_interval=INTERVAL)
    num_experts = kw["num_experts"]
    jm = jmix.OptimizedMOEImproved(32, 32, **kw).finalize("layers.8")
    p = _perturb_bn(_np_tree(jax.jit(jm.init)(jax.random.PRNGKey(3))), rng)
    if randomize is not None:
        p = randomize(p, rng)
    tm = _load_module(tmix.OptimizedMOEImproved(32, 32, **kw), p).train()
    tm.jax_path = "layers.8"
    x = rng.standard_normal((4, 8, 12, 32)).astype(np.float32)
    ct = rng.standard_normal((4, 8, 12, 32)).astype(np.float32)

    jseen = {}
    _capture(monkeypatch, jmix, jseen)

    def jloss(params, x, step):
        ctx = Context(training=True, step=step)
        y = jm(params, x, ctx)
        return jnp.sum(y * ct) + ctx.total_aux(), (y, dict(jseen))

    grad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    tseen = {}
    _capture(monkeypatch, tmix, tseen)
    dropped_any = False
    for step in MODULE_STEPS:
        (_, (jy, js)), (gp, gx) = grad(p, x, jnp.int32(step))
        k = num_experts if step == 0 else int(jm._adaptive_top_k(Context(training=True, step=step)))
        tm.step = step
        for prm in tm.parameters():
            prm.grad = None
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).requires_grad_()
        ty = tm(tx)
        ((ty.permute(0, 2, 3, 1) * torch.from_numpy(ct)).sum() + tm.aux_record.value).backward()
        rank_mask = (tseen["w0"] > 0).numpy()
        np.testing.assert_array_equal(rank_mask, np.asarray(js["w0"]) > 0, err_msg=f"rank mask, step {step}")
        assert (rank_mask.sum(-1) == tm.adaptive_top_k()).all() and tm.adaptive_top_k() == k
        np.testing.assert_array_equal(tseen["keep"].numpy(), np.asarray(js["keep"]), err_msg=f"keep, step {step}")
        dropped = tm.dropped_experts()
        dropped_any |= dropped.size > 0
        assert (dropped.size > 0) == (step >= WARMUP and step % INTERVAL == 0)
        assert not tseen["keep"].numpy()[:, dropped].any()
        _close(ty.detach().permute(0, 2, 3, 1), jy, f"forward, step {step}")
        for name in ("w0", "probs", "logits", "aux"):
            _close(tseen[name].detach(), js[name], f"{name}, step {step}")
        np.testing.assert_allclose(tm.aux_record.usage.numpy(), np.asarray(js["probs"]).mean(0), rtol=1e-6)
        _close(tx.grad.permute(0, 2, 3, 1), gx, f"input gradient, step {step}")
        ref = _grads_by_name(gp)
        for n, prm in tm.named_parameters():
            _close(prm.grad, ref[n], f"{n} gradient, step {step}")
    assert dropped_any


def _grads_by_name(gp):
    from yolo_master_tpu_torch.utils.weights import state_dict_from_jax

    sd = state_dict_from_jax({"layers": {"0": _np_tree(gp)}})
    return {k[len("model.0."):]: v.numpy() for k, v in sd.items()}


def test_draws_follow_step_batch_and_settings():
    """A block's draws are kept for its step and batch size, and made anew when
    either or a setting they depend on changes (calibrate_bn routes with the
    noise off, then turns it back on): the noise is normal(key, [B, E]) x
    noise_std, the keep mask zero at the dropped experts."""
    m = tmix.OptimizedMOEImproved(32, 32, num_experts=8, warmup_steps=WARMUP, dropout_interval=INTERVAL).train()
    m.jax_path = "layers.8"
    m.noise_std = 0.0
    assert m.draws(2, "cpu") == (None, None)
    m.noise_std = 0.5
    noise, keep = m.draws(2, "cpu")
    np.testing.assert_array_equal(noise.numpy(), jr.normal(tmix.path_key("layers.8", 0), (2, 8)) * np.float32(0.5))
    assert keep is None and m.draws(3, "cpu")[0].shape == (3, 8)
    m.step = 2 * INTERVAL
    noise, keep = m.draws(2, "cpu")
    dropped = jr.permutation(jr.fold_in(tmix.path_key("layers.8", m.step), 1), 8)[:1]
    np.testing.assert_array_equal(keep.numpy(), np.isin(np.arange(8), dropped, invert=True).astype(np.float32))
    np.testing.assert_array_equal(noise.numpy(), jr.normal(tmix.path_key("layers.8", m.step), (2, 8)) * np.float32(0.5))
