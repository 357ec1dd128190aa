"""The port's AdaptiveGate family (yolo_master_tpu_torch/nn/moe/gated.py) against
the JAX package's, one module at a time, in eval on the CPU in fp32.

Every class of the JAX ``nn/moe/gated.py`` is a case: the routers, the expert
backends, the detail gate, the context mixer, the cross-path gate and the
thirteen blocks, those that switch backend on the expert count at E=4 (fused
experts) and E=16 (shared-inverted). Width 32, on a square [2, 32, 8, 8] and a
non-square [2, 32, 6, 10] input (the mixer also on [2, 32, 8, 4], where W
equals its pool scale 4 and it pools all the same, as the JAX block tests
only H). Weights: the init's distributions, then every constant leaf (norm
affines, BN statistics, the learned scalars, the expert prior and affines,
CrossPathGate's zeroed last layer) drawn at random from a seed, so that no
branch sits at its neutral value. The weights start from the port's seeded
init carried into ``jax.eval_shape``'s tree (the JAX init's compile takes
seconds a block), and both shapes share them. Gate: max |port - JAX| <= 1e-5 (a block whose
routing parted from JAX's would be off by far more); the routers' expert picks
equal.
"""

import functools
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import gated as jg
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.nn.moe import gated as tg
from yolo_master_tpu_torch.nn.tasks import init_weights

from test_torch_model import _load_module  # noqa: E402 (tests/ is on the path)

CTX = Context(training=False)
C = 32
SHAPES = ((2, 8, 8, C), (2, 6, 10, C))  # NHWC: square, non-square
TOL = 1e-5
ROUTERS = ("ZeroCostRouter", "UltraLightRouter", "DualStreamGateRouter", "DualStreamGateRouterV2", "MultiHeadRouterV3")
EXPERTS = ("FusedExpertGroup", "MatMulFusedExperts", "LowRankFusedExpertGroup", "SharedInvertedExpertGroup",
           "DiversifiedExpertGroup")
# blocks whose experts switch backend at fused_expert_threshold (8): run at E=4 and E=16
SWITCHING = ("HybridAdaptiveGateMoE", "HybridAdaptiveGateMoEv2", "LowRankHybridAdaptiveGateMoE",
             "RefinedLowRankHybridAdaptiveGateMoE", "ContextRefinedLowRankHybridAdaptiveGateMoE",
             "VisualEnhancedAdaptiveGateMoE", "DetailAwareLowRankHybridAdaptiveGateMoE", "OptimalHybridGateMoE",
             "MultiHeadRouterMoE", "GatedFusionMoE")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cases():
    cases = {}
    for name in ROUTERS:
        cases[name] = (lambda n=name: (getattr(jg, n)(C, 8, 2), getattr(tg, n)(C, 8, 2)), "router")
    for name in EXPERTS:
        cases[name] = (lambda n=name: (getattr(jg, n)(C, C // 2, 4, top_k=2), getattr(tg, n)(C, C // 2, 4, top_k=2)),
                       "experts")
    for name in ("VisualDetailGate", "PyramidContextMixer"):
        cases[name] = (lambda n=name: (getattr(jg, n)(C), getattr(tg, n)(C)), "map")
    cases["CrossPathGate"] = (lambda: (jg.CrossPathGate(C // 2, C // 2, C), tg.CrossPathGate(C // 2, C // 2, C)),
                              "two_maps")
    for name in tg.GATED_BLOCKS:
        for e in ((4, 16) if name in SWITCHING else (4,)):
            cases[f"{name}-E{e}"] = (lambda n=name, e=e: (getattr(jg, n)(C, C, e, 2), getattr(tg, n)(C, C, e, 2)),
                                     "block")
    return cases


CASES = _cases()


def randomize_constants(tree, rng):
    """Every leaf whose elements are all equal (norm affines, BN statistics,
    scalars, the expert prior and affines, zero-init layers) drawn at random:
    scales and variances U(0.5, 1.5), the rest N(0, 0.3)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_constants(v, rng)
            continue
        v = np.asarray(v)
        if v.size and np.all(v == v.flat[0]):
            v = (rng.uniform(0.5, 1.5, v.shape) if k in ("scale", "var", "expert_norm_weight")
                 else rng.normal(0.0, 0.3, v.shape)).astype(np.float32)
        out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def module_pair(name, seed=0):
    """(JAX module, its params, the port module loaded with them, kind): the
    port's seeded init (the JAX init's distributions) carried into
    ``jax.eval_shape``'s tree of the JAX module (strict; no JAX init compile),
    its constant leaves randomized, and loaded back into the port."""
    make, kind = CASES[name]
    jm, tm = make()
    jm = jm.finalize("m")
    init_weights(tm, torch.Generator().manual_seed(seed))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    p = jax.tree_util.tree_map(np.asarray, import_state_dict(shapes, tm.state_dict(), strict=True))
    p = randomize_constants(p, np.random.default_rng(seed))
    return jm, p, _load_module(tm, p), kind


def routing_inputs(rng, b, k=2, e=4):
    """Top-k weights (renormalised, distinct indices) for the expert backends."""
    idx = np.stack([rng.permutation(e)[:k] for _ in range(b)]).astype(np.int32)
    w = rng.uniform(0.2, 1.0, (b, k)).astype(np.float32)
    return w / w.sum(1, keepdims=True), idx


def jax_and_port(jm, p, tm, kind, shape, rng, dtype=jnp.float32):
    """Run both modules on the same seeded input of ``shape`` (NHWC): [(port, JAX)]
    output pairs as numpy NHWC arrays, and the (port, JAX) picks where there are."""
    x = rng.standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    xj = jnp.asarray(x)
    if dtype != jnp.float32:
        xt = xt.to(torch.bfloat16)
        xj = jnp.asarray(xt.float().permute(0, 2, 3, 1).numpy()).astype(dtype)
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    picks = None
    with torch.no_grad():
        if kind == "router":
            w, idx, _ = jax.jit(lambda p, x: jm(p, x, CTX, temperature=0.5))(p, xj)
            tw, tidx = tm(xt, temperature=0.5)
            pairs, picks = [(tw, w)], (tidx.numpy(), np.asarray(idx))
        elif kind == "experts":
            w, idx = routing_inputs(rng, shape[0])
            ref = jax.jit(lambda p, x, w, i: jm(p, x, CTX, w, i, 2))(p, xj, jnp.asarray(w), jnp.asarray(idx))
            pairs = [(nhwc(tm(xt, torch.from_numpy(w), torch.from_numpy(idx).long())), ref)]
        elif kind == "two_maps":
            h = shape[-1] // 2
            ref = jax.jit(lambda p, x: jm(p, x[..., :h], x[..., h:], CTX))(p, xj)
            pairs = [(nhwc(tm(xt[:, :h], xt[:, h:])), ref)]
        else:
            pairs = [(nhwc(tm(xt)), jax.jit(lambda p, x: jm(p, x, CTX))(p, xj))]
    out = [(o.float().numpy(), np.asarray(jnp.asarray(r).astype(jnp.float32))) for o, r in pairs]
    return out, picks


@pytest.mark.parametrize("shape", SHAPES, ids=["square", "non_square"])
@pytest.mark.parametrize("name", list(CASES))
def test_gated_module_matches_jax(name, shape):
    jm, p, tm, kind = module_pair(name)
    rng = np.random.default_rng(zlib.crc32(f"{name}{shape}".encode()))
    pairs, picks = jax_and_port(jm, p, tm, kind, shape, rng)
    if picks is not None:
        np.testing.assert_array_equal(*picks)
    for out, ref in pairs:
        assert out.shape == ref.shape and np.isfinite(out).all()
        assert np.abs(out - ref).max() <= TOL, np.abs(out - ref).max()


def test_context_mixer_pools_where_w_equals_the_scale():
    """[2, 32, 8, 4]: H divides by 4 and exceeds it, W equals it: JAX pools the
    4x4 windows (to 2x1) and upsamples back; so does the port."""
    jm, p, tm, kind = module_pair("PyramidContextMixer")
    pairs, _ = jax_and_port(jm, p, tm, kind, (2, 8, 4, C), np.random.default_rng(3))
    out, ref = pairs[0]
    assert np.abs(out - ref).max() <= TOL


def test_backend_switch_and_parameter_names_follow_the_reference():
    """E <= 8: the fused experts (low-rank from v0_7), E > 8: shared-inverted;
    the reference's Sequential slots in the state_dict; DiversifiedExpertGroup's
    dilations 1, 1, 2, 2, ..."""
    v10 = {e: tg.VisualEnhancedAdaptiveGateMoE(C, C, e, 2) for e in (4, 16)}
    assert isinstance(v10[4].fused_experts, tg.LowRankFusedExpertGroup)
    assert isinstance(v10[16].fused_experts, tg.SharedInvertedExpertGroup)
    keys = set(v10[4].state_dict())
    for k in ("se_gate.2.weight", "se_gate.4.bias", "complexity_estimator.1.weight", "feature_gate.1.weight",
              "feature_gate.3.bias", "context_mixer.context_gate.0.weight", "context_mixer.context_scale",
              "detail_gate.detail_filter.5.bias", "routing.alpha", "refine_scale",
              "fused_experts.fused.expert_norm_weight", "static_net.1.running_var"):
        assert k in keys, k
    g = tg.GatedFusionMoE(C, C, 4, 2)
    assert {"cross_gate.gate_net.2.weight", "cross_gate.gate_net.4.bias", "cross_gate.drop_scale",
            "refine_gate.1.weight", "refine_gate.3.bias", "routing.expert_prior"} <= set(g.state_dict())
    v3 = tg.MultiHeadRouterMoE(C, C, 4, 2)
    assert "routing.global_proj.weight" in v3.state_dict() and "routing.global_fc.weight" not in v3.state_dict()
    assert tg.DiversifiedExpertGroup(C, C, 5).dilations == [1, 1, 2, 2, 3]
    assert not any("dw_dilations" in k for k in tg.DiversifiedExpertMoE(C, C, 4, 2).state_dict())


def test_a_gated_block_refuses_training():
    """Kept under its name from when training raised: a block in train mode now
    trains, and its train-mode forward at step 0 (its output and its aux loss)
    matches JAX's within 1e-5 on these weights (tests/test_torch_gated_train.py
    holds every block, the gradients and the draws)."""
    import copy

    jm, p, tm, _ = module_pair("VisualEnhancedAdaptiveGateMoE-E4")
    m = copy.deepcopy(tm).train()
    m.jax_path, m.routing.jax_path = "m", "m.routing"
    x = np.random.default_rng(7).standard_normal((2, 8, 8, C)).astype(np.float32)

    def ref(p, x):
        ctx = Context(training=True, step=0)
        return jm(p, x, ctx), ctx.total_aux()

    y, aux = jax.jit(ref)(p, jnp.asarray(x))
    with torch.no_grad():
        out = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(out - np.asarray(y)).max() <= TOL
    assert abs(float(m.aux_record.value) - float(aux)) <= TOL
