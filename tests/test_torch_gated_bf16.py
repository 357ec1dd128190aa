"""The AdaptiveGate family in bf16: the port's bf16 copy against the JAX
package's bf16 (fp32 parameters, per-op casts), on the CPU.

The tolerances are tests/test_torch_bf16.py's (PERF.md §7):

1. each block class on its own (E=4; v0_10's block and two others also at
   E=16, the shared-inverted experts), and the detail gate, context mixer and
   cross-path gate, on the same bf16 input and weights: max |port - JAX|
   within 4 * 2^-8 * max |JAX|. The detail gate's 3x3 average rounds twice in
   bf16 in JAX (the window sum cast to bf16, then divided by 9), and so does
   the port's ``avg_pool``;
2. v0_10-n whole, BN calibrated, a batch of 8 at 64 px: the rel-RMS of the
   port's bf16 head outputs from JAX's fp32 within 1.5x that of JAX's own
   bf16, box and class logits apart, with the port's routing pinned to JAX's
   bf16 routing: both the top-k picks and the complexity gate's kept count of
   each block (the two bf16 programs may part where a rounding flips a pick);
   the unpinned flips are counted;
3. the bf16 copy keeps fp32 what JAX reads in fp32: the blocks' scalars, the
   expert prior and the fused experts' affines, the Linears, LayerNorms and
   GroupNorms; the convs become bf16.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.nn import layers as tlayers
from yolo_master_tpu_torch.nn.moe import gated as tg
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils.fuse import compute_dtype_copy
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_bf16 import MODULE_TOL, _f32, _rel_rms  # noqa: E402
from test_torch_cuda import _gated_routing  # noqa: E402
from test_torch_gated import jax_and_port, module_pair  # noqa: E402

BF16 = torch.bfloat16
CTX = Context(training=False)
V10 = "yolo-master-v0_10-n"
GATED_LAYERS = (5, 8, 11)
MODULES = ["VisualDetailGate", "PyramidContextMixer", "CrossPathGate",
           *(f"{n}-E4" for n in tg.GATED_BLOCKS),
           "VisualEnhancedAdaptiveGateMoE-E16", "MultiHeadRouterMoE-E16", "GatedFusionMoE-E16"]
# v0_10-n's (sample, block) routings of the batch of 8 (top-k set or kept count) that differ between
# the port's bf16 program and JAX's, at layers 5, 8, 11 (measured)
FLIPS = [0, 0, 1]
JAX_FLIPS = [0, 0, 2]  # the same count between JAX's bf16 and fp32 programs (measured)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- 1. the modules ---------------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODULES)
def test_gated_module_matches_jax_in_bf16(name):
    jm, p, tm, kind = module_pair(name)
    tb = compute_dtype_copy(tm, BF16)
    pairs, _ = jax_and_port(jm, p, tb, kind, (2, 8, 8, 32), np.random.default_rng(21), dtype=jnp.bfloat16)
    for out, ref in pairs:
        assert out.shape == ref.shape and np.isfinite(out).all()
        assert np.abs(out - ref).max() <= MODULE_TOL * np.abs(ref).max(), (np.abs(out - ref).max(), np.abs(ref).max())


def test_detail_gate_blur_rounds_twice_as_jax():
    """avg_pool in bf16 with k=3: the fp32 window sum rounded to bf16, then /9
    rounded again, as JAX's ``avg_pool``: bit for bit on a bf16 map."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 8, 7, 9)).astype(np.float32)).to(BF16)
    xj = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
    from yolo_master_tpu.nn.layers import avg_pool as jax_avg_pool

    ref = np.asarray(jax_avg_pool(xj, 3, 1).astype(jnp.float32))
    out = tlayers.avg_pool(x, 3, 1).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(out, ref)


# -- 2. v0_10-n whole ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v10_bf16():
    """v0_10-n with BN calibrated on a batch of 8 at 64 px: the port, and JAX's
    head outputs in fp32 and bf16 with its bf16 routing at each gated block
    (top-k indices [B, k] and the kept count)."""
    jm = JaxDetectionModel(V10)
    port = DetectionModel(V10)
    port.load_state_dict(state_dict_from_jax(jax_params_of(jm, port)), strict=True)
    x = np.random.default_rng(9).random((8, 64, 64, 3)).astype(np.float32)
    calibrate_bn(port, torch.from_numpy(x))
    port.eval()
    params = jax.tree_util.tree_map(np.asarray, import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                                                                  port.state_dict(), strict=True))

    @jax.jit
    def forward(p, x):
        preds, taps = jm.forward_features_with_taps(p, x, CTX, [i - 1 for i in GATED_LAYERS])
        routing = []
        for i in GATED_LAYERS:
            mod, pi = jm.layers[i], p["layers"][str(i)]
            _, xd = mod._se_split(pi, taps[i - 1], CTX)
            xd = mod.detail_gate(pi["detail_gate"], xd, CTX)
            keep = jnp.clip(jnp.round(mod._complexity(pi, xd, CTX) * mod.top_k), 1, mod.top_k)
            routing.append((mod.routing(pi["routing"], xd, CTX, temperature=mod._temperature(CTX))[1], keep))
        return preds["one2many"]["boxes"], preds["one2many"]["scores"], routing

    t = torch.from_numpy(x).to(BF16)
    f32 = forward(params, jnp.asarray(x))
    b16 = forward(params, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    return port, t, f32, b16


def _port_bf16(port, t, monkeypatch, **routing):
    """The port's bf16 copy on the bf16 batch: (box logits, class logits) fp32
    numpy; ``routing``: ``picks`` (JAX's (indices, kept count) per block, in
    forward order) to route by, or ``seen`` to record the port's own
    (tests/test_torch_cuda.py:_gated_routing)."""
    model = compute_dtype_copy(copy.deepcopy(port), BF16)
    with monkeypatch.context() as mp, torch.no_grad():
        for k, v in _gated_routing(**routing).items():
            mp.setattr(tg, k, v)
        preds = model(t)
    assert preds["boxes"].dtype == preds["scores"].dtype == BF16
    return preds["boxes"].float().numpy(), preds["scores"].float().numpy()


def test_v0_10_whole_model_bf16_matches_jax_by_error_statistics(v10_bf16, monkeypatch):
    port, t, f32, b16 = v10_bf16
    out = _port_bf16(port, t, monkeypatch, picks=[(torch.from_numpy(np.array(i)).long(), float(k)) for i, k in b16[2]])
    for i in (0, 1):  # box logits, class logits
        ref32, ref16 = np.asarray(f32[i], np.float32), _f32(b16[i])
        own = _rel_rms(ref16, ref32)
        assert 0 < own < 1
        assert _rel_rms(out[i], ref32) <= 1.5 * own, (_rel_rms(out[i], ref32), own)


def test_v0_10_routing_flips_between_the_bf16_programs(v10_bf16, monkeypatch):
    """Unpinned: at each gated block, the samples whose top-k set differs between
    the two bf16 programs, plus one if the kept count differs (it is one count
    for the whole batch), are the counts measured; so are those between JAX's
    own bf16 and fp32 programs: the 16 experts of layer 11 leave little margin
    between the 2nd and 3rd pick."""
    port, t, f32, b16 = v10_bf16
    seen = []
    _port_bf16(port, t, monkeypatch, seen=seen)
    assert len(seen) == len(b16[2]) == 3
    counts = [sum(set(a) != set(b) for a, b in zip(np.asarray(ji).tolist(), ti.tolist())) + int(float(jk) != tk)
              for (ji, jk), (ti, tk) in zip(b16[2], seen)]
    assert counts == FLIPS, counts
    jax_own = [sum(set(a) != set(b) for a, b in zip(np.asarray(f[0]).tolist(), np.asarray(h[0]).tolist()))
               + int(float(f[1]) != float(h[1])) for f, h in zip(f32[2], b16[2])]
    assert jax_own == JAX_FLIPS, jax_own


# -- 3. what the bf16 copy keeps fp32 --------------------------------------------------------------

def test_bf16_copy_keeps_the_gated_blocks_fp32_reads_fp32():
    model = compute_dtype_copy(DetectionModel(V10), BF16)
    sd = dict(model.named_parameters())
    block = "model.5."
    for k in ("routing.alpha", "refine_scale", "detail_gate.detail_scale", "context_mixer.context_scale",
              "fused_experts.fused.expert_norm_weight", "fused_experts.fused.expert_norm_bias",
              "routing.global_fc.weight", "se_gate.2.weight", "se_gate.4.bias", "bn.weight",
              "routing.local_conv.1.weight"):
        assert sd[block + k].dtype == torch.float32, k
    for k in ("proj.weight", "fused_experts.fused.fused_conv.weight", "complexity_estimator.1.weight",
              "static_net.0.weight", "feature_gate.1.weight", "detail_gate.detail_filter.0.weight"):
        assert sd[block + k].dtype == BF16, k
    v2 = compute_dtype_copy(DetectionModel("yolo-master-v0_15-n"), BF16)
    sd = dict(v2.named_parameters())
    for k in ("routing.expert_prior", "routing.stat_norm.weight", "cross_gate.gate_scale", "cross_gate.drop_scale",
              "cross_gate.gate_net.2.weight"):
        assert sd["model.8." + k].dtype == torch.float32, k
