"""yolo26-master-n in bf16: the port's bf16 copy against the JAX package's bf16
(fp32 parameters, per-op casts), on the CPU.

The gate is tests/test_torch_bf16.py's whole-model statistic (PERF.md §7): BN
calibrated on a batch of 8 at 64 px, the rel-RMS of the port's bf16 one2one
head outputs (box and class logits apart) from JAX's fp32 within 1.5x that
of JAX's own bf16. The six MoE blocks inside A2C2fMoE (layers 4, 6, 8; 4, 8
and 16 experts, top-2) route as the v0_1 blocks do, so the port's routing is
pinned to JAX's bf16 picks, recorded inside JAX's jitted forward: two bf16
programs may part where a rounding flips a pick (ROADMAP §3). The flips are
counted unpinned. BN folded (``fuse_bn`` against ``fuse_bn_params``), the
same. The decode and ``postprocess_end2end`` of JAX's bf16 head outputs give
JAX's selection: the same boxes and classes in the same order, the scores an
fp32 ulp apart (the two sigmoids).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import mixtures as jmix
from yolo_master_tpu.nn.moe.dispatch import top_k_from_weights as jax_top_k_from_weights
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils.fuse import fuse_bn_params
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.nn.moe import mixtures as tmix
from yolo_master_tpu_torch.nn.moe.dispatch import top_k_from_weights
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils.fuse import compute_dtype_copy, fuse_bn
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_bf16 import _bf16, _f32, _pinned_routing, _rel_rms  # noqa: E402

BF16 = torch.bfloat16
CTX = Context(training=False)
Y26 = "yolo26-master-n"
BLOCKS = 6  # two ABlockMoE a layer at 4, 6 and 8
# the (sample, block) top-2 sets, of 48, that differ between the port's bf16 program and JAX's,
# unfused and BN-folded (measured); JAX_FLIPS: the same count between JAX's bf16 and fp32 programs
FLIPS = {False: 12, True: 10}
JAX_FLIPS = {False: 8, True: 13}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_forward(jm):
    """A jitted (params, x) -> (one2one box logits, class logits, the top-2
    indices [B, 2] each MoE block picked, in forward order)."""
    seen = []
    plain = jmix.process_logits

    def recording(logits, **kw):
        out = plain(logits, **kw)
        seen.append(jax_top_k_from_weights(out[0], kw["top_k"])[1])
        return out

    def forward(p, x):
        seen.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmix, "process_logits", recording)
            preds = jm.forward_features(p, x, CTX)
        return preds["one2one"]["boxes"], preds["one2one"]["scores"], list(seen)

    return jax.jit(forward)


@pytest.fixture(scope="module")
def y26_bf16():
    """The port with BN calibrated on a batch of 8 at 64 px, and for the
    unfused and the BN-folded parameters JAX's fp32 and bf16 outputs (the
    bf16 one with its picks)."""
    jm = JaxDetectionModel(Y26)
    port = DetectionModel(Y26)
    init = jax_params_of(jm, port)
    port.load_state_dict(state_dict_from_jax(init), strict=True)
    x = np.random.default_rng(9).random((8, 64, 64, 3)).astype(np.float32)
    calibrate_bn(port, torch.from_numpy(x))
    port.eval()
    params = import_state_dict(init, port.state_dict(), strict=True)
    forward = _jax_forward(jm)
    xj, t = _bf16(x)
    out = {}
    for fuse, p in ((False, params), (True, fuse_bn_params(params))):
        out[fuse] = forward(p, jnp.asarray(x)), forward(p, xj)
    return jm, port, x, t.permute(0, 2, 3, 1), out


def _port_bf16(port, t, fuse):
    model = copy.deepcopy(port)
    if fuse:
        fuse_bn(model)
    model = compute_dtype_copy(model, BF16)
    with torch.no_grad():
        preds = model(t)
    assert preds["boxes"].dtype == preds["scores"].dtype == BF16
    return preds["boxes"].float().numpy(), preds["scores"].float().numpy()


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "bn_folded"])
def test_yolo26_whole_model_bf16_matches_jax_by_error_statistics(y26_bf16, fuse, monkeypatch):
    _, port, _, t, out = y26_bf16
    f32, b16 = out[fuse]
    assert len(b16[2]) == BLOCKS
    _pinned_routing(monkeypatch, b16[2])
    got = _port_bf16(port, t, fuse)
    for i in (0, 1):  # box logits, class logits
        ref32, ref16 = np.asarray(f32[i], np.float32), _f32(b16[i])
        own = _rel_rms(ref16, ref32)
        assert 0 < own < 1
        assert _rel_rms(got[i], ref32) <= 1.5 * own, (i, _rel_rms(got[i], ref32), own)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "bn_folded"])
def test_yolo26_routing_flips_between_the_bf16_programs(y26_bf16, fuse, monkeypatch):
    """Unpinned: the (sample, block) top-2 sets where the port's bf16 program
    and JAX's part (FLIPS, measured), beside where JAX's own bf16 and fp32
    programs part (JAX_FLIPS): as many. The routers' logits sit close on the
    seeded weights, and a bf16 rounding moves a pick either way."""
    _, port, _, t, out = y26_bf16
    seen = []
    plain = tmix.process_logits

    def recorded(logits, top_k, noise=None):
        res = plain(logits, top_k, noise)
        seen.append(top_k_from_weights(res[0], top_k)[1].numpy())
        return res

    monkeypatch.setattr(tmix, "process_logits", recorded)
    _port_bf16(port, t, fuse)
    assert len(seen) == BLOCKS

    def flips(picks, ref):
        return sum(set(a.tolist()) != set(b.tolist()) for p, r in zip(picks, ref)
                   for a, b in zip(np.asarray(p), np.asarray(r)))

    f32, b16 = out[fuse]
    assert (flips(seen, b16[2]), flips(f32[2], b16[2])) == (FLIPS[fuse], JAX_FLIPS[fuse])


def test_yolo26_end2end_selection_on_jax_bf16_head_outputs_is_jax_selection(y26_bf16):
    """The decode and ``postprocess_end2end`` run in fp32 in both packages:
    on JAX's own bf16 head outputs the port selects JAX's (anchor, class)
    pairs in JAX's order."""
    jm, port, _, _, out = y26_bf16
    boxes, scores, _ = out[False][1]
    hw = ((8, 8), (4, 4), (2, 2))
    ref = jax.jit(lambda b, s: jm.head.postprocess_end2end(
        jm.head.decode({"one2one": {"boxes": b, "scores": s}, "hw_shapes": hw}), 300))(boxes, scores)
    preds = {"boxes": torch.tensor(_f32(boxes)).to(BF16), "scores": torch.tensor(_f32(scores)).to(BF16),
             "hw_shapes": hw}
    got = port.head.postprocess_end2end(port.head.decode(preds), 300).numpy()
    ref = np.asarray(ref)
    assert got.shape == (8, 84, 6)
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 5]], ref[..., [0, 1, 2, 3, 5]])  # boxes, classes, order
    np.testing.assert_allclose(got[..., 4], ref[..., 4], rtol=1e-6, atol=0)  # the two sigmoids, an ulp apart


def test_yolo26_bf16_copy_keeps_norm_statistics_and_affines_fp32(y26_bf16):
    """The bf16 copy: every conv bf16 (attention, experts, routers, both head
    branches), every BatchNorm and GroupNorm fp32, as JAX casts per op; the
    model itself stays fp32."""
    _, port, _, _, _ = y26_bf16
    model = compute_dtype_copy(port, BF16)
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    norms = [m for m in model.modules() if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm))]
    assert convs and all(m.weight.dtype == BF16 for m in convs)
    assert norms and all(t.dtype == torch.float32 for m in norms for t in (*m.parameters(), *m.buffers())
                         if t.is_floating_point())
    block = model.model[4].m[0][0]
    assert block.mlp.routing.router[0].weight.dtype == BF16 and block.mlp.routing.router[1].weight.dtype == torch.float32
    assert model.head.one2one_cv2[0][-1].weight.dtype == model.model[10].m[0].attn.qkv.conv.weight.dtype == BF16
    assert all(p.dtype == torch.float32 for p in port.parameters())
