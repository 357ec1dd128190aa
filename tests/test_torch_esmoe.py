"""The port's fused dense ES_MOE (ops/esmoe.py, nn/moe/es_moe.py:FusedESMOE,
utils/fuse.py:fused_esmoe_fuse) against the JAX package's Pallas kernel
(ops/pallas_esmoe.py, run in interpret mode as its own tests run it on the
CPU) and its deploy surgery (utils/fuse.py:pallas_esmoe_fuse), on the same
weights and inputs. Inputs and BN statistics come from numpy seeds."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe.es_moe import ES_MOE as JaxESMOE
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.ops.pallas_esmoe import fused_esmoe as jax_fused_esmoe
from yolo_master_tpu.ops.pallas_esmoe import pack_esmoe_params as jax_pack
from yolo_master_tpu.utils.fuse import fuse_bn_params, pallas_esmoe_fuse
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.nn.moe import ES_MOE, FusedESMOE
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.ops.esmoe import fused_esmoe, fused_esmoe_plain, pack_esmoe_params
from yolo_master_tpu_torch.utils.fuse import fuse_bn, fused_esmoe_fuse
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)

CTX = Context(training=False)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _block_pair(cin, cout, folded, seed=0):
    """A JAX ES_MOE block with seeded BN statistics (tests/test_pallas_esmoe.py),
    optionally BN-folded, and the port's block on the same weights."""
    rng = np.random.default_rng(seed)
    jblock = JaxESMOE(cin, cout)
    jblock.finalize("m")
    p = _np_tree(jblock.init(jax.random.PRNGKey(seed)))
    co = jblock.out_channels
    p["norm_bn"]["mean"] = rng.normal(0, 0.2, co).astype(np.float32)
    p["norm_bn"]["var"] = rng.uniform(0.5, 2.0, co).astype(np.float32)
    for i in range(jblock.num_experts):
        bn = p["experts"][str(i)]["conv"]["bn"]
        bn["mean"] = rng.normal(0, 0.2, co).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, co).astype(np.float32)
    block = ES_MOE(cin, cout)
    sd = state_dict_from_jax({"layers": {"0": p}})
    block.load_state_dict({k[len("model.0."):]: v for k, v in sd.items()}, strict=True)
    block.eval()
    if folded:
        p = _np_tree(fuse_bn_params(p))
        fuse_bn(block)
    return jblock, jax.tree_util.tree_map(jnp.asarray, p), block


@pytest.mark.parametrize("folded", [False, True], ids=["raw", "bn_folded"])
@pytest.mark.parametrize("cin,cout,hw", [(64, 64, 24), (32, 48, 32)])
def test_fused_esmoe_matches_jax_kernel(cin, cout, hw, folded):
    """Banks equal to JAX's packing; the plain version within 2e-5 of the JAX
    kernel (interpret mode) and of the unfused block. The JAX tests allow
    5e-3 (raw) and 2e-3 (folded) against the unfused block; the measured
    difference here is ~1e-6."""
    jblock, p, block = _block_pair(cin, cout, folded)
    x = np.random.default_rng(1).normal(0, 1, (2, hw, hw, cin)).astype(np.float32)
    jw, _ = jblock.routing(p["routing"], jnp.asarray(x), CTX)
    jbanks = jax_pack(jblock, p)
    ref = np.asarray(jax_fused_esmoe(jnp.asarray(x), jw.astype(jnp.float32), *jbanks[:5], ks=jbanks[5],
                                     interpret=True))
    banks = pack_esmoe_params(block)
    assert banks[5] == jbanks[5] == (3, 5, 7)
    for ours, theirs in zip(banks[:5], jbanks[:5]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6, rtol=1e-6)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        w, _ = block.routing(xt.permute(0, 3, 1, 2))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
        out = fused_esmoe(xt, w, *banks)
        unfused = block(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == (2, hw, hw, cout)
    assert np.abs(out.numpy() - ref).max() < 2e-5
    assert np.abs(out.numpy() - unfused.numpy()).max() < 2e-5


def test_fused_esmoe_uses_each_experts_own_taps():
    """A bank whose padding ring is not zero must not change the result: each
    expert reads only its own k x k taps (pallas_esmoe.py:56-75)."""
    _, _, block = _block_pair(32, 32, folded=False)
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (1, 12, 12, 32)).astype(np.float32))
    dw, pw, pb, gamma, beta, ks = pack_esmoe_params(block)
    w = torch.full((1, 3), 1 / 3)
    ref = fused_esmoe_plain(x, w, dw, pw, pb, gamma, beta, ks)
    ring = torch.ones_like(dw)
    ring[:, 1:-1, 1:-1] = 0
    ring[2] = 0  # the 7x7 expert uses the whole bank
    out = fused_esmoe_plain(x, w, dw + 5.0 * ring, pw, pb, gamma, beta, ks)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def _fp32_noise(port, x):
    """The port's own fp32 rounding noise: |fp32 - fp64| on the same input."""
    with torch.no_grad():
        o64 = copy.deepcopy(port).double().forward_predict(torch.from_numpy(x).double()).numpy()
        o32 = port.forward_predict(torch.from_numpy(x)).numpy()
    return np.abs(o32 - o64)


@pytest.fixture(scope="module")
def pairs():
    """yolo-master-n at 64 px on the port's seeded init (the JAX init's
    distributions; the JAX tree through tests/_torch_scale.py:jax_params_of),
    in two settings: "default" (the init as it is, test_surgery_forward_runs's
    setting) and "calibrated" (BN statistics calibrated on the input in the
    port and carried back to the JAX tree: at the bare init the activations
    vanish by the neck and the ES_MOE blocks hardly reach the output). Per
    setting: the port model, the JAX tree after pallas_esmoe_fuse, the layers
    it swapped, and the JAX fused model's output. The surgery rewrites the
    JAX model's specs, so each setting fuses its own copy; both copies then
    have the same graph, and one compiled forward serves both."""
    init = jax_params_of(JaxDetectionModel("yolo-master-n"), DetectionModel("yolo-master-n"))
    x = np.random.default_rng(4).normal(0.4, 0.2, (2, 64, 64, 3)).astype(np.float32)
    out, forward = {}, None
    for setting in ("default", "calibrated"):
        port = DetectionModel("yolo-master-n")
        port.load_state_dict(state_dict_from_jax(init), strict=True)
        if setting == "calibrated":
            calibrate_bn(port, torch.from_numpy(x))
        port.eval()
        params = import_state_dict(init, port.state_dict(), strict=True)
        jm = JaxDetectionModel("yolo-master-n")
        fused_params = pallas_esmoe_fuse(jm, params)
        swapped = [s.i for s in jm.specs if type(s.module).__name__ == "PallasESMOE"]
        forward = forward or jax.jit(jm.forward_predict)
        ref = np.asarray(forward(fused_params, jnp.asarray(x)))
        out[setting] = (port, _np_tree(fused_params), swapped, ref)
    return x, out


def _tolerance(setting, port, x):
    """5e-3 at the seeded init (test_surgery_forward_runs's limit). At calibrated
    BN, fp32 rounding noise grows through the depth (~0.3 px on boxes and
    ~4e-3 on scores here, for the port against fp64), so the limit is 4x the
    port's own fp32-vs-fp64 error, boxes and scores apart, as in
    tests/test_torch_model.py."""
    if setting == "default":
        return 5e-3, 5e-3
    noise = _fp32_noise(port, x)
    return 4 * noise[..., :4].max(), 4 * noise[..., 4:].max()


@pytest.mark.parametrize("setting", ["default", "calibrated"])
def test_fused_esmoe_fuse_matches_jax_surgery(pairs, setting):
    """The port's surgery swaps layers [3, 6, 9, 12], as pallas_esmoe_fuse does,
    and the decoded output agrees with the JAX fused model."""
    x, out = pairs
    port, _, swapped, ref = out[setting]
    fused = copy.deepcopy(port)
    fused_esmoe_fuse(fused)
    ours = [m.i for m in fused.model if isinstance(m, FusedESMOE)]
    assert ours == swapped == [3, 6, 9, 12]
    with torch.no_grad():
        y = fused.forward_predict(torch.from_numpy(x)).numpy()
    assert y.shape == ref.shape and np.isfinite(y).all()
    if setting == "calibrated":
        assert np.abs(ref[0] - ref[1]).max() > 1.0  # the output depends on the image
    box_tol, score_tol = _tolerance(setting, port, x)
    assert np.abs(y[..., :4] - ref[..., :4]).max() <= box_tol
    assert np.abs(y[..., 4:] - ref[..., 4:]).max() <= score_tol


@pytest.mark.parametrize("setting", ["default", "calibrated"])
def test_jax_fused_tree_loads_strict(pairs, setting):
    """A tree rewritten by pallas_esmoe_fuse loads into a port model after
    fused_esmoe_fuse with strict=True, and then decodes as the JAX fused model."""
    x, out = pairs
    port_ref, fused_params, _, ref = out[setting]
    port = DetectionModel("yolo-master-n", seed=7)
    fused_esmoe_fuse(port)
    port.load_state_dict(state_dict_from_jax(fused_params), strict=True)
    assert tuple(port.model[3].banks["dw"].shape) == (3, 49, 64)
    with torch.no_grad():
        y = port.eval().forward_predict(torch.from_numpy(x)).numpy()
    box_tol, score_tol = _tolerance(setting, port_ref, x)
    assert np.abs(y[..., :4] - ref[..., :4]).max() <= box_tol
    assert np.abs(y[..., 4:] - ref[..., 4:]).max() <= score_tol


def test_fused_esmoe_fuse_layers_and_facade():
    """``layers`` restricts the swap; after YOLO.fuse() (BN folded, fused stem)
    the surgery still applies, and predict() gives the detections of the
    unswapped model."""
    y = YOLO("yolo-master-n", device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).random((1, 64, 64, 3)).astype(np.float32))
    calibrate_bn(y.model, x)
    part = copy.deepcopy(y.model)
    fused_esmoe_fuse(part, layers=[6, 12])
    assert [m.i for m in part.model if isinstance(m, FusedESMOE)] == [6, 12]
    assert all(m.fusable() for m in y.model.model if isinstance(m, ES_MOE))
    img = (np.random.default_rng(6).random((60, 64, 3)) * 255).astype(np.uint8)
    kw = dict(imgsz=64, conf=1e-4, max_det=20)
    y.fuse()
    ref = y.predict(img, **kw)[0]
    fused_esmoe_fuse(y.model)
    assert [m.i for m in y.model.model if isinstance(m, FusedESMOE)] == [3, 6, 9, 12]
    out = y.predict(img, **kw)[0]
    assert len(out.boxes) == len(ref.boxes) > 0
    np.testing.assert_allclose(out.boxes.xyxy, ref.boxes.xyxy, atol=5e-2, rtol=0)
    np.testing.assert_allclose(out.boxes.conf, ref.boxes.conf, atol=1e-4, rtol=0)
