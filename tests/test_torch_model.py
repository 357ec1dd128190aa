"""The port's modules and yolo-master-n (yolo_master_tpu_torch/nn) against the
JAX package on the same weights and inputs, on the CPU in fp32.

Whole-model weights come from the port's seeded init, which draws every
tensor from the JAX init's distributions, as the JAX parameter tree
(tests/_torch_scale.py:jax_params_of: jax.eval_shape's tree filled strictly,
without the 30-s JAX init), and reach the port back through
utils/weights.py:state_dict_from_jax. Single modules use the JAX module's own
init. For the whole model, BatchNorm statistics
are then calibrated on the input (utils/weights.py:calibrate_bn) and carried
back to the JAX tree with import_state_dict: at the default init the
activations vanish with depth and the output would not depend on the input.
Single modules get random BN statistics instead. Inputs are made with numpy
from a seed.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn import heads as jheads
from yolo_master_tpu.nn import layers as jlayers
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import ES_MOE as JaxESMOE
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils.fuse import fuse_bn_params
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.nn import heads as theads
from yolo_master_tpu_torch.nn import layers as tlayers
from yolo_master_tpu_torch.nn.moe import ES_MOE
from yolo_master_tpu_torch.nn.tasks import DetectionModel, parse_model
from yolo_master_tpu_torch.utils.fuse import fold_uint8_input, fuse_bn, fused_stem_fuse
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)

CTX = Context(training=False)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _perturb_bn(tree, rng):
    """Random eval statistics for every BatchNorm leaf group (in place)."""
    if isinstance(tree, dict):
        if {"scale", "bias", "mean", "var"} <= set(tree):
            c = np.asarray(tree["scale"]).shape
            tree["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
            tree["bias"] = rng.normal(0, 0.05, c).astype(np.float32)
            tree["mean"] = rng.normal(0, 0.05, c).astype(np.float32)
            tree["var"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        else:
            for v in tree.values():
                _perturb_bn(v, rng)
    return tree


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _load_module(port_module, jax_params):
    """Load one JAX module's params into the matching port module (strict)."""
    sd = state_dict_from_jax({"layers": {"0": jax_params}})
    port_module.load_state_dict({k[len("model.0."):]: v for k, v in sd.items()}, strict=True)
    return port_module.eval()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def pair():
    """The JAX model and the port on the same weights, in two settings:
    "default" (the seeded init as it is) and "calibrated" (BN statistics
    calibrated on the input in the port, then carried back to the JAX tree)."""
    jm = JaxDetectionModel("yolo-master-n")
    init = jax_params_of(jm, DetectionModel("yolo-master-n"))
    forward = jax.jit(jm.forward_predict)
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    x_u8 = (x * 255).astype(np.uint8)
    xs = jnp.asarray(np.concatenate([x, x_u8 / np.float32(255)]))
    out = {}
    for setting in ("default", "calibrated"):
        port = DetectionModel("yolo-master-n")
        port.load_state_dict(state_dict_from_jax(init), strict=True)
        if setting == "calibrated":
            calibrate_bn(port, torch.from_numpy(x))
        port.eval()
        params = import_state_dict(init, port.state_dict(), strict=True)
        out[setting] = (port, np.asarray(forward(params, xs)))
    return init, x, x_u8, out


def test_weight_round_trip_through_torch_import(pair):
    init = pair[0]
    back = import_state_dict(init, pair[3]["default"][0].state_dict(), strict=True)
    leaves, back_leaves = jax.tree_util.tree_leaves(init), jax.tree_util.tree_leaves(back)
    assert len(leaves) == len(back_leaves)
    for a, b in zip(leaves, back_leaves):
        np.testing.assert_array_equal(a, b)


def test_stride_probe_gives_8_16_32(pair):
    port = pair[3]["default"][0]
    assert port.head.strides == (8, 16, 32) and port.stride == 32


def _fp32_noise(port, x):
    """The port's own fp32 rounding noise: |fp32 - fp64| on the same input."""
    with torch.no_grad():
        o64 = copy.deepcopy(port).double().forward_predict(torch.from_numpy(x).double()).numpy()
        o32 = port.forward_predict(torch.from_numpy(x)).numpy()
    return np.abs(o32 - o64)


def test_forward_predict_matches_jax(pair):
    """The seeded init as it is: boxes within 2e-3 px and scores within 1e-5
    (tests/test_parity_torch.py's gate)."""
    _, x, _, out = pair
    port, ref = out["default"]
    with torch.no_grad():
        y = port.forward_predict(torch.from_numpy(x)).numpy()
    assert y.shape == (2, 84, 84)
    assert np.abs(y[..., :4] - ref[:2, :, :4]).max() < 2e-3
    assert np.abs(y[..., 4:] - ref[:2, :, 4:]).max() < 1e-5


def test_forward_predict_matches_jax_calibrated_bn(pair):
    """Calibrated BN: unit-scale activations through the depth, an
    image-dependent output, and fp32 rounding noise that grows through it
    (~1e-2 px here, for either package, against fp64). The port must agree
    with JAX within 4x its own fp32-vs-fp64 error, element by element class:
    a wrong layer would be off by far more."""
    _, x, _, out = pair
    port, ref = out["calibrated"]
    assert np.abs(ref[0] - ref[1]).max() > 1.0  # the output depends on the image
    with torch.no_grad():
        y = port.forward_predict(torch.from_numpy(x)).numpy()
    noise = _fp32_noise(port, x)
    for sl, floor, sane in ((np.s_[..., :4], 2e-3, 0.1), (np.s_[..., 4:], 1e-5, 1e-2)):
        assert noise[sl].max() < sane  # the fp32 path itself stays close to fp64
        assert np.abs(y[sl] - ref[:2][sl]).max() <= max(4 * noise[sl].max(), floor)


@pytest.mark.parametrize("setting", ["default", "calibrated"])
@pytest.mark.parametrize("surgery", ["fused_stem", "fold_uint8"])
def test_fused_uint8_model_matches_jax_unfused(pair, surgery, setting):
    """BN folded and /255 folded into layer 0 (as the fused stem kernel's plain
    version, or as plain conv weights), fed raw uint8, against the unfused JAX
    model on the float image: within 1e-3 at the seeded init; at calibrated BN
    within 4x the port's own fp32 noise (as above)."""
    _, x, x_u8, out = pair
    port, ref = out[setting]
    fused = copy.deepcopy(port)
    fuse_bn(fused)
    if surgery == "fused_stem":
        fused_stem_fuse(fused)
        assert isinstance(fused.model[0], tlayers.FusedStem)
    else:
        fold_uint8_input(fused)
    assert fused.uint8_input
    assert not any(isinstance(m, tlayers.Conv) and not isinstance(m.bn, torch.nn.Identity) for m in fused.modules())
    with torch.no_grad():
        y = fused.forward_predict(torch.from_numpy(x_u8)).numpy()
    tol = 1e-3 if setting == "default" else max(4 * _fp32_noise(port, x_u8.astype(np.float32) / 255).max(), 1e-3)
    assert np.abs(y - ref[2:]).max() < tol


def test_fused_stem_fuse_requires_bn_fold():
    with pytest.raises(ValueError, match="fuse_bn"):
        fused_stem_fuse(DetectionModel("yolo-master-n"))


def _module_cases():
    rng = np.random.default_rng(2)

    def conv():
        return jlayers.Conv(16, 32, 3, 2), tlayers.Conv(16, 32, 3, 2), [(2, 16, 16, 16)]

    def c3k2():
        return (jlayers.C3k2(32, 64, n=1, c3k=True, e=0.5), tlayers.C3k2(32, 64, n=1, c3k=True, e=0.5),
                [(2, 8, 12, 32)])

    def a2c2f():
        return (jlayers.A2C2f(64, 64, n=1, a2=True, area=4), tlayers.A2C2f(64, 64, n=1, a2=True, area=4),
                [(2, 8, 8, 64)])

    def a2c2f_residual():  # the l/x form (parse_model's scale rule): gamma-scaled residual, mlp_ratio 1.2
        return (jlayers.A2C2f(64, 64, n=1, a2=True, area=4, residual=True, mlp_ratio=1.2),
                tlayers.A2C2f(64, 64, n=1, a2=True, area=4, residual=True, mlp_ratio=1.2), [(2, 8, 8, 64)])

    def es_moe():
        return JaxESMOE(32, 32), ES_MOE(32, 32), [(2, 10, 10, 32)]

    def detect():
        ch = (16, 32, 64)
        j = jheads.Detect(nc=80, reg_max=16, ch=ch)
        j.set_strides((8, 16, 32))
        t = theads.Detect(nc=80, reg_max=16, ch=ch)
        t.set_strides((8, 16, 32))
        return j, t, [(2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 64)]

    return rng, {"Conv": conv, "C3k2": c3k2, "A2C2f": a2c2f, "A2C2f_residual": a2c2f_residual, "ES_MOE": es_moe,
                 "Detect": detect}


@pytest.mark.parametrize("name", ["Conv", "C3k2", "A2C2f", "A2C2f_residual", "ES_MOE", "Detect"])
def test_module_matches_jax(name):
    """Each module on its own, fp32: 1e-5 on activations and scores, 2e-3 px on boxes.
    A residual A2C2f's gamma is drawn away from its 0.01 init, so the branch counts."""
    rng, cases = _module_cases()
    jm, tm, shapes = cases[name]()
    jm = jm.finalize("m")
    p = _perturb_bn(_np_tree(jax.jit(jm.init)(jax.random.PRNGKey(3))), rng)  # jit: the eager values, one compile
    if "gamma" in p:
        p["gamma"] = rng.uniform(0.5, 1.5, p["gamma"].shape).astype(np.float32)
    tm = _load_module(tm, p)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    xt = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]
    with torch.no_grad():
        if name == "Detect":
            ref = np.asarray(jm.decode(jm(p, [jnp.asarray(x) for x in xs], CTX)))
            out = tm.decode(tm(xt)).numpy()
            assert np.abs(out[..., :4] - ref[..., :4]).max() < 2e-3
            assert np.abs(out[..., 4:] - ref[..., 4:]).max() < 1e-5
            return
        ref = np.asarray(jm(p, jnp.asarray(xs[0]), CTX))
        out = _nhwc(tm(xt[0]))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 1e-5


def test_decode_topk_matches_jax_with_tied_anchors():
    """Letterbox padding gives runs of identical anchors: tied class logits
    must select in the JAX order (lower anchor index first)."""
    rng = np.random.default_rng(4)
    hw = ((8, 8), (4, 4), (2, 2))
    a, nc = sum(h * w for h, w in hw), 5
    boxes = rng.standard_normal((2, a, 64)).astype(np.float32)
    scores = rng.standard_normal((2, a, nc)).astype(np.float32)
    scores[:, 10:40] = scores[:, 10:11]  # 30 tied anchors
    scores[1, :] = 0.25  # every anchor tied
    j = jheads.Detect(nc=nc, reg_max=16, ch=(16, 16, 16))
    j.set_strides((8, 16, 32))
    t = theads.Detect(nc=nc, reg_max=16, ch=(16, 16, 16))
    t.set_strides((8, 16, 32))
    ref = np.asarray(j.decode_topk({"one2many": {"boxes": jnp.asarray(boxes), "scores": jnp.asarray(scores)},
                                    "hw_shapes": hw}, k=24))
    out = t.decode_topk({"boxes": torch.from_numpy(boxes), "scores": torch.from_numpy(scores), "hw_shapes": hw},
                        k=24).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_unported_module_names_its_roadmap_item():
    cfg = {"nc": 80, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "RepC3", [16]]],
           "head": [[[-1], 1, "Detect", ["nc"]]]}
    with pytest.raises(KeyError, match="ROADMAP.md"):
        parse_model(cfg)


@pytest.mark.parametrize("name", ["yolo-master-semantic-n", "yolo-master-v0_2-cls-n", "yolo-master-world-n",
                                  "yolo-master-dymoe-n", "yolo-master-v0_2-n",
                                  "rtdetr-master-hgnet-l", "yolo-master-uomoe-n"])
def test_other_model_yamls_name_their_roadmap_item(name):
    """A graph YAML of the JAX package that the port has not copied yet: building
    it is refused, naming the ROADMAP item."""
    with pytest.raises(FileNotFoundError, match="ROADMAP.md"):
        DetectionModel(name)


# -- yolo-master-v0_1-n: OptimizedMOEImproved blocks with sparse gathered dispatch --------

def _trainable(tree):
    """Leaves the JAX package counts as parameters (tests/test_model_configs.py:trainable)."""
    if isinstance(tree, dict):
        return sum(_trainable(v) for k, v in tree.items() if k not in ("mean", "var") and not k.startswith("_"))
    return int(np.asarray(tree).size)


@pytest.fixture(scope="module")
def v0_1():
    """v0_1-n at 64 px: the JAX model and the port on the same weights, the
    seeded init as it is ("default") and with BN calibrated in the port and
    carried back ("calibrated"), both in sparse eval (the default)."""
    jm = JaxDetectionModel("yolo-master-v0_1-n")
    init = jax_params_of(jm, DetectionModel("yolo-master-v0_1-n"))
    forward = jax.jit(jm.forward_predict)
    x = np.random.default_rng(5).random((2, 64, 64, 3)).astype(np.float32)
    out = {}
    for setting in ("default", "calibrated"):
        port = DetectionModel("yolo-master-v0_1-n")
        port.load_state_dict(state_dict_from_jax(init), strict=True)
        if setting == "calibrated":
            calibrate_bn(port, torch.from_numpy(x))
        port.eval()
        params = import_state_dict(init, port.state_dict(), strict=True)
        out[setting] = (port, params, np.asarray(forward(params, jnp.asarray(x))))
    return jm, init, x, out, forward


def test_v0_1_builds_with_the_jax_parameter_count(v0_1):
    """7,546,984 parameters in the reference, less the 16 frozen DFL weights."""
    _, init, _, out, _ = v0_1
    port = out["default"][0]
    assert sum(p.numel() for p in port.parameters()) == _trainable(init) == 7_546_984 - 16
    assert [type(m).__name__ for m in port.model if type(m).__name__ == "OptimizedMOEImproved"] == [
        "OptimizedMOEImproved"] * 3
    assert [m.num_experts for m in port.model if hasattr(m, "num_experts")] == [4, 8, 16]


def test_v0_1_weight_round_trip_through_torch_import(v0_1):
    _, init, _, out, _ = v0_1
    back = import_state_dict(init, out["default"][0].state_dict(), strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(init), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("setting", ["default", "calibrated"])
def test_v0_1_forward_predict_matches_jax(v0_1, setting):
    """Sparse eval, the port against JAX: at the seeded init within 2e-3 px and
    1e-5 on scores; with calibrated BN within 4x the port's own fp32-vs-fp64
    error (floors 2e-3 px, 1e-5), as test_forward_predict_matches_jax_calibrated_bn.
    The port's dense eval (sparse_inference=False) agrees with its sparse eval
    within the same limits."""
    _, _, x, out, _ = v0_1
    port, _, ref = out[setting]
    with torch.no_grad():
        y = port.forward_predict(torch.from_numpy(x)).numpy()
        port.sparse_inference = False
        assert not any(getattr(m, "sparse_inference", False) for m in port.model.modules())
        yd = port.forward_predict(torch.from_numpy(x)).numpy()
        port.sparse_inference = True
    assert y.shape == ref.shape == (2, 84, 84)
    if setting == "default":
        tols = ((np.s_[..., :4], 2e-3), (np.s_[..., 4:], 1e-5))
    else:
        assert np.abs(ref[0] - ref[1]).max() > 1.0  # the output depends on the image
        noise = _fp32_noise(port, x)
        tols = ((np.s_[..., :4], max(4 * noise[..., :4].max(), 2e-3)), (np.s_[..., 4:], max(4 * noise[..., 4:].max(), 1e-5)))
    for sl, tol in tols:
        assert np.abs(y[sl] - ref[sl]).max() <= tol
        assert np.abs(yd[sl] - y[sl]).max() <= tol


def test_v0_1_fuse_bn_folds_what_jax_folds(v0_1):
    """fuse_bn folds the {conv, bn} pairs and leaves the routers' and shared
    experts' [PlainConv, BatchNorm] sequences, exactly as fuse_bn_params does
    to the JAX tree: that tree loads strict into the folded port, and the two
    folded models agree within 4x the folded port's own fp32-vs-fp64 error
    (floors 2e-3 px, 1e-5): folding changes where fp32 rounds."""
    _, _, x, out, forward = v0_1
    port, params, _ = out["calibrated"]
    fused = copy.deepcopy(port)
    fuse_bn(fused)
    assert sum(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules()) == 9  # 3 blocks x (2 router + 1 shared)
    jfused = _np_tree(fuse_bn_params(params))
    fused.load_state_dict(state_dict_from_jax(jfused), strict=True)
    ref = np.asarray(forward(jfused, jnp.asarray(x)))
    with torch.no_grad():
        y = fused.forward_predict(torch.from_numpy(x)).numpy()
    noise = _fp32_noise(fused, x)
    assert np.abs(y[..., :4] - ref[..., :4]).max() <= max(4 * noise[..., :4].max(), 2e-3)
    assert np.abs(y[..., 4:] - ref[..., 4:]).max() <= max(4 * noise[..., 4:].max(), 1e-5)
