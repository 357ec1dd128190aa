"""The task models at scale n in the port against the JAX package, on the CPU
in fp32: yolo-master-seg-n, -pose-n, -obb-n and -cls-n, and
yolo-master-v0_10-seg-n (Segment on the AdaptiveGate graph).

Weights: the port's seeded init, carried into the JAX tree through
``jax.eval_shape``'s tree (tests/_torch_tasks.py:jax_tree_of), in two
settings: "default" (the init as it is) and "calibrated" (BN statistics of
the input, set in the port and carried back). Gates, at 64 px (224 px is
Classify's native size, but the graph takes any size):

- whole forward + decode against JAX's ``forward_train`` + ``decode`` (and
  ``forward_train`` alone for Classify): at the init, decoded boxes within
  2e-3 px and scores within 1e-5, prototypes, mask coefficients, keypoints
  and angles within 1e-4 + 1e-4 |ref|, probabilities within 1e-5; with BN
  calibrated, within 4x the port's own fp32-vs-fp64 error (same floors),
  as tests/test_torch_model.py's calibrated gate;
- ``fuse()`` (BN folded, the fused stem's plain version on uint8 pixels)
  against the unfused JAX model on pixels / 255, the same way;
- the task, the head and the graph's pieces (Segment's width-scaled
  prototype count, Pose's kpt_shape from the YAML, Classify at layer 13).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.tasks import ClassificationModel as JaxClassificationModel
from yolo_master_tpu.nn.tasks import OBBModel as JaxOBBModel
from yolo_master_tpu.nn.tasks import PoseModel as JaxPoseModel
from yolo_master_tpu.nn.tasks import SegmentationModel as JaxSegmentationModel
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.nn import heads as theads
from yolo_master_tpu_torch.nn.layers import FusedStem
from yolo_master_tpu_torch.nn.tasks import (ClassificationModel, DetectionModel, OBBModel, PoseModel,
                                            SegmentationModel)
from yolo_master_tpu_torch.utils.fuse import fuse_bn, fused_stem_fuse
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_tasks import jax_tree_of  # noqa: E402 (tests/ is on the path)

IMGSZ = 64
MODELS = {
    "yolo-master-seg-n": (JaxSegmentationModel, SegmentationModel),
    "yolo-master-pose-n": (JaxPoseModel, PoseModel),
    "yolo-master-obb-n": (JaxOBBModel, OBBModel),
    "yolo-master-cls-n": (JaxClassificationModel, ClassificationModel),
    "yolo-master-v0_10-seg-n": (JaxSegmentationModel, SegmentationModel),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(out):
    """The JAX eval output -> {name: array} of what the port's eval forward gives."""
    if not isinstance(out, dict):
        return {"probs": out}
    branch = out["one2one"] if "one2one" in out else out["one2many"]
    flat = {k: v for k, v in branch.items()}
    if "proto" in out:
        flat["proto"] = out["proto"]
    return flat


def _port_flat(model, x):
    with torch.no_grad():
        out = model(x)
        if not isinstance(out, dict):
            return {"probs": out.numpy()}, None
        flat = {k: (v.permute(0, 2, 3, 1) if k == "proto" else v).numpy() for k, v in out.items()
                if k != "hw_shapes"}
        return flat, model.head.decode(out).numpy()


def _noise(model, x):
    """The port's own fp32 rounding noise on each output: |fp32 - fp64| (uint8 pixels stay uint8)."""
    a, da = _port_flat(model, x)
    b, db = _port_flat(copy.deepcopy(model).double(), x.double() if x.is_floating_point() else x)
    noise = {k: np.abs(a[k] - b[k]) for k in a}
    if da is not None:
        noise["decoded"] = np.abs(da - db)
    return noise


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """(name, port models by setting, JAX outputs by setting, x, x_u8): one
    compiled JAX program per model serves both settings and the uint8 check."""
    name = request.param
    jcls, tcls = MODELS[name]
    jm = jcls(name)
    first = tcls(name)
    init = jax_tree_of(jm, first)
    x = np.random.default_rng(11).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    x_u8 = (x * 255).astype(np.uint8)
    xs = jnp.asarray(np.concatenate([x, x_u8 / np.float32(255)]))

    def run(p, a):
        out = jm.forward_train(p, a, Context(training=False))
        if not isinstance(out, dict):
            return out, out
        return {k: v for k, v in out.items() if k != "hw_shapes"}, jm.head.decode(out)

    forward = jax.jit(run)
    ports, refs = {}, {}
    for setting in ("default", "calibrated"):
        port = first if setting == "default" else tcls(name)
        port.load_state_dict(state_dict_from_jax(init), strict=True)
        if setting == "calibrated":
            calibrate_bn(port, torch.from_numpy(x))
        port.eval()
        params = import_state_dict(init, port.state_dict(), strict=True)
        out, dec = forward(params, xs)
        refs[setting] = ({k: np.asarray(v) for k, v in _flat(out).items()}, np.asarray(dec))
        ports[setting] = port
    return name, ports, refs, x, x_u8


def _check(model, x, ref, dec_ref, calibrated: bool, rows=slice(0, 2)):
    """The port's eval outputs and decode on x against JAX's rows ``rows``: at
    the floors (2e-3 px, 1e-5 on scores and probabilities, 1e-4 + 1e-4 |ref| on
    the rest) or, ``calibrated``, within 4x the port's own fp32-vs-fp64 error."""
    flat, dec = _port_flat(model, torch.from_numpy(x))
    noise = _noise(model, torch.from_numpy(x)) if calibrated else None

    def tol(key, floor, sl=np.s_[...], ceiling=1e-2):
        """max(4x the port's own noise, floor); the noise itself below a sane ``ceiling``."""
        if noise is None:
            return floor
        assert noise[key][sl].max() < ceiling, (key, noise[key][sl].max())
        return max(4 * noise[key][sl].max(), floor)

    extras = ("proto", "mask_coefficient", "kpts", "angle")
    for k, v in flat.items():
        r = ref[k][rows]
        assert v.shape == r.shape, (k, v.shape, r.shape)
        if k == "probs":
            assert np.abs(v - r).max() <= tol(k, 1e-5), k
        elif k in extras:
            assert (np.abs(v - r) <= tol(k, 1e-4) + 1e-4 * np.abs(r)).all(), (k, np.abs(v - r).max())
    if dec is None:
        return
    d, nc = dec_ref[rows], model.nc
    assert dec.shape == d.shape
    # fp32 rounding grows through the calibrated network to ~0.3 px on boxes and keypoints at 64 px
    px = 0.5
    for sl, floor, ceiling in ((np.s_[..., :4], 2e-3, px), (np.s_[..., 4:4 + nc], 1e-5, 1e-2)):
        assert np.abs(dec[sl] - d[sl]).max() <= tol("decoded", floor, sl, ceiling)
    sl = np.s_[..., 4 + nc:]
    assert (np.abs(dec[sl] - d[sl]) <= tol("decoded", 1e-4, sl, px) + 1e-4 * np.abs(d[sl])).all()


@pytest.mark.parametrize("setting", ["default", "calibrated"])
def test_task_model_matches_jax(pair, setting):
    name, ports, refs, x, _ = pair
    port = ports[setting]
    ref, dec_ref = refs[setting]
    if setting == "calibrated":  # the output depends on the image
        key = "probs" if "probs" in ref else "scores"
        assert np.abs(ref[key][0] - ref[key][1]).max() > 1e-3
    _check(port, x, ref, dec_ref, setting == "calibrated")


def test_fused_task_model_on_uint8_matches_unfused_jax(pair):
    """fuse_bn + the fused stem (its plain version on the CPU) on raw uint8,
    against the unfused JAX model on the same pixels / 255."""
    name, ports, refs, _, x_u8 = pair
    fused = copy.deepcopy(ports["calibrated"])
    fuse_bn(fused)
    fused_stem_fuse(fused)
    assert isinstance(fused.model[0], FusedStem) and fused.uint8_input
    ref, dec_ref = refs["calibrated"]
    _check(fused, x_u8, ref, dec_ref, True, rows=slice(2, 4))


def test_task_graph_pieces(pair):
    name, ports, _, _, _ = pair
    port = ports["default"]
    head = port.head
    if "seg" in name:
        assert isinstance(head, theads.Segment) and head.npr == 64 and head.nm == 32  # 256 * 0.25
        assert head.proto.upsample.weight.shape == (64, 64, 2, 2) and port.task == "segment"
    elif "pose" in name:
        assert isinstance(head, theads.Pose) and port.kpt_shape == (17, 3) and port.nc == 1
    elif "obb" in name:
        assert isinstance(head, theads.OBB) and head.ne == 1 and port.nc == 15
    else:
        assert isinstance(head, theads.Classify) and head.i == 13 and port.nc == 1000
        assert head.linear.weight.shape == (1000, 1280) and not hasattr(port, "stride")
    if not isinstance(head, theads.Classify):
        assert head.strides == (8, 16, 32)


def test_facade_builds_each_task_and_refuses_the_rest():
    """The task from the name (``-seg``, ``-pose``, ``-obb``, ``-cls``) or ``task=``;
    a graph whose head is not the task's raises; SemanticSegment and v0_2's task
    graphs name their ROADMAP items."""
    for name, task in (("yolo-master-seg-n", "segment"), ("yolo-master-v0_7-pose-n", "pose"),
                       ("yolo-master-v0_12-obb-s", "obb"), ("yolo-master-cls-n", "classify"),
                       ("yolo-master-n", "detect")):
        y = YOLO(name, device="cpu")
        assert y.task == task and y.model.task == task
    with pytest.raises(ValueError, match="must end with Segment"):
        YOLO("yolo-master-n", device="cpu", task="segment")
    with pytest.raises(ValueError, match="must end with Detect"):
        DetectionModel("yolo-master-pose-n")
    for kw in ({"model": "yolo-master-n", "task": "semantic"}, {"model": "yolo-master-semantic-n"}):
        with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
            YOLO(device="cpu", **kw)
    with pytest.raises(KeyError, match="unknown task"):
        YOLO("yolo-master-n", device="cpu", task="depth")
    for name in ("yolo-master-v0_2-seg-n", "yolo-master-v0_2-cls-n"):  # UltraOptimizedMoE is not ported
        with pytest.raises(FileNotFoundError, match=r"ROADMAP.md §1\.F item 14"):
            YOLO(name, device="cpu")
    with pytest.raises(FileNotFoundError, match=r"ROADMAP.md §1\.E item 13"):
        SegmentationModel("yolo-master-semantic-n")
    cfg = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]]], "head": [[-1, 1, "SemanticSegment", ["nc"]]]}
    with pytest.raises(KeyError, match=r"§1\.E item 13"):
        ClassificationModel(cfg)
