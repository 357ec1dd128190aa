"""yolo-master-v0_4 ... v0_15 (the AdaptiveGate family's detection graphs) in
the port against the JAX package, on the CPU in fp32.

1. Construction, no JAX compile: each of the twelve graphs at n has JAX's
   parameter count (v0_10-n 3,449,963 in the reference, less the 16 frozen
   DFL weights), and its weights go through ``import_state_dict`` and
   ``state_dict_from_jax`` both ways, strict, unchanged.
2. v0_10-n's ``forward_predict`` at 64 px against JAX's on the same weights
   (the port's seeded init through tests/_torch_scale.py:jax_params_of): at
   the init within 2e-3 px and 1e-5 on scores; with BN calibrated within 4x
   the port's own fp32-vs-fp64 error (floors 2e-3, 1e-5); BN folded
   (``fuse_bn``) against ``fuse_bn_params``' tree the same way. The batch is
   three images and a zero image: what JAX's predictor runs for 3 images at
   ``batch=4`` (it zero-pads a ragged batch to a power of two,
   ``yolo_master_tpu/engine/predictor.py:254-258``).
3. The batch coupling: ``_complexity`` is a mean over the batch, so that pad
   enters every image's kept expert count. On these weights the counts do not
   move (c stays near 0.5) and the padded rows equal the unpadded batch's;
   with layer 5's complexity estimator set so that the three images' c sits
   just under 0.75, the pad lifts it past 0.75 and JAX's padded forward keeps
   two experts where the unpadded one keeps one. The port's predictor does not
   pad, as the upstream torch model does not: it gives the unpadded answer.
4. Both validators on the same 6 images at imgsz 64, ``batch=4`` (the last
   batch wraps, so the coupling reaches the metrics), labelled from the
   port's own detections: per-image detection counts equal, metrics within
   1e-3.
5. Training, where it raised before: each training entry runs, the
   train-mode forward matches JAX's, and trained weights round-trip strictly
   (tests/test_torch_gated_train*.py hold the training itself).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils import metrics as jmetrics
from yolo_master_tpu.utils.fuse import fuse_bn_params
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.data import dataset as tdataset
from yolo_master_tpu_torch.engine.train_step import make_train_step
from yolo_master_tpu_torch.engine.validator import DetectionValidator
from yolo_master_tpu_torch.nn.moe import gated as tg
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils import coco_names
from yolo_master_tpu_torch.utils import metrics as tmetrics
from yolo_master_tpu_torch.utils.fuse import fuse_bn, fused_stem_fuse
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_train import synth_dataset  # noqa: F401 (fixture reuse: 16 train, 8 val 96-px images)
from test_torch_cuda import _gated_routing  # noqa: E402
from test_torch_model import _fp32_noise, _np_tree, _trainable  # noqa: E402
from test_torch_validator import METRIC_TOL, METRICS, _counting  # noqa: E402

V10 = "yolo-master-v0_10-n"
GRAPHS = [f"yolo-master-v0_{v}-n" for v in range(4, 16)]
IMGSZ, BATCH = 64, 4
VAL_SHAPES = [(48, 64), (64, 40), (64, 64), (30, 64), (64, 52), (40, 40)]  # 6 images: batches of 4 and 2 + 2 wrapped
BOX, SCORE = np.s_[..., :4], np.s_[..., 4:]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tols(port, x, setting):
    """(box, score) limits: at the init 2e-3 / 1e-5; calibrated, 4x the port's own fp32-vs-fp64 error."""
    if setting == "default":
        return 2e-3, 1e-5
    noise = _fp32_noise(port, x)
    assert noise[BOX].max() < 0.1 and noise[SCORE].max() < 1e-2
    return max(4 * noise[BOX].max(), 2e-3), max(4 * noise[SCORE].max(), 1e-5)


@pytest.fixture(scope="module")
def v10():
    """v0_10-n: the JAX model, its jitted forward_predict, the 3 images + zero pad
    [4, 64, 64, 3], and for "default" and "calibrated" (BN calibrated on the
    three images in the port) the port, the JAX tree and JAX's output on the
    padded batch and on the three images alone."""
    jm = JaxDetectionModel(V10)
    init = jax_params_of(jm, DetectionModel(V10))
    forward = jax.jit(jm.forward_predict)
    x = np.random.default_rng(17).random((3, IMGSZ, IMGSZ, 3)).astype(np.float32)
    xp = np.concatenate([x, np.zeros_like(x[:1])])
    out = {}
    for setting in ("default", "calibrated"):
        port = DetectionModel(V10)
        port.load_state_dict(state_dict_from_jax(init), strict=True)
        if setting == "calibrated":
            calibrate_bn(port, torch.from_numpy(x))
        port.eval()
        params = _np_tree(import_state_dict(init, port.state_dict(), strict=True))
        out[setting] = (port, params, np.asarray(forward(params, jnp.asarray(xp))),
                        np.asarray(forward(params, jnp.asarray(x))))
    return jm, forward, x, xp, out


# -- 1. construction ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", GRAPHS)
def test_gated_graph_builds_with_the_jax_parameter_count_and_round_trips(name):
    port = DetectionModel(name)
    jm = JaxDetectionModel(name)
    tree = jax_params_of(jm, port)  # port -> JAX, strict
    assert sum(p.numel() for p in port.parameters()) == _trainable(tree)
    if name == V10:
        assert _trainable(tree) == 3_449_963 - 16
    blocks = [m for m in port.model if isinstance(m, tg.AdaptiveGateMoE)]
    assert [m.i for m in blocks] == [5, 8, 11] and [m.num_experts for m in blocks] == [4, 8, 16]
    assert {type(m).__name__ for m in blocks} == {type(jm.layers[5]).__name__}
    back = DetectionModel(name, seed=1)
    back.load_state_dict(state_dict_from_jax(tree), strict=True)  # JAX -> port, strict
    got = back.state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(got[k], v), k


# -- 2. forward_predict ---------------------------------------------------------------------------

@pytest.mark.parametrize("setting", ["default", "calibrated"])
def test_v0_10_forward_predict_matches_jax(v10, setting):
    _, _, x, xp, out = v10
    port, _, ref, ref3 = out[setting]
    with torch.no_grad():
        y = port.forward_predict(torch.from_numpy(xp)).numpy()
        y3 = port.forward_predict(torch.from_numpy(x)).numpy()
    assert y.shape == ref.shape == (4, 84, 84)
    if setting == "calibrated":
        assert np.abs(ref[0] - ref[1]).max() > 1.0  # the output depends on the image
    box_tol, score_tol = _tols(port, xp, setting)
    for a, b in ((y, ref), (y3, ref3)):
        assert np.abs(a[BOX] - b[BOX]).max() <= box_tol
        assert np.abs(a[SCORE] - b[SCORE]).max() <= score_tol


def test_v0_10_fuse_folds_what_jax_folds(v10):
    """fuse_bn folds the Convs and leaves the gated blocks' static_net
    [PlainConv, BatchNorm] pairs (2 a block), as fuse_bn_params does: the
    folded JAX tree loads strict into the folded port, and the two agree within
    4x the folded port's own fp32-vs-fp64 error; the fused stem's plain
    version on uint8 lands as close to the unfused JAX model."""
    jm, forward, _, xp, out = v10
    port, params, ref, _ = out["calibrated"]
    fused = copy.deepcopy(port)
    fuse_bn(fused)
    assert sum(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules()) == 6
    jfused = _np_tree(fuse_bn_params(params))
    fused.load_state_dict(state_dict_from_jax(jfused), strict=True)
    ref_f = np.asarray(forward(jfused, jnp.asarray(xp)))
    with torch.no_grad():
        y = fused.forward_predict(torch.from_numpy(xp)).numpy()
    box_tol, score_tol = _tols(fused, xp, "calibrated")
    assert np.abs(y[BOX] - ref_f[BOX]).max() <= box_tol
    assert np.abs(y[SCORE] - ref_f[SCORE]).max() <= score_tol
    fused_stem_fuse(fused)
    x_u8 = np.round(xp * 255).astype(np.uint8)
    with torch.no_grad():
        y8 = fused.forward_predict(torch.from_numpy(x_u8)).numpy()
    ref8 = np.asarray(forward(params, jnp.asarray(x_u8 / np.float32(255))))
    box_tol, score_tol = _tols(fused, x_u8.astype(np.float32), "calibrated")
    assert np.abs(y8[BOX] - ref8[BOX]).max() <= box_tol
    assert np.abs(y8[SCORE] - ref8[SCORE]).max() <= score_tol


# -- 3. the batch coupling --------------------------------------------------------------------------

def _keep_counts(port, x, monkeypatch):
    """The port's kept expert count at each gated block (layers 5, 8, 11) on batch x."""
    seen = []
    with monkeypatch.context() as mp, torch.no_grad():
        for k, v in _gated_routing(seen=seen).items():
            mp.setattr(tg, k, v)
        port.forward_predict(torch.from_numpy(x))
    return [int(k) for _, k in seen]


def _pooled_dynamic_inputs(port, x):
    """Layer 5's pooled dynamic branch (the complexity estimator's input) per image."""
    seen = []
    block = port.model[5]
    hook = block.complexity_estimator[0].register_forward_hook(lambda m, i, o: seen.append(o.flatten(1)))
    with torch.no_grad():
        port.forward_predict(torch.from_numpy(x))
    hook.remove()
    return seen[0].double().numpy()


def test_zero_padding_moves_the_kept_expert_count_through_the_batch_mean(v10, monkeypatch):
    jm, forward, x, xp, out = v10
    port, params, ref, ref3 = out["calibrated"]
    # the seeded weights: c near 0.5 in every block, one expert kept with or without the pad
    assert _keep_counts(port, x, monkeypatch) == _keep_counts(port, xp, monkeypatch) == [1, 1, 1]
    box_tol, score_tol = _tols(port, xp, "calibrated")
    assert np.abs(ref[:3][BOX] - ref3[BOX]).max() <= box_tol
    assert np.abs(ref[:3][SCORE] - ref3[SCORE]).max() <= score_tol
    # layer 5's estimator set so that the three images' c is 0.74 and the zero image's well above
    m = _pooled_dynamic_inputs(port, xp)
    d = m[3] - m[:3].mean(0)
    w = 3.0 * d / (d @ d)
    z = m @ w
    lo, hi = -20.0, 20.0
    for _ in range(60):
        b = (lo + hi) / 2
        lo, hi = (b, hi) if np.mean(1 / (1 + np.exp(-(z[:3] + b)))) < 0.74 else (lo, b)
    tuned = copy.deepcopy(port)
    est = tuned.model[5].complexity_estimator[1]
    with torch.no_grad():
        est.weight.copy_(torch.from_numpy(w).float().view_as(est.weight))
        est.bias.fill_(b)
    assert _keep_counts(tuned, x, monkeypatch)[0] == 1 and _keep_counts(tuned, xp, monkeypatch)[0] == 2
    tparams = _np_tree(import_state_dict(params, tuned.state_dict(), strict=True))
    jpad, junpad = np.asarray(forward(tparams, jnp.asarray(xp))), np.asarray(forward(tparams, jnp.asarray(x)))
    assert np.abs(jpad[:3][SCORE] - junpad[SCORE]).max() > 100 * score_tol  # JAX's pad changed the three images
    with torch.no_grad():
        y3 = tuned.forward_predict(torch.from_numpy(x)).numpy()
    box_tol, score_tol = _tols(tuned, x, "calibrated")
    assert np.abs(y3[BOX] - junpad[BOX]).max() <= box_tol  # the port's unpadded batch is JAX's unpadded one
    assert np.abs(y3[SCORE] - junpad[SCORE]).max() <= score_tol


# -- 4. both validators -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """6 noise PNGs with rectangles (long side 64, so no resize) and a yaml
    (names: the 80 COCO classes); labels come later (:func:`labelled`)."""
    root = tmp_path_factory.mktemp("gatedval")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(31)
    for i, (h0, w0) in enumerate(VAL_SHAPES):
        im = rng.integers(0, 60, (h0, w0, 3)).astype(np.uint8)
        for _ in range(2):
            bw, bh = int(rng.integers(w0 // 5, w0 // 2)), int(rng.integers(h0 // 5, h0 // 2))
            x1, y1 = int(rng.integers(0, w0 - bw)), int(rng.integers(0, h0 - bh))
            im[y1:y1 + bh, x1:x1 + bw] = rng.integers(80, 255, 3)
        Image.fromarray(im).save(root / "images" / f"{i + 1:06d}.png")
    lines = [f"path: {root}", "train: images", "val: images", "names:"]
    (root / "data.yaml").write_text("\n".join(lines + [f"  {k}: {v}" for k, v in coco_names().items()]) + "\n")
    return root


@pytest.fixture(scope="module")
def val_weights(val_set):
    """(JAX params, the port's facade): the seeded init with BN calibrated on
    the set's images, the head's class biases at 0 (the init's prior puts
    nearly every score below conf 0.001), carried into the JAX tree."""
    y = YOLO(V10, device="cpu", seed=5)
    ds = tdataset.YOLODataset(str(val_set / "data.yaml"), imgsz=IMGSZ)
    images = next(tdataset.DataLoader(ds, len(ds)).epoch())["images"]
    calibrate_bn(y.model, torch.from_numpy(images).float() / 255.0)
    with torch.no_grad():
        for branch in y.model.head.cv3:
            branch[-1].bias.zero_()
    jm = JaxDetectionModel(V10)
    return jm, import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), y.model.state_dict(), strict=True), y


@pytest.fixture(scope="module")
def labelled(val_set, val_weights):
    """Labels from the port's own detections at batch 4 (each image's 3 best,
    jittered), so that the metrics compare real matches."""
    _, _, y = val_weights
    ds = tdataset.YOLODataset(str(val_set / "data.yaml"), imgsz=IMGSZ)
    v = DetectionValidator(y.model, imgsz=IMGSZ)
    rng = np.random.default_rng(8)
    seen = 0
    for b in tdataset.DataLoader(ds, BATCH).epoch():
        det = {k: t.numpy() for k, t in v.run(v.preprocess(b["images"])).items()}
        for i in range(min(BATCH, len(ds) - seen)):
            h0, w0 = ds.shapes[seen]
            boxes = v._to_original(det["boxes"][i, :3], *v._letterbox_params(h0, w0), w0, h0, clip=True)
            rows = []
            for box, c in zip(boxes, det["classes"][i, :3]):
                box = box + rng.uniform(-0.1, 0.1, 4) * np.tile(box[2:] - box[:2], 2)
                x1, x2 = np.clip(box[[0, 2]], 0, w0)
                y1, y2 = np.clip(box[[1, 3]], 0, h0)
                if x2 - x1 >= 1 and y2 - y1 >= 1:
                    rows.append(f"{int(c)} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} "
                                f"{(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
            (val_set / "labels" / f"{Path(ds.img_files[seen]).stem}.txt").write_text("\n".join(rows) + "\n")
            seen += 1
    return val_set / "data.yaml"


def test_v0_10_validators_agree_on_a_wrapped_batch(labelled, val_weights, monkeypatch):
    jm, params, y = val_weights
    with monkeypatch.context() as mp:
        counts = _counting(mp, tmetrics.DetMetrics)
        m = y.val(data=str(labelled), imgsz=IMGSZ, batch=BATCH)
    with monkeypatch.context() as mp:
        jcounts = _counting(mp, jmetrics.DetMetrics)
        jmm = JaxValidator(model=jm, params=params, data=str(labelled), imgsz=IMGSZ, batch=BATCH)()
    assert m["images"] == jmm["images"] == len(VAL_SHAPES)
    assert counts == jcounts and min(counts) > 0
    assert m["mAP50"] > 0.1  # real matches, not 0 against 0
    for k in METRICS:
        assert np.isfinite(m[k]) and abs(m[k] - jmm[k]) <= METRIC_TOL, (k, m[k], jmm[k])


# -- 5. training, where it raised before ----------------------------------------------------------

def test_training_a_gated_model_refuses(v10, synth_dataset, tmp_path):  # noqa: F811
    """Kept under its name from when each of these calls raised: each now trains.
    forward_train of the calibrated v0_10-n in train mode at step 0: the head
    outputs within 4x the port's own fp32-vs-fp64 error (floor 1e-5) of JAX's
    forward_train, each gated block's aux loss within 1e-5 relative of JAX's;
    make_train_step builds; YOLO(v0_10-n).train(data=...) and
    .train(data=[a, a]) (MultiTrainer) run an epoch with finite losses; the
    trained weights go through the JAX tree and back, strict, every floating
    entry bitwise (BN statistics included; the JAX tree holds no
    num_batches_tracked, which comes back 0)."""
    jm, _, x, _, out = v10
    port, params, _, _ = out["calibrated"]
    model = copy.deepcopy(port).train()
    with torch.no_grad():
        preds, aux = model.forward_train(torch.from_numpy(x))
        preds64, _ = copy.deepcopy(port).double().train().forward_train(torch.from_numpy(x).double())

    def ref(p, x):
        ctx = Context(training=True, step=0)
        return jm.forward_train(p, x, ctx)["one2many"], ctx.aux

    jpreds, jaux = jax.jit(ref)(params, jnp.asarray(x))
    for k in ("boxes", "scores"):
        got, r = preds["one2many"][k].numpy(), np.asarray(jpreds[k])
        noise = np.abs(got - preds64["one2many"][k].numpy()).max()
        assert got.shape == r.shape and np.abs(got - r).max() <= max(4 * noise, 1e-5), (k, np.abs(got - r).max(), noise)
    assert [n for n in aux] == [f"model.{i}" for i in (5, 8, 11)]
    for name, rec in aux.items():
        jv = float(jaux[name.replace("model.", "layers.")])
        assert abs(float(rec.value) - jv) <= 1e-5 * abs(jv), (name, float(rec.value), jv)
    assert callable(make_train_step(copy.deepcopy(port)))
    kw = dict(epochs=1, batch=4, imgsz=IMGSZ, workers=0, val=False, amp=False)
    y = YOLO(V10, device="cpu").load_state_dict(port.state_dict())
    m = y.train(data=synth_dataset, save_dir=str(tmp_path / "run"), **kw)
    assert "best_fitness" in m
    rows = (tmp_path / "run" / "results.csv").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(",")[1:])
    runs = YOLO(V10, device="cpu").load_state_dict(port.state_dict()).train(
        data=[synth_dataset, synth_dataset], save_dir=str(tmp_path / "multi"), **kw)
    assert list(runs) == ["data", "data-2"]
    trained = y.model.state_dict()
    tree = _np_tree(import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), trained, strict=True))
    back = DetectionModel(V10, seed=1)
    back.load_state_dict(state_dict_from_jax(tree), strict=True)
    for k, v in back.state_dict().items():
        if v.is_floating_point():
            assert torch.equal(v, trained[k]), k
        else:
            assert int(v) == 0, k
    moved = [k for k in trained if k.endswith("static_net.1.running_var") and not torch.equal(trained[k],
                                                                                             port.state_dict()[k])]
    assert moved == [f"model.{i}.static_net.1.running_var" for i in (5, 8, 11)]
