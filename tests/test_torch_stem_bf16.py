"""The bf16 path of the stem and of the predictor, on the CPU.

1. The stem kernel's bf16 forms (yolo_master_tpu_torch/csrc/stem.cu,
   stem_bf16_kernel) mirrored in plain PyTorch with ``ops/_bf16.py``'s helpers,
   against the fp64 stem rounded once to bf16, at every stem width and for both
   inputs (uint8, and a bf16 image with /255 not folded):
     - conv0: im2col of the image (exact in bf16) times w0 split into bf16 hi
       and lo, two passes;
     - conv1: the conv0 map split once into bf16 hi and lo, K ordered (channel
       chunk of 16, tap), one chain of three passes (lo*hi + hi*lo + hi*hi) per
       tap from zero, the chains joined by fp32 adds;
   the mirror must hold the gate the card's kernel is held to
   (``ops/_bf16.py:bf16_rounding_apart``: within 1 bf16 ulp plus the fp32 gate,
   at most 1% of the outputs a rounding apart), while products one bf16 pass
   deep must fail it.
2. The bf16 predictor follows the model: after an in-place weight edit,
   ``calibrate_bn``, ``fused_esmoe_fuse`` or a flip of ``sparse_inference``, a
   bf16 predict equals a fresh bf16 predictor's; without a change it runs the
   copy it ran before, and predictors of one model share it.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
from yolo_master_tpu_torch.ops._bf16 import bf16_rounding_apart, matmul_bf16_plain, matmul_split_bf16_plain, split_bf16
from yolo_master_tpu_torch.ops.stem import fused_stem_plain
from yolo_master_tpu_torch.utils import fuse as fuse_mod
from yolo_master_tpu_torch.utils.fuse import fused_esmoe_fuse
from yolo_master_tpu_torch.utils.weights import calibrate_bn

BF16 = torch.bfloat16
CHANNEL_CHUNK = 16  # conv0 channels per chunk of the kernel: one tap's chain is one depth-16 step


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _im2col(x, h_out, w_out):
    """x [B, H, W, C] NHWC -> the 9 taps of a k3 s2 p1 window, each [B*h_out*w_out, C], tap-major (kh, kw)."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, kh:kh + 2 * h_out:2, kw:kw + 2 * w_out:2, :].reshape(-1, x.shape[3])
            for kh in range(3) for kw in range(3)]


def stem_as_the_bf16_kernel(x, w0, b0, w1, b1, conv1_product=matmul_split_bf16_plain):
    """x [B, H, W, 3] uint8 or bf16; OIHW float32 weights -> [B, H/4, W/4, c1] bf16."""
    B, H, W, _ = x.shape
    c0, c1 = w0.shape[0], w1.shape[0]
    # conv0: [positions, 27] x [27, c0], K ordered (kh, kw, channel); A exact, w0 split, two passes
    a0 = torch.cat(_im2col(x.float(), H // 2, W // 2), 1)
    w0_hi, w0_lo = split_bf16(w0.permute(2, 3, 1, 0).reshape(27, c0))
    y0 = F.silu(a0 @ w0_lo + a0 @ w0_hi + b0).reshape(B, H // 2, W // 2, c0)
    # conv1: one chain per (channel chunk, tap), each from zero, joined in fp32 in the kernel's order
    taps = _im2col(y0, H // 4, W // 4)
    acc = torch.zeros(taps[0].shape[0], c1)
    for c in range(0, c0, CHANNEL_CHUNK):
        for t in range(9):
            acc = acc + conv1_product(taps[t][:, c:c + CHANNEL_CHUNK], w1[:, c:c + CHANNEL_CHUNK, t // 3, t % 3].T)
    return F.silu(acc + b1).reshape(B, H // 4, W // 4, c1).to(BF16)


def _stem_inputs(c0, c1, form, seed):
    """Two 64x64 images and weights drawn as chip_smoke.py's stem phases draw them
    (w1 scaled by 1.2 / sqrt(c0), so conv1's outputs keep one scale at every width)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    img = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    w0 = t((rng.random((c0, 3, 3, 3)) - 0.5) * 0.6 / 255.0)
    b0 = t(rng.random(c0) - 0.5)
    w1, b1 = t((rng.random((c1, c0, 3, 3)) - 0.5) * 1.2 / c0 ** 0.5), t(rng.random(c1) - 0.5)
    if form == "uint8":
        return img, w0, b0, w1, b1
    return (img.float() / 255.0).to(BF16), w0 * 255.0, b0, w1, b1


@pytest.mark.parametrize("form", ["uint8", "bf16"])
@pytest.mark.parametrize("c0,c1", [(16, 32), (32, 64), (64, 128), (96, 192)], ids=["n", "s", "m_l", "x"])
def test_split_bf16_stem_holds_the_bf16_gate(c0, c1, form):
    x, w0, b0, w1, b1 = _stem_inputs(c0, c1, form, seed=c0)
    ref = fused_stem_plain(x, w0.double(), b0.double(), w1.double(), b1.double(), out_dtype=BF16)  # fp64, rounded once
    got = stem_as_the_bf16_kernel(x, w0, b0, w1, b1)
    assert got.dtype == ref.dtype == BF16 and got.shape == ref.shape == (2, 16, 16, c1)
    within, apart = bf16_rounding_apart(got, ref)
    assert within and apart <= 1e-2, (within, apart)
    # products one bf16 pass deep keep about two digits: the gate must see them
    within, apart = bf16_rounding_apart(stem_as_the_bf16_kernel(x, w0, b0, w1, b1, matmul_bf16_plain), ref)
    assert not (within and apart <= 1e-2), (within, apart)


# -- the bf16 predictor follows the model -------------------------------------

KW = dict(imgsz=64, conf=1e-4, max_det=20)


def _image(seed):
    return np.random.default_rng(seed).integers(0, 256, (48, 64, 3), dtype=np.uint8)


def _facade(name):
    """A fused facade on the CPU with BN calibrated on one 64 px frame."""
    y = YOLO(name, device="cpu")
    x, _ = DetectionPredictor(y.model, imgsz=64).preprocess([_image(0)])
    calibrate_bn(y.model, x)
    return y.fuse()


def _dets(results):
    return [r.boxes.data for r in results]


def _assert_same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def _edit_weights(y):
    with torch.no_grad():
        for p in y.model.head.parameters():
            p.mul_(1.5)


def _calibrate_again(y):
    x, _ = DetectionPredictor(y.model, imgsz=64).preprocess([_image(1), _image(2)])
    calibrate_bn(y.model, x)


def _dense_eval(y):
    y.model.sparse_inference = False


CHANGES = {"weight_edit": ("yolo-master-n", _edit_weights), "calibrate_bn": ("yolo-master-n", _calibrate_again),
           "fused_esmoe_fuse": ("yolo-master-n", lambda y: fused_esmoe_fuse(y.model)),
           "sparse_inference": ("yolo-master-v0_1-n", _dense_eval)}


@pytest.mark.parametrize("change", list(CHANGES))
def test_bf16_predict_after_a_change_equals_a_fresh_predictor(change):
    name, apply = CHANGES[change]
    y = _facade(name)
    img = [_image(3), _image(4)]
    before = _dets(y.predict(img, batch=2, compute_dtype=BF16, **KW))
    copy_before = y._predictor.model
    apply(y)
    after = _dets(y.predict(img, batch=2, compute_dtype=BF16, **KW))
    assert y._predictor.model is not copy_before
    # a fresh predictor of an equal model (its own bf16 copy: copies are kept per model)
    fresh = DetectionPredictor(copy.deepcopy(y.model), names=y.names, batch=2, compute_dtype=BF16, **KW)
    assert fresh.model is not y._predictor.model
    _assert_same(after, _dets(fresh(img)))
    if change == "sparse_inference":  # v0_1's sparse and dense eval agree to rounding: the copy's switch shows it
        assert not any(getattr(m, "sparse_inference", False) for m in y._predictor.model.modules())
    else:
        assert any(not np.array_equal(a, b) for a, b in zip(before, after))
    # fp32 follows the same change, as it always did
    _assert_same(_dets(y.predict(img, batch=2, **KW)),
                 _dets(DetectionPredictor(y.model, names=y.names, batch=2, **KW)(img)))


def test_bf16_predict_without_a_change_reuses_the_copy(monkeypatch):
    """No change, no new copy: a second predict, and a predictor at another batch
    size, run the same copy (on the card its stem then keeps its weight bank)."""
    y = _facade("yolo-master-n")
    made = []
    copy_fn = fuse_mod.compute_dtype_copy
    monkeypatch.setattr(fuse_mod, "compute_dtype_copy", lambda m, d: made.append(d) or copy_fn(m, d))
    img = [_image(5), _image(6)]
    first = _dets(y.predict(img, batch=2, compute_dtype=BF16, **KW))
    model = y._predictor.model
    _assert_same(_dets(y.predict(img, batch=2, compute_dtype=BF16, **KW)), first)
    y.predict(img[0], batch=1, compute_dtype=BF16, **KW)  # a new predictor of the same model
    assert y._predictor.model is model and made == [BF16]
    key = fuse_mod.model_key(y.model)
    assert key is not None and key == fuse_mod.model_key(y.model)
