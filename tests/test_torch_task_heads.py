"""The task heads (nn/heads.py: Segment, Pose, OBB, Classify, Proto and its
transposed conv) and the rotated-box ops (ops/rotated.py,
ops/nms.py:rotated_non_max_suppression) against the JAX package's, module by
module on the CPU in fp32, on the same weights: the port's (its BN statistics
drawn at random), carried into ``jax.eval_shape``'s tree of the JAX module by
``import_state_dict`` and back by ``state_dict_from_jax``, strict both ways,
unchanged.

Tolerances: decoded boxes within 2e-3 px and scores within 1e-5
(tests/test_parity_torch.py:54-55); prototypes, mask coefficients,
keypoints and angles within 1e-4 + 1e-4 |ref|; keep sets exactly equal.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn import heads as jheads
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.ops import rotated as jrot
from yolo_master_tpu.ops.nms import rotated_non_max_suppression as jax_rotated_nms
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.nn import heads as theads
from yolo_master_tpu_torch.ops import rotated as trot
from yolo_master_tpu_torch.ops.nms import rotated_non_max_suppression

from test_torch_model import _load_module  # noqa: E402 (tests/ is on the path)

CH = (16, 32, 64)  # three levels at 8x8, 4x4 and 2x2 (a 64-px input's P3-P5)
HW = ((8, 8), (4, 4), (2, 2))
STRIDES = (8, 16, 32)
BOX_TOL, SCORE_TOL = 2e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(a, ref, what):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (what, a.shape, ref.shape)
    bad = np.abs(a - ref) > 1e-4 + 1e-4 * np.abs(ref)
    assert not bad.any(), (what, np.abs(a - ref).max())


def _feats(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, w, c)).astype(np.float32) for (h, w), c in zip(HW, CH)]


def _nchw(f):
    return torch.from_numpy(f).permute(0, 3, 1, 2)


def _pair(jax_cls, port_cls, *args, seed=0, **kw):
    """(JAX module, its params, the port's module): the port's weights, BN
    statistics drawn at random, in JAX's tree (``import_state_dict``, strict;
    ``jax.eval_shape`` gives the tree without running JAX's init)."""
    jm, tm = jax_cls(*args, **kw), port_cls(*args, **kw)
    for m in (jm, tm):
        if hasattr(m, "set_strides"):
            m.set_strides(STRIDES)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in tm.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.running_mean.normal_(0, 0.2, generator=g)
                bn.running_var.uniform_(0.5, 2.0, generator=g)
    shapes = {"layers": {"0": jax.eval_shape(jm.init, jax.random.PRNGKey(0))}}
    params = import_state_dict(shapes, {f"model.0.{k}": v for k, v in tm.state_dict().items()}, strict=True)
    return jm, jax.tree_util.tree_map(np.asarray, params["layers"]["0"]), tm.eval()


def _round_trip(tm, params):
    """JAX's tree -> a fresh port module (``state_dict_from_jax``, strict) gives the
    port's weights back bit for bit."""
    back = copy.deepcopy(tm)
    for t in back.state_dict().values():
        t.zero_()
    _load_module(back, params)
    got = back.state_dict()
    for k, v in tm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def _jax_head(jh, params, feats):
    """JAX's eval dict (hw_shapes dropped) and decode on NHWC maps."""
    def run(p, fs):
        out = jh(p, fs, Context(training=False))
        hw = out.pop("hw_shapes")
        return out, jh.decode({**out, "hw_shapes": hw})
    out, dec = jax.jit(run)(params, [jnp.asarray(f) for f in feats])
    return jax.tree_util.tree_map(np.asarray, out), np.asarray(dec)


EXTRA = {"Segment": "mask_coefficient", "Pose": "kpts", "OBB": "angle"}
HEADS = [("Segment", dict(nc=5, nm=8, npr=24)), ("Pose", dict(nc=2, kpt_shape=(5, 3))),
         ("Pose", dict(nc=1, kpt_shape=(4, 2))), ("OBB", dict(nc=4, ne=1))]


@pytest.mark.parametrize("end2end", [False, True], ids=["one2many", "end2end"])
@pytest.mark.parametrize("name,kw", HEADS, ids=["segment", "pose", "pose_xy", "obb"])
def test_head_matches_jax(name, kw, end2end):
    """Raw branch outputs, prototypes and decode against JAX's module, in eval
    (an end2end head reads its one2one branch) and in train mode (both
    branches; BN on its statistics in both packages), then the strict round
    trip of the weights."""
    jh, params, th = _pair(getattr(jheads, name), getattr(theads, name), **kw, end2end=end2end, ch=CH,
                           seed=len(name))
    feats = _feats(seed=len(name))
    ref, dec_ref = _jax_head(jh, params, feats)
    with torch.no_grad():
        out = th([_nchw(f) for f in feats])
        dec = th.decode(out).numpy()
    assert out["hw_shapes"] == HW
    branch = ref["one2one"] if end2end else ref["one2many"]
    key = EXTRA[name]
    _close(out[key].numpy(), branch[key], key)
    nc = kw["nc"]
    # decode: boxes (xywh, or OBB's rotated xywh), scores, then the extra columns
    assert dec.shape == dec_ref.shape
    assert np.abs(dec[..., :4] - dec_ref[..., :4]).max() <= BOX_TOL
    assert np.abs(dec[..., 4:4 + nc] - dec_ref[..., 4:4 + nc]).max() <= SCORE_TOL
    _close(dec[..., 4 + nc:], dec_ref[..., 4 + nc:], f"decoded {key}")
    if name == "Segment":
        _close(out["proto"].permute(0, 2, 3, 1).numpy(), ref["proto"], "proto")
        assert out["proto"].shape[-2:] == (16, 16)
    # train mode, BN held on its statistics: both branches as JAX's eval dict has them
    th.train()
    for m in th.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    with torch.no_grad():
        tout = th([_nchw(f) for f in feats])
    for b in ("one2many", "one2one") if end2end else ("one2many",):
        for k in ("boxes", "scores", key):
            _close(tout[b][k].numpy(), ref[b][k], f"{b}.{k}")
    assert ("one2one" in tout) == end2end
    _round_trip(th, params)


def test_kpts_decode_matches_jax():
    """xy * 2 + anchor - 0.5 times the stride; the visibility sigmoid."""
    jh = jheads.Pose(nc=1, kpt_shape=(17, 3), ch=CH)
    th = theads.Pose(nc=1, kpt_shape=(17, 3), ch=CH)
    jh.set_strides(STRIDES)
    th.set_strides(STRIDES)
    kpts = np.random.default_rng(3).standard_normal((2, 84, 51)).astype(np.float32) * 3
    ref = np.asarray(jh.kpts_decode(jnp.asarray(kpts), HW))
    got = th.kpts_decode(torch.from_numpy(kpts), HW).numpy()
    _close(got, ref, "kpts")


def test_conv_transpose_matches_jax_with_cin_unequal_cout():
    """JAX stores the 2x2 stride-2 transposed conv as [2, 2, cout, cin] and
    computes an einsum + depth-to-space; the port's F.conv_transpose2d reads
    PyTorch's [cin, cout, 2, 2]. cin != cout, so that an axis swap fails."""
    jm, params, tm = _pair(lambda: jheads.ConvTranspose2x(6, 10), lambda: theads.ConvTranspose2d(6, 10, 2, 2, 0))
    assert params["w"].shape == (2, 2, 10, 6) and tm.weight.shape == (6, 10, 2, 2)
    x = np.random.default_rng(2).standard_normal((2, 5, 7, 6)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jm(p, a, Context()))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 10, 14, 10)
    _close(got, ref, "conv transpose")
    # the swapped reading (cout and cin exchanged) does not fit the weights
    with pytest.raises(RuntimeError):
        torch.nn.functional.conv_transpose2d(_nchw(x), tm.weight.transpose(0, 1), stride=2)
    _round_trip(tm, params)


def test_proto_matches_jax():
    jm, params, tm = _pair(jheads.Proto, theads.Proto, 16, 24, 8, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 16)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jm(p, a, Context()))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close(got, ref, "proto")
    _round_trip(tm, params)


def test_classify_matches_jax():
    """Conv 1x1 to 1280, global average pool, Linear: softmax probabilities in
    eval, against JAX's; logits in train mode (BN held on its statistics),
    equal to the log of those probabilities up to a constant per image."""
    jm, params, tm = _pair(jheads.Classify, theads.Classify, 64, 10, seed=6)
    x = np.random.default_rng(7).standard_normal((3, 2, 2, 64)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jm(p, a, Context()))(params, jnp.asarray(x)))
    with torch.no_grad():
        probs = tm(_nchw(x)).numpy()
        tm.train()
        tm.conv.bn.eval()
        logits = tm(_nchw(x)).numpy()
    _close(probs, ref, "probabilities")
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)
    centred = np.log(ref) - np.log(ref).mean(-1, keepdims=True)
    _close(logits - logits.mean(-1, keepdims=True), centred, "logits")
    _round_trip(tm, params)


def test_rotated_ops_match_jax():
    rng = np.random.default_rng(8)
    a = np.concatenate([rng.uniform(0, 64, (50, 2)), rng.uniform(1, 30, (50, 2)),
                        rng.uniform(-np.pi / 4, 3 * np.pi / 4, (50, 1))], -1).astype(np.float32)
    b = a[rng.permutation(50)] + rng.normal(0, 2, a.shape).astype(np.float32) * np.array([1, 1, 0.2, 0.2, 0.1],
                                                                                         np.float32)
    ref = np.asarray(jrot.probiou(jnp.asarray(a)[:, None], jnp.asarray(b)[None]))
    got = trot.probiou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None]).numpy()
    assert got.shape == (50, 50) and ref.max() > 0.3
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    dist = rng.uniform(0, 10, (2, 30, 4)).astype(np.float32)
    ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 30, 1)).astype(np.float32)
    anc = rng.uniform(0, 8, (1, 30, 2)).astype(np.float32)
    np.testing.assert_allclose(trot.dist2rbox(*map(torch.from_numpy, (dist, ang, anc))).numpy(),
                               np.asarray(jrot.dist2rbox(*map(jnp.asarray, (dist, ang, anc)))), atol=1e-5, rtol=0)
    np.testing.assert_allclose(trot.xywhr2xyxyxyxy(torch.from_numpy(a)).numpy(),
                               np.asarray(jrot.xywhr2xyxyxyxy(jnp.asarray(a))), atol=1e-4, rtol=0)


def _obb_predictions(seed, b=2, a=200, nc=3):
    """[B, A, 4+nc+1]: xywh in a 64-px frame, scores on a 1/16 grid (many exact
    ties, some below conf), angles; clusters of overlapping boxes."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 64, (b, a // 4, 2)).repeat(4, 1) + rng.normal(0, 2, (b, a, 2))
    wh = rng.uniform(4, 24, (b, a, 2))
    ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, a, 1))
    scores = np.round(rng.uniform(0, 1, (b, a, nc)) * 16) / 16
    return np.concatenate([ctr, wh, scores, ang], -1).astype(np.float32)


@pytest.mark.parametrize("multi_label,agnostic,max_det,max_nms",
                         [(False, False, 300, 2048), (True, False, 300, 2048), (False, True, 30, 64),
                          (True, False, 40, 128), (True, True, 300, 4096)])
def test_rotated_nms_matches_jax(multi_label, agnostic, max_det, max_nms):
    """Fast-NMS keep sets equal to JAX's, tied scores included; more candidates
    than max_det and fewer; the class offset on the centres."""
    pred = _obb_predictions(seed=int(multi_label) + 2 * int(agnostic) + max_det)
    kw = dict(nc=3, conf_thres=0.1, iou_thres=0.3, max_det=max_det, max_nms=max_nms, agnostic=agnostic,
              multi_label=multi_label)
    ref = {k: np.asarray(v) for k, v in jax_rotated_nms(jnp.asarray(pred), **kw).items()}
    got = {k: v.numpy() for k, v in rotated_non_max_suppression(torch.from_numpy(pred), **kw).items()}
    assert set(got) == set(ref)
    assert ref["valid"].any()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
