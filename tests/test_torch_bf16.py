"""The port's bf16 inference path against the JAX package's bf16, on the CPU.

The JAX package runs bf16 with fp32 parameters and per-op casts (its facade's
``predict(compute_dtype=jnp.bfloat16)``); the port runs a bf16 copy of the
model made once (``utils/fuse.py:compute_dtype_copy``). Inputs and BN
statistics come from numpy seeds, at 64 px and scale n. The tolerance has
three parts:

1. each module on its own, element by element: max |port - JAX| within
   4 * 2^-8 * max |JAX| (four bf16 roundings of the largest output);
2. the whole model: at the bare init element by element, within twice JAX's
   own bf16-vs-fp32 error; with calibrated BN, where random weights amplify
   rounding by orders of magnitude and no element-wise gate between two bf16
   programs can hold, by error statistics: the rel-RMS distance of the port's bf16 head
   outputs from JAX's fp32 within 1.5 x that of JAX's own bf16. v0_1-n's
   routers pick their top-2 experts from near-equal probabilities, and the two
   bf16 programs part where a rounding flips a pick (a routing flip): there
   the port's routing is pinned to JAX's bf16 picks, and the flips are counted;
3. decode and NMS exact: JAX's bf16 head outputs, many logits tied, through
   the port's decode_topk and NMS give JAX's keep sets.
fp32 stays the default and gives what it gave before.
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
from yolo_master_tpu.nn.moe.dispatch import top_k_from_weights as jax_top_k_from_weights
from yolo_master_tpu.nn.moe.mixtures import OptimizedMOEImproved as JaxOptimizedMOE
from yolo_master_tpu.nn.moe.mixtures import process_logits as jax_process_logits
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_master_tpu.utils.fuse import fuse_bn_params
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
from yolo_master_tpu_torch.nn import heads as theads
from yolo_master_tpu_torch.nn import layers as tlayers
from yolo_master_tpu_torch.nn.moe import ES_MOE, FusedESMOE, OptimizedMOEImproved
from yolo_master_tpu_torch.nn.moe.dispatch import top_k_from_weights
from yolo_master_tpu_torch.nn.moe import mixtures as tmixtures
from yolo_master_tpu_torch.nn.moe.mixtures import process_logits
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.ops.cuda_nms import _check_candidates
from yolo_master_tpu_torch.ops.nms import non_max_suppression
from yolo_master_tpu_torch.utils.fuse import KEEP_FP32, compute_dtype_copy, fuse_bn, fused_esmoe_fuse
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_model import _load_module, _np_tree, _perturb_bn  # noqa: E402

BF16 = torch.bfloat16
CTX = Context(training=False)
MODULE_TOL = 4 * 2.0 ** -8  # of max |JAX output|
# v0_1-n's routing picks that differ between the port's bf16 and JAX's at layers 5, 8, 11 (measured)
FLIPS_UNFUSED, FLIPS_FOLDED = [0, 2, 3], [0, 0, 1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bf16(x: np.ndarray):
    """The same bf16 rounding of x for both packages: (JAX array, port NCHW channels_last tensor)."""
    t = torch.from_numpy(x).to(BF16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t.permute(0, 3, 1, 2)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


# -- (a) each module on its own ---------------------------------------------------------------

def _module_cases():
    def detect():
        ch = (16, 32, 64)
        j = jheads.Detect(nc=80, reg_max=16, ch=ch)
        j.set_strides((8, 16, 32))
        t = theads.Detect(nc=80, reg_max=16, ch=ch)
        t.set_strides((8, 16, 32))
        return j, t, [(2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 64)]

    return {
        "Conv": lambda: (jlayers.Conv(16, 32, 3, 2), tlayers.Conv(16, 32, 3, 2), [(2, 16, 16, 16)]),
        "C3k2": lambda: (jlayers.C3k2(32, 64, n=1, c3k=True, e=0.5), tlayers.C3k2(32, 64, n=1, c3k=True, e=0.5),
                         [(2, 8, 12, 32)]),
        "A2C2f": lambda: (jlayers.A2C2f(64, 64, n=1, a2=True, area=4), tlayers.A2C2f(64, 64, n=1, a2=True, area=4),
                          [(2, 8, 8, 64)]),
        "A2C2f_residual": lambda: (jlayers.A2C2f(64, 64, n=1, a2=True, area=4, residual=True, mlp_ratio=1.2),
                                   tlayers.A2C2f(64, 64, n=1, a2=True, area=4, residual=True, mlp_ratio=1.2),
                                   [(2, 8, 8, 64)]),
        "ES_MOE_dense": lambda: (JaxESMOE(32, 32), ES_MOE(32, 32), [(2, 10, 10, 32)]),
        "ES_MOE_sparse": lambda: (JaxESMOE(32, 32, num_experts=4, top_k=2), ES_MOE(32, 32, num_experts=4, top_k=2),
                                  [(4, 10, 10, 32)]),
        "OptimizedMOEImproved": lambda: (JaxOptimizedMOE(32, 32, num_experts=8, top_k=2, progressive_sparsity=False),
                                         OptimizedMOEImproved(32, 32, num_experts=8, top_k=2), [(4, 16, 16, 32)]),
        "Detect": detect,
    }


@pytest.mark.parametrize("name", list(_module_cases()))
def test_module_matches_jax_in_bf16(name):
    """Each module class of the bf16 path, in the port's bf16 copy (Conv with
    unfused BN), against the JAX module on the same bf16 input and weights,
    random BN statistics: max |port - JAX| <= 4 * 2^-8 * max |JAX|. The
    OptimizedMOEImproved router picks the same experts (indices equal)."""
    rng = np.random.default_rng(12)
    jm, tm, shapes = _module_cases()[name]()
    jm = jm.finalize("m")
    p = _perturb_bn(_np_tree(jax.jit(jm.init)(jax.random.PRNGKey(7))), rng)  # jit: the eager values, one compile
    if "gamma" in p:
        p["gamma"] = rng.uniform(0.5, 1.5, p["gamma"].shape).astype(np.float32)
    tb = compute_dtype_copy(_load_module(tm, p), BF16)
    xs = [_bf16(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    with torch.no_grad():
        if name == "Detect":
            ref = jm(p, [x for x, _ in xs], CTX)["one2many"]
            out = tb([t for _, t in xs])
            pairs = [(out["boxes"], ref["boxes"]), (out["scores"], ref["scores"])]
        else:
            pairs = [(tb(xs[0][1]).permute(0, 2, 3, 1), jm(p, xs[0][0], CTX))]
        if name == "OptimizedMOEImproved":
            jw, _, _ = jax_process_logits(jm.routing.logits(p["routing"], xs[0][0], CTX), training=False,
                                          noise_std=0.0, top_k=2, num_experts=8)
            tw = process_logits(tb.routing.logits(xs[0][1]), 2)[0]
            jidx, tidx = np.asarray(jax_top_k_from_weights(jw, 2)[1]), top_k_from_weights(tw, 2)[1].numpy()
            np.testing.assert_array_equal(tidx, jidx)
    for out, ref in pairs:
        assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
        out, ref = _f32(out), _f32(ref)
        assert out.shape == ref.shape and np.isfinite(out).all()
        assert np.abs(out - ref).max() <= MODULE_TOL * np.abs(ref).max(), (np.abs(out - ref).max(), np.abs(ref).max())


# -- (b, c, d) the whole model --------------------------------------------------------------

def _rel_rms(a, ref):
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


def _moe_layers(jm):
    return [i for i, spec in enumerate(jm.specs) if isinstance(spec.module, JaxOptimizedMOE)]


def _jax_routing(jm):
    """A jitted (params, x) -> the top-k expert indices [B, K] that JAX's eval picks
    at each OptimizedMOEImproved block, in forward order."""
    layers = _moe_layers(jm)

    @jax.jit
    def routing(p, x):
        _, taps = jm.forward_features_with_taps(p, x, CTX, [i - 1 for i in layers])
        out = []
        for i in layers:
            mod = jm.layers[i]
            w, _, _ = jax_process_logits(mod.routing.logits(p["layers"][str(i)]["routing"], taps[i - 1], CTX),
                                         training=False, noise_std=0.0, top_k=mod.top_k, num_experts=mod.num_experts)
            out.append(jax_top_k_from_weights(w, mod.top_k)[1])
        return out

    return routing


@pytest.fixture(scope="module")
def models():
    """yolo-master-n and yolo-master-v0_1-n at 64 px, a batch of 8: the port
    and JAX on the same weights, the init as it is ("default") and with BN
    calibrated in the port and carried back ("calibrated"). Both take the
    port's seeded init (the JAX init's distributions; the JAX tree through
    tests/_torch_scale.py:jax_params_of, without the 30-s JAX init). v0_1-n
    took the JAX init until the cause of its 2.2x was found: no cast differs
    (block by block, on JAX's bf16 inputs, the port's bf16 is as close to
    JAX's fp32 as JAX's bf16 is, 0.88-1.0x), but 5 of its 24 routing picks
    (8 samples x 3 blocks) differ between the two bf16 programs, and with the
    port's routing pinned to JAX's bf16 picks the gate holds (PERF.md §7).
    For each: the port's fp32 model and JAX's raw head outputs and decode, in
    fp32 and bf16, of the unfused parameters and (calibrated) of
    fuse_bn_params'; for v0_1-n also JAX's bf16 routing picks of both."""
    out = {}
    for name, seed in (("yolo-master-n", 1), ("yolo-master-v0_1-n", 5)):
        jm = JaxDetectionModel(name)
        init = jax_params_of(jm, DetectionModel(name))

        @jax.jit
        def forward(p, x, jm=jm):
            preds = jm.forward_features(p, x, Context(training=False))
            return preds["one2many"]["boxes"], preds["one2many"]["scores"], jm.head.decode(preds)

        routing = _jax_routing(jm) if _moe_layers(jm) else None
        x = np.random.default_rng(seed).random((8, 64, 64, 3)).astype(np.float32)
        xj, _ = _bf16(x)
        for setting in ("default", "calibrated"):
            port = DetectionModel(name)
            port.load_state_dict(state_dict_from_jax(init), strict=True)
            if setting == "calibrated":
                calibrate_bn(port, torch.from_numpy(x))
            port.eval()
            params = import_state_dict(init, port.state_dict(), strict=True)
            out[name, setting] = case = dict(port=port, x=x, jm=jm, f32=forward(params, jnp.asarray(x)),
                                             bf16=forward(params, xj))
            if setting == "calibrated":
                folded = fuse_bn_params(params)
                case.update(f32_folded=forward(folded, jnp.asarray(x)), bf16_folded=forward(folded, xj))
                if routing is not None:
                    case.update(picks=routing(params, xj), picks_folded=routing(folded, xj))
    return out


def _port_bf16(case, fuse=False):
    """The port's bf16 copy (of the BN-folded model with ``fuse``) on the bf16 input:
    (raw box logits, raw class logits, decode), fp32 numpy."""
    model = copy.deepcopy(case["port"])
    if fuse:
        fuse_bn(model)
    model = compute_dtype_copy(model, BF16)
    with torch.no_grad():
        preds = model(torch.from_numpy(case["x"]).to(BF16))
        decoded = model.head.decode(preds)
    assert preds["boxes"].dtype == preds["scores"].dtype == BF16 and decoded.dtype == torch.float32
    return preds["boxes"].float().numpy(), preds["scores"].float().numpy(), decoded.numpy()


def _pinned_routing(monkeypatch, picks):
    """Make each OptimizedMOEImproved block, in forward order, route by ``picks``
    (JAX's [B, K] bf16 picks) over its own probabilities, renormalised as
    process_logits does."""
    it = iter([torch.from_numpy(np.array(p)).long() for p in picks])

    def pinned(logits, top_k, noise=None):
        logits = logits.float()
        probs = torch.softmax(logits.clamp(-30.0, 30.0), dim=-1)
        w = probs * torch.zeros_like(probs, dtype=torch.bool).scatter_(1, next(it), True)
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), probs, logits

    monkeypatch.setattr(tmixtures, "process_logits", pinned)


def test_whole_model_at_the_jax_init_matches_jax_bf16(models):
    """The init as it is (activations fade with depth): the port's bf16 decode
    against JAX's bf16, element by element, within twice JAX's own
    bf16-vs-fp32 error (floors 2e-3 px and 1e-5, the fp32 gates')."""
    case = models["yolo-master-n", "default"]
    _, _, dec = _port_bf16(case)
    ref16, ref32 = np.asarray(case["bf16"][2]), np.asarray(case["f32"][2])
    for sl, floor in ((np.s_[..., :4], 2e-3), (np.s_[..., 4:], 1e-5)):
        own = np.abs(ref16[sl] - ref32[sl]).max()
        assert np.abs(dec[sl] - ref16[sl]).max() <= max(2 * own, floor), (np.abs(dec[sl] - ref16[sl]).max(), own)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "bn_folded"])
@pytest.mark.parametrize("name", ["yolo-master-n", "yolo-master-v0_1-n"])
def test_whole_model_with_calibrated_bn_matches_jax_by_error_statistics(models, name, fuse, monkeypatch):
    """Calibrated BN (v0_1-n in sparse eval), unfused and BN-folded (each against
    the JAX program of the same parameters): element-wise gates cannot hold
    between two bf16 programs here, so the raw head outputs are held by their
    distance from JAX's fp32: rel-RMS(port bf16 - JAX fp32) <= 1.5 x
    rel-RMS(JAX bf16 - JAX fp32), for box logits and class logits apart. The
    statistic of one bf16 program varies with its data, and less over a batch
    of 8 than of 2: hence the batch of 8. v0_1-n's routing is pinned to JAX's
    bf16 picks (the flips are test_v0_1_routing_flips_between_the_bf16_programs')."""
    case = models[name, "calibrated"]
    assert np.abs(np.asarray(case["f32"][2])[0] - np.asarray(case["f32"][2])[1]).max() > 1.0  # image-dependent
    suffix = "_folded" if fuse else ""
    if "picks" in case:
        _pinned_routing(monkeypatch, case["picks" + suffix])
    port = _port_bf16(case, fuse)
    for i in (0, 1):  # box logits, class logits
        ref32, ref16 = np.asarray(case["f32" + suffix][i], np.float32), _f32(case["bf16" + suffix][i])
        own = _rel_rms(ref16, ref32)
        assert 0 < own < 1
        assert _rel_rms(port[i], ref32) <= 1.5 * own, (_rel_rms(port[i], ref32), own)


@pytest.mark.parametrize("fuse,flips", [(False, FLIPS_UNFUSED), (True, FLIPS_FOLDED)], ids=["unfused", "bn_folded"])
def test_v0_1_routing_flips_between_the_bf16_programs(models, fuse, flips, monkeypatch):
    """v0_1-n on the port's seeded init, calibrated BN, the batch of 8: the
    samples whose top-2 expert set differs between the port's bf16 program and
    JAX's, at each of the three OptimizedMOEImproved blocks (layers 5, 8, 11),
    are the counts measured (a block's inputs carry every earlier rounding, and
    8 and 16 experts of near-equal probability leave little margin between the
    2nd and 3rd pick). The blocks' routers run unpinned here."""
    case = models["yolo-master-v0_1-n", "calibrated"]
    seen = []

    def recorded(logits, top_k, noise=None):
        out = process_logits(logits, top_k, noise)
        seen.append(top_k_from_weights(out[0], top_k)[1].numpy())
        return out

    monkeypatch.setattr(tmixtures, "process_logits", recorded)
    _port_bf16(case, fuse)
    picks = case["picks_folded" if fuse else "picks"]
    assert len(seen) == len(picks) == 3
    counts = [sum(set(a) != set(b) for a, b in zip(np.asarray(j), t)) for j, t in zip(picks, seen)]
    assert counts == flips, counts


def _tied_head_outputs(case):
    """JAX's bf16 head outputs of the calibrated model, with many tied logits:
    class logits on a coarse grid (1/8 steps), a run of anchors copied from one,
    and one image's logits all equal."""
    boxes, scores = np.asarray(case["bf16"][0]), _f32(case["bf16"][1])
    scores = np.round(scores * 8) / 8
    scores[:, 20:50] = scores[:, 20:21]
    scores[1, :, :] = 0.25
    return boxes, jnp.asarray(scores).astype(jnp.bfloat16)


@pytest.mark.parametrize("max_det,k", [(300, 2048), (20, 40)])
def test_decode_and_nms_on_jax_bf16_head_outputs_give_jax_keep_sets(models, max_det, k):
    """JAX's bf16 head outputs (many logits tied) through the port's decode_topk
    and NMS (fp32, the kernel's plain version here) and through JAX's: the same
    keep sets, classes and order, boxes within 2e-3 px, scores within 1e-6."""
    case = models["yolo-master-n", "calibrated"]
    jm, hw = case["jm"], ((8, 8), (4, 4), (2, 2))
    boxes, scores = _tied_head_outputs(case)
    jdec = jm.head.decode_topk({"one2many": {"boxes": boxes, "scores": scores}, "hw_shapes": hw}, k=k)
    ref = jax_nms(jdec, nc=80, conf_thres=0.0, iou_thres=0.45, max_det=max_det, max_nms=k, scores_are_logits=True)
    head = case["port"].head
    tdec = head.decode_topk({"boxes": torch.tensor(_f32(boxes)).to(BF16),
                             "scores": torch.tensor(_f32(scores)).to(BF16), "hw_shapes": hw}, k=k)
    assert tdec.dtype == torch.float32  # NMS sees fp32 on the bf16 path
    out = non_max_suppression(tdec, nc=80, conf_thres=0.0, iou_thres=0.45, max_det=max_det, max_nms=k,
                              scores_are_logits=True)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(out["classes"].numpy(), np.asarray(ref["classes"]))
    assert out["valid"][0].sum() > 10
    np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]), atol=2e-3, rtol=0)
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]), atol=1e-6, rtol=0)


def test_nms_kernel_takes_fp32_only():
    """The NMS kernels' argument check refuses bf16 candidates (the bf16 path
    hands them fp32: decode_topk decodes in fp32)."""
    boxes, scores = torch.zeros(1, 8, 4, dtype=BF16), torch.zeros(1, 8, dtype=BF16)
    with pytest.raises(TypeError, match="float32"):
        _check_candidates("batched_greedy_nms", boxes, scores, 16384)
    _check_candidates("batched_greedy_nms", boxes.float(), scores.float(), 16384)


# -- (e, f, g) the facade and the copy ---------------------------------------------------------

@pytest.fixture(scope="module")
def facade():
    """yolo-master-n on the CPU with BN calibrated on the test image, fused
    (BN folded, the fused stem) and with fused ES_MOE."""
    y = YOLO("yolo-master-n", device="cpu")
    img = (np.random.default_rng(3).random((80, 70, 3)) * 255).astype(np.uint8)
    x, _ = DetectionPredictor(y.model, imgsz=64).preprocess([img])
    calibrate_bn(y.model, x)
    y.fuse()
    fused_esmoe_fuse(y.model)
    return y, img


def _dets(results):
    return [r.boxes.data for r in results]


def test_fp32_stays_the_default_and_unchanged(facade):
    """predict() without compute_dtype runs the facade's own model (no copy) and
    gives exactly forward -> decode_topk -> NMS of it, as before."""
    y, img = facade
    kw = dict(imgsz=64, conf=1e-4, max_det=20)
    out = y.predict(img, **kw)
    pred = y._predictor
    assert pred.compute_dtype == torch.float32 and pred.model is y.model
    x, _ = pred.preprocess([img])
    assert x.dtype == torch.uint8
    with torch.no_grad():
        det = non_max_suppression(y.model.head.decode_topk(y.model(x), k=pred.max_nms), nc=80, conf_thres=1e-4,
                                  iou_thres=0.45, max_det=20, max_nms=pred.max_nms, scores_are_logits=True)
    n = int(det["valid"][0].sum())
    assert len(out[0].boxes) == n > 0
    np.testing.assert_array_equal(out[0].boxes.cls, det["classes"][0, :n].numpy())
    np.testing.assert_array_equal(out[0].boxes.conf, det["scores"][0, :n].numpy())
    for a, b in zip(_dets(y.predict(img, compute_dtype=torch.float32, **kw)), _dets(out)):
        np.testing.assert_array_equal(a, b)


def test_bf16_predict_leaves_the_facade_model_fp32(facade):
    """A bf16 predict runs a copy: the facade's weights are bit for bit what they
    were, still fp32, and a later fp32 predict gives what it gave before."""
    y, img = facade
    kw = dict(imgsz=64, conf=1e-4, max_det=20)
    before = _dets(y.predict(img, **kw))
    state = {k: v.clone() for k, v in y.model.state_dict().items()}
    r16 = y.predict(img, compute_dtype=torch.bfloat16, **kw)
    assert y._predictor.model is not y.model and y._predictor.compute_dtype == BF16
    assert len(r16[0].boxes) > 0 and r16[0].boxes.data.dtype == np.float32
    for k, v in y.model.state_dict().items():
        assert v.dtype == state[k].dtype and torch.equal(v, state[k]), k
    for a, b in zip(_dets(y.predict(img, **kw)), before):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="compute_dtype"):
        y.predict(img, compute_dtype=torch.float16, **kw)


def test_bf16_copy_keeps_kernel_norm_and_router_weights_fp32(facade):
    """In the bf16 copy: the fused stem's and fused ES_MOE's weights, BN
    statistics, GroupNorm affines and the ES_MOE routers stay fp32; every other
    weight is bf16; the fused stem writes bf16."""
    y, _ = facade
    for model in (y.model, DetectionModel("yolo-master-v0_1-n").eval()):
        copy16 = compute_dtype_copy(model, BF16)
        kept = {id(t) for m in copy16.modules() if isinstance(m, KEEP_FP32) for t in (*m.parameters(), *m.buffers())}
        assert kept
        for name, t in (*copy16.named_parameters(), *copy16.named_buffers()):
            if t.is_floating_point():
                assert t.dtype == (torch.float32 if id(t) in kept else BF16), name
        assert all(t.dtype == torch.float32 for t in (*model.parameters(), *model.buffers()) if t.is_floating_point())
    copy16 = compute_dtype_copy(y.model, BF16)
    stem, fused = copy16.model[0], [m for m in copy16.model if isinstance(m, FusedESMOE)]
    assert isinstance(stem, tlayers.FusedStem) and stem.out_dtype == BF16 and y.model.model[0].out_dtype is None
    assert len(fused) == 4 and all(t.dtype == torch.float32 for m in fused for t in m.parameters())
    with torch.no_grad():
        x = torch.zeros(1, 64, 64, 3, dtype=torch.uint8)
        assert stem(x).dtype == BF16 and y.model.model[0](x).dtype == torch.float32


def test_fused_stem_and_esmoe_plain_versions_round_their_fp32_once():
    """The kernels' plain versions take bf16 (and uint8) in and give bf16 out:
    the fp32 computation rounded once, so on the card a kernel and its plain
    version differ by a rounding-boundary flip at most."""
    from yolo_master_tpu_torch.ops.esmoe import fused_esmoe, pack_esmoe_params
    from yolo_master_tpu_torch.ops.stem import fused_stem

    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.integers(0, 256, (2, 16, 20, 3), dtype=np.uint8))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    w = (t((rng.random((16, 3, 3, 3)) - 0.5) * 0.6 / 255), t(rng.random(16) - 0.5),
         t((rng.random((32, 16, 3, 3)) - 0.5) * 0.3), t(rng.random(32) - 0.5))
    ref = fused_stem(img, *w)
    assert ref.dtype == torch.float32
    assert torch.equal(fused_stem(img, *w, out_dtype=BF16), ref.to(BF16))
    xb = (img.float() / 255).to(BF16)
    w255 = (w[0] * 255, *w[1:])
    assert torch.equal(fused_stem(xb, *w255), fused_stem(xb.float(), *w255).to(BF16))
    block = ES_MOE(32, 32).eval()
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 32)).astype(np.float32)).to(BF16)
    wts = torch.softmax(torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32)), -1)
    banks = pack_esmoe_params(block)
    out = fused_esmoe(x, wts, *banks)
    assert out.dtype == BF16 and torch.equal(out, fused_esmoe(x.float(), wts, *banks).to(BF16))


def test_fused_model_bf16_predict_on_uint8_and_fused_esmoe(facade):
    """The fused model's bf16 forward (uint8 into the fused stem, bf16 trunk with
    fused ES_MOE) against its fp32 forward: the same detections' shapes, finite,
    and the raw head outputs within bf16 distance of fp32 (rel-RMS < 0.5 on these
    calibrated random weights)."""
    y, img = facade
    pred = DetectionPredictor(y.model, imgsz=64, compute_dtype=BF16)
    x, _ = pred.preprocess([img])
    assert x.dtype == torch.uint8
    with torch.no_grad():
        p16, p32 = pred.model(x), y.model(x)
        det = pred.run(x)
    assert p16["scores"].dtype == BF16 and all(v.dtype in (torch.float32, torch.bool) for v in det.values())
    for k in ("boxes", "scores"):
        assert _rel_rms(p16[k].float().numpy(), p32[k].numpy()) < 0.5
