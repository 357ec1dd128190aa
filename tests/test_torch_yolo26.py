"""yolo26-master's modules in the port against the JAX package, one at a time,
in eval on the CPU: SPPF, the PSA attention family (Attention, PSABlock,
C2PSA, C3k2's ``attn`` form), the spatial, ghost and inverted experts and the
local and adaptive routers (alone and inside OptimizedMOEImproved, sparse and
dense eval), ABlockMoE, A2C2fMoE and the end2end Detect head with its
``postprocess_end2end``.

Weights: the port's seeded init (the JAX init's distributions) carried into
``jax.eval_shape``'s tree of the JAX module (strict), every constant leaf
(norm affines, BN statistics, biases, A2C2fMoE's gamma) drawn at random, and
loaded back into the port (tests/test_torch_gated.py's recipe); the long
attention cases pass ``ATTN_KEY_CHUNK`` keys, where the port sums the keys in
chunks. Gates: fp32 max |port - JAX| <= 1e-5 (inside OptimizedMOEImproved, the expert picks
equal); bf16 (the port's bf16 copy against the JAX module on the same bf16
input) within tests/test_torch_bf16.py's module tolerance, 4 * 2^-8 * max
|JAX|; ``postprocess_end2end`` equal to JAX's, tied scores included.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn import heads as jheads
from yolo_master_tpu.nn import layers as jlayers
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import mixtures as jmix
from yolo_master_tpu.nn.moe.dispatch import top_k_from_weights as jax_top_k_from_weights
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.nn import heads as theads
from yolo_master_tpu_torch.nn import layers as tlayers
from yolo_master_tpu_torch.nn.moe import mixtures as tmix
from yolo_master_tpu_torch.nn.moe.dispatch import top_k_from_weights
from yolo_master_tpu_torch.nn.tasks import init_weights
from yolo_master_tpu_torch.utils.fuse import compute_dtype_copy

from test_torch_bf16 import MODULE_TOL, _bf16, _f32  # noqa: E402 (tests/ is on the path)
from test_torch_gated import randomize_constants  # noqa: E402
from test_torch_model import _load_module  # noqa: E402

TOL = 1e-5
BF16 = torch.bfloat16
CH = (32, 64, 128)  # Detect's level widths
FEATS = [(2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 128)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _detect(legacy):
    def make():
        j = jheads.Detect(nc=80, reg_max=1, end2end=True, ch=CH, legacy=legacy)
        t = theads.Detect(nc=80, reg_max=1, end2end=True, ch=CH, legacy=legacy)
        j.set_strides((8, 16, 32))
        t.set_strides((8, 16, 32))
        return j, t, FEATS
    return make


def _moe(expert_type, router_type, e=4, c1=32, c2=32):
    return lambda: (jmix.OptimizedMOEImproved(c1, c2, num_experts=e, top_k=2, expert_type=expert_type,
                                              router_type=router_type),
                    tmix.OptimizedMOEImproved(c1, c2, num_experts=e, top_k=2, expert_type=expert_type,
                                              router_type=router_type),
                    [(4, 8, 8, c1)])


# name -> (JAX module, port module, NHWC input shapes)
CASES = {
    "SPPF": lambda: (jlayers.SPPF(64, 32, 5), tlayers.SPPF(64, 32, 5), [(2, 8, 6, 64)]),
    "SPPF_shortcut": lambda: (jlayers.SPPF(32, 32, 3, n=2, shortcut=True),
                              tlayers.SPPF(32, 32, 3, n=2, shortcut=True), [(2, 7, 7, 32)]),
    "Attention": lambda: (jlayers.Attention(64, num_heads=2), tlayers.Attention(64, num_heads=2), [(2, 6, 8, 64)]),
    "Attention_ratio1": lambda: (jlayers.Attention(32, num_heads=1, attn_ratio=1.0),
                                 tlayers.Attention(32, num_heads=1, attn_ratio=1.0), [(2, 5, 4, 32)]),
    # past layers.ATTN_KEY_CHUNK keys, attention sums the keys' partial products in fp32
    "Attention_long": lambda: (jlayers.Attention(32, num_heads=1), tlayers.Attention(32, num_heads=1),
                               [(1, 36, 36, 32)]),
    "AAttn_long": lambda: (jlayers.AAttn(32, 1, area=1), tlayers.AAttn(32, 1, area=1), [(1, 40, 40, 32)]),
    "AAttn_long_area2": lambda: (jlayers.AAttn(64, 2, area=2), tlayers.AAttn(64, 2, area=2), [(1, 48, 48, 64)]),
    "PSABlock": lambda: (jlayers.PSABlock(64, 0.5, 2), tlayers.PSABlock(64, 0.5, 2), [(2, 4, 4, 64)]),
    "PSABlock_no_shortcut": lambda: (jlayers.PSABlock(32, 0.5, 1, shortcut=False),
                                     tlayers.PSABlock(32, 0.5, 1, shortcut=False), [(2, 4, 4, 32)]),
    "C2PSA": lambda: (jlayers.C2PSA(256, 256, n=1), tlayers.C2PSA(256, 256, n=1), [(2, 4, 4, 256)]),
    "C2PSA_n2": lambda: (jlayers.C2PSA(64, 64, n=2), tlayers.C2PSA(64, 64, n=2), [(2, 4, 4, 64)]),
    "C3k2_attn": lambda: (jlayers.C3k2(64, 64, 1, False, 0.5, True), tlayers.C3k2(64, 64, 1, False, 0.5, True),
                          [(2, 6, 6, 64)]),
    "C3k2_attn_c3k": lambda: (jlayers.C3k2(96, 128, 2, True, 0.5, True), tlayers.C3k2(96, 128, 2, True, 0.5, True),
                              [(2, 4, 4, 96)]),
    "SpatialExpert": lambda: (jmix.SpatialExpert(32, 48), tmix.SpatialExpert(32, 48), [(2, 6, 6, 32)]),
    "GhostExpert": lambda: (jmix.GhostExpert(32, 40, ratio=3), tmix.GhostExpert(32, 40, ratio=3), [(2, 6, 6, 32)]),
    "InvertedResidualExpert": lambda: (jmix.InvertedResidualExpert(32, 32), tmix.InvertedResidualExpert(32, 32),
                                       [(2, 6, 6, 32)]),
    "InvertedResidualExpert_c1_c2": lambda: (jmix.InvertedResidualExpert(32, 16, kernel_size=5),
                                             tmix.InvertedResidualExpert(32, 16, kernel_size=5), [(2, 6, 6, 32)]),
    "OptimizedMOEImproved_spatial": _moe("spatial", "efficient"),
    "OptimizedMOEImproved_ghost": _moe("ghost", "local", c2=48),
    "OptimizedMOEImproved_inverted": _moe("inverted", "adaptive", e=8),
    "OptimizedMOEImproved_simple_local": _moe("simple", "local"),
    "ABlockMoE": lambda: (jmix.ABlockMoE(64, 2, 2.0, 1, 4, 2), tmix.ABlockMoE(64, 2, 2.0, 1, 4, 2), [(4, 4, 4, 64)]),
    "ABlockMoE_area_ghost": lambda: (jmix.ABlockMoE(32, 1, 2.0, 2, 8, 2, "ghost"),
                                     tmix.ABlockMoE(32, 1, 2.0, 2, 8, 2, "ghost"), [(4, 4, 4, 32)]),
    "A2C2fMoE": lambda: (jmix.A2C2fMoE(64, 128, 1, True, 1, False, 2.0, 0.5, 1, True, 4, 2),
                         tmix.A2C2fMoE(64, 128, 1, True, 1, False, 2.0, 0.5, 1, True, 4, 2), [(4, 4, 4, 64)]),
    "A2C2fMoE_residual": lambda: (jmix.A2C2fMoE(64, 64, 1, True, 1, True, 2.0, 0.5, 1, True, 8, 2),
                                  tmix.A2C2fMoE(64, 64, 1, True, 1, True, 2.0, 0.5, 1, True, 8, 2), [(4, 4, 4, 64)]),
    "A2C2fMoE_c3k": lambda: (jmix.A2C2fMoE(32, 64, 2, False), tmix.A2C2fMoE(32, 64, 2, False), [(2, 6, 6, 32)]),
    "Detect_end2end": _detect(False),
    "Detect_end2end_legacy": _detect(True),
}
BF16_CASES = ["SPPF", "Attention", "C2PSA", "C3k2_attn", "A2C2fMoE", "Detect_end2end"]


@functools.lru_cache(maxsize=None)
def module_pair(name):
    """(JAX module, its params, the port module loaded with them, input shapes)."""
    jm, tm, shapes = CASES[name]()
    jm = jm.finalize("m")
    init_weights(tm, torch.Generator().manual_seed(3))
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(np.asarray, import_state_dict(tree, tm.state_dict(), strict=True))
    p = randomize_constants(p, np.random.default_rng(4))
    return jm, p, _load_module(tm, p), shapes


@functools.lru_cache(maxsize=None)
def _jax_forward(name, sparse):
    """The JAX module's jitted eval forward (Detect: its two branches and both decodes), compiled once."""
    jm, ctx = module_pair(name)[0], Context(training=False, sparse_inference=sparse)
    if not name.startswith("Detect"):
        return jax.jit(lambda p, x: jm(p, x, ctx))

    def forward(p, f):
        r = jm(p, f, ctx)
        return r["one2one"], r["one2many"], jm.decode(r), jm.decode_topk(r, k=40)

    return jax.jit(forward)


def _run(name, tm, p, xs, sparse):
    """((port, JAX) output pairs as NHWC / [B, A, C] numpy-able arrays) on inputs xs [(JAX, port NCHW)]."""
    forward = _jax_forward(name, sparse)
    with torch.no_grad():
        if name.startswith("Detect"):
            one, many_ref, dec, dec_k = forward(p, [x for x, _ in xs])
            feats = [t for _, t in xs]
            out = tm(feats)
            many = tm._branch(tm.cv2, tm.cv3, feats)
            pairs = [(out[k], one[k]) for k in ("boxes", "scores")] + [(many[k], many_ref[k]) for k in ("boxes", "scores")]
            # the decodes on JAX's head outputs: a rounding apart, two anchors can swap places in the top-k
            same = {k: torch.tensor(np.asarray(one[k])) for k in ("boxes", "scores")}
            same["hw_shapes"] = out["hw_shapes"]
            return pairs + [(tm.decode(same), dec), (tm.decode_topk(same, k=40), dec_k)]
        return [(tm(xs[0][1]).permute(0, 2, 3, 1), forward(p, xs[0][0]))]


MOE_CASES = [n for n, make in CASES.items() if any(isinstance(m, tmix.OptimizedMOEImproved) for m in make()[1].modules())]


@pytest.mark.parametrize("name,sparse", [(n, True) for n in CASES] + [(n, False) for n in MOE_CASES])
def test_module_matches_jax(name, sparse):
    """fp32, two inputs of each shape; the MoE blocks in sparse eval (the
    default) and in masked-dense eval. Inside every OptimizedMOEImproved the
    router picks the same experts as JAX."""
    jm, p, tm, shapes = module_pair(name)
    moe = [m for m in tm.modules() if isinstance(m, tmix.OptimizedMOEImproved)]
    for m in moe:
        m.sparse_inference = sparse
    rng = np.random.default_rng(len(name))
    ctx = Context(training=False, sparse_inference=sparse)
    for _ in range(2):
        xs = [(jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2))
              for x in (rng.standard_normal(s).astype(np.float32) for s in shapes)]
        for out, ref in _run(name, tm, p, xs, sparse):
            out, ref = np.asarray(out), np.asarray(ref)
            assert out.shape == ref.shape and np.isfinite(out).all()
            assert np.abs(out - ref).max() <= TOL * max(1.0, np.abs(ref).max()), (np.abs(out - ref).max(),
                                                                                   np.abs(ref).max())
        if moe and not name.startswith("ABlock") and not name.startswith("A2C2f"):  # the block itself: picks equal
            jw, _, _ = jmix.process_logits(jm.routing.logits(p["routing"], xs[0][0], ctx), training=False,
                                           noise_std=0.0, top_k=2, num_experts=jm.num_experts)
            tw = tmix.process_logits(tm.routing.logits(xs[0][1]), 2)[0]
            np.testing.assert_array_equal(top_k_from_weights(tw, 2)[1].numpy(),
                                          np.asarray(jax_top_k_from_weights(jw, 2)[1]))


@pytest.mark.parametrize("name", ["LocalRoutingLayer", "AdaptiveRoutingLayer"])
@pytest.mark.parametrize("hw", [(8, 8), (5, 7), (2, 2)])
def test_router_logits_match_jax(name, hw):
    """The local router pools 2x where H exceeds 2 (VALID windows: an odd size
    drops its last row); the adaptive router pools to 1x1. fp32, 1e-5."""
    jr, tr = getattr(jmix, name)(32, 8).finalize("m"), getattr(tmix, name)(32, 8)
    init_weights(tr, torch.Generator().manual_seed(5))
    p = jax.tree_util.tree_map(np.asarray, import_state_dict(jax.eval_shape(jr.init, jax.random.PRNGKey(0)),
                                                             tr.state_dict(), strict=True))
    p = randomize_constants(p, np.random.default_rng(6))
    tr = _load_module(tr, p)
    x = np.random.default_rng(7).standard_normal((3, *hw, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jr.logits(p, x, Context(training=False)))(p, jnp.asarray(x)))
    with torch.no_grad():
        out = tr.logits(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert out.shape == ref.shape == (3, 8) and out.dtype == np.float32
    assert np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("name", BF16_CASES)
def test_module_matches_jax_in_bf16(name):
    """The port's bf16 copy against the JAX module on the same bf16 input and
    weights (its per-op casts): max |port - JAX| <= 4 * 2^-8 * max |JAX|."""
    jm, p, tm, shapes = module_pair(name)
    tb = compute_dtype_copy(tm, BF16)
    rng = np.random.default_rng(11)
    xs = [_bf16(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    ctx = Context(training=False)
    with torch.no_grad():
        if name.startswith("Detect"):
            ref = jax.jit(lambda p, f: jm(p, f, ctx))(p, [x for x, _ in xs])["one2one"]
            out = tb([t for _, t in xs])
            pairs = [(out[k], ref[k]) for k in ("boxes", "scores")]
        else:
            pairs = [(tb(xs[0][1]).permute(0, 2, 3, 1), jax.jit(lambda p, x: jm(p, x, ctx))(p, xs[0][0]))]
    for out, ref in pairs:
        assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
        out, ref = _f32(out), _f32(ref)
        assert out.shape == ref.shape and np.isfinite(out).all()
        assert np.abs(out - ref).max() <= MODULE_TOL * np.abs(ref).max(), (np.abs(out - ref).max(), np.abs(ref).max())


def test_detect_end2end_keeps_the_one2one_branch_apart():
    """The one2one branches are their own modules with their own bias init (box
    2.0, class log(5 / nc / (640 / stride)^2), as the one2many ones); in train
    mode the head gives both branches, the one2one one on detached maps (no
    gradient reaches the trunk through it); in eval the one2one branch alone."""
    _, _, tm, _ = module_pair("Detect_end2end")
    head = theads.Detect(nc=80, reg_max=1, end2end=True, ch=CH)
    head.set_strides((8, 16, 32))
    head.bias_init()
    assert head.one2one_cv2[0][-1].bias.unique().tolist() == [2.0]
    for i, s in enumerate((8, 16, 32)):
        for cv3 in (head.cv3, head.one2one_cv3):
            np.testing.assert_allclose(cv3[i][-1].bias.detach().numpy(), np.log(5 / 80 / (640 / s) ** 2), rtol=1e-6)
    assert head.cv2[0][-1].out_channels == 4 and head.cv2[0][0].conv.out_channels == max(16, CH[0] // 4, 4)
    feats = [torch.randn(s[0], s[3], s[1], s[2], requires_grad=True) for s in FEATS]
    out = tm.train()(feats)
    tm.eval()
    assert set(out) == {"one2many", "one2one", "hw_shapes"}
    out["one2one"]["scores"].sum().backward()
    assert all(f.grad is None for f in feats)
    out["one2many"]["scores"].sum().backward()
    assert all(f.grad is not None for f in feats)


def _tied_decode(rng, b=2, a=84, nc=80):
    """Decoded [B, A, 4+nc] xyxy boxes and scores with ties: whole anchors alike,
    classes tied within an anchor, and a block of saturated 1.0 scores."""
    boxes = rng.uniform(0, 64, (b, a, 4)).astype(np.float32)
    scores = rng.choice(np.array([0.1, 0.25, 0.5, 0.75], np.float32), (b, a, nc))
    scores[:, 10:20] = scores[:, 10:11]  # ten anchors alike
    scores[:, 30:40, 5:9] = 1.0
    return np.concatenate([boxes, scores], -1)


@pytest.mark.parametrize("max_det", [300, 50, 7])
def test_postprocess_end2end_matches_jax_with_ties(max_det):
    """k = min(max_det, A): at 84 anchors and max_det 300 every anchor
    competes. Ties go to the lower index first in both top-k passes, as
    ``jax.lax.top_k``: the selection equals JAX's exactly."""
    dec = _tied_decode(np.random.default_rng(max_det))
    ref = np.asarray(jheads.Detect.postprocess_end2end(None, jnp.asarray(dec), max_det))
    out = theads.Detect.postprocess_end2end(torch.from_numpy(dec), max_det).numpy()
    assert out.shape == (2, min(max_det, 84), 6)
    np.testing.assert_array_equal(out, ref)
    assert (np.diff(out[..., 4], axis=1) <= 0).all()  # best first
