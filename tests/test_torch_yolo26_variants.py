"""yolo26-master-latent and yolo26-master-moa-mot in the port against the JAX
package, on the CPU, in eval: LatentMixture (nn/latent_mixture.py), C2fMoA
(nn/moa.py) and C2fMoT (nn/mot.py), alone and in their -n graphs.

1. Each class alone in fp32 against JAX within 1e-5 of max(1, max |JAX|):
   weights from the port's seeded init carried into ``jax.eval_shape``'s tree,
   every constant leaf drawn at random in both (tests/test_torch_gated.py's
   ``randomize_constants``): the zero-initialised router heads, deformable
   offsets and weights and ``residual_gain`` (0 at the init, where the
   latent experts add nothing) become non-zero, the layer scales other than
   0.1. MoA's three global-attention regimes (N <= 448 exact, 448 < N < 512
   the blend, N >= 512 linear), its window padding on maps that are not a
   multiple of 7, MoT's shifted windows, the deformable expert's samples off
   the map (``bilinear_sample`` alone too), MoT's router on ties (at the
   zero init all three experts tie and all are kept; two tied at the k-th
   largest keep k + 1).
2. Both -n graphs: JAX's parameter counts, strict round trips both ways
   (``_rf_matrix``, ``residual_gain``, ``scale_embedding``, ``ls1`` / ``ls2``
   and ``ls_attn`` / ``ls_ffn`` among them), ``forward_predict`` at the init
   and, with the zero-initialised parts set non-zero, BN calibrated, within
   4x the port's own fp32-vs-fp64 error (floors 2e-3 px, 1e-5).
3. The facade: fused ``predict`` against JAX's end2end graph (decode,
   ``postprocess_end2end``, the conf mask), no NMS; ``val`` against the
   end2end reference of tests/test_torch_yolo26_model.py (JAX's validator
   with that graph as its device function): detection counts equal, metrics
   within 1e-3.
4. bf16: the port's bf16 copy against JAX bf16 by rel-RMS from JAX fp32
   within 1.5x JAX bf16's own, on a batch of 8, routing pinned to JAX bf16's
   picks (the A2C2fMoE blocks of -latent, MoT's kept experts of -moa-mot);
   the copy keeps the routers, norms, ``scale_embedding`` and ``_rf_matrix``
   in fp32.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_master_tpu.nn import latent_mixture as jlat
from yolo_master_tpu.nn import moa as jmoa
from yolo_master_tpu.nn import mot as jmot
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils import metrics as jmetrics
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.nn import latent_mixture as tlat
from yolo_master_tpu_torch.nn import moa as tmoa
from yolo_master_tpu_torch.nn import mot as tmot
from yolo_master_tpu_torch.nn import layers as tlayers
from yolo_master_tpu_torch.nn.tasks import DetectionModel, init_weights
from yolo_master_tpu_torch.utils import metrics as tmetrics
from yolo_master_tpu_torch.utils.fuse import compute_dtype_copy
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax, wake_mixtures

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_bf16 import MODULE_TOL, _bf16, _f32, _pinned_routing, _rel_rms  # noqa: E402
from test_torch_gated import randomize_constants  # noqa: E402
from test_torch_model import _fp32_noise, _load_module, _np_tree, _trainable  # noqa: E402
from test_torch_validator import METRIC_TOL, METRICS, _counting  # noqa: E402
from test_torch_yolo26_model import BATCH, IMGSZ, _no_nms, labelled, val_set, val_weights  # noqa: E402,F401

TOL = 1e-5
BF16 = torch.bfloat16
BOX, SCORE = np.s_[..., :4], np.s_[..., 4:]
GRAPHS = ("yolo26-master-latent-n", "yolo26-master-moa-mot-n")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- 1. each class alone --------------------------------------------------------------------------

def _pair(jcls, tcls, *args, **kw):
    return lambda: (jcls(*args, **kw), tcls(*args, **kw))


# name -> (make, input shapes (NHWC; a list input where kind is "maps"), kind)
CASES = {
    "DenseChannelExpert": (_pair(jlat.DenseChannelExpert, tlat.DenseChannelExpert, 32), [(2, 6, 6, 32)], "map"),
    "LatentMixture_identity_base": (_pair(jlat.LatentMixture, tlat.LatentMixture, [32, 64], 32),
                                    [(2, 8, 8, 32), (2, 8, 8, 64)], "maps"),
    "LatentMixture_projected_base": (_pair(jlat.LatentMixture, tlat.LatentMixture, [48, 32, 64], 32, num_experts=3,
                                           router_hidden_dim=24, temperature=0.7),
                                     [(2, 4, 4, 48), (2, 4, 4, 32), (2, 2, 2, 64)], "maps"),
    "MultiScaleLatentMixture": (_pair(jlat.MultiScaleLatentMixture, tlat.MultiScaleLatentMixture, [32, 64],
                                      latent_dim=32), [(2, 8, 8, 32), (2, 4, 4, 64)], "multi"),
    "LatentRouter": (_pair(jlat.LatentRouter, tlat.LatentRouter, 32, 4, num_tokens=3), [(2, 3, 32)], "tokens"),
    "LocalAttnHead_padded": (_pair(jmoa._LocalAttnHead, tmoa.LocalAttnHead, 32, 2, 16), [(2, 9, 11, 32)], "map"),
    "LocalAttnHead_two_windows": (_pair(jmoa._LocalAttnHead, tmoa.LocalAttnHead, 32, 1, 16, window_size=4),
                                  [(2, 8, 4, 32)], "map"),
    "RegionalAttnHead_odd": (_pair(jmoa._RegionalAttnHead, tmoa.RegionalAttnHead, 32, 2, 16), [(2, 7, 9, 32)], "map"),
    "RegionalAttnHead_row": (_pair(jmoa._RegionalAttnHead, tmoa.RegionalAttnHead, 32, 1, 16), [(2, 1, 6, 32)], "map"),
    # N <= 448: exact; 448 < N < 512: the static blend; N >= 512: linear attention
    "GlobalAttnHead_exact": (_pair(jmoa._GlobalAttnHead, tmoa.GlobalAttnHead, 32, 2, 16), [(1, 16, 16, 32)], "map"),
    "GlobalAttnHead_blend": (_pair(jmoa._GlobalAttnHead, tmoa.GlobalAttnHead, 32, 2, 16), [(1, 20, 23, 32)], "map"),
    "GlobalAttnHead_linear": (_pair(jmoa._GlobalAttnHead, tmoa.GlobalAttnHead, 32, 2, 16), [(1, 24, 24, 32)], "map"),
    "MoARouter": (_pair(jmoa._MoARouter, tmoa.MoARouter, 32, 3, temperature=0.8), [(2, 5, 6, 32)], "router"),
    "MoABlock": (_pair(jmoa.MoABlock, tmoa.MoABlock, 32, 3, block_index=1), [(2, 9, 9, 32)], "map"),
    "MoABlock_no_shortcut": (_pair(jmoa.MoABlock, tmoa.MoABlock, 32, 6, shortcut=False), [(2, 5, 5, 32)], "map"),
    "C2fMoA": (_pair(jmoa.C2fMoA, tmoa.C2fMoA, 64, 64, 1, 3, 2.0, 0.8, True), [(2, 8, 8, 64)], "map"),
    "LocalConvTransformerExpert": (_pair(jmot._LocalConvTransformerExpert, tmot.LocalConvTransformerExpert, 32, 4),
                                   [(2, 6, 7, 32)], "map"),
    "WindowTransformerExpert": (_pair(jmot._WindowTransformerExpert, tmot.WindowTransformerExpert, 32, 4),
                                [(2, 4, 4, 32)], "map"),
    "WindowTransformerExpert_shifted": (_pair(jmot._WindowTransformerExpert, tmot.WindowTransformerExpert, 32, 4,
                                              shift_size=3), [(2, 9, 10, 32)], "map"),
    "DeformableTransformerExpert": (_pair(jmot._DeformableTransformerExpert, tmot.DeformableTransformerExpert, 32,
                                          4), [(2, 6, 8, 32)], "map"),
    "MoTRouter": (_pair(jmot._MoTRouter, tmot.MoTRouter, 32, 3, 2, temperature=0.8), [(2, 5, 6, 32)], "router"),
    "MoTRouter_image": (_pair(jmot._MoTRouter, tmot.MoTRouter, 32, 3, 1, use_spatial=False), [(2, 5, 6, 32)],
                        "router"),
    "MoTBlock": (_pair(jmot.MoTBlock, tmot.MoTBlock, 32, 4), [(2, 5, 6, 32)], "map"),
    "MoTBlock_shifted_image_router": (_pair(jmot.MoTBlock, tmot.MoTBlock, 32, 4, top_k=1, use_spatial_router=False,
                                            window_shift=True), [(2, 8, 9, 32)], "map"),
    "C2fMoT": (_pair(jmot.C2fMoT, tmot.C2fMoT, 64, 64, 2, 8, 2, 7, 4, 2.0, 1.0, 0.01, 0.5), [(2, 4, 4, 64)], "map"),
}
BF16_CASES = ["LatentMixture_identity_base", "MoABlock", "GlobalAttnHead_linear", "DeformableTransformerExpert",
              "WindowTransformerExpert_shifted"]


@functools.lru_cache(maxsize=None)
def module_pair(name):
    """(JAX module, its params, the port module loaded with them, input shapes, kind)."""
    make, shapes, kind = CASES[name]
    jm, tm = make()
    jm = jm.finalize("m")
    init_weights(tm, torch.Generator().manual_seed(3))
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    p = _np_tree(import_state_dict(tree, tm.state_dict(), strict=True))
    p = randomize_constants(p, np.random.default_rng(len(name)))
    return jm, p, _load_module(tm, p), shapes, kind


def _to_port(x):
    return torch.from_numpy(x) if x.ndim == 3 else torch.from_numpy(x).permute(0, 3, 1, 2)


def _outputs(kind, out):
    """The port's outputs as JAX's layout (NHWC maps, channel-last router outputs)."""
    if kind == "tokens":
        return list(out)
    if kind == "router":
        return [t.permute(0, 2, 3, 1) for t in out]
    if kind == "multi":
        return [t.permute(0, 2, 3, 1) for t in out]
    return [out.permute(0, 2, 3, 1)]


def _run(name, xs, ctx=Context(training=False)):
    jm, p, tm, _, kind = module_pair(name)
    many = kind in ("maps", "multi")
    ref = jax.jit(lambda p, x: jm(p, x, ctx))(p, [jnp.asarray(x) for x in xs] if many else jnp.asarray(xs[0]))
    with torch.no_grad():
        out = tm([_to_port(x) for x in xs] if many else _to_port(xs[0]))
    ref = list(ref) if isinstance(ref, (tuple, list)) else [ref]
    return _outputs(kind, out), ref


@pytest.mark.parametrize("name", list(CASES))
def test_module_matches_jax(name):
    """fp32, two inputs of each shape, every output within 1e-5 of max(1, max |JAX|)."""
    _, _, _, shapes, _ = module_pair(name)
    rng = np.random.default_rng(len(name) + 7)
    for _ in range(2):
        xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        outs, refs = _run(name, xs)
        assert len(outs) == len(refs)
        for out, ref in zip(outs, refs):
            out, ref = out.numpy(), np.asarray(ref)
            assert out.shape == ref.shape and np.isfinite(out).all(), (out.shape, ref.shape)
            assert np.abs(out - ref).max() <= TOL * max(1.0, np.abs(ref).max()), (np.abs(out - ref).max(),
                                                                                   np.abs(ref).max())


def test_latent_experts_add_nothing_at_the_init():
    """residual_gain starts at residual_init (0 in the YAML): the init's output
    is the base exactly, so the module test sets it (and the router head) non-zero."""
    m = tlat.LatentMixture([32, 64], 32).eval()
    init_weights(m, torch.Generator().manual_seed(0))
    x = [torch.randn(2, 32, 4, 4), torch.randn(2, 64, 4, 4)]
    with torch.no_grad():
        assert torch.equal(m(x), x[0])
        assert m.router.expert_head.weight.abs().max() == 0 and float(m.residual_gain) == 0.0
    _, p, tm, _, _ = module_pair("LatentMixture_identity_base")
    assert float(tm.residual_gain) != 0 and tm.router.expert_head.weight.abs().max() > 0


def test_global_head_random_features_are_the_jax_buffer():
    """``_rf_matrix`` is the QR of ``default_rng(block_index * 7919 + 2 * 65537)``
    draws, JAX's exactly, a persistent buffer (in the state dict, not a
    parameter), and MoABlock seeds each block's own."""
    for idx in (0, 3):
        jb, tb = jmoa.MoABlock(48, 3, block_index=idx), tmoa.MoABlock(48, 3, block_index=idx)
        np.testing.assert_array_equal(tb.global_head._rf_matrix.numpy(), np.asarray(jb.global_head._rf_init))
        assert "global_head._rf_matrix" in tb.state_dict()
        assert "global_head._rf_matrix" not in dict(tb.named_parameters())
    assert not torch.equal(tmoa.MoABlock(48, 3, block_index=0).global_head._rf_matrix,
                           tmoa.MoABlock(48, 3, block_index=1).global_head._rf_matrix)


def test_bilinear_sample_matches_jax_off_the_map():
    """Samples at coordinates across and beyond the map (up to 3 px out on every
    side, and exactly on its edges): corners off the map read 0, as JAX's gather."""
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    sx = rng.uniform(-3, 9, (2, 40, 4)).astype(np.float32)
    sy = rng.uniform(-3, 7, (2, 40, 4)).astype(np.float32)
    sx[:, :4, 0], sy[:, :4, 0] = [0.0, 6.0, -1.0, 6.5], [0.0, 4.0, 2.0, -0.5]
    ref = np.asarray(jmot.bilinear_sample(jnp.asarray(feat), jnp.asarray(sx), jnp.asarray(sy)))
    out = tmot.bilinear_sample(torch.from_numpy(feat), torch.from_numpy(sx), torch.from_numpy(sy)).numpy()
    assert out.shape == (2, 40, 4, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert (np.abs(ref[(sx < -1) | (sx > 7) | (sy < -1) | (sy > 5)]) == 0).all()


def test_deformable_expert_samples_off_the_map():
    """With the offsets non-zero (module test's weights) most points of the
    deformable expert fall off the 6x8 map, and the expert still equals JAX's."""
    _, p, tm, shapes, _ = module_pair("DeformableTransformerExpert")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shapes[0]).astype(np.float32))
    with torch.no_grad():
        q = tm.q_proj(tm.norm1(x).reshape(2, -1, 32))
        off = torch.tanh(tm.offset_proj(q)).reshape(2, 48, 4, 4, 2)
    ys, xs = np.divmod(np.arange(48), 8)
    sx = xs[None, :, None, None] + off[..., 0].numpy() * 7 / 2
    sy = ys[None, :, None, None] + off[..., 1].numpy() * 5 / 2
    assert ((sx < 0) | (sx > 7) | (sy < 0) | (sy > 5)).mean() > 0.2


def _router_on(logits_rows, top_k):
    """A MoT router of both packages whose last conv gives ``logits_rows`` (bias
    only, weights zero) at every pixel: (port weights, JAX weights)."""
    jr_, tr = jmot._MoTRouter(32, 3, top_k), tmot.MoTRouter(32, 3, top_k)
    jr_ = jr_.finalize("m")
    init_weights(tr, torch.Generator().manual_seed(1))
    with torch.no_grad():
        tr.router[3].bias.copy_(torch.tensor(logits_rows))
    p = _np_tree(import_state_dict(jax.eval_shape(jr_.init, jax.random.PRNGKey(0)), tr.state_dict(), strict=True))
    tr = _load_module(tr, p)
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 32)).astype(np.float32)
    ref = jax.jit(lambda p, x: jr_(p, x, Context(training=False)))(p, jnp.asarray(x))[0]
    with torch.no_grad():
        out = tr(torch.from_numpy(x).permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("rows,top_k,kept", [((0.0, 0.0, 0.0), 2, 3), ((1.0, 0.5, 0.5), 2, 3), ((2.0, 2.0, 0.0), 1, 2),
                                             ((1.0, 0.5, 0.25), 2, 2)], ids=["zero_init", "tie_at_kth", "tie_at_top",
                                                                            "no_tie"])
def test_mot_router_keeps_every_expert_tied_at_the_kth(rows, top_k, kept):
    """``probs >= kth largest``: ties keep more than top_k experts (all three at
    the zero-initialised init), as JAX's router; not a top-k index mask."""
    out, ref = _router_on(rows, top_k)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)
    assert ((out > 0).sum(-1) == kept).all()


@pytest.mark.parametrize("name", BF16_CASES)
def test_module_matches_jax_in_bf16(name):
    """The port's bf16 copy against the JAX module on the same bf16 input and
    weights: max |port - JAX| <= 4 * 2^-8 * max |JAX| (the module gate of
    tests/test_torch_bf16.py)."""
    jm, p, tm, shapes, kind = module_pair(name)
    tb = compute_dtype_copy(tm, BF16)
    rng = np.random.default_rng(11)
    xs = [_bf16(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    ctx = Context(training=False)
    many = kind == "maps"
    ref = jax.jit(lambda p, x: jm(p, x, ctx))(p, [x for x, _ in xs] if many else xs[0][0])
    with torch.no_grad():
        out = tb([t for _, t in xs] if many else xs[0][1]).permute(0, 2, 3, 1)
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    out, ref = _f32(out), _f32(ref)
    assert np.abs(out - ref).max() <= MODULE_TOL * np.abs(ref).max(), (np.abs(out - ref).max(), np.abs(ref).max())


def test_bf16_copy_keeps_the_routers_and_features_fp32():
    """In the bf16 copy the LatentRouter (LayerNorm, Linears, scale_embedding),
    GroupNorms, LayerNorms and MoA's ``_rf_matrix`` stay fp32 (JAX reads them in
    fp32: the fp32 router softmax, the fp32 linear attention); convs and the
    layer scales are bf16, as JAX's per-op casts."""
    for name in GRAPHS:
        b16 = compute_dtype_copy(DetectionModel(name), BF16)
        for mod in b16.modules():
            if isinstance(mod, (tlat.LatentRouter, tlayers.GroupNorm, tlayers.LayerNorm, tlayers.Linear)):
                assert all(t.dtype == torch.float32 for t in (*mod.parameters(), *mod.buffers())), type(mod)
            if isinstance(mod, tmoa.GlobalAttnHead):
                assert mod._rf_matrix.dtype == torch.float32 and mod.qkv.weight.dtype == BF16
            if isinstance(mod, (tmoa.MoABlock, tmot.LocalConvTransformerExpert)):
                assert all(p.dtype == BF16 for n, p in mod.named_parameters(recurse=False))


# -- 2. the -n graphs -----------------------------------------------------------------------------

@pytest.mark.parametrize("name", GRAPHS)
def test_graph_builds_with_the_jax_parameter_count_and_round_trips(name):
    port = DetectionModel(name)
    tree = jax_params_of(JaxDetectionModel(name), port)  # port -> JAX, strict
    assert sum(p.numel() for p in port.parameters()) == _trainable(tree)
    assert _trainable(tree) == {"yolo26-master-latent-n": 5_478_423, "yolo26-master-moa-mot-n": 2_908_922}[name]
    if "latent" in name:
        lm = [m for m in port.model if isinstance(m, tlat.LatentMixture)]
        assert [m.i for m in lm] == [23, 24, 25] and [m.f for m in lm] == [[16, 4], [19, 13, 6], [22, 10, 8]]
        assert [m.in_channels for m in lm] == [(64, 128), (128, 128, 128), (256, 256, 256)]
        assert all(float(m.residual_gain) == 0.0 and m.base_proj is None for m in lm)
    else:
        assert isinstance(port.model[16], tmoa.C2fMoA) and len(port.model[16].m) == 1
        assert [type(port.model[i]) for i in (13, 19, 22)] == [tmot.C2fMoT] * 3
        assert port.model[9].add and port.model[9].n == 3  # SPPF [1024, 5, 3, True]: the shortcut
        assert [m.global_head.nh for m in port.model[16].m] == [1]
    head = port.head
    assert head.end2end and head.reg_max == 1
    back = DetectionModel(name, seed=1)
    back.load_state_dict(state_dict_from_jax(tree), strict=True)  # JAX -> port, strict
    got = back.state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(got[k], v), k
    names = set(got)
    want = ({"residual_gain", "scale_embedding"} if "latent" in name
            else {"_rf_matrix", "ls1", "ls2", "ls_attn", "ls_ffn", "ffn_gate.0.conv.weight", "ffn.3.weight"})
    assert all(any(k.endswith(w) for k in names) for w in want), want


@functools.lru_cache(maxsize=None)
def graph(name, setting):
    """(the port in eval, JAX model, JAX params, two 64-px images, JAX's
    forward_predict on them): "default" the seeded init, "woken" the parts
    that start at zero set non-zero and BN calibrated on the images."""
    jm = JaxDetectionModel(name)
    port = DetectionModel(name)
    x = np.random.default_rng(31).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    if setting == "woken":
        wake_mixtures(port)
        calibrate_bn(port, torch.from_numpy(x))
    port.eval()
    params = jax_params_of(jm, port)
    return port, jm, params, x, np.asarray(_jax_predict(name)(params, jnp.asarray(x)))


@functools.lru_cache(maxsize=None)
def _jax_predict(name):
    jm = JaxDetectionModel(name)
    return jax.jit(jm.forward_predict)


@pytest.mark.parametrize("setting", ["default", "woken"])
@pytest.mark.parametrize("name", GRAPHS)
def test_graph_forward_predict_matches_jax(name, setting):
    """At the init within 2e-3 px and 1e-5 on scores; woken and calibrated
    within 4x the port's own fp32-vs-fp64 error (floors 2e-3, 1e-5)."""
    port, _, _, x, ref = graph(name, setting)
    with torch.no_grad():
        y = port.forward_predict(torch.from_numpy(x)).numpy()
    assert y.shape == ref.shape == (2, 84, 84)
    box_tol, score_tol = 2e-3, 1e-5
    if setting == "woken":
        assert np.abs(ref[0] - ref[1]).max() > 1.0  # the output depends on the image
        noise = _fp32_noise(port, x)
        box_tol, score_tol = max(4 * noise[BOX].max(), 2e-3), max(4 * noise[SCORE].max(), 1e-5)
    assert np.abs(y[BOX] - ref[BOX]).max() <= box_tol, (np.abs(y[BOX] - ref[BOX]).max(), box_tol)
    assert np.abs(y[SCORE] - ref[SCORE]).max() <= score_tol, (np.abs(y[SCORE] - ref[SCORE]).max(), score_tol)


# -- 3. the facade: predict and val ------------------------------------------------------------------

@pytest.mark.parametrize("name", GRAPHS)
def test_graph_facade_predict_matches_the_jax_end2end_graph(name, monkeypatch):
    """The woken weights with the class biases at 0, fused (BN folded, the
    stem's plain version on uint8): ``predict`` at batch 2 runs no NMS and
    returns max_det rows; the predictor's fixed-shape detections on the
    letterboxed uint8 batch are those of JAX's end2end graph on it / 255
    (forward_predict, postprocess_end2end, conf 0.05): the same classes in the
    same order, boxes within 0.1 px, scores within 1e-4."""
    port, jm, _, _, _ = graph(name, "woken")
    y = YOLO(name, device="cpu").load_state_dict(port.state_dict())
    with torch.no_grad():
        for branch in (*y.model.head.cv3, *y.model.head.one2one_cv3):
            branch[-1].bias.zero_()
    params = jax_params_of(jm, y.model)
    rng = np.random.default_rng(23)
    imgs = [(rng.random((80, 70, 3)) * 255).astype(np.uint8) for _ in range(2)]
    _no_nms(monkeypatch)
    y.fuse()
    res = y.predict(imgs, imgsz=IMGSZ, conf=0.05, max_det=40, batch=2)
    assert len(res) == 2 and all(0 < len(r.boxes) <= 40 for r in res)
    xu8, _ = y._predictor.preprocess(imgs)
    assert xu8.dtype == torch.uint8
    with torch.no_grad():
        det = y._predictor.run(xu8)
    dec = _jax_predict(name)(params, jnp.asarray(xu8.numpy() / np.float32(255)))
    ref = np.asarray(jm.head.postprocess_end2end(dec, 40))
    valid = ref[..., 4] > 0.05
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    np.testing.assert_array_equal(det["classes"].numpy()[valid], ref[..., 5][valid])
    np.testing.assert_allclose(det["scores"].numpy()[valid], ref[..., 4][valid], atol=1e-4, rtol=0)
    np.testing.assert_allclose(det["boxes"].numpy()[valid], ref[..., :4][valid], atol=0.1, rtol=0)


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_val_matches_the_end2end_reference(name, labelled, monkeypatch):  # noqa: F811
    """The port's val (no NMS) on tests/test_torch_yolo26_model.py's labelled
    set (labels from yolo26-master-n's detections), the woken weights
    (calibrated on two noise images) with the class biases at 0, against the JAX validator whose device function is the end2end graph
    from JAX's pieces (tests/test_torch_yolo26_model.py's reference): per-image detection counts equal,
    each metric within 1e-3."""
    port, jm, _, _, _ = graph(name, "woken")
    y = YOLO(name, device="cpu").load_state_dict(port.state_dict())
    with torch.no_grad():
        for branch in (*y.model.head.cv3, *y.model.head.one2one_cv3):
            branch[-1].bias.zero_()
    params = jax_params_of(jm, y.model)
    with monkeypatch.context() as mp:
        _no_nms(mp)
        counts = _counting(mp, tmetrics.DetMetrics)
        m = y.val(data=str(labelled), imgsz=IMGSZ, batch=BATCH)

    def end2end(p, x, conf=0.001, max_det=300):
        out = jm.head.postprocess_end2end(jm.forward_predict(p, x, Context(training=False)), max_det)
        ok = out[..., 4] > conf
        return {"boxes": out[..., :4], "scores": out[..., 4] * ok, "classes": jnp.where(ok, out[..., 5], -1.0),
                "valid": ok}

    jv = JaxValidator(model=jm, params=params, data=str(labelled), imgsz=IMGSZ, batch=BATCH)
    jv._fn = jax.jit(end2end)
    with monkeypatch.context() as mp:
        jcounts = _counting(mp, jmetrics.DetMetrics)
        jmm = jv()
    assert m["images"] == jmm["images"] and counts == jcounts and min(counts) > 0
    for k in METRICS:
        assert np.isfinite(m[k]) and abs(m[k] - jmm[k]) <= METRIC_TOL, (k, m[k], jmm[k])


# -- 4. bf16 --------------------------------------------------------------------------------------------

def _jax_forward_recording(jm):
    """A jitted (params, x) -> (one2one box logits, class logits, each routed
    block's picks in forward order: the A2C2fMoE blocks' top-2 indices, MoT
    routers' kept-expert masks)."""
    from yolo_master_tpu.nn.moe import mixtures as jmix
    from yolo_master_tpu.nn.moe.dispatch import top_k_from_weights as jax_top_k_from_weights

    seen = {"moe": [], "mot": []}
    plain_pl, plain_router = jmix.process_logits, jmot._MoTRouter.__call__

    def recording(logits, **kw):
        out = plain_pl(logits, **kw)
        seen["moe"].append(jax_top_k_from_weights(out[0], kw["top_k"])[1])
        return out

    def router(self, p, x, ctx):
        out = plain_router(self, p, x, ctx)
        seen["mot"].append(out[0] > 0)
        return out

    def forward(p, x):
        seen["moe"].clear()
        seen["mot"].clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmix, "process_logits", recording)
            mp.setattr(jmot._MoTRouter, "__call__", router)
            preds = jm.forward_features(p, x, Context(training=False))
        return preds["one2one"]["boxes"], preds["one2one"]["scores"], list(seen["moe"]), list(seen["mot"])

    return jax.jit(forward)


def _pin_mot(monkeypatch, masks):
    """Make each MoTRouter, in forward order, keep JAX's [B, H, W, E] masks over its own probabilities."""
    it = iter([torch.from_numpy(np.array(m)).permute(0, 3, 1, 2) for m in masks])
    plain = tmot.MoTRouter.forward

    def pinned(self, x):
        _, probs, logits = plain(self, x)
        w = probs * next(it)
        return w / w.sum(1, keepdim=True).clamp_min(1e-9), probs, logits

    monkeypatch.setattr(tmot.MoTRouter, "forward", pinned)


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_bf16_matches_jax_by_error_statistics(name, monkeypatch):
    """The woken graph, BN calibrated on a batch of 8: the port's bf16 one2one
    head outputs' rel-RMS from JAX fp32 within 1.5x JAX bf16's own (box and
    class logits apart), the routing pinned to JAX bf16's picks."""
    jm = JaxDetectionModel(name)
    port = DetectionModel(name)
    wake_mixtures(port, seed=4)
    x = np.random.default_rng(9).random((8, IMGSZ, IMGSZ, 3)).astype(np.float32)
    calibrate_bn(port, torch.from_numpy(x))
    port.eval()
    params = jax_params_of(jm, port)
    forward = _jax_forward_recording(jm)
    xj, t = _bf16(x)
    f32, b16 = forward(params, jnp.asarray(x)), forward(params, xj)
    assert len(b16[2]) == (6 if "latent" in name else 0) and len(b16[3]) == (0 if "latent" in name else 3)
    if b16[2]:
        _pinned_routing(monkeypatch, b16[2])
    if b16[3]:
        _pin_mot(monkeypatch, b16[3])
    model = compute_dtype_copy(port, BF16)
    with torch.no_grad():
        preds = model(t.permute(0, 2, 3, 1))
    for i, key in enumerate(("boxes", "scores")):
        assert preds[key].dtype == BF16
        got, ref32, ref16 = preds[key].float().numpy(), np.asarray(f32[i], np.float32), _f32(b16[i])
        own, port_err = _rel_rms(ref16, ref32), _rel_rms(got, ref32)
        assert np.isfinite(got).all() and 0 < own and port_err <= 1.5 * own, (key, port_err, own)
