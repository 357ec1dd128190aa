"""The MoA, MoT and latent mixtures in training, each module alone, in the port
against ``jax.value_and_grad`` of the JAX package's module, on the CPU.

1. fp32, loss sum(out * ct) + the aux the module publishes: the output within
   1e-5 of its largest |JAX| value, each aux record within 1e-5 relative of
   JAX's ``ctx.aux`` entry (same family), the routing stats equal to JAX's
   ``ctx.stats`` in keys and values, and the gradients of the input and every
   parameter within max(8x the port's own fp32-vs-fp64 error, 1e-6 x the
   tree's largest |g|) (tests/test_torch_moe_train.py's gate):

   * ``MoABlock`` and ``C2fMoA`` in each regime of the global head: exact
     attention (16x16 = 256 tokens), the blend (20x23 = 460) and the linear
     path (24x24 = 576), where JAX's gradient of ``_rf_matrix`` is left out by
     name (fault 4 of the reference: JAX trains it, the port keeps a buffer);
   * ``NeckMoAFusion`` with and without its shortcut;
   * ``MoTBlock`` and ``C2fMoT`` at top-k 1, 2 and 3, at the init (the router
     head at zero: every expert ties and is kept; the deformable offsets at
     zero) and after ``wake_mixtures``; the exploration floor in train mode;
   * ``LatentMixture`` and ``MultiScaleLatentMixture`` with ``noise_std`` 0.5
     at steps 3 and 7: the router's noise bit for bit JAX's
     ``normal(_path_key(step, path)) * noise_std``.

2. bf16 (fp32 parameters, bf16 input): the parameter gradients' rel-RMS from
   JAX fp32 within 1.5x JAX bf16's own (PERF.md §7's statistic), MoT's kept
   experts pinned to JAX bf16's picks.
3. Fault 4 of the reference: JAX's gradient of ``_rf_matrix`` on the linear
   path and its ``"other"`` optimizer group; the port's matrix unchanged by a
   yolo26-master-moa-mot-n step at 192 px (P3 24x24, the linear path).
4. Graph dicts: ``NeckMoAFusion`` builds with JAX's parameter count, round
   trips strictly and trains; ``MultiScaleLatentMixture`` between layers
   raises JAX's own ``TypeError`` in both parsers (neither has a branch for a
   list of inputs, as the module takes).
5. ``calibrate_bn`` runs the eval form of every mixture (no floor, no noise,
   no aux record).
"""

import contextlib
import copy
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine import train_step as jts
from yolo_master_tpu.nn import latent_mixture as jlat
from yolo_master_tpu.nn import moa as jmoa
from yolo_master_tpu.nn import mot as jmot
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import mixtures as jmix
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.nn import latent_mixture as tlat
from yolo_master_tpu_torch.nn import moa as tmoa
from yolo_master_tpu_torch.nn import mot as tmot
from yolo_master_tpu_torch.nn.tasks import DetectionModel, init_weights
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax, wake_mixtures

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_torch_bf16 import _bf16, _f32, _rel_rms  # noqa: E402
from test_torch_gated import randomize_constants  # noqa: E402
from test_torch_model import _load_module, _np_tree, _trainable  # noqa: E402
from test_torch_moe_train_model import _batch  # noqa: E402
from test_torch_train_step import _tb  # noqa: E402

REL = 1e-5
STAT = 1.5
NOISE = 0.5
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mk(jcls, tcls, *a, **k):
    return lambda: (jcls(*a, **k), tcls(*a, **k))


MOA = _mk(jmoa.MoABlock, tmoa.MoABlock, 32, 3, block_index=1)
C2FMOA = _mk(jmoa.C2fMoA, tmoa.C2fMoA, 32, 32, 1, 3, 2.0, 0.8, True)
REGIMES = {"exact": (2, 16, 16, 32), "blend": (1, 20, 23, 32), "linear": (1, 24, 24, 32)}

# name -> (module factory, input shapes (NHWC), several inputs)
BLOCKS = {
    **{f"MoABlock_{r}": (MOA, [s], False) for r, s in REGIMES.items()},
    **{f"C2fMoA_{r}": (C2FMOA, [s], False) for r, s in REGIMES.items()},
    "NeckMoAFusion": (_mk(jmoa.NeckMoAFusion, tmoa.NeckMoAFusion, [32, 48], 32), [(2, 8, 8, 32), (2, 4, 4, 48)],
                      True),
    "NeckMoAFusion_no_shortcut": (_mk(jmoa.NeckMoAFusion, tmoa.NeckMoAFusion, [32, 24], 40, num_heads=2),
                                  [(2, 6, 6, 32), (2, 3, 3, 24)], True),
    **{f"MoTBlock_top{k}": (_mk(jmot.MoTBlock, tmot.MoTBlock, 32, 4, top_k=k), [(2, 8, 9, 32)], False)
       for k in (1, 2, 3)},
    **{f"C2fMoT_top{k}": (_mk(jmot.C2fMoT, tmot.C2fMoT, 64, 64, 2, 8, k), [(2, 6, 6, 64)], False) for k in (1, 2, 3)},
    "LatentMixture": (_mk(jlat.LatentMixture, tlat.LatentMixture, [32, 64], 32, noise_std=NOISE),
                      [(2, 8, 8, 32), (2, 8, 8, 64)], True),
    "MultiScaleLatentMixture": (_mk(jlat.MultiScaleLatentMixture, tlat.MultiScaleLatentMixture, [32, 64],
                                    latent_dim=32, noise_std=NOISE), [(2, 8, 8, 32), (2, 4, 4, 64)], True),
}
CASES = ([(f"MoABlock_{r}", "woken", 3) for r in REGIMES] + [(f"C2fMoA_{r}", "woken", 3) for r in REGIMES]
         + [("NeckMoAFusion", "woken", 3), ("NeckMoAFusion_no_shortcut", "woken", 3)]
         + [(f"{b}_top{k}", s, 3) for b in ("MoTBlock", "C2fMoT") for k in (1, 2, 3) for s in ("init", "woken")]
         + [(n, "woken", step) for n in ("LatentMixture", "MultiScaleLatentMixture") for step in (3, 7)])


@functools.lru_cache(maxsize=None)
def block(name):
    """(JAX module finalised at path "m", the jitted value_and_grad of its train-mode loss, the port module,
    {path: family} of its aux entries, filled when the loss is traced)."""
    make, _, many = BLOCKS[name]
    jm, tm = make()
    jm = jm.finalize("m")
    families = {}

    def loss(params, xs, cts, step, dtype):
        ctx = Context(training=True, step=step, compute_dtype=dtype)
        kept = []
        plain = jmot._MoTRouter.__call__

        def router(self, p, x, c):  # record each MoT router's kept experts, in forward order
            out = plain(self, p, x, c)
            kept.append(out[1] >= jax.lax.top_k(out[1], self.top_k)[0][..., -1:])
            return out

        jmot._MoTRouter.__call__ = router
        try:
            ys = jm(params, [x.astype(dtype) for x in xs] if many else xs[0].astype(dtype), ctx)
        finally:
            jmot._MoTRouter.__call__ = plain
        ys = list(ys) if isinstance(ys, (list, tuple)) else [ys]
        total = sum(jnp.sum(y.astype(jnp.float32) * c) for y, c in zip(ys, cts)) + ctx.total_aux()
        families.update(ctx.aux_family)
        return total, (ys, dict(ctx.aux), ctx.stats, kept)

    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), static_argnums=4)
    return jm, grad, tm, families


def weights(name, setting):
    """JAX params and the port module loaded with them: "init" the seeded init
    as it is; "woken" after wake_mixtures, every other constant leaf random."""
    jm, _, tm, _ = block(name)
    tm = copy.deepcopy(tm)
    init_weights(tm, torch.Generator().manual_seed(3))
    if setting == "woken":
        wake_mixtures(tm, seed=len(name))
    p = _np_tree(import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), tm.state_dict(), strict=True))
    if setting == "woken":
        p = randomize_constants(p, np.random.default_rng(len(name) + 1))
    tm = _load_module(tm, p).train()
    for n, m in tm.named_modules():  # the JAX paths under "m"
        if hasattr(m, "jax_path"):
            m.jax_path = f"m.{n}" if n else "m"
    return p, tm


def _port_run(tm, xs, cts, step, dtype=torch.float32, pin=None):
    """The port module's train-mode loss, backward: (outputs NHWC, {JAX path: aux record}, input grads)."""
    for m in tm.modules():
        if hasattr(m, "step"):
            m.step = step
    tx = [torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
          .requires_grad_() for x in xs]
    plain = tmot.MoTRouter.forward
    if pin is not None:  # each MoT router keeps the given experts over its own probabilities
        it = iter(pin)

        def pinned(self, x):
            _, probs, logits = plain(self, x)
            w = probs * torch.from_numpy(np.array(next(it))).permute(0, 3, 1, 2)
            w = w / w.sum(1, keepdim=True).clamp_min(1e-9)
            return (1 - self.eps) * w + self.eps / self.num_experts, probs, logits

        tmot.MoTRouter.forward = pinned
    try:
        ys = tm(tx if len(xs) > 1 else tx[0])
    finally:
        tmot.MoTRouter.forward = plain
    ys = [y.permute(0, 2, 3, 1) for y in (ys if isinstance(ys, list) else [ys])]
    recs = {(f"m.{n}" if n else "m"): m.aux_record for n, m in tm.named_modules()
            if getattr(m, "aux_record", None) is not None}
    for m in tm.modules():  # the module keeps no graph past this call
        if hasattr(m, "aux_record"):
            m.aux_record = None
    total = sum((y.double() * torch.from_numpy(c).double()).sum() for y, c in zip(ys, cts))
    total = total + sum(r.value.double() for r in recs.values())
    total.backward()
    return [y.detach() for y in ys], recs, [t.grad for t in tx]


def _inputs(name, seed):
    _, shapes, _ = BLOCKS[name]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes], rng


@pytest.mark.parametrize("name,setting,step", CASES, ids=[f"{n}-{s}-step{k}" for n, s, k in CASES])
def test_module_trains_like_jax(name, setting, step):
    jm, grad, _, jfam = block(name)
    p, tm = weights(name, setting)
    xs, rng = _inputs(name, len(name) + step)
    many = BLOCKS[name][2]
    y_shapes = jax.eval_shape(lambda p, x: jm(p, x if many else x[0], Context(training=True, step=step)), p,
                              [jnp.asarray(x) for x in xs])
    y_shapes = y_shapes if isinstance(y_shapes, (list, tuple)) else [y_shapes]
    cts = [rng.standard_normal(s.shape).astype(np.float32) for s in y_shapes]
    (_, (jys, jaux, jstats, _)), (gp, gx) = grad(p, [jnp.asarray(x) for x in xs], cts, jnp.int32(step),
                                                       jnp.float32)
    ys, recs, gxs = _port_run(tm, xs, cts, step)
    for y, jy in zip(ys, jys):
        jy = np.asarray(jy)
        assert y.shape == jy.shape and np.abs(y.numpy() - jy).max() <= REL * np.abs(jy).max(), "output"
    # the aux records: JAX's entries, families and values; the stats: JAX's keys and values
    assert set(recs) == set(jaux) and all(recs[k].family == jfam[k] for k in recs), (sorted(recs), sorted(jaux))
    for k, r in recs.items():
        value = float(r.value.detach())
        assert abs(value - float(jaux[k])) <= REL * abs(float(jaux[k])) + 1e-12, (k, value, float(jaux[k]))
    assert {k for k, r in recs.items() if r.usage is not None} == set(jstats)
    for k, s in jstats.items():
        assert list(s) == ["expert_usage"]
        np.testing.assert_allclose(recs[k].usage.numpy(), np.asarray(s["expert_usage"]), rtol=0, atol=1e-6)
    # the latent routers' noise: JAX's draw, bit for bit
    for n, m in tm.named_modules():
        if isinstance(m, tlat.LatentRouter):
            key = jmix._path_key(step, m.jax_path)
            np.testing.assert_array_equal(m._draws[1].numpy(),
                                          np.asarray(jax.random.normal(key, m._draws[0][1]) * NOISE))
    # gradients against the port's own float64 run
    t64 = copy.deepcopy(tm).double()
    _, _, gxs64 = _port_run(t64, [x.astype(np.float64) for x in xs], cts, step, torch.float64)
    ref = state_dict_from_jax({"layers": {"0": _np_tree(gp)}})
    ref = {k[len("model.0."):]: v for k, v in ref.items() if not k.endswith("_rf_matrix")}
    gmax = max(float(v.abs().max()) for v in ref.values())
    pairs = [(g.permute(0, 2, 3, 1), torch.from_numpy(np.array(j)), g64.permute(0, 2, 3, 1), f"input {i}")
             for i, (g, j, g64) in enumerate(zip(gxs, gx, gxs64))]
    params64 = dict(t64.named_parameters())
    pairs += [(prm.grad, ref[n], params64[n].grad, n) for n, prm in tm.named_parameters()]
    for got, want, g64, what in pairs:
        assert got is not None and got.shape == want.shape and torch.isfinite(got).all(), what
        own = (got.double() - g64).abs().max().item()
        err = (got - want).abs().max().item()
        floor = 1e-6 * gmax if not what.startswith("input") else REL * want.abs().max().item()
        assert err <= max(8 * own, floor), (what, err, own, gmax)
    if "linear" in name:  # fault 4 of the reference: JAX's features take a gradient, the port's are a buffer
        rf = [np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(gp) if "_rf_matrix" in str(path)]
        assert rf and all(np.abs(r).max() > 0 for r in rf)
        assert not any("_rf_matrix" in n for n, _ in tm.named_parameters())


def test_mot_exploration_floor_and_ties():
    """In train mode every expert keeps at least eps / E = 0.02 / 3 of weight,
    eps clamped to [0, 0.2]; in eval there is no floor (calibrate_bn's pass:
    the last test below); at the zero-initialised router every expert ties and all three are
    kept (uniform weights), at top_k 1 too."""
    r = tmot.MoTRouter(32, 3, top_k=1)
    init_weights(r, torch.Generator().manual_seed(0))
    with torch.no_grad():
        r.router[3].bias.copy_(torch.tensor([3.0, 0.0, -2.0]))
    x = torch.randn(2, 32, 4, 5)
    w_eval = r.eval()(x)[0]
    w_train = r.train()(x)[0]
    assert torch.equal(w_eval[:, 1:], torch.zeros_like(w_eval[:, 1:]))
    torch.testing.assert_close(w_train, 0.98 * w_eval + 0.02 / 3, rtol=0, atol=1e-7)
    assert tmot.MoTRouter(32, exploration_eps=0.7).eps == 0.2 and tmot.MoTRouter(32, exploration_eps=-1).eps == 0.0
    z = tmot.MoTRouter(32, 3, top_k=1)
    init_weights(z, torch.Generator().manual_seed(0))
    torch.testing.assert_close(z.train()(x)[0], torch.full((2, 3, 4, 5), 1 / 3), rtol=0, atol=1e-7)


# -- 2. bf16 ---------------------------------------------------------------------------------------------

@contextlib.contextmanager
def _fp32_parts(tm):
    """Record, as (what, dtype), the output of every router of ``tm`` (MoA, MoT:
    probabilities and logits; latent: its LayerNorm, trunk, head and outputs)
    and the input of every GroupNorm and LayerNorm it computes."""
    seen = []

    def outputs(what):
        def hook(_, __, out):
            seen.extend((what, t.dtype) for t in (out if isinstance(out, tuple) else (out,)))
        return hook

    hooks = []
    for n, m in tm.named_modules():
        if isinstance(m, (tmoa.MoARouter, tmot.MoTRouter, tlat.LatentRouter)):
            hooks.append(m.register_forward_hook(outputs(n)))
        if isinstance(m, tlat.LatentRouter):
            hooks += [getattr(m, c).register_forward_hook(outputs(f"{n}.{c}")) for c in ("norm", "trunk", "expert_head")]
    norms = {"group_norm": F.group_norm, "layer_norm": F.layer_norm}

    def normed(fn, what):
        def call(x, *a, **k):
            seen.append((what, x.dtype))
            return fn(x, *a, **k)
        return call

    for k, fn in norms.items():
        setattr(F, k, normed(fn, k))
    try:
        yield seen
    finally:
        for k, fn in norms.items():
            setattr(F, k, fn)
        for h in hooks:
            h.remove()


BF16_CASES = ["MoABlock_linear", "NeckMoAFusion", "MoTBlock_top2", "C2fMoT_top1", "LatentMixture"]


@pytest.mark.parametrize("name", BF16_CASES)
def test_module_trains_like_jax_in_bf16(name):
    """fp32 parameters, the same bf16 input, four inputs: the parameter
    gradients' rel-RMS from JAX fp32 (squared distances summed over the tree
    and the inputs) within 1.5x JAX bf16's own, MoT's kept experts pinned to
    JAX bf16's; each aux record within 2^-6 relative of JAX bf16's. The parts
    both packages compute in fp32 in a bf16 step are held to it by dtype: every
    router's logits and probabilities, the latent router's LayerNorm, trunk and
    head, and every GroupNorm's and LayerNorm's input (the statistic cannot see
    them: one of them computed in bf16 moves it by less than its spread). Per
    tensor the statistic of a correct program spreads too far (a router's
    GroupNorm or a norm bias deep in a block measured 1.6-2.6x), as PERF.md §7
    says of whole models."""
    jm, grad, _, _ = block(name)
    p, tm = weights(name, "woken")
    many = BLOCKS[name][2]
    sums = np.zeros(3)  # |port16 - jax32|^2, |jax16 - jax32|^2, |jax32|^2
    names = [n for n, _ in tm.named_parameters()]
    for seed in range(40, 44):
        xs, rng = _inputs(name, seed)
        xs = [np.array(_f32(_bf16(x)[0])) for x in xs]  # bf16-representable: both packages read the same values
        y_shapes = jax.eval_shape(lambda p, x: jm(p, x if many else x[0], Context(training=True, step=2)), p,
                                  [jnp.asarray(x) for x in xs])
        y_shapes = y_shapes if isinstance(y_shapes, (list, tuple)) else [y_shapes]
        cts = [rng.standard_normal(s.shape).astype(np.float32) for s in y_shapes]
        args = (p, [jnp.asarray(x) for x in xs], cts, jnp.int32(2))
        (_, (_, jaux16, _, kept16)), (g16, _) = grad(*args, jnp.bfloat16)
        _, (g32, _) = grad(*args, jnp.float32)
        for prm in tm.parameters():
            prm.grad = None
        with _fp32_parts(tm) as seen:
            _, recs, _ = _port_run(tm, xs, cts, 2, BF16, pin=[np.asarray(k) for k in kept16] if kept16 else None)
        assert seen and all(dt == torch.float32 for _, dt in seen), [w for w, dt in seen if dt != torch.float32]
        for k, r in recs.items():
            assert abs(float(r.value.detach()) - float(jaux16[k])) <= 2.0 ** -6 * abs(float(jaux16[k])) + 1e-9, k
        r16, r32 = (state_dict_from_jax({"layers": {"0": _np_tree(g)}}) for g in (g16, g32))
        assert all(prm.grad.dtype == torch.float32 for prm in tm.parameters())
        gp = torch.cat([prm.grad.flatten() for prm in tm.parameters()]).numpy()
        j16, j32 = (torch.cat([r[f"model.0.{n}"].flatten() for n in names]).numpy() for r in (r16, r32))
        assert np.isfinite(gp).all()
        sums += [np.sum((gp - j32) ** 2), np.sum((j16 - j32) ** 2), np.sum(j32 ** 2)]
    port, own = np.sqrt(sums[0] / sums[2]), np.sqrt(sums[1] / sums[2])
    assert 0 < own < 1 and port <= STAT * own, (port, own)


# -- 3. fault 4 of the reference ----------------------------------------------------------------------

def test_fault4_jax_trains_the_random_features_the_port_keeps_them():
    """JAX: jax.grad of MoABlock(48, 3) in training on a 24x24 map (576 tokens,
    the linear path) gives ``global_head._rf_matrix`` a non-zero gradient, and
    param_group_labels puts it in "other" (Adam moves it at the base lr). The
    port: ``_rf_matrix`` is a buffer; a yolo26-master-moa-mot-n SGD step at 192
    px (P3 24x24) changes the parameters and leaves every ``_rf_matrix`` as it was."""
    jb = jmoa.MoABlock(48, 3).finalize("m")
    tb = tmoa.MoABlock(48, 3)
    init_weights(tb, torch.Generator().manual_seed(1))
    wake_mixtures(tb)
    p = _np_tree(import_state_dict(jax.eval_shape(jb.init, jax.random.PRNGKey(0)), tb.state_dict(), strict=True))
    x = np.random.default_rng(0).standard_normal((1, 24, 24, 48)).astype(np.float32)
    g = jax.jit(jax.grad(lambda p: jnp.sum(jb(p, jnp.asarray(x), Context(training=True)) ** 2)))(p)
    assert np.abs(np.asarray(g["global_head"]["_rf_matrix"])).max() > 1.0
    assert jts.param_group_labels(p)["global_head"]["_rf_matrix"] == "other"
    model = DetectionModel("yolo26-master-moa-mot-n")
    wake_mixtures(model)
    b = _batch(5, 2)
    b["images"] = np.random.default_rng(5).random((2, 192, 192, 3), np.float32)
    b["boxes"] = b["boxes"] * 3
    calibrate_bn(model, torch.from_numpy(b["images"]))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = ts.make_optimizer(0.05, model)
    state = ts.make_train_state(model, tx)
    _, met = ts.make_train_step(model, tx)(state, _tb(b))
    assert float(met["finite"]) == 1.0 and float(met["aux_moa"]) > 0
    after = model.state_dict()
    rf = [k for k in after if k.endswith("_rf_matrix")]
    assert rf == ["model.16.m.0.global_head._rf_matrix"]
    assert all(torch.equal(after[k], before[k]) for k in rf)
    assert not torch.equal(after["model.16.m.0.global_head.qkv.weight"], before["model.16.m.0.global_head.qkv.weight"])


# -- 4. graph dicts -------------------------------------------------------------------------------------

def _graph(fusion):
    return {"nc": 4, "end2end": True, "reg_max": 1,
            "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                         [-1, 1, "Conv", [96, 3, 2]]],
            "head": [fusion, [[4, 3], 1, "Detect", ["nc"]]]}


def test_neck_moa_fusion_graph_builds_round_trips_and_trains():
    """A graph dict with NeckMoAFusion between P3 (64 wide, queries) and P4 (96,
    keys and values upsampled): JAX's parameter count, a strict round trip both
    ways (c1 is the list of input widths, c2 width-scaled), and a train step
    that publishes its aux under the "moa" family and no routing stats."""
    cfg = _graph([[2, 3], 1, "NeckMoAFusion", [64, 4]])
    port = DetectionModel(cfg)
    fusion = port.model[4]
    assert isinstance(fusion, tmoa.NeckMoAFusion) and fusion.shortcut and fusion.f == [2, 3]
    assert fusion.kv_proj.weight.shape[1] == 96
    tree = jax_params_of(JaxDetectionModel(cfg), port)
    assert sum(p.numel() for p in port.parameters()) == _trainable(tree)
    back = DetectionModel(cfg, seed=1)
    back.load_state_dict(state_dict_from_jax(tree), strict=True)
    assert all(torch.equal(back.state_dict()[k], v) for k, v in port.state_dict().items())
    assert {"model.4.router.router.3.bias", "model.4.out_proj.bn.running_var", "model.4.q_proj.weight"} <= set(
        port.state_dict())
    wake_mixtures(port)
    tx = ts.make_optimizer(0.01, port)
    state = ts.make_train_state(port, tx)
    _, met = ts.make_train_step(port, tx, return_stats=True)(state, _tb(_batch(3, 2)))
    assert float(met["finite"]) == 1.0 and float(met["aux_moa"]) > 0 and met["moe_stats"] == {}


def test_multi_scale_latent_mixture_graph_raises_as_jax():
    """MultiScaleLatentMixture is registered in both parsers, neither has a
    branch for it: with its list of inputs, both raise JAX's TypeError."""
    cfg = _graph([[2, 3], 1, "MultiScaleLatentMixture", [[64, 96]]])
    with pytest.raises(TypeError) as jerr:
        JaxDetectionModel(cfg)
    with pytest.raises(TypeError) as terr:
        DetectionModel(cfg)
    assert str(terr.value) == str(jerr.value) == "list indices must be integers or slices, not list"


# -- 5. calibrate_bn ------------------------------------------------------------------------------------

def test_calibrate_bn_runs_the_eval_form_of_every_mixture():
    """With the latent noise on, calibrate_bn's pass sets the same BN statistics
    as a train-mode pass whose mixtures are switched to their eval form by hand
    (MoT's floor off, the latent noise at 0), publishes no aux record, and
    leaves every module in the mode it was in."""
    for name in ("yolo26-master-latent-n", "yolo26-master-moa-mot-n"):
        model = DetectionModel(name)
        wake_mixtures(model)
        for m in model.modules():
            if isinstance(m, tlat.LatentRouter):
                m.noise_std = NOISE
        x = torch.from_numpy(np.random.default_rng(1).random((2, 64, 64, 3), np.float32))
        ref = copy.deepcopy(model)
        calibrate_bn(model, x)
        assert all(m.training for m in model.modules())
        assert all(getattr(m, "aux_record", None) is None for m in model.modules())
        for m in ref.modules():
            if isinstance(m, tlat.LatentRouter):
                m.noise_std = 0.0
            if isinstance(m, tmot.MoTRouter):
                m.eps = 0.0
        calibrate_bn(ref, x)
        for k, v in ref.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), (name, k)
