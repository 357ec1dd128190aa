"""The pieces of the port's train loss against the JAX package's, on the CPU in
fp32: box IoUs, the task-aligned assigner, the v8 detection loss and its
gradient, the MoE aux losses and their composition, and BatchNorm in train
mode. Inputs are made with numpy from seeds and fed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn import assigner as jassigner
from yolo_master_tpu.nn import layers as jlayers
from yolo_master_tpu.nn import losses as jlosses
from yolo_master_tpu.nn import mixture_loss as jmix
from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import losses as jmoe_losses
from yolo_master_tpu.ops import anchors as janchors
from yolo_master_tpu.ops import boxes as jboxes
from yolo_master_tpu_torch.nn import assigner, losses, mixture_loss
from yolo_master_tpu_torch.nn.layers import BN_EPS, BN_MOMENTUM, BatchNorm2d
from yolo_master_tpu_torch.nn.mixture_loss import AuxRecord
from yolo_master_tpu_torch.nn.moe import losses as moe_losses
from yolo_master_tpu_torch.ops import anchors, boxes

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _boxes(rng, n, lo=0.0, hi=64.0, wh=(2.0, 30.0)):
    """n xyxy boxes with corners in [lo, hi] and sides in ``wh``."""
    xy = rng.uniform(lo, hi - wh[1], (n, 2))
    return np.concatenate([xy, xy + rng.uniform(*wh, (n, 2))], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("xywh", [False, True], ids=["xyxy", "xywh"])
def test_bbox_iou_and_its_gradient_match_jax(kind, xywh):
    """Values within 1e-6 (absolute, IoUs lie in [-1, 1]) and the gradient of their
    sum with respect to the first boxes within 1e-5 * max |g|; CIoU's alpha
    carries no gradient in either package."""
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 200), _boxes(rng, 200)
    a[:20] = b[:20]  # coincident boxes
    a[20:40, 2:] = a[20:40, :2] + 1e-3  # tiny boxes
    if xywh:  # the same boxes as centre and size
        a, b = (np.concatenate([(v[:, :2] + v[:, 2:]) / 2, v[:, 2:] - v[:, :2]], -1) for v in (a, b))
    flags = {"GIoU": kind == "giou", "DIoU": kind == "diou", "CIoU": kind == "ciou"}

    def jfn(x):
        return jboxes.bbox_iou(x, jnp.asarray(b), xywh=xywh, **flags)

    ref, jgrad = jfn(jnp.asarray(a)), jax.grad(lambda x: jnp.sum(jfn(x)))(jnp.asarray(a))
    ta = T(a).requires_grad_(True)
    out = boxes.bbox_iou(ta, T(b), xywh=xywh, **flags)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    g = np.asarray(jgrad)
    assert np.abs(ta.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_bbox2dist_matches_jax():
    """Clamped (reg_max 15) and unclamped ltrb distances, exactly."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 40, (300, 2)).astype(np.float32)
    bb = _boxes(rng, 300, 0, 40, (0.5, 20))
    for reg_max in (None, 15):
        ref = np.asarray(janchors.bbox2dist(jnp.asarray(pts), jnp.asarray(bb), reg_max))
        np.testing.assert_array_equal(anchors.bbox2dist(T(pts), T(bb), reg_max).numpy(), ref)


def _assign_inputs(case: str, seed: int = 2):
    """Predictions of a 64 px, strides (8, 16, 32) grid (84 anchors) and padded GTs.

    * ``random``: four images, up to 6 GTs each, random scores and boxes;
    * ``few_candidates``: a small GT with fewer than 10 candidate anchors, the
      scores of most anchors exactly 0 (align ties at 0 decide the top-k);
    * ``shared_anchor``: two GTs covering the same anchors with equal overlaps
      (the first GT wins the argmax), and duplicated anchors with tied align.
    """
    rng = np.random.default_rng(seed)
    hw, strides, nc = ((8, 8), (4, 4), (2, 2)), (8, 16, 32), 5
    pts, st = janchors.make_anchors(hw, strides)
    anc = np.asarray(pts * st, np.float32)
    a_n = anc.shape[0]
    b, m = (4, 6) if case == "random" else (2, 3)
    scores = rng.uniform(0, 1, (b, a_n, nc)).astype(np.float32)
    pd = np.concatenate([anc - rng.uniform(2, 20, (a_n, 2)), anc + rng.uniform(2, 20, (a_n, 2))], -1)
    pd = np.broadcast_to(pd, (b, a_n, 4)).astype(np.float32).copy()
    gt = np.stack([_boxes(rng, m, 0, 64, (4, 40)) for _ in range(b)])
    labels = rng.integers(0, nc, (b, m)).astype(np.int32)
    mask = rng.random((b, m)) < 0.8
    mask[:, 0] = True
    if case == "few_candidates":
        scores[:, ::2] = 0.0
        gt[:, 0] = [20, 20, 27, 26]  # smaller than the smallest stride: widened to 16 px
        mask[:, 1:] = False
    elif case == "shared_anchor":
        gt[:, 1] = gt[:, 0]
        labels[:, 1] = labels[:, 0]
        mask[:, :2] = True
        pd[:, 10:20] = pd[:, 10:11]
        scores[:, 10:20] = scores[:, 10:11]
    return scores, pd, anc, labels, gt, mask, nc, strides


@pytest.mark.parametrize("case", ["random", "few_candidates", "shared_anchor"])
def test_task_aligned_assign_matches_jax(case):
    """fg_mask, target_gt_idx and target_labels equal; target boxes and scores within 1e-6."""
    scores, pd, anc, labels, gt, mask, nc, strides = _assign_inputs(case)
    ref = jassigner.task_aligned_assign(jnp.asarray(scores), jnp.asarray(pd), jnp.asarray(anc), jnp.asarray(labels),
                                        jnp.asarray(gt), jnp.asarray(mask), num_classes=nc, strides=strides)
    out = assigner.task_aligned_assign(T(scores), T(pd), T(anc), T(labels), T(gt), T(mask), num_classes=nc,
                                       strides=strides)
    assert np.asarray(ref.fg_mask).sum() > 0
    np.testing.assert_array_equal(out.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(out.target_gt_idx.numpy(), np.asarray(ref.target_gt_idx))
    np.testing.assert_array_equal(out.target_labels.numpy(), np.asarray(ref.target_labels))
    np.testing.assert_allclose(out.target_bboxes.numpy(), np.asarray(ref.target_bboxes), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.target_scores.numpy(), np.asarray(ref.target_scores), atol=1e-6, rtol=0)
    if case == "shared_anchor":  # the shared anchors went to the first of the two GTs
        fg, idx = np.asarray(ref.fg_mask), np.asarray(ref.target_gt_idx)
        assert (idx[fg] != 1).all()


def _loss_inputs(reg_max: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    hw, strides, nc, b, m = ((8, 8), (4, 4), (2, 2)), (8, 16, 32), 6, 3, 5
    a_n = sum(h * w for h, w in hw)
    box = rng.normal(0, 1.5, (b, a_n, 4 * reg_max)).astype(np.float32)
    if reg_max == 1:
        box = np.abs(box) + 0.5  # ltrb distances in grid units
    cls = rng.normal(-2, 1.5, (b, a_n, nc)).astype(np.float32)
    gt = np.stack([_boxes(rng, m, 0, 64, (6, 40)) for _ in range(b)])
    labels = rng.integers(0, nc, (b, m)).astype(np.int32)
    mask = rng.random((b, m)) < 0.7
    mask[:, 0] = True
    mask[2] = False  # an image without objects
    return box, cls, gt, labels, mask, hw, strides, nc


@pytest.mark.parametrize("reg_max", [16, 1])
def test_detection_loss_and_its_gradient_match_jax(reg_max):
    """Each component within 1e-5 relative; the gradient of the total with
    respect to the raw head outputs (box and class logits) within 1e-5 * max |g|."""
    box, cls, gt, labels, mask, hw, strides, nc = _loss_inputs(reg_max)

    def jloss(bx, sc):
        return jlosses.detection_loss({"boxes": bx, "scores": sc}, hw, strides, jnp.asarray(gt), jnp.asarray(labels),
                                      jnp.asarray(mask), nc=nc, reg_max=reg_max)

    ref = jloss(jnp.asarray(box), jnp.asarray(cls))
    jg = jax.grad(lambda bx, sc: jloss(bx, sc).total, argnums=(0, 1))(jnp.asarray(box), jnp.asarray(cls))
    tb, tc = T(box).requires_grad_(True), T(cls).requires_grad_(True)
    out = losses.detection_loss({"boxes": tb, "scores": tc}, hw, strides, T(gt), T(labels), T(mask), nc=nc,
                                reg_max=reg_max)
    out.total.backward()
    for name in ("total", "box", "cls", "dfl"):
        r, o = float(getattr(ref, name)), float(getattr(out, name))
        assert r > 0 and abs(o - r) <= 1e-5 * abs(r), (name, o, r)
    for g, ref_g in ((tb.grad, jg[0]), (tc.grad, jg[1])):
        ref_g = np.asarray(ref_g)
        assert np.abs(g.numpy() - ref_g).max() <= 1e-5 * np.abs(ref_g).max()


def test_moe_aux_losses_match_jax():
    """gshard_balance_loss (uniform usage gives 1, one expert gives E) and router_z_loss, within 1e-6 relative."""
    rng = np.random.default_rng(4)
    for usage in (rng.random(8).astype(np.float32), np.full(4, 0.25, np.float32), np.eye(6, dtype=np.float32)[2]):
        ref = float(jmoe_losses.gshard_balance_loss(jnp.asarray(usage), usage.size))
        assert abs(float(moe_losses.gshard_balance_loss(T(usage), usage.size)) - ref) <= 1e-6 * ref
    assert float(moe_losses.gshard_balance_loss(torch.full((4,), 0.25), 4)) == pytest.approx(1.0)
    logits = rng.normal(0, 3, (16, 8)).astype(np.float32)
    ref = float(jmoe_losses.router_z_loss(jnp.asarray(logits)))
    assert abs(float(moe_losses.router_z_loss(T(logits))) - ref) <= 1e-6 * ref


@pytest.mark.parametrize("case", ["finite", "non_finite_family", "budget", "raw"])
def test_compose_aux_matches_jax(case):
    """Per-family sums, gains, EMA normalisation, the budget and the isolation of a
    non-finite family: the total, the new EMA and every metric within 1e-6
    relative, and the total's gradient with respect to each aux value within
    1e-6 relative or 1e-9 (under the budget the gradient is 0 up to rounding;
    elsewhere it is 1e-3 to 1e-1)."""
    rng = np.random.default_rng(5)
    entries = [("model.3", "moe", 1.7), ("model.6", "moe", 0.9), ("model.9", "mot", 2.5), ("model.12", "weird", 0.4)]
    if case == "non_finite_family":
        entries.append(("model.15", "mot", np.inf))
    ema = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    gains = {"moe": 0.01, "mot": 0.05}
    kw = {"budget": 0.02 if case == "budget" else 0.0, "normalize": case != "raw"}

    def jtotal(vals):
        ctx = Context(training=True)
        for (path, fam, _), v in zip(entries, vals):
            ctx.add_aux(path, v, fam)
        return jmix.compose_aux(ctx, gains, jnp.asarray(ema), **kw)

    vals = [jnp.float32(v) for _, _, v in entries]
    ref_total, ref_ema, ref_metrics = jtotal(vals)
    ref_grad = jax.grad(lambda v: jtotal(v)[0])(vals)
    tv = [torch.tensor(v, dtype=torch.float32, requires_grad=True) for _, _, v in entries]
    recs = {path: AuxRecord(v, fam, torch.zeros(1)) for (path, fam, _), v in zip(entries, tv)}
    total, new_ema, metrics = mixture_loss.compose_aux(recs, gains, T(ema), **kw)
    total.backward()
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-6)
    np.testing.assert_allclose(new_ema.numpy(), np.asarray(ref_ema), rtol=1e-6)
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-6, atol=1e-12)
    for t, g in zip(tv, ref_grad):
        np.testing.assert_allclose(float(t.grad), float(g), rtol=1e-6, atol=1e-9)
    assert float(metrics["aux_isolated"]) == (1.0 if case == "non_finite_family" else 0.0)
    assert np.isfinite(float(total))


def test_batchnorm_train_mode_matches_jax():
    """BatchNorm2d in train mode (batch statistics; the running statistics move
    by momentum 0.03 toward the batch mean and the unbiased variance) against
    JAX's BatchNorm with ctx.training: the output within 1e-5, the new running
    statistics within 1e-6 relative; and the output's gradient with respect to
    the input, weight and bias within 1e-5 * max |g|."""
    rng = np.random.default_rng(6)
    c = 24
    x = rng.normal(0.3, 2.0, (3, 7, 5, c)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32), "bias": rng.normal(0, 0.3, c).astype(np.float32),
         "mean": rng.normal(0, 0.2, c).astype(np.float32), "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    up = rng.normal(0, 1, x.shape).astype(np.float32)  # the upstream gradient
    jbn = jlayers.BatchNorm(c).finalize("m")
    ctx = Context(training=True)
    ref = jbn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), ctx)
    upd = ctx.updates[jbn.path]

    def jf(xx, scale, bias):
        return jnp.sum(jbn({**p, "scale": scale, "bias": bias}, xx, Context(training=True)) * up)

    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(p["scale"]), jnp.asarray(p["bias"]))
    bn = BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(T(p["scale"]))
        bn.bias.copy_(T(p["bias"]))
        bn.running_mean.copy_(T(p["mean"]))
        bn.running_var.copy_(T(p["var"]))
    bn.train()
    xt = T(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = bn(xt)
    (out * T(up).permute(0, 3, 1, 2)).sum().backward()
    assert np.abs(out.detach().permute(0, 2, 3, 1).numpy() - np.asarray(ref)).max() <= 1e-5
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["var"]), rtol=1e-6)
    for g, r in ((xt.grad.permute(0, 2, 3, 1), jg[0]), (bn.weight.grad, jg[1]), (bn.bias.grad, jg[2])):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()
