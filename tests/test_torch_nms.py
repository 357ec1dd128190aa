"""The port's NMS (yolo_master_tpu_torch/ops/nms.py, ops/cuda_nms.py) against
the JAX package's: the batched greedy loop against the Pallas kernels in
interpret mode (keep sets exactly equal, ties and early exit included), and
non_max_suppression against JAX's (outputs within 1e-6).

On the CPU the port's wrapper runs its plain PyTorch loop; the CUDA kernel
(csrc/nms.cu) is compared with that loop on the card, in
tests/test_torch_cuda.py and in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_master_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_master_tpu.ops.pallas_nms import pallas_batched_greedy_nms, pallas_greedy_nms
from yolo_master_tpu_torch.ops.cuda_nms import batched_greedy_nms, batched_greedy_nms_plain, greedy_nms
from yolo_master_tpu_torch.ops.nms import non_max_suppression, stable_topk


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)



def _candidates(seed, b, n, valid_counts, ties=True):
    """Seeded boxes [B,N,4] xyxy and scores [B,N]; rows get the given number of
    positive scores (the rest 0), some of them exactly tied."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (b, n, 2))
    wh = rng.uniform(10, 120, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.zeros((b, n), np.float32)
    for i, nv in enumerate(valid_counts):
        if nv:
            idx = rng.choice(n, nv, replace=False)
            scores[i, idx] = rng.uniform(0.1, 1.0, nv)
            if ties and nv >= 8:  # exact ties between far-apart candidates
                scores[i, idx[: nv // 4]] = scores[i, idx[0]]
    return boxes, scores


def test_plain_batched_nms_equals_pallas_kernel():
    """Rows: dense, 3 valid, all invalid, medium, dense with many ties."""
    boxes, scores = _candidates(11, 5, 256, [256, 3, 0, 40, 200])
    ki_j, kv_j = pallas_batched_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.45, 64, interpret=True)
    ki_t, kv_t = batched_greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 64)
    assert ki_t.dtype == torch.int32 and kv_t.dtype == torch.bool
    np.testing.assert_array_equal(ki_t.numpy(), np.asarray(ki_j))
    np.testing.assert_array_equal(kv_t.numpy(), np.asarray(kv_j))
    assert not kv_t[2].any() and kv_t[1].sum() <= 3


def test_plain_nms_ties_go_to_the_lowest_index():
    """Identical boxes with identical scores: the first index is kept, the rest suppressed."""
    boxes = torch.tensor([[[0.0, 0, 10, 10]] * 4 + [[100.0, 100, 110, 110]]])
    scores = torch.tensor([[0.5, 0.5, 0.5, 0.5, 0.5]])
    ki, kv = batched_greedy_nms_plain(boxes, scores, 0.45, 4)
    assert ki.tolist() == [[0, 4, 0, 0]] and kv.tolist() == [[True, True, False, False]]


def test_single_image_entry_point_equals_pallas_kernel():
    boxes, scores = _candidates(7, 1, 256, [6], ties=False)
    ki_j, kv_j = pallas_greedy_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.45, 64, interpret=True)
    ki_t, kv_t = greedy_nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), 0.45, 64)
    np.testing.assert_array_equal(ki_t.numpy(), np.asarray(ki_j))
    np.testing.assert_array_equal(kv_t.numpy(), np.asarray(kv_j))
    assert kv_t.sum() <= 6


def test_stable_topk_keeps_lower_index_first():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    v, i = stable_topk(x, 4)
    assert i.tolist() == [[1, 2, 4, 3]] and v.tolist() == [[3.0, 3.0, 3.0, 2.0]]


@pytest.mark.parametrize("scores_are_logits,multi_label,agnostic",
                         [(False, False, False), (True, False, False), (True, True, False), (False, False, True)])
def test_non_max_suppression_matches_jax(scores_are_logits, multi_label, agnostic):
    rng = np.random.default_rng(13)
    nc = 8
    pred = rng.uniform(0, 1, (3, 128, 4 + nc)).astype(np.float32)
    pred[..., :2] = rng.uniform(100, 500, (3, 128, 2))
    pred[..., 2:4] = rng.uniform(20, 80, (3, 128, 2))
    if scores_are_logits:
        pred[..., 4:] = rng.normal(-1.0, 2.0, (3, 128, nc))
    pred[1, :, 4:] = pred[1, 0, 4:]  # one image of identical scores: every candidate tied
    kw = dict(nc=nc, conf_thres=0.3, iou_thres=0.5, max_det=16, max_nms=64, agnostic=agnostic,
              multi_label=multi_label, scores_are_logits=scores_are_logits)
    ref = jax_nms(jnp.asarray(pred), use_pallas=False, **kw)
    out = non_max_suppression(torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
    for key in ("boxes", "scores", "classes", "extra"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-6, rtol=0, err_msg=key)


def test_non_max_suppression_class_mask_matches_jax():
    rng = np.random.default_rng(5)
    nc = 6
    pred = rng.uniform(0, 1, (2, 96, 4 + nc)).astype(np.float32)
    pred[..., :2] = rng.uniform(100, 500, (2, 96, 2))
    pred[..., 2:4] = rng.uniform(20, 80, (2, 96, 2))
    mask = np.array([1, 0, 1, 0, 0, 1], np.float32)
    kw = dict(nc=nc, conf_thres=0.2, iou_thres=0.45, max_det=12, max_nms=50)
    ref = jax_nms(jnp.asarray(pred), class_mask=jnp.asarray(mask), use_pallas=False, **kw)
    out = non_max_suppression(torch.from_numpy(pred), class_mask=torch.from_numpy(mask), **kw)
    for key in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-6, rtol=0, err_msg=key)

