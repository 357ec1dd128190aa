"""The design of the port's NMS kernels (csrc/nms_common.cuh, nms.cu,
cw_nms.cu), mirrored on the CPU: sort, IoU bitmask, scan, and for CW-NMS the
cluster sums. The kernels cannot run here; this mirror follows them step for
step (the bitonic network over 64-bit keys, 64-bit mask words of the upper
triangle, the scan 64 candidates at a time from the diagonal words, each kept
row's later words ORed in sorted order, a cluster as the bits a kept row newly
sets) and is held to batched_greedy_nms_plain / batched_cw_nms_plain, and
through them to the JAX kernels in interpret mode.

IoUs are the plain versions' torch fp32 expression, elementwise, so keep sets
and cluster memberships must be equal, not close; fused boxes are sums in
another order (1e-4 + 5e-7*|ref|, as on the card).
"""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from yolo_master_tpu.ops.pallas_nms import pallas_batched_cw_nms, pallas_batched_greedy_nms
from yolo_master_tpu_torch.ops.cuda_nms import batched_cw_nms_plain, batched_greedy_nms_plain

ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sort(scores: np.ndarray):
    """sort_candidates_kernel: keys (~score bits) << 32 | index for score > 0,
    all ones otherwise, padded to a power of two and sorted ascending by the
    bitonic network the kernel runs. -> (sorted indices of the valid, count)."""
    n = len(scores)
    p = 1
    while p < n:
        p <<= 1
    keys = np.full(p, ONES, np.uint64)
    valid = scores > 0
    bits = scores.astype(np.float32).view(np.uint32)
    keys[:n][valid] = (((~bits[valid]).astype(np.uint64) << np.uint64(32))
                       | np.arange(n, dtype=np.uint64)[valid])
    q = np.arange(p // 2)
    k = 2
    while k <= p:
        j = k >> 1
        while j > 0:
            i = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            a, c = keys[i].copy(), keys[i | j].copy()
            swap = (a > c) == ((i & k) == 0)
            keys[i[swap]], keys[(i | j)[swap]] = c[swap], a[swap]
            j >>= 1
        k <<= 1
    cnt = int(valid.sum())
    return (keys[:cnt] & np.uint64(0xFFFFFFFF)).astype(np.int64), cnt


def _iou_matrix(sb: torch.Tensor) -> torch.Tensor:
    """iou[i, j] of candidate j against pick i, the plain loop's fp32 expression."""
    x1, y1, x2, y2 = sb.unbind(-1)
    areas = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    iw = (torch.minimum(x2[None], x2[:, None]) - torch.maximum(x1[None], x1[:, None])).clamp_min(0.0)
    ih = (torch.minimum(y2[None], y2[:, None]) - torch.maximum(y1[None], y1[:, None])).clamp_min(0.0)
    inter = iw * ih
    return inter / (areas[None] + areas[:, None] - inter + 1e-7)


def _mask(sb: torch.Tensor, iou_thres: float) -> np.ndarray:
    """iou_mask_kernel: words [cnt, W]; bit j of word c of row i set when
    iou(candidate 64c+j, pick i) > iou_thres, for 64c+j > i only."""
    cnt = sb.shape[0]
    w = (cnt + 63) // 64
    over = (_iou_matrix(sb) > iou_thres).numpy() & np.triu(np.ones((cnt, cnt), bool), 1)
    padded = np.zeros((cnt, w * 64), bool)
    padded[:, :cnt] = over
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    return (padded.reshape(cnt, w, 64).astype(np.uint64) * weights).sum(-1, dtype=np.uint64)


def _scan(mask: np.ndarray, cnt: int, max_det: int, clusters: bool):
    """scan_kernel: kept sorted positions, and with ``clusters`` each kept
    position's member words (the bits its row newly sets)."""
    nw = (cnt + 63) // 64
    rem = np.zeros(nw, np.uint64)
    kept, members = [], []
    for w in range(nw):
        if len(kept) >= max_det:
            break
        cur = rem[w]
        rows = min(64, cnt - 64 * w)
        block = []
        for t in range(rows):
            if (cur >> np.uint64(t)) & np.uint64(1):
                continue
            d = mask[64 * w + t, w]
            block.append(64 * w + t)
            if clusters:
                words = np.zeros(nw, np.uint64)
                words[w] = d & ~cur
                members.append(words)
            cur |= d
            if len(kept) + len(block) == max_det:
                break
        base = len(kept)
        kept += block
        if not clusters and len(kept) == max_det:
            break
        for r, i in enumerate(block):  # the later words, in sorted order
            row = mask[i, w + 1:]
            if clusters:
                members[base + r][w + 1:] = row & ~rem[w + 1:]
            rem[w + 1:] |= row
    return kept, members


def scan_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int):
    """Greedy NMS by sort, bitmask and scan: keep_idx [B, max_det] int32, keep_valid [B, max_det] bool."""
    b = scores.shape[0]
    keep_idx = torch.zeros((b, max_det), dtype=torch.int32)
    keep_valid = torch.zeros((b, max_det), dtype=torch.bool)
    for i in range(b):
        order, cnt = _sort(scores[i].numpy())
        kept, _ = _scan(_mask(boxes[i][order], iou_thres), cnt, max_det, False)
        keep_idx[i, :len(kept)] = torch.from_numpy(order[kept].astype(np.int32))
        keep_valid[i, :len(kept)] = True
    return keep_idx, keep_valid


def scan_cw_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int, sigma: float = 0.1,
                weighted_iou: bool = True):
    """Cluster-weighted NMS by sort, bitmask, scan and cluster sums (cluster_fuse_kernel)."""
    b = scores.shape[0]
    fused = torch.zeros((b, max_det, 4))
    fscore = torch.zeros((b, max_det))
    seed = torch.zeros((b, max_det), dtype=torch.int32)
    valid = torch.zeros((b, max_det), dtype=torch.bool)
    for i in range(b):
        order, cnt = _sort(scores[i].numpy())
        sb, ss = boxes[i][order], scores[i][order]
        kept, members = _scan(_mask(sb, iou_thres), cnt, max_det, True)
        iou = _iou_matrix(sb)
        for s, (k, words) in enumerate(zip(kept, members)):
            bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:cnt].astype(bool)
            bits[k] = True  # the seed
            ov = iou[k][torch.from_numpy(bits)]
            sj = ss[torch.from_numpy(bits)]
            w = sj * torch.exp(-((1.0 - ov) ** 2) / sigma) if weighted_iou else sj * ov
            fused[i, s] = (sb[torch.from_numpy(bits)] * w[:, None]).sum(0) / w.sum().clamp_min(1e-9)
            fscore[i, s], seed[i, s], valid[i, s] = ss[k], int(order[k]), True
    return fused, fscore, seed, valid


# -- inputs ----------------------------------------------------------------------------------------------

def _grid_boxes(rng, b, n):
    """Boxes with corners on a 2-px grid of a 40-px field: many exact IoUs
    (0.5, 0.25, 1/3, ...), so boxes sit on the threshold."""
    xy = rng.integers(0, 20, (b, n, 2)) * 2.0
    wh = rng.integers(1, 8, (b, n, 2)) * 2.0
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _tied_scores(rng, b, n, invalid_rows):
    """Scores from five values and 0: exact ties everywhere; some rows all invalid."""
    scores = rng.choice(np.array([0.0, 0.1, 0.25, 0.5, 0.75, 0.9], np.float32), (b, n))
    scores[list(invalid_rows)] = 0.0
    return scores


def _reorder(boxes, scores, how, rng):
    if how == "as_is":
        return boxes, scores
    perm = np.stack([rng.permutation(boxes.shape[1]) if how == "shuffled" else np.arange(boxes.shape[1])[::-1]
                     for _ in range(boxes.shape[0])])
    return (np.take_along_axis(boxes, perm[..., None], 1), np.take_along_axis(scores, perm, 1))


CASES = dict(
    seed=st.integers(0, 2 ** 31 - 1),
    n=st.sampled_from([1, 5, 63, 64, 65, 100, 130, 200]),
    b=st.integers(1, 3),
    iou_thres=st.sampled_from([0.5, 0.25, 0.45, 1.0 / 3.0]),
    max_det=st.sampled_from([1, 3, 10, 300]),
    order=st.sampled_from(["as_is", "reversed", "shuffled"]),
)


def _inputs(seed, n, b, order):
    rng = np.random.default_rng(seed)
    boxes = _grid_boxes(rng, b, n)
    scores = _tied_scores(rng, b, n, invalid_rows=[0] if b > 1 and seed % 3 == 0 else [])
    boxes, scores = _reorder(boxes, scores, order, rng)
    return torch.from_numpy(np.ascontiguousarray(boxes)), torch.from_numpy(np.ascontiguousarray(scores))


# -- the sort ----------------------------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 300))
def test_bitonic_sort_is_a_stable_descending_sort(seed, n):
    """The kernel's network on its keys gives the indices of score > 0 by
    (score descending, index ascending): np.argsort(-score, stable) on them."""
    rng = np.random.default_rng(seed)
    scores = rng.choice(np.array([0.0, -1.0, 0.3, 0.3, 1e-30, 0.7, np.inf], np.float32), n)
    order, cnt = _sort(scores)
    valid = np.flatnonzero(scores > 0)
    ref = valid[np.argsort(-scores[valid], kind="stable")]
    assert cnt == len(valid)
    np.testing.assert_array_equal(order, ref)


# -- greedy NMS ---------------------------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(**CASES)
@example(seed=3, n=200, b=2, iou_thres=0.45, max_det=300, order="shuffled")
@example(seed=4, n=130, b=3, iou_thres=0.5, max_det=10, order="reversed")
def test_scan_nms_equals_plain_greedy_loop(seed, n, b, iou_thres, max_det, order):
    """Exact ties, boxes on the threshold, all-invalid rows, N off a multiple of
    64, reversed and shuffled candidates, more survivors than max_det."""
    boxes, scores = _inputs(seed, n, b, order)
    ki, kv = scan_nms(boxes, scores, iou_thres, max_det)
    ki_p, kv_p = batched_greedy_nms_plain(boxes, scores, iou_thres, max_det)
    assert torch.equal(ki, ki_p) and torch.equal(kv, kv_p)


def test_scan_nms_cases_are_hit():
    """The inputs above do reach what they are for: boxes exactly on the
    threshold, tied picks, and more survivors than max_det."""
    boxes, scores = _inputs(3, 200, 3, "shuffled")
    iou = _iou_matrix(boxes[1])
    assert bool((iou == 0.5).any()) and bool((iou == 0.25).any())
    ki, kv = scan_nms(boxes, scores, 0.5, 10)
    assert not kv[0].any() and kv[1].all() and kv[2].all()  # row 0 all invalid; 10 of many survivors
    assert len(set(scores[1, ki[1].long()].tolist())) < 10  # tied scores among the picks


@pytest.mark.parametrize("order", ["as_is", "reversed", "shuffled"])
def test_scan_nms_equals_jax_kernel(order):
    """Against the JAX kernel in interpret mode, on grid boxes with tied scores."""
    boxes, scores = _inputs(11, 130, 3, order)
    scores[0] = 0.0
    ki, kv = scan_nms(boxes, scores, 0.5, 40)
    kj, vj = pallas_batched_greedy_nms(jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()), 0.5, 40,
                                       interpret=True)
    np.testing.assert_array_equal(ki.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(vj))
    assert kv[1:].any()


# -- cluster-weighted NMS -----------------------------------------------------------------------------------

def _assert_cw_equal(out, ref):
    fb, fs, seed, valid = out
    pb, ps, pseed, pvalid = (torch.as_tensor(np.array(t)) for t in ref)
    assert torch.equal(valid, pvalid) and torch.equal(seed, pseed.to(seed.dtype)) and torch.equal(fs, ps)
    assert bool(((fb - pb).abs() <= 1e-4 + 5e-7 * pb.abs()).all()), (fb - pb).abs().max().item()


@settings(max_examples=60, deadline=None)
@given(weighted=st.booleans(), **CASES)
@example(seed=3, n=200, b=2, iou_thres=0.45, max_det=300, order="shuffled", weighted=True)
@example(seed=2, n=130, b=3, iou_thres=0.5, max_det=300, order="reversed", weighted=False)
@example(seed=4, n=200, b=1, iou_thres=0.25, max_det=10, order="as_is", weighted=True)
def test_scan_cw_nms_equals_plain_loop(seed, n, b, iou_thres, max_det, order, weighted):
    """Seeds, scores and validity equal, fused boxes within 1e-4 + 5e-7*|ref|,
    over the same cases as the greedy scan."""
    boxes, scores = _inputs(seed, n, b, order)
    boxes = boxes + torch.from_numpy(np.random.default_rng(seed).integers(0, 3, (b, n, 1)).astype(np.float32)) * 7680.0
    _assert_cw_equal(scan_cw_nms(boxes, scores, iou_thres, max_det, 0.1, weighted),
                     batched_cw_nms_plain(boxes, scores, iou_thres, max_det, 0.1, weighted))


@pytest.mark.parametrize("weighted", [True, False], ids=["gaussian_iou", "plain_iou"])
@pytest.mark.parametrize("order", ["as_is", "shuffled"])
def test_scan_cw_nms_equals_jax_kernel(order, weighted):
    """Against the JAX CW-NMS kernel in interpret mode."""
    boxes, scores = _inputs(5, 100, 2, order)
    out = scan_cw_nms(boxes, scores, 0.45, 24, 0.1, weighted)
    ref = pallas_batched_cw_nms(jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()), 0.45, 24, sigma=0.1,
                                weighted_iou=weighted, interpret=True)
    _assert_cw_equal(out, ref)
    assert out[3].sum() > 5
