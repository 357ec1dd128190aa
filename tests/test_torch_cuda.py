"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false. The file imports neither jax nor the JAX package, so it also runs on
a machine without them; there, tests/conftest.py (which imports jax) is left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from yolo_master_tpu_torch.nn.layers import C3k2
from yolo_master_tpu_torch.nn.moe import ES_MOE, FusedESMOE
from yolo_master_tpu_torch.ops._bf16 import bf16_rounding_apart, round_bf16, split_product_check_bf16
from yolo_master_tpu_torch.ops._tf32 import split_product_check
from yolo_master_tpu_torch.ops.c3k2 import c3k2_bank, fused_c3k2, fused_c3k2_plain, prepare_c3k2_weights
from yolo_master_tpu_torch.ops.cuda_nms import (batched_cw_nms, batched_cw_nms_plain, batched_greedy_nms,
                                                batched_greedy_nms_plain, greedy_nms)
from yolo_master_tpu_torch.ops.esmoe import fused_esmoe, fused_esmoe_plain, pack_esmoe_params
from yolo_master_tpu_torch.ops.moe import dense_expert_matmul, gathered_expert_matmul
from yolo_master_tpu_torch.ops._build import SMEM_LIMIT_BYTES
from yolo_master_tpu_torch.ops.stem import fused_stem, fused_stem_plain, stem_bank, stem_plan, stem_weight_layout
from yolo_master_tpu_torch.utils.fuse import fuse_bn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card; decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (see README, PyTorch / H100 port)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("depth", [32, 8, 20])
def test_split_tf32_product_matches_fp64(dev, depth):
    """csrc/mma_tf32.cuh on its own: one warpgroup's [64, depth] x [depth, N] split
    product in both wgmma forms (operands from shared memory, N = 64; A from
    registers, N = 128) against the fp64 product of the same float32 inputs of
    mixed magnitude. Tolerance 2e-6 * sum_k |a||b|: fp32's rounding step 6e-8
    times the three products, the dropped lo*lo term and the sum over depth; a
    one-pass TF32 product is off by 1e-3 of that sum."""
    rng = np.random.default_rng(depth)
    a = (rng.standard_normal((64, 32)) * 10.0 ** rng.integers(-2, 3, (64, 32))).astype(np.float32)
    b = (rng.standard_normal((128, 32)) * 10.0 ** rng.integers(-2, 3, (128, 32))).astype(np.float32)
    d_ss, d_rs = split_product_check(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), depth)
    torch.cuda.synchronize()
    a64, b64 = a[:, :depth].astype(np.float64), b[:, :depth].astype(np.float64)
    ref, scale = a64 @ b64.T, np.abs(a64) @ np.abs(b64).T
    for got, cols in ((d_ss, 64), (d_rs, 128)):
        err = np.abs(got.cpu().numpy().astype(np.float64) - ref[:, :cols])
        assert (err <= 2e-6 * scale[:, :cols]).all(), (err / scale[:, :cols]).max()


@pytest.mark.parametrize("depth", [32, 16, 20])
def test_split_bf16_product_matches_fp64(dev, depth):
    """csrc/mma_bf16.cuh on its own: one warpgroup's [64, depth] x [depth, 128]
    product as the stem's bf16 forms compute it (bf16 hi/lo splits, three passes
    a depth-16 step, chains from zero joined in fp32) against the fp64 product
    of the same float32 inputs of mixed magnitude. Tolerance 6e-5 * sum_k |a||b|:
    three terms of about 2^-16 |a||b| each (lo*lo dropped, lo and hi rounded)
    and fp32's sums; one bf16 pass is off by about 4e-3 of that sum."""
    rng = np.random.default_rng(depth)

    def mixed(shape):  # float32 of magnitudes 1e-2 to 1e2
        return (rng.standard_normal(shape) * 10.0 ** rng.integers(-2, 3, shape)).astype(np.float32)

    a, b, c = mixed((64, 32)), mixed((128, 32)), mixed((64, 128))
    d_split, _ = split_product_check_bf16(*(torch.from_numpy(t).to(dev) for t in (a, b, c)), depth)
    torch.cuda.synchronize()
    a64, b64 = a[:, :depth].astype(np.float64), b[:, :depth].astype(np.float64)
    ref, scale = a64 @ b64.T, np.abs(a64) @ np.abs(b64).T
    err = np.abs(d_split.cpu().numpy().astype(np.float64) - ref)
    assert (err <= 6e-5 * scale).all(), (err / scale).max()


def test_bf16_accumulation_rounds_toward_zero(dev):
    """The tensor cores round an accumulation toward zero in bf16 wgmma, as in
    TF32 (PERF.md): c + bf16(a) @ bf16(b), accumulated onto c, in rows whose terms
    share one sign, is never above the exact sum in magnitude (rounding to
    nearest would put about half of the inexact outputs above it). Why the stem's
    bf16 forms start each tap's chain from zero and join the chains in fp32."""
    rng = np.random.default_rng(7)

    def mixed(shape):  # float32 of magnitudes 1e-2 to 1e2
        return (rng.standard_normal(shape) * 10.0 ** rng.integers(-2, 3, shape)).astype(np.float32)

    sign = np.where(np.arange(64) % 2 == 0, 1.0, -1.0).astype(np.float32)[:, None]
    a = np.abs(round_bf16(torch.from_numpy(mixed((64, 32)))).numpy()) * sign
    b = np.abs(round_bf16(torch.from_numpy(mixed((128, 32)))).numpy())
    c = np.abs(mixed((64, 128))) * sign
    _, d_acc = split_product_check_bf16(*(torch.from_numpy(t).to(dev) for t in (a, b, c)), 32)
    exact = c.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64).T
    got = d_acc.cpu().numpy().astype(np.float64)
    assert (np.abs(got) <= np.abs(exact)).all()
    assert (np.abs(got) < np.abs(exact)).sum() > got.size // 4  # most sums are inexact in fp32


def _stem_weights(rng, c0, c1, device):
    """w1 scaled by 0.8 / sqrt(c0) (0.2 at c0 = 16), so conv1's outputs keep one scale at every width."""
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return (stem_weight_layout(t(rng.standard_normal((c0, 3, 3, 3)) * 0.2)), t(rng.standard_normal(c0)),
            stem_weight_layout(t(rng.standard_normal((c1, c0, 3, 3)) * (0.8 / c0 ** 0.5))), t(rng.standard_normal(c1)))


@pytest.mark.parametrize("shape", [(2, 96, 128), (1, 36, 44), (3, 640, 640)])
def test_stem_kernel_matches_plain(dev, shape):
    """uint8 and float input, ragged tiles included. Tolerance 1e-4 + 1e-4*|ref|:
    fp32 sums in another order than cuDNN's."""
    rng = np.random.default_rng(4)
    w0, b0, w1, b1 = _stem_weights(rng, 16, 32, dev)
    img = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(dev)
    for x, w in ((img, stem_weight_layout(w0 / 255.0)), (img.float() / 255.0, w0)):
        out = fused_stem(x, w, b0, w1, b1)
        ref = fused_stem_plain(x, w, b0, w1, b1)
        torch.cuda.synchronize()
        assert out.shape == ref.shape
        assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())


@pytest.mark.parametrize("shape", [(2, 96, 128), (1, 36, 44), (2, 640, 640)])
@pytest.mark.parametrize("c0,c1", [(32, 64), (64, 128), (96, 192)], ids=["s", "m_l", "x"])
def test_stem_kernel_at_every_scale_width(dev, c0, c1, shape):
    """The stem widths of scales s, m/l and x (conv1's weights staged in
    output-channel slices past s), uint8 and float input, ragged tiles
    included. Tolerance 1e-4 + 1e-4*|ref|: fp32 sums in another order."""
    rng = np.random.default_rng(c0)
    w0, b0, w1, b1 = _stem_weights(rng, c0, c1, dev)
    img = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(dev)
    for x, w in ((img, stem_weight_layout(w0 / 255.0)), (img.float() / 255.0, w0)):
        out = fused_stem(x, w, b0, w1, b1)
        ref = fused_stem_plain(x, w, b0, w1, b1)
        torch.cuda.synchronize()
        assert out.shape == ref.shape == (shape[0], shape[1] // 4, shape[2] // 4, c1)
        assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()), (out - ref).abs().max().item()


def assert_bf16_rounding_apart(out: torch.Tensor, ref: torch.Tensor) -> None:
    """A kernel's bf16 output against its plain version's: both round an fp32 result
    once, and the two fp32 results agree within the fp32 forms' gate,
    1e-4 + 1e-4*|ref|. So each pair of outputs lies within 1 bf16 ulp of |ref| plus
    that gate (near 0 the gate is many bf16 ulps: 2 of 78.6M outputs at the x width
    differed by 1.2e-6 at |ref| ~4e-6, within the fp32 gate), and a rounding
    boundary between them is rare: at most 1% of the outputs differ (a wrong
    rounding mode would move about half; ops/_bf16.py:bf16_rounding_apart)."""
    assert out.dtype == ref.dtype == torch.bfloat16 and out.shape == ref.shape
    within, share = bf16_rounding_apart(out, ref)
    assert within, (out.float() - ref.float()).abs().max().item()
    assert share <= 1e-2, share


@pytest.mark.parametrize("shape", [(2, 96, 128), (1, 36, 44), (3, 68, 100), (1, 640, 640), (2, 640, 640)])
@pytest.mark.parametrize("c0,c1", [(8, 16), (16, 32), (32, 64), (64, 128), (96, 192)], ids=["c8", "n", "s", "m_l", "x"])
def test_stem_kernel_bf16_matches_plain(dev, c0, c1, shape):
    """The bf16 path's forms (stem_bf16_kernel: split-bf16 wgmma), uint8 -> bf16
    (the predict path) and bf16 -> bf16 (a bf16 image, /255 not folded), at the
    stem widths of every scale (and c0 = 8, half a conv0 chunk), ragged tiles
    (9x13 of 8x16, 17x25) and B=1 included. The plain version computes in fp32
    and rounds once to bf16 (assert_bf16_rounding_apart)."""
    rng = np.random.default_rng(c1)
    w0, b0, w1, b1 = _stem_weights(rng, c0, c1, dev)
    img = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(dev)
    for x, w in ((img, stem_weight_layout(w0 / 255.0)), ((img.float() / 255.0).bfloat16(), w0)):
        out = fused_stem(x, w, b0, w1, b1, out_dtype=torch.bfloat16)
        ref = fused_stem_plain(x, w, b0, w1, b1, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert out.shape == (shape[0], shape[1] // 4, shape[2] // 4, c1)
        assert_bf16_rounding_apart(out, ref)
    with pytest.raises(TypeError):  # float32 -> bf16 is no form of the kernel
        fused_stem(img.float() / 255.0, w0, b0, w1, b1, out_dtype=torch.bfloat16)


def test_stem_plan_keeps_scale_n_and_fits_every_width(dev):
    """Scale n's plan: an 8x16 tile, one warpgroup per 64 pixels with all 32 of
    c1, a three-stage weight ring; every YAML width fits one block, and n, s
    and m/l fit two per SM (each block also holds 1 KB of the SM's 228 KB)."""
    assert stem_plan(16, 32) == {"tile": (8, 16), "c1_per_warpgroup": 32, "warpgroups_per_64_pixels": 1,
                                 "stages": 3, "smem_bytes": 102908, "bank_floats": 10240}
    for c0, c1 in ((16, 32), (32, 64), (64, 128), (96, 192)):
        plan = stem_plan(c0, c1)
        assert plan["c1_per_warpgroup"] * plan["warpgroups_per_64_pixels"] >= c1
        assert 0 < plan["smem_bytes"] <= SMEM_LIMIT_BYTES
        if c1 <= 128:
            assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024


def test_stem_bf16_plan_takes_128_pixels_at_every_width(dev):
    """The bf16 forms' plan: an 8x16 tile (128 pixels) at every width; all of c1
    on each of two warpgroups and two blocks an SM up to c1 = 64, two halves of c1
    on four warpgroups and one block an SM from 128; every YAML width fits; the
    bf16 bank takes 4 bytes a weight (hi and lo; the fp32 bank takes 8)."""
    for c0, c1 in ((16, 32), (32, 64), (64, 128), (96, 192)):
        plan = stem_plan(c0, c1, torch.bfloat16)
        assert plan["tile"] == (8, 16)
        assert plan["warpgroups_per_64_pixels"] == (1 if c1 <= 64 else 2)
        assert plan["c1_per_warpgroup"] * plan["warpgroups_per_64_pixels"] >= c1
        assert 0 < plan["smem_bytes"] <= SMEM_LIMIT_BYTES
        if c1 <= 64:
            assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
        # hi and lo, 2 bytes each, for 12 tap slots (3 K-chunks of 4 taps) of each 16 conv0 channels
        assert plan["bank_bytes"] == 4 * 12 * -(-c0 // 16) * 16 * plan["c1_per_warpgroup"] * plan[
            "warpgroups_per_64_pixels"]


def test_stem_bank_keeps_fp32_and_bf16_banks_apart(dev):
    """One w1, both forms: each form writes its own bank once (fp32 split-TF32
    halves, bf16 halves), keeps it while the other form runs, and an in-place
    write to w1 rebuilds both; outputs follow w1 in both forms."""
    rng = np.random.default_rng(8)
    w0, b0, w1, b1 = _stem_weights(rng, 16, 32, dev)
    w0 = stem_weight_layout(w0 / 255.0)
    img = torch.from_numpy(rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)).to(dev)
    before = fused_stem.bank_launches
    bank32, bank16 = stem_bank(w1, 16, 32), stem_bank(w1, 16, 32, torch.bfloat16)
    assert bank32.dtype == torch.float32 and bank16.dtype == torch.bfloat16
    assert fused_stem.bank_launches == before + 2
    for _ in range(2):
        for out_dtype in (torch.float32, torch.bfloat16):
            fused_stem(img, w0, b0, w1, b1, out_dtype=out_dtype)
    assert stem_bank(w1, 16, 32) is bank32 and stem_bank(w1, 16, 32, torch.bfloat16) is bank16
    assert fused_stem.bank_launches == before + 2
    with torch.no_grad():
        w1.mul_(0.5)
    out32 = fused_stem(img, w0, b0, w1, b1)
    out16 = fused_stem(img, w0, b0, w1, b1, out_dtype=torch.bfloat16)
    assert fused_stem.bank_launches == before + 4
    ref32 = fused_stem_plain(img, w0, b0, w1, b1)
    torch.cuda.synchronize()
    assert bool(((out32 - ref32).abs() <= 1e-4 + 1e-4 * ref32.abs()).all())
    assert_bf16_rounding_apart(out16, fused_stem_plain(img, w0, b0, w1, b1, out_dtype=torch.bfloat16))


# sha256 (first 16 hex digits) of the fp32 forms' outputs, [B, H/4, W/4, c1] float32, for the inputs of
# test_stem_fp32_forms_are_unchanged, as the fp32 kernel gave them before the bf16 forms moved to
# their own kernel (the kernel is deterministic: no atomics, a fixed order of sums)
FP32_DIGESTS = {
    (32, 64, (2, 96, 128), "uint8"): "04c8847f32328e85",
    (32, 64, (2, 96, 128), "float32"): "78c48cbc7760fc17",
    (32, 64, (1, 36, 44), "uint8"): "0416cbfdd19da923",
    (32, 64, (1, 36, 44), "float32"): "4ec13539c50e89c2",
    (64, 128, (2, 96, 128), "uint8"): "9c1108d7ea561d18",
    (64, 128, (2, 96, 128), "float32"): "d7cd44639b8d489d",
    (64, 128, (1, 36, 44), "uint8"): "93b758f37f4262b2",
    (64, 128, (1, 36, 44), "float32"): "a96b01f89fc6ca11",
    (96, 192, (2, 96, 128), "uint8"): "f93de6d690666d30",
    (96, 192, (2, 96, 128), "float32"): "344739c6836a5bf8",
    (96, 192, (1, 36, 44), "uint8"): "42a21cc8d30427b4",
    (96, 192, (1, 36, 44), "float32"): "e57c58d42d6d6fc3",
}


@pytest.mark.parametrize("shape", [(2, 96, 128), (1, 36, 44)])
@pytest.mark.parametrize("c0,c1", [(32, 64), (64, 128), (96, 192)], ids=["s", "m_l", "x"])
def test_stem_fp32_forms_are_unchanged(dev, c0, c1, shape):
    """The fp32 forms (uint8 -> float32, float32 -> float32) give bit for bit
    what they gave before the bf16 forms were redesigned, at the widths of
    test_stem_kernel_at_every_scale_width, from fixed seeds."""
    import hashlib

    rng = np.random.default_rng(1000 + c0 + shape[1])
    w0, b0, w1, b1 = _stem_weights(rng, c0, c1, dev)
    img = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(dev)
    for form, x, w in (("uint8", img, stem_weight_layout(w0 / 255.0)), ("float32", img.float() / 255.0, w0)):
        out = fused_stem(x, w, b0, w1, b1)
        assert hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16] == FP32_DIGESTS[(c0, c1, shape, form)]


@pytest.mark.parametrize("shape", [(3, 36, 52), (3, 68, 100), (0, 36, 52)])
@pytest.mark.parametrize("c0,c1", [(8, 16), (16, 32), (32, 64), (64, 128), (96, 192)],
                         ids=["c8", "n", "s", "m_l", "x"])
def test_stem_kernel_ragged_tiles_and_batch_edges(dev, c0, c1, shape):
    """H/4 and W/4 off the tile (9x13, 17x25), B=3 and B=0, uint8 and float
    input, at every width (and c0 = 8, half a conv0 chunk). Tolerance
    1e-4 + 1e-4*|ref|, the kernel's gate at every width."""
    rng = np.random.default_rng(c0 + shape[1])
    w0, b0, w1, b1 = _stem_weights(rng, c0, c1, dev)
    img = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(dev)
    before = fused_stem.launches
    for x, w in ((img, stem_weight_layout(w0 / 255.0)), (img.float() / 255.0, w0)):
        out = fused_stem(x, w, b0, w1, b1)
        ref = fused_stem_plain(x, w, b0, w1, b1)
        torch.cuda.synchronize()
        assert out.shape == ref.shape == (shape[0], shape[1] // 4, shape[2] // 4, c1)
        assert bool(torch.isfinite(out).all())
        assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
    assert fused_stem.launches == before + (2 if shape[0] else 0)


def test_stem_kernel_counts_launches_and_rejects_bad_input(dev):
    w = _stem_weights(np.random.default_rng(5), 8, 16, dev)
    before, bank_before = fused_stem.launches, fused_stem.bank_launches
    fused_stem(torch.zeros(1, 32, 32, 3, dtype=torch.uint8, device=dev), *w)
    assert fused_stem.launches == before + 1 and fused_stem.bank_launches == bank_before + 1
    fused_stem(torch.zeros(2, 32, 32, 3, dtype=torch.uint8, device=dev), *w)  # w1's bank is kept
    assert fused_stem.launches == before + 2 and fused_stem.bank_launches == bank_before + 1
    with pytest.raises(ValueError):
        fused_stem(torch.zeros(1, 30, 32, 3, dtype=torch.uint8, device=dev), *w)
    with pytest.raises(TypeError):
        fused_stem(torch.zeros(1, 32, 32, 3, dtype=torch.float16, device=dev), *w)
    with pytest.raises(ValueError, match="layout"):  # OIHW-contiguous weights
        fused_stem(torch.zeros(1, 32, 32, 3, dtype=torch.uint8, device=dev), w[0].contiguous(), *w[1:])
    assert fused_stem.launches == before + 2 and fused_stem.bank_launches == bank_before + 1


def test_stem_bank_is_kept_until_w1_changes(dev):
    """The weight bank is written at w1's first call and kept after it; an
    in-place write to w1 (FusedStem: load_state_dict) and a move to another
    address (.to()) rebuild it, and the output follows the new weights; an
    inference tensor's bank is written at every call."""
    from yolo_master_tpu_torch.nn.layers import FusedStem

    rng = np.random.default_rng(6)
    w0, b0, w1, b1 = (t.cpu() for t in _stem_weights(rng, 16, 32, dev))
    stem = FusedStem(w0 / 255.0, b0, w1, b1).to(dev)
    x = torch.from_numpy(rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)).to(dev)

    def check(expect_bank_launches):
        before, bank_before = fused_stem.launches, fused_stem.bank_launches
        out = stem(x).permute(0, 2, 3, 1)
        ref = fused_stem_plain(x, *stem.weights())
        torch.cuda.synchronize()
        assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()), (out - ref).abs().max().item()
        assert fused_stem.launches == before + 1
        assert fused_stem.bank_launches == bank_before + expect_bank_launches

    check(1)
    check(0)
    state = {k: v.clone() for k, v in stem.state_dict().items()}
    state["w1"] = state["w1"].flip(0) * 0.5
    stem.load_state_dict(state)
    check(1)
    check(0)
    held = stem.w1.data  # keeps w1's old block, so that .to() moves it to another address
    stem.cpu().to(dev)
    assert stem.w1.data_ptr() != held.data_ptr()
    check(1)
    with torch.inference_mode():  # an inference tensor has no version counter: its bank is written every call
        w = [stem_weight_layout(t) if t.dim() == 4 else t.clone() for t in stem.weights()]
        for _ in range(2):
            bank_before = fused_stem.bank_launches
            out, ref = fused_stem(x, *w), fused_stem_plain(x, *w)
            assert fused_stem.bank_launches == bank_before + 1
            assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())


def _candidates(b, n, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(b, n, 2, generator=g) * 600
    wh = torch.rand(b, n, 2, generator=g) * 110 + 10
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand(b, n, generator=g)
    scores[:, 1::5] = scores[:, :1]  # exact ties
    if b > 2:
        scores[1] = 0.0  # all invalid
        scores[2, 4:] = 0.0  # exhausts early
    return boxes.to(device), scores.to(device)


@pytest.mark.parametrize("b,n", [(16, 1024), (16, 2048), (3, 5000)])
def test_nms_kernel_equals_plain(dev, b, n):
    """Exact keep sets and slot contents, ties, early exit and an all-invalid row included."""
    boxes, scores = _candidates(b, n, dev)
    ki, kv = batched_greedy_nms(boxes, scores, 0.45, 300)
    ki_p, kv_p = batched_greedy_nms_plain(boxes, scores, 0.45, 300)
    torch.cuda.synchronize()
    assert torch.equal(ki, ki_p) and torch.equal(kv, kv_p)
    assert not bool(kv[1].any()) and int(kv[2].sum()) <= 4
    k1, v1 = greedy_nms(boxes[0], scores[0], 0.45, 300)
    assert torch.equal(k1, ki_p[0]) and torch.equal(v1, kv_p[0])


def _shuffled(boxes, scores, seed=0):
    """The same candidates in a random order per image (the kernels sort them themselves)."""
    g = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(scores.shape[1], generator=g) for _ in range(scores.shape[0])]).to(scores.device)
    return boxes.gather(1, perm[..., None].expand(-1, -1, 4)).contiguous(), scores.gather(1, perm).contiguous()


@pytest.mark.parametrize("n", [1000, 2047, 2048, 4096])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_nms_kernel_equals_plain_shuffled(dev, b, n):
    """Candidates in no order, N off and on a multiple of 64, 80 class offsets:
    keep sets equal to the plain loop's."""
    boxes, scores = _candidates(b, n, dev, seed=n)
    cls = torch.randint(0, 80, (b, n, 1), generator=torch.Generator().manual_seed(b)).float().to(dev) * 7680.0
    boxes, scores = _shuffled((boxes + cls).contiguous(), scores, seed=b)
    ki, kv = batched_greedy_nms(boxes, scores, 0.45, 300)
    ki_p, kv_p = batched_greedy_nms_plain(boxes, scores, 0.45, 300)
    torch.cuda.synchronize()
    assert torch.equal(ki, ki_p) and torch.equal(kv, kv_p)


def test_nms_kernel_counts_launches_and_takes_up_to_its_candidate_limit(dev):
    """One count per call (three kernels inside); the sort's keys bound N at
    16384 (128 KB of shared memory), above which the wrapper refuses."""
    from yolo_master_tpu_torch.ops.cuda_nms import _cw_max_candidates, _max_candidates

    assert _max_candidates() == _cw_max_candidates() == 16384
    boxes, scores = _candidates(1, 16384, dev)
    before = batched_greedy_nms.launches
    ki, kv = batched_greedy_nms(boxes, scores, 0.45, 300)
    greedy_nms(boxes[0], scores[0], 0.45, 300)
    assert batched_greedy_nms.launches == before + 2
    ki_p, kv_p = batched_greedy_nms_plain(boxes, scores, 0.45, 300)
    torch.cuda.synchronize()
    assert torch.equal(ki, ki_p) and torch.equal(kv, kv_p)


def test_nms_kernel_rejects_too_many_candidates(dev):
    boxes, scores = _candidates(1, 20000, dev)
    with pytest.raises(ValueError, match="shared memory"):
        batched_greedy_nms(boxes, scores, 0.45, 300)


def _esmoe_block(cin, cout, device, seed=0):
    """An ES_MOE block with seeded BN statistics, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    block = ES_MOE(cin, cout)
    with torch.no_grad():
        for bn in (m for m in block.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.running_mean.copy_(torch.randn(bn.num_features, generator=g) * 0.2)
            bn.running_var.copy_(torch.rand(bn.num_features, generator=g) * 1.5 + 0.5)
        for conv in (m for m in block.modules() if isinstance(m, torch.nn.Conv2d)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) / conv.weight[0].numel() ** 0.5)
    return block.eval().to(device)


@pytest.mark.parametrize("b,hw,cin,cout", [(2, (24, 24), 64, 64), (1, (21, 37), 32, 48), (3, (20, 20), 256, 256),
                                           (1, (160, 160), 64, 64)])
def test_esmoe_kernel_matches_plain(dev, b, hw, cin, cout):
    """Ragged tiles, O not a multiple of the block's 64 channels, and C of one
    to eight chunks. Tolerance 1e-4 + 1e-4*|ref|: fp32 sums in another order."""
    block = _esmoe_block(cin, cout, dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, *hw, cin, generator=g).to(dev)
    banks = pack_esmoe_params(block)
    w = torch.softmax(torch.randn(b, 3, generator=g), -1).to(dev)
    out = fused_esmoe(x, w, *banks)
    ref = fused_esmoe_plain(x, w, *banks)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (b, *hw, cout)
    assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())


@pytest.mark.parametrize("b,hw,cin,cout,ks", [
    (1, (9, 17), 4, 4, (3,)), (2, (7, 5), 12, 68, (3, 5, 7)), (1, (23, 31), 36, 260, (15,)),
    (1, (17, 33), 132, 36, (3, 5, 7, 9, 11, 13, 15, 3)), (2, (8, 16), 64, 64, (5, 3)), (1, (1, 1), 8, 8, (7,)),
])
def test_esmoe_kernel_tile_tails(dev, b, hw, cin, cout, ks):
    """What a tensor-core tile can get wrong: C of 4, 12, 36, 132 (the last 32-deep
    chunk zero-filled, its depth-8 steps partly empty), O of 4, 36, 68, 260 (columns
    past O in the last 64-wide slice), H and W off the 8x16 tile and below one tile,
    one to eight experts up to 15x15 (the widest halo). The depthwise bank is
    random outside each expert's own taps too: neither version may read them.
    Tolerance 1e-4 + 1e-4*|ref|."""
    rng = np.random.default_rng(cin + cout)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    e, kmax = len(ks), max(ks)
    x = t(rng.standard_normal((b, *hw, cin)))
    w = torch.softmax(t(rng.standard_normal((b, e))), -1)
    banks = (t(rng.standard_normal((e, kmax, kmax, cin)) / kmax), t(rng.standard_normal((e, cin, cout)) / cin ** 0.5),
             t(rng.standard_normal((e, cout)) * 0.2), t(rng.uniform(0.5, 1.5, cout)), t(rng.standard_normal(cout) * 0.2),
             ks)
    out = fused_esmoe(x, w, *banks)
    ref = fused_esmoe_plain(x, w, *banks)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (b, *hw, cout)
    assert bool(torch.isfinite(out).all())
    assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()), (out - ref).abs().max().item()


@pytest.mark.parametrize("b,hw,c", [(2, (160, 160), 64), (2, (80, 80), 128), (2, (40, 40), 128), (2, (20, 20), 256),
                                    (1, (21, 37), 36)])
def test_esmoe_kernel_bf16_matches_plain(dev, b, hw, c):
    """bf16 x in and bf16 out, fp32 weights, at yolo-master-n's four placements
    (and a ragged tile with C off the 32-channel chunk). Both versions compute
    in fp32 and round once (assert_bf16_rounding_apart). The module's bf16 form
    (FusedESMOE in a bf16 copy) launches the same kernel."""
    from yolo_master_tpu_torch.utils.fuse import compute_dtype_copy

    block = _esmoe_block(c, c, dev, seed=c)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(b, *hw, c, generator=g).to(dev).bfloat16()
    w = torch.softmax(torch.randn(b, 3, generator=g), -1).to(dev)
    banks = pack_esmoe_params(block)
    out = fused_esmoe(x, w, *banks)
    ref = fused_esmoe_plain(x, w, *banks)
    torch.cuda.synchronize()
    assert out.shape == (b, *hw, c)
    assert_bf16_rounding_apart(out, ref)
    fused = compute_dtype_copy(FusedESMOE(block), torch.bfloat16)
    before = fused_esmoe.launches
    with torch.no_grad():
        y = fused(x.permute(0, 3, 1, 2))
    torch.cuda.synchronize()
    assert fused_esmoe.launches == before + 1 and y.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in fused.parameters())


def test_fused_esmoe_module_counts_launches_and_rejects_bad_input(dev):
    block = _esmoe_block(64, 64, dev)
    fused = FusedESMOE(block)
    x = torch.randn(2, 64, 16, 16, device=dev).contiguous(memory_format=torch.channels_last)
    before = fused_esmoe.launches
    with torch.no_grad():
        y, ref = fused(x), block(x)
    torch.cuda.synchronize()
    assert fused_esmoe.launches == before + 1
    assert bool(((y - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
    banks = pack_esmoe_params(block)
    w = torch.full((2, 3), 1 / 3, device=dev)
    xh = x.permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_esmoe(xh.permute(0, 2, 1, 3), w, *banks)
    with pytest.raises(TypeError):
        fused_esmoe(xh.half(), w, *banks)
    with pytest.raises(NotImplementedError):
        fused_esmoe(xh, w, *banks[:5], (3, 5, 8))
    assert fused_esmoe.launches == before + 1


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("b,n", [(1, 4096), (4, 2048)])
def test_cw_nms_kernel_equals_plain(dev, b, n, weighted):
    """Seeds, scores and validity equal, ties, early exit and an all-invalid row
    included; fused boxes within 1e-4 + 5e-7*|x| (sums in another order, at
    class-offset coordinates up to 6e5)."""
    boxes, scores = _candidates(b, n, dev)
    cls = torch.randint(0, 80, (b, n, 1), generator=torch.Generator().manual_seed(3)).float().to(dev) * 7680.0
    boxes = (boxes + cls).contiguous()
    fb, fs, seed, valid = batched_cw_nms(boxes, scores, 0.45, 300, 0.1, weighted)
    pb, ps, pseed, pvalid = batched_cw_nms_plain(boxes, scores, 0.45, 300, 0.1, weighted)
    torch.cuda.synchronize()
    assert torch.equal(valid, pvalid) and torch.equal(seed, pseed) and torch.equal(fs, ps)
    assert bool(((fb - pb).abs() <= 1e-4 + 5e-7 * pb.abs()).all())
    if b > 2:
        assert not bool(valid[1].any()) and int(valid[2].sum()) <= 4


@pytest.mark.parametrize("n", [1000, 2047, 2048, 4096])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_cw_nms_kernel_equals_plain_shuffled(dev, b, n):
    """Candidates in no order, N off and on a multiple of 64, 80 class offsets:
    seeds, scores and validity equal, fused boxes within 1e-4 + 5e-7*|x|."""
    boxes, scores = _candidates(b, n, dev, seed=n)
    cls = torch.randint(0, 80, (b, n, 1), generator=torch.Generator().manual_seed(b)).float().to(dev) * 7680.0
    boxes, scores = _shuffled((boxes + cls).contiguous(), scores, seed=b)
    fb, fs, seed, valid = batched_cw_nms(boxes, scores, 0.45, 300, 0.1, True)
    pb, ps, pseed, pvalid = batched_cw_nms_plain(boxes, scores, 0.45, 300, 0.1, True)
    torch.cuda.synchronize()
    assert torch.equal(valid, pvalid) and torch.equal(seed, pseed) and torch.equal(fs, ps)
    assert bool(((fb - pb).abs() <= 1e-4 + 5e-7 * pb.abs()).all())


def test_cw_nms_kernel_counts_launches_and_rejects_too_many_candidates(dev):
    boxes, scores = _candidates(1, 512, dev)
    before = batched_cw_nms.launches
    batched_cw_nms(boxes, scores, 0.45, 100)
    assert batched_cw_nms.launches == before + 1
    boxes, scores = _candidates(1, 20000, dev)
    with pytest.raises(ValueError, match="shared memory"):
        batched_cw_nms(boxes, scores, 0.45, 300)


def _matmul_inputs(b, n, c, o, e, k, device, seed=0):
    """Row 0 repeats one expert; the last row has a zero weight."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(device)
    w = torch.from_numpy((rng.standard_normal((e, c, o)) / c ** 0.5).astype(np.float32)).to(device)
    idx = rng.integers(0, e, (b, k)).astype(np.int32)
    idx[0, :] = idx[0, 0]
    wts = rng.uniform(0.2, 0.8, (b, k)).astype(np.float32)
    wts[-1, -1] = 0.0
    return x, w, torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device)


@pytest.mark.parametrize("b,n,c,o,e,k", [(2, 128, 32, 64, 8, 2), (3, 100, 36, 20, 4, 3), (16, 6400, 128, 256, 4, 2),
                                         (2, 400, 256, 512, 16, 2), (1, 1, 4, 4, 2, 1)])
def test_gathered_matmul_kernel_matches_plain(dev, b, n, c, o, e, k):
    """Ragged N and O tiles, C not a multiple of the 8-channel chunk, repeated
    experts and zero weights. Tolerance 1e-4 + 1e-4*|ref|: fp32 sums in
    another order, and the weight applied before the sum over C."""
    x, w, idx, wts = _matmul_inputs(b, n, c, o, e, k, dev)
    out = gathered_expert_matmul(x, w, idx, wts)
    ref = dense_expert_matmul(x, w, idx, wts)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (b, n, o)
    assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())


@pytest.mark.parametrize("b,n,c,o,e,k", [
    (1, 1, 4, 4, 8, 1), (1, 63, 12, 68, 8, 3), (2, 129, 36, 260, 8, 1), (1, 6401, 132, 4, 8, 3),
    (3, 257, 128, 132, 8, 2), (2, 64, 260, 128, 3, 3), (1, 400, 256, 512, 16, 2), (5, 1000, 32, 256, 8, 2),
])
def test_gathered_matmul_tile_tails(dev, b, n, c, o, e, k):
    """What a tensor-core tile can get wrong: C of 4, 12, 36, 132, 260 (the last
    32-deep chunk zero-filled), O of 4, 68, 132, 260 (columns past O in the last
    128-wide tile), N of 1, 63, 129, 257, 6401 (rows past N; more tiles than
    resident blocks), B = 1, K = 1 and 3, E = 8, with a repeated expert, a zero
    weight and an index outside [0, E). Tolerance 1e-4 + 1e-4*|ref|."""
    x, w, idx, wts = _matmul_inputs(b, n, c, o, e, k, dev, seed=n)
    if k > 1:
        idx[-1, 0] = e  # outside [0, E): adds nothing
    out = gathered_expert_matmul(x, w, idx, wts)
    ref = dense_expert_matmul(x, w, idx, wts)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (b, n, o)
    assert bool(torch.isfinite(out).all())
    assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()), (out - ref).abs().max().item()


def test_gathered_matmul_counts_launches_skips_bad_indices_and_rejects_bad_input(dev):
    x, w, idx, wts = _matmul_inputs(2, 64, 32, 64, 4, 2, dev)
    before = gathered_expert_matmul.launches
    idx[1, 1] = 4  # outside [0, E): adds nothing
    out = gathered_expert_matmul(x, w, idx, wts)
    ref = dense_expert_matmul(x, w, idx, wts)
    torch.cuda.synchronize()
    assert gathered_expert_matmul.launches == before + 1
    assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
    with pytest.raises(TypeError):
        gathered_expert_matmul(x.half(), w, idx, wts)
    with pytest.raises(TypeError):
        gathered_expert_matmul(x, w, idx.long(), wts)
    with pytest.raises(NotImplementedError):
        gathered_expert_matmul(x[..., :30].contiguous(), w[:, :30].contiguous(), idx, wts)
    with pytest.raises(ValueError, match="contiguous"):
        gathered_expert_matmul(torch.cat([x, x], -1)[..., :32], w, idx, wts)
    assert gathered_expert_matmul.launches == before + 1


def _c3k2_block(c1, c2, n, device, seed=0):
    """A C3k2 (Bottleneck inner blocks) with seeded weights and BN statistics, BN folded."""
    g = torch.Generator().manual_seed(seed)
    block = C3k2(c1, c2, n=n, c3k=False, e=0.25)
    with torch.no_grad():
        for bn in (m for m in block.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.running_mean.copy_(torch.randn(bn.num_features, generator=g) * 0.2)
            bn.running_var.copy_(torch.rand(bn.num_features, generator=g) * 1.5 + 0.5)
        for conv in (m for m in block.modules() if isinstance(m, torch.nn.Conv2d)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) / conv.weight[0].numel() ** 0.5)
    block.eval()
    fuse_bn(block)
    return block.to(device, memory_format=torch.channels_last)


@pytest.mark.parametrize("b,hw,c1,c2,n", [(2, (16, 20), 32, 64, 1), (1, (37, 45), 32, 64, 2), (2, (160, 160), 32, 64, 1),
                                          (2, (80, 80), 64, 128, 1), (1, (5, 3), 32, 64, 2), (2, (27, 35), 64, 128, 2),
                                          (1, (29, 38), 32, 64, 3), (2, (24, 40), 32, 64, 4), (1, (21, 18), 40, 192, 1)])
def test_c3k2_kernel_matches_plain_and_module(dev, b, hw, c1, c2, n):
    """Ragged tiles, images smaller than a tile, n = 1 to 4 (halos of 2 to 8
    pixels; n = 2 at layer 5's widths, 64 -> 128, which are also scale s's
    layer 2; n = 4 at layer 2's, most of a block's shared memory), and 40 -> 192
    (c = 48, cb = 24: maps with an odd number of 8-channel groups, stages of
    3 and 6 weight slabs). Tolerance 1e-4 + 1e-4*|ref| against the plain
    version and the module (cuDNN, TF32 off): fp32 sums in another order, the
    kernel's products split-TF32."""
    block = _c3k2_block(c1, c2, n, dev)
    w = prepare_c3k2_weights(block)
    x = torch.randn(b, *hw, c1, generator=torch.Generator().manual_seed(1)).to(dev)
    out = fused_c3k2(x, w, block.c, n)
    ref = fused_c3k2_plain(x, w, block.c, n)
    with torch.no_grad():
        mod = block(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (b, *hw, c2)
    for r in (ref, mod):
        assert bool(((out - r).abs() <= 1e-4 + 1e-4 * r.abs()).all())


def test_c3k2_kernel_counts_launches_and_rejects_bad_input(dev):
    block = _c3k2_block(32, 64, 1, dev)
    w = prepare_c3k2_weights(block)
    x = torch.randn(1, 16, 16, 32, device=dev)
    before = fused_c3k2.launches
    fused_c3k2(x, w, block.c, 1)
    assert fused_c3k2.launches == before + 1
    with pytest.raises(TypeError):
        fused_c3k2(x.half(), w, block.c, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_c3k2(x.transpose(1, 2), w, block.c, 1)
    with pytest.raises(NotImplementedError):
        fused_c3k2(x, w, block.c, 5)
    assert fused_c3k2.launches == before + 1


def test_c3k2_kernel_refuses_widths_it_does_not_take(dev):
    """Widths that are not multiples of 8 (C3k2(32, 48): c = 12, cb = 6) and
    blocks whose maps do not fit one block's shared memory (scale s's layer 5,
    128 -> 256) raise NotImplementedError and launch nothing."""
    before = fused_c3k2.launches
    for c1, c2, match in ((32, 48, "multiples of 8"), (128, 256, "shared memory")):
        block = _c3k2_block(c1, c2, 1, dev)
        with pytest.raises(NotImplementedError, match=match):
            fused_c3k2(torch.zeros(1, 16, 16, c1, device=dev), prepare_c3k2_weights(block), block.c, 1)
    assert fused_c3k2.launches == before


def test_c3k2_bank_is_kept_until_the_weights_change(dev):
    """The weight bank is built at a weight set's first call and kept after it;
    an in-place write to a weight matrix and a new tensor in the dict rebuild it,
    and the output follows the new weights; inference tensors' bank is built at
    every call."""
    block = _c3k2_block(32, 64, 1, dev, seed=4)
    w = prepare_c3k2_weights(block)
    x = torch.randn(2, 24, 40, 32, generator=torch.Generator().manual_seed(5)).to(dev)

    def check(expect_builds):
        before, builds_before = fused_c3k2.launches, fused_c3k2.bank_builds
        out, ref = fused_c3k2(x, w, block.c, 1), fused_c3k2_plain(x, w, block.c, 1)
        torch.cuda.synchronize()
        assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()), (out - ref).abs().max().item()
        assert fused_c3k2.launches == before + 1
        assert fused_c3k2.bank_builds == builds_before + expect_builds

    check(1)
    check(0)
    w["m0_w1"].mul_(-0.5)
    check(1)
    check(0)
    w["cv2_y"] = w["cv2_y"].flip(1).contiguous()
    check(1)
    assert c3k2_bank(w, block.c, 1) is c3k2_bank(w, block.c, 1)
    with torch.inference_mode():
        wi = {k: v.clone() for k, v in w.items()}
        for _ in range(2):
            builds_before = fused_c3k2.bank_builds
            out, ref = fused_c3k2(x, wi, block.c, 1), fused_c3k2_plain(x, wi, block.c, 1)
            assert fused_c3k2.bank_builds == builds_before + 1
            assert bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())


def _val_decoded(b, a, nc, seed=0):
    """Decoded predictions [b, a, 4 + nc] as the validator's NMS sees them: xywh
    px and probabilities, every third anchor scoring five classes at 1.0, saturated (one box
    under several classes), most other scores spread below and about conf 0.001."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(b, a, 2, generator=g) * 600
    wh = torch.rand(b, a, 2, generator=g) * 110 + 10
    probs = torch.rand(b, a, nc, generator=g)
    probs = torch.where(probs < 0.6, probs * 0.003, probs)
    probs[:, ::3, :5] = 1.0  # saturated: tied across classes and anchors
    return torch.cat([xy, wh, probs], -1)


def test_nms_kernel_equals_plain_on_multilabel_val_candidates(dev):
    """The validator's regime: multi-label candidates (conf 0.001, iou 0.7,
    max_nms 4096) at B=16, N=4096, with the same box under several classes kept
    apart only by the class offset: the kernel's keep sets equal the plain
    loop's, and non_max_suppression on the card gives the CPU's detections."""
    from yolo_master_tpu_torch.ops.nms import MAX_WH, _prep_candidates, non_max_suppression

    decoded = _val_decoded(16, 2100, 80)
    kw = dict(nc=80, conf_thres=0.001, iou_thres=0.7, max_det=300, max_nms=4096, multi_label=True)
    cboxes, scores, cls_idx, _ = _prep_candidates(decoded.to(dev), 80, 0.001, 4096, True, None, False)
    assert scores.shape == (16, 4096) and bool((scores > 0).all())
    assert bool((cboxes[:, :1] == cboxes[:, 1:5]).all())  # the five tied classes of one anchor come first
    cand = (cboxes + cls_idx[..., None] * MAX_WH).contiguous()
    ki, kv = batched_greedy_nms(cand, scores.contiguous(), 0.7, 300)
    ki_p, kv_p = batched_greedy_nms_plain(cand, scores, 0.7, 300)
    torch.cuda.synchronize()
    assert torch.equal(ki, ki_p) and torch.equal(kv, kv_p) and bool(kv.all())
    on_card = non_max_suppression(decoded.to(dev), **kw)
    on_cpu = non_max_suppression(decoded, **kw)
    for k in ("valid", "classes", "scores", "boxes"):
        assert torch.equal(on_card[k].cpu(), on_cpu[k]), k


def _val_set(root, n, imgsz, seed=0):
    """``n`` PNGs with their long side at ``imgsz`` (no resize), portrait and
    landscape; returns the yaml (80 classes)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        s = int(rng.integers(imgsz // 2, imgsz + 1))
        h, w = (s, imgsz) if i % 2 else (imgsz, s)
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(im).save(root / "images" / f"{i:04d}.png")
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\nval: images\nnames:\n" + "".join(f"  {i}: c{i}\n" for i in range(80)))
    return yaml_path


def test_val_on_the_card_matches_the_cpu(dev, tmp_path):
    """YOLO(...).fuse().val() at 64 px on 20 images (batches of 8, the last
    wrapped) on the card and on the CPU, same weights (BN calibrated on the set,
    class biases at 0), labels drawn from the CPU's own detections (each
    image's 4 best): the stem and NMS kernels launched once a batch, detection
    counts per image equal, each metric within 1e-3 (the port-vs-JAX gate of
    tests/test_torch_validator.py), in fp32; bf16 runs and gives finite metrics."""
    import json

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.data.dataset import DataLoader, YOLODataset, img2label_path
    from yolo_master_tpu_torch.engine.validator import DetectionValidator
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    imgsz, n, bs = 64, 20, 8
    yaml_path = _val_set(tmp_path, n, imgsz)
    ds = YOLODataset(str(yaml_path), imgsz=imgsz)
    cpu = YOLO("yolo-master-n", device="cpu", seed=1)
    calibrate_bn(cpu.model, torch.from_numpy(next(DataLoader(ds, bs).epoch())["images"]).float() / 255.0)
    with torch.no_grad():
        for branch in cpu.model.head.cv3:
            branch[-1].bias.zero_()
    card = YOLO("yolo-master-n", device=dev).load_state_dict(cpu.model.state_dict()).fuse()
    cpu.fuse()
    v = DetectionValidator(cpu.model, imgsz=imgsz)
    seen = 0
    for b in DataLoader(ds, bs).epoch():
        det = {k: t.numpy() for k, t in v.run(v.preprocess(b["images"])).items()}
        for i in range(min(bs, n - seen)):
            h0, w0 = ds.shapes[seen]
            boxes = v._to_original(det["boxes"][i, :4], *v._letterbox_params(h0, w0), w0, h0, clip=True)
            rows = [f"{int(c)} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} {(x2 - x1) / w0:.6f} "
                    f"{(y2 - y1) / h0:.6f}" for (x1, y1, x2, y2), c in zip(boxes, det["classes"][i, :4])]
            with open(img2label_path(ds.img_files[seen]), "w") as f:
                f.write("\n".join(rows) + "\n")
            seen += 1

    def counts(path):
        rows = json.loads(path.read_text())
        return [sum(r["image_id"] == i for r in rows) for i in range(n)]

    kw = dict(data=str(yaml_path), imgsz=imgsz, batch=bs)
    m_cpu = cpu.val(save_json=str(tmp_path / "cpu.json"), **kw)
    fused_stem.launches = batched_greedy_nms.launches = 0
    m_card = card.val(save_json=str(tmp_path / "card.json"), **kw)
    torch.cuda.synchronize()
    assert fused_stem.launches == batched_greedy_nms.launches == 3
    assert m_card["images"] == m_cpu["images"] == n
    assert counts(tmp_path / "card.json") == counts(tmp_path / "cpu.json")
    assert m_cpu["mAP50-95"] > 0.1
    for k in ("precision", "recall", "mAP50", "mAP50-95"):
        assert abs(m_card[k] - m_cpu[k]) <= 1e-3, (k, m_card[k], m_cpu[k])
    m16 = card.val(compute_dtype=torch.bfloat16, **kw)
    assert m16["images"] == n and all(np.isfinite(m16[k]) for k in ("precision", "recall", "mAP50", "mAP50-95"))
    assert fused_stem.launches == batched_greedy_nms.launches == 6


def test_train_step_on_the_card_matches_the_cpu(dev):
    """engine/train_step.py: one SGD step of yolo-master-n at 64 px, B=2, from
    step 50 of the warmup (every group's lr non-zero), on the card and on the
    CPU from the same weights (BN calibrated) and batch: the loss components
    within 1e-4 relative, the parameters, BN statistics and EMA after the step
    within 1e-4 of each tensor's scale plus 1e-2 of its move in the step (the
    card's backward sums in another order), ema_updates and the optimizer's
    count advanced; then a fused copy of the card's EMA weights launches the
    stem kernel in predict."""
    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine import train_step as ts
    from yolo_master_tpu_torch.nn.tasks import DetectionModel
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(5)
    xy, wh = rng.uniform(0, 24, (2, 6, 2)), rng.uniform(16, 40, (2, 6, 2))
    batch = {"images": torch.from_numpy(rng.random((2, 64, 64, 3), np.float32)),
             "boxes": torch.from_numpy(np.concatenate([xy, np.minimum(xy + wh, 63)], -1).astype(np.float32)),
             "classes": torch.from_numpy(rng.integers(0, 80, (2, 6))), "mask": torch.from_numpy(rng.random((2, 6)) < 0.8)}
    base = DetectionModel("yolo-master-n")
    calibrate_bn(base, batch["images"])
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD")
    out = {}
    for where in (dev, torch.device("cpu")):
        model = DetectionModel("yolo-master-n")
        model.load_state_dict(base.state_dict())
        model.to(where)
        tx = pol.build_optimizer(model)
        state = ts.make_train_state(model, tx)
        state.step = state.opt_state.count = 50
        state.ema_updates = 50.0
        step = ts.make_train_step(model, tx)
        state, met = step(state, {k: v.to(where) for k, v in batch.items()})
        assert state.opt_state.count == 51 and state.ema_updates == 51.0 and float(met["finite"]) == 1.0
        out[where.type] = (model, state, {k: float(met[k]) for k in ("loss", "box_loss", "cls_loss", "dfl_loss")})
    (mg, sg, lg), (mc, sc, lc) = out["cuda"], out["cpu"]
    for k, v in lc.items():
        assert abs(lg[k] - v) <= 1e-4 * abs(v), (k, lg[k], v)
    sd_g, sd_c, start = mg.state_dict(), mc.state_dict(), base.state_dict()
    for name, ref in sc.ema_params.items():
        move = (sd_c[name] - start[name]).abs().max()
        for a, b in ((sd_g[name], sd_c[name]), (sg.ema_params[name], ref)):
            assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max() + 1e-2 * move + 1e-7, name
    ema = YOLO("yolo-master-n", device=dev).load_state_dict(
        {k: sg.ema_params.get(k, v) for k, v in mg.state_dict().items()}).fuse()
    fused_stem.launches = 0
    ema.predict((rng.random((64, 64, 3)) * 255).astype(np.uint8), imgsz=64, conf=0.0)
    assert fused_stem.launches == 1


def test_trainer_one_epoch_on_the_card_matches_the_cpu(dev, tmp_path):
    """engine/trainer.py: one epoch of yolo-master-n at 64 px (8 train and 4 val
    PNGs, batch 4, no accumulation, the synchronous loader) on the card and on
    the CPU from the same weights (BN calibrated, class biases at 0): the first
    optimizer step's loss components within 1e-4 relative (the card-vs-CPU
    limit of test_train_step_on_the_card_matches_the_cpu), finite val metrics,
    and the NMS kernel launched once by the EMA val's one batch."""
    import cv2

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.data.dataset import DataLoader, YOLODataset
    from yolo_master_tpu_torch.engine.trainer import DetectionTrainer
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(11)
    for split, n in (("train", 8), ("val", 4)):
        (tmp_path / "images" / split).mkdir(parents=True)
        (tmp_path / "labels" / split).mkdir(parents=True)
        for i in range(n):
            im = rng.integers(0, 256, (64, 48 + (8 * i) % 24, 3), dtype=np.uint8)
            cv2.imwrite(str(tmp_path / "images" / split / f"{i}.png"), im)
            (tmp_path / "labels" / split / f"{i}.txt").write_text(f"{i % 80} 0.5 0.5 0.4 0.5\n")
    yaml_path = tmp_path / "data.yaml"
    yaml_path.write_text(f"path: {tmp_path}\ntrain: images/train\nval: images/val\nnames:\n"
                         + "".join(f"  {i}: c{i}\n" for i in range(80)))
    base = YOLO("yolo-master-n", device="cpu")
    ds = YOLODataset(str(yaml_path), split="train", imgsz=64)
    calibrate_bn(base.model, torch.from_numpy(next(DataLoader(ds, 8, images=np.float32).epoch())["images"]))
    with torch.no_grad():
        for branch in base.model.head.cv3:
            branch[-1].bias.zero_()
    weights = {k: v.clone() for k, v in base.model.state_dict().items()}
    out = {}
    for where in (dev, torch.device("cpu")):
        y = YOLO("yolo-master-n", device=where).load_state_dict(weights)
        trainer = DetectionTrainer(y, data=str(yaml_path), epochs=1, batch=4, nbs=4, imgsz=64, amp=False, workers=0,
                                   save_dir=str(tmp_path / f"run_{where.type}"))
        first = []
        step = trainer.step_fn

        def recorded(state, batch, gain, step=step, first=first):
            state, m = step(state, batch, gain)
            if not first:
                first.append({k: float(m[k]) for k in ("loss", "box_loss", "cls_loss", "dfl_loss")})
            return state, m

        trainer.step_fn = recorded
        batched_greedy_nms.launches = 0
        metrics = trainer.train()
        out[where.type] = (first[0], metrics, batched_greedy_nms.launches)
    (lg, mg, ng), (lc, _, _) = out["cuda"], out["cpu"]
    for k, v in lc.items():
        assert abs(lg[k] - v) <= 1e-4 * abs(v), (k, lg[k], v)
    assert ng == 1 and all(np.isfinite(mg[k]) for k in ("precision", "recall", "mAP50", "mAP50-95"))


def test_bf16_train_step_on_the_card_matches_the_cpu(dev):
    """engine/train_step.py in bf16 (the trainer's default): one step of
    yolo-master-n at 640, B=2, on the card in bf16 and on the CPU in fp32 and
    bf16, from the same weights (BN calibrated) and batch, on two batches: the
    gradient trees the step hands its optimizer, rel-RMS(card bf16 - CPU fp32)
    within 1.5x rel-RMS(CPU bf16 - CPU fp32), the squared distances summed over
    the batches (chip_smoke.py's phase 19 (a); a bf16 gradient deep in the
    backbone is mostly rounding noise, so the two bf16 programs are held by
    their distance from fp32, not element by element)."""
    import copy

    from yolo_master_tpu_torch.engine import train_step as ts
    from yolo_master_tpu_torch.nn.tasks import DetectionModel
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    def batch_of(seed):
        rng = np.random.default_rng(seed)
        xy, wh = rng.uniform(0, 400, (2, 8, 2)), rng.uniform(24, 320, (2, 8, 2))
        return {"images": torch.from_numpy(rng.random((2, 640, 640, 3), np.float32)),
                "boxes": torch.from_numpy(np.concatenate([xy, np.minimum(xy + wh, 639)], -1).astype(np.float32)),
                "classes": torch.from_numpy(rng.integers(0, 80, (2, 8))),
                "mask": torch.from_numpy(np.arange(8)[None] < rng.integers(1, 9, (2, 1)))}

    def grads(model, batch, dtype):
        tx = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD").build_optimizer(model)
        out, apply = {}, tx.apply

        def capture(m, opt_state):
            out.update({n: p.grad.detach().float().cpu().clone() for n, p in m.named_parameters()})
            apply(m, opt_state)

        tx.apply = capture
        st, met = ts.make_train_step(model, tx, compute_dtype=dtype)(ts.make_train_state(model, tx), batch)
        assert float(met["finite"]) == 1.0
        return torch.cat([out[n].flatten() for n in sorted(out)]).double()

    batches = [batch_of(seed) for seed in (3, 4)]
    base = DetectionModel("yolo-master-n")
    calibrate_bn(base, batches[0]["images"])
    sums = np.zeros(3)
    for batch in batches:
        g = {}
        for key, where, dtype in (("card16", dev, torch.bfloat16), ("cpu32", "cpu", torch.float32),
                                  ("cpu16", "cpu", torch.bfloat16)):
            model = copy.deepcopy(base).to(where)
            g[key] = grads(model, {k: v.to(where) for k, v in batch.items()}, dtype)
        ref = g["cpu32"]
        sums += [float(((g["card16"] - ref) ** 2).sum()), float(((g["cpu16"] - ref) ** 2).sum()),
                 float((ref ** 2).sum())]
    card, own = np.sqrt(sums[0] / sums[2]), np.sqrt(sums[1] / sums[2])
    assert 0 < own < 2 and card <= 1.5 * own, (card, own)


def test_v0_1_train_step_on_the_card_matches_the_cpu(dev):
    """engine/train_step.py on yolo-master-v0_1-n (router noise, progressive
    sparsity, expert dropout and aux loss; warmup_steps 2 and dropout_interval
    2 on the routed blocks): one SGD step at 640, B=2, from step 50 (k = 2, a
    dropout step) on the card and on the CPU from the same weights (BN
    calibrated) and batch: chip_smoke.py's phase 22 (a) gate (the loss
    components within 1e-4 relative, the parameters, BN statistics and EMA
    after the step within 1e-4 of each tensor's scale plus 1e-2 of its move),
    and each block's router noise and keep mask on the card equal to the CPU's
    bit for bit."""
    from yolo_master_tpu_torch.engine import train_step as ts
    from yolo_master_tpu_torch.nn.moe import OptimizedMOEImproved
    from yolo_master_tpu_torch.nn.tasks import DetectionModel
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(6)
    xy, wh = rng.uniform(0, 400, (2, 8, 2)), rng.uniform(24, 320, (2, 8, 2))
    batch = {"images": torch.from_numpy(rng.random((2, 640, 640, 3), np.float32)),
             "boxes": torch.from_numpy(np.concatenate([xy, np.minimum(xy + wh, 639)], -1).astype(np.float32)),
             "classes": torch.from_numpy(rng.integers(0, 80, (2, 8))),
             "mask": torch.from_numpy(np.arange(8)[None] < rng.integers(1, 9, (2, 1)))}
    base = DetectionModel("yolo-master-v0_1-n")
    calibrate_bn(base, batch["images"])
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD")
    out = {}
    for where in (dev, torch.device("cpu")):
        model = DetectionModel("yolo-master-v0_1-n")
        model.load_state_dict(base.state_dict())
        model.to(where)
        blocks = [m for m in model.modules() if isinstance(m, OptimizedMOEImproved)]
        for m in blocks:
            m.warmup_steps, m.dropout_interval = 2, 2
        tx = pol.build_optimizer(model)
        state = ts.make_train_state(model, tx)
        state.step = state.opt_state.count = 50
        state.ema_updates = 50.0
        state, met = ts.make_train_step(model, tx)(state, {k: v.to(where) for k, v in batch.items()})
        assert float(met["finite"]) == 1.0 and all(m.dropped_experts().size > 0 for m in blocks)
        out[where.type] = (model, state, {k: float(met[k]) for k in ("loss", "box_loss", "cls_loss", "dfl_loss",
                                                                      "aux_loss")}, blocks)
    (mg, sg, lg, bg), (mc, sc, lc, bc) = out["cuda"], out["cpu"]
    for k, v in lc.items():
        assert abs(lg[k] - v) <= 1e-4 * abs(v), (k, lg[k], v)
    for a, b in zip(bg, bc):
        assert a.jax_path == b.jax_path and torch.equal(a._draws[1].cpu(), b._draws[1]), a.jax_path
    sd_g, sd_c, start = mg.state_dict(), mc.state_dict(), base.state_dict()
    for name, ref in sc.ema_params.items():
        move = (sd_c[name] - start[name]).abs().max()
        for a, b in ((sd_g[name], sd_c[name]), (sg.ema_params[name], ref)):
            assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max() + 1e-2 * move + 1e-7, name


def test_v0_10_train_step_on_the_card_matches_the_cpu(dev, monkeypatch):
    """engine/train_step.py on yolo-master-v0_10-n (the gated blocks' temperature
    anneal, complexity gate and aux loss): one SGD step at 640, B=2, from step
    50 on the card and on the CPU from the same weights (BN calibrated) and
    batch, the card's routing pinned to the CPU step's picks and kept counts
    (a pick may flip between the two fp32 programs): chip_smoke.py's phase 17
    (a) gate (the loss components within 1e-4 relative, the parameters, BN
    statistics and EMA after the step within 1e-4 of each tensor's scale plus
    1e-2 of its move); then yolo-master-v0_13-n's and v0_15-n's router noise,
    soft expert dropout and drop-path draws on the card equal to the CPU's bit
    for bit."""
    from yolo_master_tpu_torch.engine import train_step as ts
    from yolo_master_tpu_torch.nn.moe import AdaptiveGateMoE, gated
    from yolo_master_tpu_torch.nn.tasks import DetectionModel
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(6)
    xy, wh = rng.uniform(0, 400, (2, 8, 2)), rng.uniform(24, 320, (2, 8, 2))
    batch = {"images": torch.from_numpy(rng.random((2, 640, 640, 3), np.float32)),
             "boxes": torch.from_numpy(np.concatenate([xy, np.minimum(xy + wh, 639)], -1).astype(np.float32)),
             "classes": torch.from_numpy(rng.integers(0, 80, (2, 8))),
             "mask": torch.from_numpy(np.arange(8)[None] < rng.integers(1, 9, (2, 1)))}
    base = DetectionModel("yolo-master-v0_10-n")
    calibrate_bn(base, batch["images"])
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD")
    out, seen = {}, []
    for where in (torch.device("cpu"), dev):
        model = DetectionModel("yolo-master-v0_10-n")
        model.load_state_dict(base.state_dict())
        model.to(where)
        tx = pol.build_optimizer(model)
        state = ts.make_train_state(model, tx)
        state.step = state.opt_state.count = 50
        state.ema_updates = 50.0
        with monkeypatch.context() as mp:
            for k, v in _gated_routing(**({"seen": seen} if where.type == "cpu" else {"picks": seen})).items():
                mp.setattr(gated, k, v)
            state, met = ts.make_train_step(model, tx)(state, {k: v.to(where) for k, v in batch.items()})
        assert float(met["finite"]) == 1.0
        out[where.type] = (model, state, {k: float(met[k]) for k in ("loss", "box_loss", "cls_loss", "dfl_loss",
                                                                      "aux_loss")})
    (mg, sg, lg), (mc, sc, lc) = out["cuda"], out["cpu"]
    for k, v in lc.items():
        assert abs(lg[k] - v) <= 1e-4 * abs(v), (k, lg[k], v)
    sd_g, sd_c, start = mg.state_dict(), mc.state_dict(), base.state_dict()
    for name, ref in sc.ema_params.items():
        move = (sd_c[name] - start[name]).abs().max()
        for a, b in ((sd_g[name], sd_c[name]), (sg.ema_params[name], ref)):
            assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max() + 1e-2 * move + 1e-7, name
    for name, owner, attr in (("yolo-master-v0_13-n", "routing", "expert_dropout"),
                              ("yolo-master-v0_15-n", "cross_gate", "drop_prob")):
        draws = {}
        for where in (torch.device("cpu"), dev):
            blocks = [m for m in DetectionModel(name).modules() if isinstance(m, AdaptiveGateMoE)]
            for m in blocks:
                setattr(getattr(m, owner), attr, 0.5)
                m.step = 3
            draws[where.type] = [torch.cat(m.draws(2, where), 1) for m in blocks]
        assert all(torch.equal(a.cpu(), b) for a, b in zip(draws["cuda"], draws["cpu"])), name


def _gated_routing(picks=None, seen=None):
    """Patches for nn/moe/gated.py: record each gated block's (top-k indices,
    kept count) in forward order into ``seen``, or route by ``picks`` (a list
    of those) over the block's own probabilities."""
    from yolo_master_tpu_torch.nn.moe import gated

    plain_topk, plain_keep, it, state = gated.topk_renorm, gated.keep_count, iter(picks or []), {}

    def topk(probs, k):
        w, idx = plain_topk(probs, k)
        if picks is not None:
            state["pick"] = next(it)
            idx = state["pick"][0].to(probs.device)
            w = probs.gather(1, idx)
            w = w / (w.sum(-1, keepdim=True) + 1e-6)
        elif seen is not None:
            seen.append([idx.cpu()])
        return w, idx

    def keep(complexity, k):
        own = plain_keep(complexity, k)
        if picks is not None:
            return torch.tensor(state["pick"][1], device=complexity.device)
        if seen is not None:
            seen[-1].append(float(own))
        return own

    return {"topk_renorm": topk, "keep_count": keep}


def test_v0_10_predict_on_the_card_matches_the_cpu(dev, monkeypatch):
    """YOLO("yolo-master-v0_10-n").fuse() on the card and on the CPU from the
    same weights (BN calibrated on four frames), 640 px: predict() launches the
    stem and NMS kernels once a batch in fp32 and bf16 and gives max_det
    detections; on two frames the card's fp32 decode lies within chip_smoke.py's
    limits of the CPU's (5e-2 px, 1e-3 logit), and its bf16 raw head outputs,
    routed by the CPU bf16's picks and kept counts, within 1.5x the CPU bf16's
    rel-RMS from the CPU fp32."""
    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.nn.moe import gated
    from yolo_master_tpu_torch.utils.fuse import current_dtype_copy
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(10)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
    cpu = YOLO("yolo-master-v0_10-n", device="cpu")
    calibrate_bn(cpu.model, DetectionPredictor(cpu.model, imgsz=640).preprocess(frames)[0])
    card = YOLO("yolo-master-v0_10-n", device=dev).load_state_dict(cpu.model.state_dict()).fuse()
    cpu.fuse()
    kw = dict(imgsz=640, conf=0.0, iou=0.45, max_det=300)
    for dtype in (torch.float32, torch.bfloat16):
        fused_stem.launches = batched_greedy_nms.launches = 0
        res = card.predict(frames[:1], batch=1, compute_dtype=dtype, **kw) + card.predict(frames, batch=4,
                                                                                          compute_dtype=dtype, **kw)
        torch.cuda.synchronize()
        assert fused_stem.launches == batched_greedy_nms.launches == 2, dtype
        assert all(len(r.boxes) == 300 and np.isfinite(r.boxes.data).all() for r in res)
    x, _ = DetectionPredictor(cpu.model, imgsz=640).preprocess(frames[:2])
    with torch.inference_mode():
        g, c = card.model(x.to(dev)), cpu.model(x)
        dg, dc = card.model.head.decode(g, raw_scores=True).cpu(), cpu.model.head.decode(c, raw_scores=True)
    assert (dg[..., :4] - dc[..., :4]).abs().max() <= 5e-2 and (dg[..., 4:] - dc[..., 4:]).abs().max() <= 1e-3
    seen = []
    with monkeypatch.context() as mp, torch.inference_mode():
        for k, v in _gated_routing(seen=seen).items():
            mp.setattr(gated, k, v)
        c16 = current_dtype_copy(cpu.model, torch.bfloat16)(x)
    assert len(seen) == 3
    with monkeypatch.context() as mp, torch.inference_mode():
        for k, v in _gated_routing(picks=seen).items():
            mp.setattr(gated, k, v)
        g16 = current_dtype_copy(card.model, torch.bfloat16)(x.to(dev))

    def rel_rms(a, ref):
        return ((a.float() - ref).square().mean() / ref.square().mean()).sqrt().item()

    for key in ("boxes", "scores"):
        ref = c[key].float()
        assert rel_rms(g16[key].cpu(), ref) <= 1.5 * rel_rms(c16[key], ref), key


def _moe_routing(picks=None, seen=None):
    """A process_logits for nn/moe/mixtures.py that records each
    OptimizedMOEImproved block's [B, E] top-k mask in forward order into
    ``seen``, or routes by ``picks`` (a list of those) over the block's own
    probabilities, renormalised."""
    from yolo_master_tpu_torch.nn.moe import mixtures

    plain, it = mixtures.process_logits, iter(picks or [])

    def routing(logits, top_k, noise=None):
        w, probs, logits = plain(logits, top_k, noise)
        if picks is not None:
            w = probs * next(it).to(probs.device)
            w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
        elif seen is not None:
            seen.append((w > 0).cpu())
        return w, probs, logits

    return routing


def test_yolo26_predict_on_the_card_matches_the_cpu(dev, monkeypatch):
    """YOLO("yolo26-master-n").fuse() on the card and on the CPU from the same
    weights (BN calibrated on four frames), 640 px: predict() launches the
    stem kernel once a batch in fp32 and bf16 and no NMS, and gives max_det
    fixed-shape detections; on two frames the card's fp32 decode, routed by the
    CPU's picks, lies within chip_smoke.py's limits of the CPU's (5e-2 px,
    1e-3 logit), and its bf16 one2one head outputs, routed by the CPU bf16's
    picks, within 1.5x the CPU bf16's rel-RMS from the CPU fp32."""
    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.nn.moe import mixtures
    from yolo_master_tpu_torch.utils.fuse import current_dtype_copy
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
    cpu = YOLO("yolo26-master-n", device="cpu")
    calibrate_bn(cpu.model, DetectionPredictor(cpu.model, imgsz=640).preprocess(frames)[0])
    card = YOLO("yolo26-master-n", device=dev).load_state_dict(cpu.model.state_dict()).fuse()
    cpu.fuse()
    kw = dict(imgsz=640, conf=0.0, max_det=300)
    for dtype in (torch.float32, torch.bfloat16):
        fused_stem.launches = batched_greedy_nms.launches = 0
        res = card.predict(frames[:1], batch=1, compute_dtype=dtype, **kw) + card.predict(frames, batch=4,
                                                                                          compute_dtype=dtype, **kw)
        torch.cuda.synchronize()
        assert fused_stem.launches == 2 and batched_greedy_nms.launches == 0, dtype
        assert all(len(r.boxes) == 300 and np.isfinite(r.boxes.data).all() for r in res)
    x, _ = DetectionPredictor(cpu.model, imgsz=640).preprocess(frames[:2])
    seen = []
    with monkeypatch.context() as mp, torch.inference_mode():
        mp.setattr(mixtures, "process_logits", _moe_routing(seen=seen))
        c = cpu.model(x)
        dc = cpu.model.head.decode(c, raw_scores=True)
    with monkeypatch.context() as mp, torch.inference_mode():
        mp.setattr(mixtures, "process_logits", _moe_routing(picks=seen))
        dg = card.model.head.decode(card.model(x.to(dev)), raw_scores=True).cpu()
    assert len(seen) == 6
    assert (dg[..., :4] - dc[..., :4]).abs().max() <= 5e-2 and (dg[..., 4:] - dc[..., 4:]).abs().max() <= 1e-3
    seen16 = []
    with monkeypatch.context() as mp, torch.inference_mode():
        mp.setattr(mixtures, "process_logits", _moe_routing(seen=seen16))
        c16 = current_dtype_copy(cpu.model, torch.bfloat16)(x)
    with monkeypatch.context() as mp, torch.inference_mode():
        mp.setattr(mixtures, "process_logits", _moe_routing(picks=seen16))
        g16 = current_dtype_copy(card.model, torch.bfloat16)(x.to(dev))

    def rel_rms(a, ref):
        return ((a.float() - ref).square().mean() / ref.square().mean()).sqrt().item()

    for key in ("boxes", "scores"):
        ref = c[key].float()
        assert rel_rms(g16[key].cpu(), ref) <= 1.5 * rel_rms(c16[key], ref), key


def _mot_routing(seen=None, picks=None):
    """MoTRouter.forward that records each router's [B, E, H, W] kept-expert mask
    into ``seen`` in forward order, or keeps ``picks``' over its own
    probabilities (in training lifted to the router's exploration floor)."""
    from yolo_master_tpu_torch.nn import mot

    plain = mot.MoTRouter.forward
    it = iter(picks or [])

    def forward(self, x):
        w, probs, logits = plain(self, x)
        if picks is not None:
            w = probs * next(it).to(probs.device)
            w = w / w.sum(1, keepdim=True).clamp_min(1e-9)
            if self.training and self.eps > 0:
                w = (1 - self.eps) * w + self.eps / self.num_experts
        else:  # the kept set (in training the floor lifts every weight above 0)
            seen.append((probs >= probs.topk(self.top_k, 1).values[:, -1:]).cpu())
        return w, probs, logits

    return forward


@pytest.mark.parametrize("name", ["yolo26-master-latent-n", "yolo26-master-moa-mot-n"])
def test_yolo26_variant_predict_on_the_card_matches_the_cpu(dev, monkeypatch, name):
    """yolo26-master-latent-n and -moa-mot-n (their zero-initialised mixture
    parts set non-zero, utils/weights.py:wake_mixtures; BN calibrated on four
    frames), fused, on the card and on the CPU, 640 px: predict() launches the
    stem kernel once a batch in fp32 and bf16 and no NMS, with max_det
    fixed-shape detections; on two frames the card's fp32 decode, routed by
    the CPU's picks (A2C2fMoE's top-2 sets, MoT's kept experts), lies within
    chip_smoke.py's limits of the CPU's (5e-2 px, 1e-3 logit), and its bf16
    one2one head outputs, routed by the CPU bf16's, within 1.5x the CPU bf16's
    rel-RMS from the CPU fp32."""
    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.nn import mot
    from yolo_master_tpu_torch.nn.moe import mixtures
    from yolo_master_tpu_torch.utils.fuse import current_dtype_copy
    from yolo_master_tpu_torch.utils.weights import calibrate_bn, wake_mixtures

    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
    cpu = YOLO(name, device="cpu")
    wake_mixtures(cpu.model)
    calibrate_bn(cpu.model, DetectionPredictor(cpu.model, imgsz=640).preprocess(frames)[0])
    card = YOLO(name, device=dev).load_state_dict(cpu.model.state_dict()).fuse()
    cpu.fuse()
    kw = dict(imgsz=640, conf=0.0, max_det=300)
    for dtype in (torch.float32, torch.bfloat16):
        fused_stem.launches = batched_greedy_nms.launches = 0
        res = card.predict(frames[:1], batch=1, compute_dtype=dtype, **kw) + card.predict(frames, batch=4,
                                                                                          compute_dtype=dtype, **kw)
        torch.cuda.synchronize()
        assert fused_stem.launches == 2 and batched_greedy_nms.launches == 0, dtype
        assert all(len(r.boxes) == 300 and np.isfinite(r.boxes.data).all() for r in res)
    x, _ = DetectionPredictor(cpu.model, imgsz=640).preprocess(frames[:2])

    def routed(model, x, seen=None, picks=None):
        with monkeypatch.context() as mp, torch.inference_mode():
            mp.setattr(mixtures, "process_logits", _moe_routing(seen=seen and seen[0], picks=picks and picks[0]))
            mp.setattr(mot.MoTRouter, "forward", _mot_routing(seen=seen and seen[1], picks=picks and picks[1]))
            return model(x)

    seen = ([], [])
    c = routed(cpu.model, x, seen=seen)
    dc = cpu.model.head.decode(c, raw_scores=True)
    with torch.inference_mode():
        dg = card.model.head.decode(routed(card.model, x.to(dev), picks=seen), raw_scores=True).cpu()
    assert (len(seen[0]), len(seen[1])) == ((6, 0) if "latent" in name else (0, 3))
    assert (dg[..., :4] - dc[..., :4]).abs().max() <= 5e-2 and (dg[..., 4:] - dc[..., 4:]).abs().max() <= 1e-3
    seen16 = ([], [])
    c16 = routed(current_dtype_copy(cpu.model, torch.bfloat16), x, seen=seen16)
    g16 = routed(current_dtype_copy(card.model, torch.bfloat16), x.to(dev), picks=seen16)

    def rel_rms(a, ref):
        return ((a.float() - ref).square().mean() / ref.square().mean()).sqrt().item()

    for key in ("boxes", "scores"):
        ref = c[key].float()
        assert rel_rms(g16[key].cpu(), ref) <= 1.5 * rel_rms(c16[key], ref), key


def test_yolo26_train_step_on_the_card_matches_the_cpu(dev, monkeypatch):
    """engine/train_step.py on yolo26-master-n (the end2end dual-assignment
    loss at reg_max 1; the six routed blocks with router noise, k annealed to
    2 and expert dropout: warmup_steps 2 and dropout_interval 2): one SGD step
    at 640, B=2, from step 50 (a dropout step) on the card and on the CPU from
    the same weights (BN calibrated) and batch, the card's routing pinned to
    the CPU step's picks (a pick may flip between the two fp32 programs):
    chip_smoke.py's phase 17 (a) gate (the loss components within 1e-4
    relative, the parameters, BN statistics and EMA after the step within 1e-4
    of each tensor's scale plus 1e-2 of its move); each block's router noise
    and keep mask on the card equal the CPU's bit for bit."""
    from yolo_master_tpu_torch.engine import train_step as ts
    from yolo_master_tpu_torch.nn.moe import OptimizedMOEImproved, mixtures
    from yolo_master_tpu_torch.nn.tasks import DetectionModel
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(7)
    xy, wh = rng.uniform(0, 400, (2, 8, 2)), rng.uniform(24, 320, (2, 8, 2))
    batch = {"images": torch.from_numpy(rng.random((2, 640, 640, 3), np.float32)),
             "boxes": torch.from_numpy(np.concatenate([xy, np.minimum(xy + wh, 639)], -1).astype(np.float32)),
             "classes": torch.from_numpy(rng.integers(0, 80, (2, 8))),
             "mask": torch.from_numpy(np.arange(8)[None] < rng.integers(1, 9, (2, 1)))}
    base = DetectionModel("yolo26-master-n")
    calibrate_bn(base, batch["images"])
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD")
    out, seen = {}, []
    for where in (torch.device("cpu"), dev):
        model = DetectionModel("yolo26-master-n")
        model.load_state_dict(base.state_dict())
        model.to(where)
        for m in model.modules():
            if isinstance(m, OptimizedMOEImproved):
                m.warmup_steps, m.dropout_interval = 2, 2
        tx = pol.build_optimizer(model)
        state = ts.make_train_state(model, tx)
        state.step = state.opt_state.count = 50
        state.ema_updates = 50.0
        with monkeypatch.context() as mp:
            mp.setattr(mixtures, "process_logits",
                       _moe_routing(**({"seen": seen} if where.type == "cpu" else {"picks": seen})))
            state, met = ts.make_train_step(model, tx)(state, {k: v.to(where) for k, v in batch.items()})
        assert float(met["finite"]) == 1.0
        out[where.type] = (model, state, {k: float(met[k]) for k in ("loss", "box_loss", "cls_loss", "dfl_loss",
                                                                      "aux_loss")})
    (mg, sg, lg), (mc, sc, lc) = out["cuda"], out["cpu"]
    assert len(seen) == 6
    for k, v in lc.items():
        assert abs(lg[k] - v) <= 1e-4 * abs(v), (k, lg[k], v)
    sd_g, sd_c, start = mg.state_dict(), mc.state_dict(), base.state_dict()
    for name, ref in sc.ema_params.items():
        move = (sd_c[name] - start[name]).abs().max()
        for a, b in ((sd_g[name], sd_c[name]), (sg.ema_params[name], ref)):
            assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max() + 1e-2 * move + 1e-7, name
    blocks = [[m for m in model.modules() if isinstance(m, OptimizedMOEImproved)] for model in (mg, mc)]
    for a, b in zip(*blocks):
        assert a.dropped_experts().size > 0 and torch.equal(a._draws[1].cpu(), b._draws[1]), a.jax_path


@pytest.mark.parametrize("name", ["yolo26-master-latent-n", "yolo26-master-moa-mot-n"])
def test_yolo26_variant_train_step_on_the_card_matches_the_cpu(dev, monkeypatch, name):
    """engine/train_step.py on yolo26-master-latent-n and -moa-mot-n (the moa,
    mot and latent aux losses, MoT's exploration floor, the latent routers'
    noise at noise_std 0.5, MoA's linear global head at P3's 6,400 tokens),
    their mixtures woken and BN calibrated: one SGD step at 640, B=2, from
    step 50 on the card and on the CPU from the same weights and batch, the
    card's routed-block picks and MoT kept sets pinned to the CPU step's:
    phase 17 (a)'s gate, each family's composed aux within 1e-5 relative, the
    latent noise bit for bit, every ``_rf_matrix`` unchanged."""
    from yolo_master_tpu_torch.engine import train_step as ts
    from yolo_master_tpu_torch.nn import mot
    from yolo_master_tpu_torch.nn.latent_mixture import LatentRouter
    from yolo_master_tpu_torch.nn.moe import OptimizedMOEImproved, mixtures
    from yolo_master_tpu_torch.nn.tasks import DetectionModel
    from yolo_master_tpu_torch.utils.weights import calibrate_bn, wake_mixtures

    rng = np.random.default_rng(7)
    xy, wh = rng.uniform(0, 400, (2, 8, 2)), rng.uniform(24, 320, (2, 8, 2))
    batch = {"images": torch.from_numpy(rng.random((2, 640, 640, 3), np.float32)),
             "boxes": torch.from_numpy(np.concatenate([xy, np.minimum(xy + wh, 639)], -1).astype(np.float32)),
             "classes": torch.from_numpy(rng.integers(0, 80, (2, 8))),
             "mask": torch.from_numpy(np.arange(8)[None] < rng.integers(1, 9, (2, 1)))}
    base = DetectionModel(name)
    wake_mixtures(base)
    calibrate_bn(base, batch["images"])
    families = ("aux_moe", "aux_latent") if "latent" in name else ("aux_moa", "aux_mot")
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD")
    out, seen, kept = {}, [], []
    for where in (torch.device("cpu"), dev):
        model = DetectionModel(name)
        model.load_state_dict(base.state_dict())
        model.to(where)
        for m in model.modules():
            if isinstance(m, OptimizedMOEImproved):
                m.warmup_steps, m.dropout_interval = 2, 2
            if isinstance(m, LatentRouter):
                m.noise_std = 0.5
        tx = pol.build_optimizer(model)
        state = ts.make_train_state(model, tx)
        state.step = state.opt_state.count = 50
        state.ema_updates = 50.0
        cpu = where.type == "cpu"
        with monkeypatch.context() as mp:
            mp.setattr(mixtures, "process_logits", _moe_routing(**({"seen": seen} if cpu else {"picks": seen})))
            mp.setattr(mot.MoTRouter, "forward", _mot_routing(**({"seen": kept} if cpu else {"picks": kept})))
            state, met = ts.make_train_step(model, tx)(state, {k: v.to(where) for k, v in batch.items()})
        assert float(met["finite"]) == 1.0
        out[where.type] = (model, state, {k: float(met[k]) for k in ("loss", "box_loss", "cls_loss", "dfl_loss",
                                                                      "aux_loss", *families)})
    (mg, sg, lg), (mc, sc, lc) = out["cuda"], out["cpu"]
    assert (len(seen), len(kept)) == ((6, 0) if "latent" in name else (0, 3))
    for k, v in lc.items():
        tol = 1e-5 if k in families else 1e-4
        assert k not in families or v > 0, k
        assert abs(lg[k] - v) <= tol * abs(v), (k, lg[k], v)
    sd_g, sd_c, start = mg.state_dict(), mc.state_dict(), base.state_dict()
    for key, ref in sc.ema_params.items():
        move = (sd_c[key] - start[key]).abs().max()
        for a, b in ((sd_g[key], sd_c[key]), (sg.ema_params[key], ref)):
            assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max() + 1e-2 * move + 1e-7, key
    routers = [[m for m in model.modules() if isinstance(m, LatentRouter)] for model in (mg, mc)]
    assert len(routers[0]) == (3 if "latent" in name else 0)
    for a, b in zip(*routers):
        assert torch.equal(a._draws[1].cpu(), b._draws[1]), a.jax_path
    rf = [k for k in start if k.endswith("_rf_matrix")]
    assert len(rf) == (0 if "latent" in name else 1)
    assert all(torch.equal(sd_g[k].cpu(), start[k]) and torch.equal(sd_c[k], start[k]) for k in rf)


TASKS = [("yolo-master-seg-n", 640), ("yolo-master-pose-n", 640), ("yolo-master-obb-n", 640), ("yolo-master-cls-n", 224)]


@pytest.mark.parametrize("name,imgsz", TASKS, ids=["segment", "pose", "obb", "classify"])
def test_task_predict_on_the_card_matches_the_cpu(dev, name, imgsz):
    """A task model (Segment, Pose, OBB at 640; Classify at 224, where the stem
    kernel writes 56x56) fused on the card and on the CPU from the same weights
    (BN calibrated on four frames, class biases at 0): predict() launches the
    stem kernel once a batch and the NMS kernel once a batch for seg and pose
    only; on two frames the card's decode lies within chip_smoke.py's limits of
    the CPU's (5e-2 px on boxes and keypoints, 1e-3 on logits, angles and
    visibilities; cls: log-probabilities within 1e-3)."""
    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictors_task import TASK_PREDICTORS
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
    cpu = YOLO(name, device="cpu")
    calibrate_bn(cpu.model, TASK_PREDICTORS[cpu.task](cpu.model, imgsz=imgsz).preprocess(frames)[0])
    if cpu.task != "classify":
        with torch.no_grad():
            for branch in cpu.model.head.cv3:
                branch[-1].bias.zero_()
    card = YOLO(name, device=dev).load_state_dict(cpu.model.state_dict()).fuse()
    cpu.fuse()
    fused_stem.launches = batched_greedy_nms.launches = 0
    res = card.predict(frames[:1], imgsz=imgsz, batch=1) + card.predict(frames, imgsz=imgsz, batch=4)
    torch.cuda.synchronize()
    nms = 2 if cpu.task in ("segment", "pose") else 0
    assert fused_stem.launches == 2 and batched_greedy_nms.launches == nms
    assert len(res) == 5
    x, _ = card._predictor.preprocess(frames[:2])
    with torch.inference_mode():
        g, c = card.model(x), cpu.model(x.cpu())
    if cpu.task == "classify":
        lg, lc = g.log().cpu(), c.log()
        assert ((lg - lg.mean(-1, keepdim=True)) - (lc - lc.mean(-1, keepdim=True))).abs().max() <= 1e-3
        return
    with torch.inference_mode():
        dg, dc = card.model.head.decode(g, raw_scores=True).cpu(), cpu.model.head.decode(c, raw_scores=True)
    nc, e = cpu.model.nc, (dg - dc).abs()
    assert e[..., :4].max() <= 5e-2 and e[..., 4:4 + nc].max() <= 1e-3
    if cpu.task == "pose":
        k = e[..., 4 + nc:].reshape(*e.shape[:2], 17, 3)
        assert k[..., :2].max() <= 5e-2 and k[..., 2].max() <= 1e-3
    elif cpu.task == "obb":
        assert e[..., -1].max() <= 1e-3
    else:
        assert all(r.masks is not None and r.masks.data.shape[1:] == (480, 640) for r in res if len(r))


@pytest.mark.parametrize("extra", [32, 51])
def test_nms_kernel_with_extra_columns_equals_plain(dev, extra, monkeypatch):
    """non_max_suppression over [16, 8400, 4 + nc + extra] predictions (the
    Segment head's 32 mask coefficients, the Pose head's 51 keypoint values):
    the kernel's detections and gathered extra columns equal the plain loop's."""
    from yolo_master_tpu_torch.ops import nms as tnms

    g = torch.Generator().manual_seed(extra)
    b, a, nc = 16, 8400, 80 if extra == 32 else 1
    xy = torch.rand(b, a, 2, generator=g) * 640
    wh = torch.rand(b, a, 2, generator=g) * 120 + 4
    scores = (torch.rand(b, a, nc, generator=g) * 64).round() / 64  # exact ties
    pred = torch.cat([xy, wh, scores, torch.randn(b, a, extra, generator=g)], -1).to(dev)
    for kw in (dict(conf_thres=0.25, iou_thres=0.45, max_nms=2048), dict(conf_thres=0.001, iou_thres=0.7,
                                                                          max_nms=4096, multi_label=True)):
        got = tnms.non_max_suppression(pred, nc=nc, max_det=300, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(tnms, "batched_greedy_nms", batched_greedy_nms_plain)
            plain = tnms.non_max_suppression(pred, nc=nc, max_det=300, **kw)
        assert got["extra"].shape == (b, 300, extra) and int(got["valid"].sum()) > 0
        for k in got:
            assert torch.equal(got[k], plain[k]), (kw, k)
