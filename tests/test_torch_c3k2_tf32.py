"""The C3k2 kernel's arithmetic (yolo_master_tpu_torch/csrc/c3k2.cu), mirrored on
the CPU in plain PyTorch, against an fp64 C3k2 block.

The kernel computes each conv stage (cv1's y_b and y_a, each bottleneck's two
3x3 convs, cv2 over the concat) as an implicit GEMM on the tensor cores: A is
the stage's input map gathered tap by tap (K tap-major, zero outside the
image), B the stage's slabs of the weight bank that ``ops/c3k2.py`` builds.
Each 16-deep chain's three-pass split product starts from zero and joins the
stage's sum by an fp32 add. The mirror reads B from that same bank, in the
kernel's K order, so it also holds the bank's layout; it must stay within the
kernel's gate, 1e-4 + 1e-4*|ref| of the fp64 block, while one TF32 pass must
not.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolo_master_tpu_torch.nn.layers import C3k2
from yolo_master_tpu_torch.ops._tf32 import round_tf32, split_tf32
from yolo_master_tpu_torch.ops.c3k2 import (BANK_K_ORDER, TILE_K, c3k2_bank, c3k2_stage_bank, c3k2_stage_weights,
                                            fused_c3k2, prepare_c3k2_weights, slab_width)
from yolo_master_tpu_torch.utils.fuse import fuse_bn

CHAIN = 16  # K rows per chain of the kernel: two depth-8 wgmma steps
# (C1, C2, n): yolo-master-n's layers 2 and 5, and layer 2's width with two bottlenecks
WIDTHS = [(32, 64, 1), (64, 128, 1), (32, 64, 2)]
IDS = ["layer2", "layer5", "layer2_n2"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _block(c1, c2, n, seed):
    """C3k2(c1, c2, n, c3k=False, e=0.25) with numpy-seeded weights and BN statistics, BN folded."""
    rng = np.random.default_rng(seed)
    block = C3k2(c1, c2, n=n, c3k=False, e=0.25)
    with torch.no_grad():
        for bn in (m for m in block.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, bn.num_features).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, bn.num_features).astype(np.float32)))
        for conv in (m for m in block.modules() if isinstance(m, torch.nn.Conv2d)):
            w = rng.standard_normal(conv.weight.shape) / conv.weight[0].numel() ** 0.5
            conv.weight.copy_(torch.from_numpy(w.astype(np.float32)))
    block.eval()
    fuse_bn(block)
    return block


def _k_rows(kp):
    """Logical K row of each bank column: BANK_K_ORDER within each 8."""
    return (torch.arange(0, kp, 8)[:, None] + torch.tensor(BANK_K_ORDER)).reshape(-1)


def _bank_matrices(bank):
    """A stage bank [slabs, k tiles, 2, slab width, 32] -> (hi, lo), each [K padded, N] in the bank's K order."""
    s, kt, _, nw, _ = bank.shape
    return [bank[:, :, h].permute(1, 3, 0, 2).reshape(kt * TILE_K, s * nw) for h in range(2)]


def split_chain(a, b_hi, b_lo):
    """One chain's product as the kernel's three passes: small terms first, in fp32."""
    a_hi, a_lo = split_tf32(a)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def one_pass_chain(a, b_hi, b_lo):
    """One TF32 pass: about three decimal digits."""
    return round_tf32(a) @ b_hi


def _gather(m, taps):
    """NHWC map -> [pixels, taps*taps*C], K tap-major (dy, dx), zeros outside the image."""
    b, h, w, c = m.shape
    if taps == 1:
        return m.reshape(-1, c)
    mp = F.pad(m, (0, 0, 1, 1, 1, 1))
    return torch.cat([mp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], -1).reshape(-1, 9 * c)


def _stage(a, bank, chain):
    """A [pixels, K] times the stage's bank, in 16-deep chains from zero joined in fp32."""
    b_hi, b_lo = _bank_matrices(bank)
    k = a.shape[1]
    ap = torch.zeros(a.shape[0], b_hi.shape[0])
    ap[:, :k] = a
    ap = ap[:, _k_rows(b_hi.shape[0])]
    acc = torch.zeros(a.shape[0], b_hi.shape[1])
    for k0 in range(0, k, CHAIN):
        k1 = min(k0 + CHAIN, k)
        acc = acc + chain(ap[:, k0:k1], b_hi[k0:k1], b_lo[k0:k1])
    return acc


def c3k2_as_the_kernel(x, weights, c, n, chain=split_chain):
    """x [B, H, W, C1] float32 and prepare_c3k2_weights' dict -> [B, H, W, C2], stage by stage as the kernel."""
    b, h, w, _ = x.shape
    banks = [c3k2_stage_bank(m) for m in c3k2_stage_weights(weights, c, n)]

    def conv(m, taps, s, bias):
        return F.silu(_stage(_gather(m, taps), banks[s], chain) + bias).reshape(b, h, w, -1)

    yb = conv(x, 1, 0, weights["cv1_b"][c:])
    ya = conv(x, 1, 1, weights["cv1_b"][:c])
    hs = [yb]
    for i in range(n):
        a = conv(hs[-1], 3, 2 + 2 * i, weights[f"m{i}_b1"])
        hs.append(hs[-1] + conv(a, 3, 3 + 2 * i, weights[f"m{i}_b2"]))
    return conv(torch.cat([ya, *hs], -1), 1, 2 + 2 * n, weights["cv2_b"])


@pytest.mark.parametrize("c1,c2,n", WIDTHS, ids=IDS)
def test_c3k2_kernel_arithmetic_holds_fp32_accuracy(c1, c2, n):
    block = _block(c1, c2, n, seed=c1 + n)
    w = prepare_c3k2_weights(block)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, 12, 20, c1)).astype(np.float32))
    with torch.no_grad():
        ref = block.double()(x.double().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    tol = 1e-4 + 1e-4 * ref.abs()
    got = c3k2_as_the_kernel(x, w, block.c, n).double()
    assert got.shape == ref.shape == (2, 12, 20, c2)
    assert bool(((got - ref).abs() <= tol).all()), (got - ref).abs().max().item()
    # one TF32 pass keeps about three digits: the gate must see it
    one_pass = c3k2_as_the_kernel(x, w, block.c, n, chain=one_pass_chain).double()
    assert not bool(((one_pass - ref).abs() <= tol).all())


@pytest.mark.parametrize("c1,c2,n", WIDTHS, ids=IDS)
def test_c3k2_bank_holds_every_stage_split_and_zero_padded(c1, c2, n):
    """Each stage's hi + lo gives back its [K, N] weights to 2^-21 relative, both
    halves are TF32 values, the stages come in the kernel's order with the
    shapes it reads, and every padded K row is exactly 0 in both halves."""
    block = _block(c1, c2, n, seed=7)
    w = prepare_c3k2_weights(block)
    c, cb = block.c, w["m0_b1"].shape[0]
    mats = c3k2_stage_weights(w, c, n)
    assert [tuple(m.shape) for m in mats] == ([(c1, c)] * 2 + [(9 * c, cb), (9 * cb, c)] * n + [((2 + n) * c, c2)])
    for m in mats:
        bank = c3k2_stage_bank(m)
        k, o = m.shape
        kp = -(-k // TILE_K) * TILE_K
        assert tuple(bank.shape) == (o // slab_width(o), kp // TILE_K, 2, slab_width(o), TILE_K)
        hi, lo = _bank_matrices(bank)
        for half in (hi, lo):
            assert torch.equal(round_tf32(half), half)
        logical = torch.zeros(kp, o)
        logical[_k_rows(kp)] = hi + lo
        assert bool(((logical[:k] - m).abs() <= 2.0 ** -21 * m.abs()).all())
        assert not bool(logical[k:].any()) and not bool(hi[_k_rows(kp) >= k].any())
        assert not bool(lo[_k_rows(kp) >= k].any())


def test_c3k2_bank_is_kept_until_the_weights_change_on_the_cpu():
    """The bank is built at a weight set's first call and kept; an in-place write
    to a weight matrix or a new matrix in the dict rebuilds it."""
    block = _block(32, 64, 1, seed=3)
    w = prepare_c3k2_weights(block)
    before = fused_c3k2.bank_builds
    first = c3k2_bank(w, block.c, 1)
    assert c3k2_bank(w, block.c, 1) is first and fused_c3k2.bank_builds == before + 1
    w["cv2_m0"].mul_(0.5)
    second = c3k2_bank(w, block.c, 1)
    assert second is not first and fused_c3k2.bank_builds == before + 2
    w["m0_w2"] = w["m0_w2"].clone()
    assert c3k2_bank(w, block.c, 1) is not second and fused_c3k2.bank_builds == before + 3
    torch.testing.assert_close(c3k2_bank(w, block.c, 1)[-10:], second[-10:], rtol=0, atol=0)
