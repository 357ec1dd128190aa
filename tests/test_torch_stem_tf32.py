"""The stem kernel's arithmetic (yolo_master_tpu_torch/csrc/stem.cu), mirrored on
the CPU in plain PyTorch, against an fp64 convolution, at every stem width.

The kernel computes both convs as implicit GEMMs on the tensor cores:
  - conv0: im2col of the image (K = 3x3 taps x 3 channels) times w0, two
    split-TF32 passes for uint8 pixels (exact in TF32) and three for float input;
  - conv1: im2col of the conv0 map (zero border) times w1, K ordered
    (channel chunk of 16, tap), one 16-deep chain per tap and channel chunk:
    each chain's three-pass split product starts from zero and joins the sum
    by an fp32 add.
The mirror uses ``ops/_tf32.py``'s plain helpers and must hold the kernel's
gate, 1e-4 + 1e-4*|ref| of the fp64 stem, while one TF32 pass for conv1 must
not. Beside it, the JAX package's Pallas stem (interpret mode) stays within its
own 1e-4 of the port's plain version at the same width.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from yolo_master_tpu.ops.pallas_stem import fused_stem as jax_fused_stem
from yolo_master_tpu.ops.pallas_stem import s2d4_blob
from yolo_master_tpu_torch.ops._tf32 import matmul_split_tf32_plain, matmul_tf32_plain, split_tf32
from yolo_master_tpu_torch.ops.stem import fused_stem_plain

CHANNEL_CHUNK = 16  # conv0 channels per chunk of the kernel: the depth of one conv1 chain


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _im2col(x, h_out, w_out):
    """x [B, H, W, C] NHWC -> the 9 taps of a k3 s2 p1 window, each [B*h_out*w_out, C], tap-major (kh, kw)."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, kh:kh + 2 * h_out:2, kw:kw + 2 * w_out:2, :].reshape(-1, x.shape[3])
            for kh in range(3) for kw in range(3)]


def stem_as_the_kernel(x, w0, b0, w1, b1, conv1_product=matmul_split_tf32_plain):
    """x [B, H, W, 3] uint8 or float32; OIHW float32 weights -> [B, H/4, W/4, c1] float32."""
    B, H, W, _ = x.shape
    c0, c1 = w0.shape[0], w1.shape[0]
    xf = x.float()
    # conv0: [positions, 27] x [27, c0], K ordered (kh, kw, channel)
    a0 = torch.cat(_im2col(xf, H // 2, W // 2), 1)
    k0 = w0.permute(2, 3, 1, 0).reshape(27, c0)
    if x.dtype == torch.uint8:
        hi, lo = split_tf32(k0)
        y0 = a0 @ lo + a0 @ hi
    else:
        y0 = matmul_split_tf32_plain(a0, k0)
    y0 = F.silu(y0 + b0).reshape(B, H // 2, W // 2, c0)
    # conv1: one chain per (channel chunk, tap), each from zero, joined in fp32 in the kernel's order
    taps = _im2col(y0, H // 4, W // 4)
    acc = torch.zeros(taps[0].shape[0], c1)
    for c in range(0, c0, CHANNEL_CHUNK):
        for t in range(9):
            acc = acc + conv1_product(taps[t][:, c:c + CHANNEL_CHUNK], w1[:, c:c + CHANNEL_CHUNK, t // 3, t % 3].T)
    return F.silu(acc + b1).reshape(B, H // 4, W // 4, c1)


def _inputs(c0, c1, dtype, seed):
    """A ragged 36x52 image (9x13 outputs), weights scaled as the chip checks scale them."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (2, 36, 52, 3), dtype=np.uint8)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    w0 = t((rng.random((c0, 3, 3, 3)) - 0.5) * 0.6)
    b0, b1 = t(rng.random(c0) - 0.5), t(rng.random(c1) - 0.5)
    w1 = t((rng.random((c1, c0, 3, 3)) - 0.5) * 1.2 / c0 ** 0.5)
    if dtype == "uint8":
        return torch.from_numpy(img), w0 / 255.0, b0, w1, b1
    return torch.from_numpy(img.astype(np.float32) / 255.0), w0, b0, w1, b1


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("c0,c1", [(16, 32), (32, 64), (64, 128), (96, 192)], ids=["n", "s", "m_l", "x"])
def test_stem_kernel_arithmetic_holds_fp32_accuracy(c0, c1, dtype):
    x, w0, b0, w1, b1 = _inputs(c0, c1, dtype, seed=c0)
    ref = fused_stem_plain(x, w0.double(), b0.double(), w1.double(), b1.double())  # fp64 convs
    tol = 1e-4 + 1e-4 * ref.abs()
    got = stem_as_the_kernel(x, w0, b0, w1, b1).double()
    assert got.shape == ref.shape == (2, 9, 13, c1)
    assert bool(((got - ref).abs() <= tol).all()), (got - ref).abs().max().item()
    # a single TF32 pass for conv1 keeps about three digits: the gate must see it
    one_pass = stem_as_the_kernel(x, w0, b0, w1, b1, conv1_product=matmul_tf32_plain).double()
    assert not bool(((one_pass - ref).abs() <= tol).all())


@pytest.mark.parametrize("c0,c1", [(16, 32), (32, 64), (64, 128), (96, 192)], ids=["n", "s", "m_l", "x"])
def test_jax_pallas_stem_matches_plain_at_every_width(c0, c1):
    """The JAX package's stem (interpret mode) within its own 1e-4 of the port's
    plain version (tests/test_pallas_stem.py), float input, at each YAML width."""
    x, w0, b0, w1, b1 = _inputs(c0, c1, "float32", seed=c0 + 1)
    hwio = lambda w: jnp.asarray(w.permute(2, 3, 1, 0).numpy())  # noqa: E731
    blob = s2d4_blob(jnp.transpose(jnp.asarray(x.numpy()), (0, 3, 1, 2)))
    ref = np.asarray(jax_fused_stem(blob, hwio(w0), jnp.asarray(b0.numpy()), hwio(w1), jnp.asarray(b1.numpy()),
                                    height=36, width=52, interpret=True))
    out = fused_stem_plain(x, w0, b0, w1, b1).numpy()
    assert out.shape == ref.shape == (2, 9, 13, c1)
    assert np.abs(out - ref).max() < 1e-4
