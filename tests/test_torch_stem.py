"""The port's fused stem (yolo_master_tpu_torch/ops/stem.py) against the JAX
package's Pallas stem (ops/pallas_stem.py, interpret mode on the CPU).

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA kernel
(csrc/stem.cu) is compared with that plain version on the card, in
tests/test_torch_cuda.py and in chip_smoke.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_master_tpu.ops.pallas_stem import fused_stem as jax_fused_stem
from yolo_master_tpu.ops.pallas_stem import s2d4_blob
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.nn.layers import FusedStem
from yolo_master_tpu_torch.ops.stem import fused_stem, stem_weight_layout


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)



def _weights(rng, c0, c1):
    """HWIO weights (the JAX layout) and biases."""
    w0 = (rng.standard_normal((3, 3, 3, c0)) * 0.2).astype(np.float32)
    b0 = rng.standard_normal(c0).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c0, c1)) * 0.2).astype(np.float32)
    b1 = rng.standard_normal(c1).astype(np.float32)
    return w0, b0, w1, b1


def _oihw(w0, b0, w1, b1):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return t(w0.transpose(3, 2, 0, 1)), t(b0), t(w1.transpose(3, 2, 0, 1)), t(b1)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 32, 96)])
def test_plain_stem_matches_jax_pallas_stem(shape):
    """Tolerance 1e-4 absolute, the JAX package's own stem gate
    (tests/test_pallas_stem.py): fp32 sums in another order."""
    b, h, w = shape
    c0, c1 = 8, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    wts = _weights(rng, c0, c1)
    blob = s2d4_blob(jnp.transpose(jnp.asarray(x), (0, 3, 1, 2)))
    ref = np.asarray(jax_fused_stem(blob, *(jnp.asarray(a) for a in wts), height=h, width=w, interpret=True))
    out = fused_stem(torch.from_numpy(x), *_oihw(*wts))
    assert tuple(out.shape) == (b, h // 4, w // 4, c1)
    assert np.abs(out.numpy() - ref).max() < 1e-4


def test_uint8_input_with_folded_scale_matches_float_input():
    """uint8 pixels with /255 folded into w0 give the float /255 image's output
    (within 1e-4: the fold moves one rounding)."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    w0, b0, w1, b1 = _oihw(*_weights(rng, 8, 16))
    out_u8 = fused_stem(torch.from_numpy(img), w0 / 255.0, b0, w1, b1)
    out_f = fused_stem(torch.from_numpy(img.astype(np.float32) / 255.0), w0, b0, w1, b1)
    assert out_u8.dtype == torch.float32
    assert (out_u8 - out_f).abs().max().item() < 1e-4


def test_stem_zero_pads_conv1_outside_the_conv0_map():
    """conv1's padding is zeros, not SiLU(b0): with a large positive b0 a wrong
    border would change the edge outputs by a lot."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    w0, b0, w1, b1 = _oihw(*_weights(rng, 4, 8))
    b0 = b0.abs() + 5.0
    out = fused_stem(torch.from_numpy(x), w0, b0, w1, b1)
    xf = torch.from_numpy(x).permute(0, 3, 1, 2)
    y = torch.nn.functional.silu(torch.nn.functional.conv2d(xf, w0, b0, stride=2, padding=1))
    y = torch.nn.functional.silu(torch.nn.functional.conv2d(y, w1, b1, stride=2, padding=1))
    assert torch.allclose(out, y.permute(0, 2, 3, 1), atol=1e-5)


def test_fused_stem_keeps_weights_in_the_kernel_layout():
    """FusedStem stores w0/w1 once in HWIO memory order (what the CUDA wrapper
    checks for), and keeps it through load_state_dict, a channels_last
    conversion of the module and the facade's fuse()."""
    w0, b0, w1, b1 = _oihw(*_weights(np.random.default_rng(4), 8, 16))
    stem = FusedStem(w0, b0, w1, b1)
    other = FusedStem(torch.zeros_like(w0), b0, torch.zeros_like(w1), b1)
    other.load_state_dict(stem.state_dict())
    moved = copy.deepcopy(stem).to("cpu", memory_format=torch.channels_last)
    for m in (stem, other, moved):
        mw0, _, mw1, _ = m.weights()
        for w, ref in ((mw0, w0), (mw1, w1)):
            assert torch.equal(w, ref) and w.permute(2, 3, 1, 0).is_contiguous()
    assert torch.equal(stem_weight_layout(w0), w0)
    fused = YOLO("yolo-master-n", device="cpu").fuse().model.model[0]
    assert all(w.permute(2, 3, 1, 0).is_contiguous() for w in fused.weights()[::2])


def test_cpu_tensor_never_counts_a_kernel_launch():
    before = fused_stem.launches
    w = _oihw(*_weights(np.random.default_rng(3), 4, 8))
    fused_stem(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), *w)
    assert fused_stem.launches == before

