"""Shared by tests/test_torch_scale_l.py and test_torch_scale_x.py: yolo-master
at a wide scale in both packages on the same weights, on the CPU in fp32.

Weights come from the port's seeded init, which draws every tensor from the
JAX init's distributions (convs U(+-1/sqrt(fan_in)), BN identity, area
attention trunc_normal(0.02)); BatchNorm statistics are calibrated on the
input in the port, and the weights reach the JAX tree through
:func:`jax_params_of` (at the bare init the activations die out by the neck
and the comparison would show nothing). The tolerances are those of
test_forward_predict_matches_jax_calibrated_bn: within 4x the port's own
fp32-vs-fp64 error (floors 2e-3 px on boxes, 1e-5 on scores).
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.nn import layers as tlayers
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils.fuse import fuse_bn, fused_stem_fuse
from yolo_master_tpu_torch.utils.weights import calibrate_bn

BOX, SCORE = np.s_[..., :4], np.s_[..., 4:]
FLOORS = ((BOX, 2e-3, 0.1), (SCORE, 1e-5, 1e-2))  # (slice, floor, largest sane fp32-vs-fp64 error)


def jax_params_of(jm, port):
    """The port's weights as the JAX model's parameter tree (numpy leaves):
    ``jax.eval_shape`` gives the tree's names and shapes without running the
    JAX init (a 30-s compile on the CPU at any scale), and import_state_dict
    fills it strictly, so a drift in the names fails."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, import_state_dict(shapes, port.state_dict(), strict=True))


def scale_pair(name: str):
    """(port, x, x_u8, ref): the port with calibrated BN, a [2,64,64,3] float
    image and its uint8 copy, and JAX's forward_predict on both, stacked
    ([4, A, 84]: the float images, then the uint8 ones / 255)."""
    jm = JaxDetectionModel(name)
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    x_u8 = (x * 255).astype(np.uint8)
    port = DetectionModel(name)
    calibrate_bn(port, torch.from_numpy(x))
    port.eval()
    params = jax_params_of(jm, port)
    ref = np.asarray(jax.jit(jm.forward_predict)(params, jnp.asarray(np.concatenate([x, x_u8 / np.float32(255)]))))
    return port, x, x_u8, ref


def fp32_noise(port, x: np.ndarray) -> np.ndarray:
    """The port's own fp32 rounding noise: |fp32 - fp64| on the same input."""
    with torch.no_grad():
        o64 = copy.deepcopy(port).double().forward_predict(torch.from_numpy(x).double()).numpy()
        o32 = port.forward_predict(torch.from_numpy(x)).numpy()
    return np.abs(o32 - o64)


def check_scale_rules(port) -> None:
    """parse_model's scale rules of l and x reached the graph: every C3k2 has
    C3k inner blocks (c3k=True, the backbone's too), and both A2C2f blocks the
    residual gamma and mlp_ratio 1.2."""
    c3k2 = [m for m in port.model if isinstance(m, tlayers.C3k2)]
    assert len(c3k2) == 6 and all(isinstance(b, tlayers.C3k) for m in c3k2 for b in m.m)
    a2 = [m for m in port.model if isinstance(m, tlayers.A2C2f)]
    assert len(a2) == 2
    for m in a2:
        assert m.gamma is not None
        assert m.m[0][0].mlp[0].conv.out_channels == int(m.cv1.conv.out_channels * 1.2)


def check_forward_predict(port, x, ref) -> None:
    """Calibrated BN: the output depends on the image, and the port agrees with
    JAX within 4x its own fp32-vs-fp64 error."""
    assert np.abs(ref[0] - ref[1]).max() > 1.0
    with torch.no_grad():
        y = port.forward_predict(torch.from_numpy(x)).numpy()
    assert y.shape == ref[:2].shape
    noise = fp32_noise(port, x)
    for sl, floor, sane in FLOORS:
        assert noise[sl].max() < sane
        assert np.abs(y[sl] - ref[:2][sl]).max() <= max(4 * noise[sl].max(), floor)


def check_fused_uint8(port, x_u8, ref) -> None:
    """BN folded and the fused stem swapped in (its plain version on the CPU),
    fed raw uint8, against the unfused JAX model on the same image / 255:
    within 4x the fused model's own fp32-vs-fp64 error (floors 2e-3 px,
    1e-5). Folding moves where fp32 rounds, and at depth 1.0 that rounding
    grows through the trunk as the noise does (BN folding alone, without the
    stem, lands as far from JAX at scale l)."""
    fused = copy.deepcopy(port)
    fuse_bn(fused)
    fused_stem_fuse(fused)
    assert isinstance(fused.model[0], tlayers.FusedStem) and fused.uint8_input
    with torch.no_grad():
        y = fused.forward_predict(torch.from_numpy(x_u8)).numpy()
        y64 = copy.deepcopy(fused).double().forward_predict(torch.from_numpy(x_u8)).numpy()
    noise = np.abs(y - y64)
    for sl, floor, sane in FLOORS:
        assert noise[sl].max() < sane
        assert np.abs(y[sl] - ref[2:][sl]).max() <= max(4 * noise[sl].max(), floor)
