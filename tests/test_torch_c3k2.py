"""The port's whole-block C3k2 (ops/c3k2.py) against the JAX package's
(ops/pallas_c3k2.py, both Pallas variants run in interpret mode as their own
tests run them on the CPU), on the same BN-folded weights and inputs, fp32.
Weights come from the JAX init with BN statistics from a numpy seed and reach
the port through utils/weights.py:state_dict_from_jax.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.layers import C3k2 as JaxC3k2
from yolo_master_tpu.ops.pallas_c3k2 import pallas_c3k2, pallas_c3k2_cf
from yolo_master_tpu.ops.pallas_c3k2 import prepare_c3k2_weights as jax_prepare
from yolo_master_tpu.utils.fuse import fuse_bn_params
from yolo_master_tpu_torch.nn.layers import C3k2
from yolo_master_tpu_torch.ops.c3k2 import fused_c3k2, fused_c3k2_plain, prepare_c3k2_weights
from yolo_master_tpu_torch.utils.fuse import fuse_bn
from yolo_master_tpu_torch.utils.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _block_pair(n, c1=32, c2=64, seed=0):
    """tests/test_pallas_kernels.py:66's block, C3k2(32, 64, n, c3k=False,
    e=0.25), with seeded BN statistics: the JAX tree BN-folded, and the port's
    block on the same weights (unfolded)."""
    rng = np.random.default_rng(seed)
    jm = JaxC3k2(c1, c2, n=n, c3k=False, e=0.25).finalize("l2")
    p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))

    def seed_bn(tree):
        if {"scale", "bias", "mean", "var"} <= set(tree):
            c = tree["scale"].shape
            tree["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            tree["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        for v in tree.values():
            if isinstance(v, dict):
                seed_bn(v)

    seed_bn(p)
    block = C3k2(c1, c2, n=n, c3k=False, e=0.25)
    sd = state_dict_from_jax({"layers": {"0": p}})
    block.load_state_dict({k[len("model.0."):]: v for k, v in sd.items()}, strict=True)
    folded = fuse_bn_params({"layers": {"0": p}})["layers"]["0"]
    return jm, folded, block.eval()


@pytest.mark.parametrize("n", [1, 2])
def test_prepare_c3k2_weights_matches_jax(n):
    """Same names, shapes and layout as pallas_c3k2.py:prepare_c3k2_weights, and
    the values within 1e-6 (BN folded in another order); folding here or by
    fuse_bn first gives the same dict."""
    jm, folded, block = _block_pair(n)
    theirs = {k: np.asarray(v) for k, v in jax_prepare(folded, c=jm.c, n=n).items()}
    ours = prepare_c3k2_weights(block)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_allclose(ours[k].numpy(), v, atol=1e-6, rtol=1e-6, err_msg=k)
    fuse_bn(block)
    for k, v in prepare_c3k2_weights(block).items():
        np.testing.assert_allclose(v.numpy(), ours[k].numpy(), atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("n", [1, 2])
def test_fused_c3k2_plain_matches_jax_kernels(n):
    """The plain version (and the wrapper on a CPU tensor) within 1e-5 of both
    Pallas variants in interpret mode (tests/test_pallas_kernels.py:85's
    limit) and of the port's own C3k2 module."""
    jm, folded, block = _block_pair(n)
    x = np.random.default_rng(1).standard_normal((2, 16, 20, 32)).astype(np.float32)
    jw = jax_prepare(folded, c=jm.c, n=n)
    w = prepare_c3k2_weights(block)
    out = fused_c3k2_plain(torch.from_numpy(x), w, block.c, n).numpy()
    assert out.shape == (2, 16, 20, 64)
    for fn in (pallas_c3k2, pallas_c3k2_cf):
        ref = np.asarray(fn(jnp.asarray(x), jw, c=jm.c, n=n, interpret=True))
        assert np.abs(out - ref).max() < 1e-5, fn.__name__
    with torch.no_grad():
        mod = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(out - mod).max() < 1e-5
    np.testing.assert_array_equal(fused_c3k2(torch.from_numpy(x), w, block.c, n).numpy(), out)


def test_prepare_c3k2_weights_refuses_what_the_kernel_does_not_compute():
    """C3k inner blocks (c3k=True) and Bottlenecks without the shortcut raise,
    where the JAX function would compute a wrong answer."""
    with pytest.raises(NotImplementedError, match="c3k=False"):
        prepare_c3k2_weights(C3k2(32, 64, n=1, c3k=True, e=0.25))
    with pytest.raises(NotImplementedError, match="shortcut"):
        prepare_c3k2_weights(C3k2(32, 64, n=1, c3k=False, e=0.25, shortcut=False))
