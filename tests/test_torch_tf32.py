"""The arithmetic of the split-TF32 product that csrc/mma_tf32.cuh runs on the
tensor cores (ops/_tf32.py is its plain PyTorch version), on the CPU: the
split itself, the three-term product against fp64 at the port's kernel
tolerance, the one-pass TF32 product that misses it, and the two wrappers that
use the product on the card (ops/moe.py, ops/esmoe.py) still equal to the JAX
functions on CPU tensors. Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe.es_moe import ES_MOE as JaxESMOE
from yolo_master_tpu.ops.pallas_esmoe import fused_esmoe as jax_fused_esmoe
from yolo_master_tpu.ops.pallas_esmoe import pack_esmoe_params as jax_pack
from yolo_master_tpu.ops.pallas_moe import dense_expert_matmul as jax_dense_expert_matmul
from yolo_master_tpu.ops.pallas_moe import gathered_expert_matmul as jax_gathered_expert_matmul
from yolo_master_tpu_torch.ops._tf32 import (matmul_split_tf32_plain, matmul_tf32_plain, round_tf32, split_product_check,
                                             split_tf32)
from yolo_master_tpu_torch.ops.esmoe import fused_esmoe
from yolo_master_tpu_torch.ops.moe import gathered_expert_matmul

DEPTHS = [64, 128, 256]  # the C of the kernels' main shapes


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mixed(rng, shape):
    """Normal values times powers of ten from 1e-2 to 10, both signs."""
    return (rng.standard_normal(shape) * 10.0 ** rng.integers(-2, 2, shape)).astype(np.float32)


def _operands(c, seed):
    """a [96, c] of mixed magnitude against weights [c, 80] at a layer's scale, 1/sqrt(c)."""
    rng = np.random.default_rng(seed)
    return _mixed(rng, (96, c)), (rng.standard_normal((c, 80)) / c ** 0.5).astype(np.float32)


def _within_kernel_tolerance(out, ref64):
    """The tolerance every matmul kernel of the port is held to: 1e-4 + 1e-4 * |ref|."""
    return np.abs(out.astype(np.float64) - ref64) <= 1e-4 + 1e-4 * np.abs(ref64)


@pytest.mark.parametrize("c", DEPTHS)
def test_round_tf32_keeps_ten_mantissa_bits(c):
    """The low 13 bits are zero, the value moves by at most half a TF32 step
    (2^-11 relative), TF32 values and zero stay, and a tie rounds away from zero
    (cvt.rna)."""
    x = torch.from_numpy(_mixed(np.random.default_rng(c), (c, 33)))
    r = round_tf32(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    torch.testing.assert_close(round_tf32(r), r, rtol=0, atol=0)
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 0.0, 1.0 + 2.0 ** -10], dtype=torch.float32)
    expect = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 0.0, 1.0 + 2.0 ** -10], dtype=torch.float32)
    torch.testing.assert_close(round_tf32(ties), expect, rtol=0, atol=0)


@pytest.mark.parametrize("c", DEPTHS)
def test_split_tf32_recovers_x(c):
    """(a) hi + lo equals x to 2^-21 relative (lo is rounded at 2^-11 of a
    remainder that is at most 2^-11 of x), and both halves are TF32 values."""
    x = torch.from_numpy(_mixed(np.random.default_rng(c + 1), (c, 47)))
    hi, lo = split_tf32(x)
    for half in (hi, lo):
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi.double() + lo.double() - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21


@pytest.mark.parametrize("c", DEPTHS)
def test_split_product_holds_the_kernel_tolerance(c):
    """(b) The three-term product stays within a tenth of 1e-4 + 1e-4*|ref| of the
    fp64 product (measured ~1e-5 of it on these inputs), and about as close to
    fp64 as the plain fp32 product is."""
    a, b = _operands(c, seed=c)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    out = matmul_split_tf32_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    margin = np.abs(out.astype(np.float64) - ref) / (1e-4 + 1e-4 * np.abs(ref))
    assert margin.max() <= 0.1, margin.max()
    fp32_err = np.abs((torch.from_numpy(a) @ torch.from_numpy(b)).numpy().astype(np.float64) - ref).max()
    assert np.abs(out.astype(np.float64) - ref).max() <= 4 * fp32_err + 1e-6


@pytest.mark.parametrize("c", DEPTHS)
def test_one_pass_tf32_product_misses_the_kernel_tolerance(c):
    """(c) One TF32 pass (operands rounded once, as a tensor-core product without
    the split) leaves the tolerance on the same inputs: the reason for the split."""
    a, b = _operands(c, seed=c)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    one_pass = matmul_tf32_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert not _within_kernel_tolerance(one_pass, ref).all()
    split = matmul_split_tf32_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _within_kernel_tolerance(split, ref).all()
    assert np.abs(one_pass - ref).max() > 100 * np.abs(split - ref).max()


@pytest.mark.parametrize("c", DEPTHS)
@pytest.mark.parametrize("n", [128, 100])
def test_gathered_matmul_on_cpu_still_matches_jax(c, n):
    """(d) ops/moe.py on CPU tensors against the JAX dense reference and, at N a
    multiple of the TPU tile, the Pallas kernel in interpret mode: within 1e-4,
    tests/test_torch_moe.py's limit. A repeated expert and a zero weight included."""
    rng = np.random.default_rng(c + n)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    w = (rng.standard_normal((8, c, 64)) * 0.05).astype(np.float32)
    idx = rng.integers(0, 8, (2, 2)).astype(np.int32)
    idx[0, :] = idx[0, 0]
    wts = rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)
    wts[-1, -1] = 0.0
    out = gathered_expert_matmul(*map(torch.from_numpy, (x, w, idx, wts))).numpy()
    ref = np.asarray(jax_dense_expert_matmul(*map(jnp.asarray, (x, w, idx, wts))))
    assert out.shape == (2, n, 64)
    assert np.abs(out - ref).max() < 1e-4
    if n % 64 == 0:
        kern = np.asarray(jax_gathered_expert_matmul(*map(jnp.asarray, (x, w, idx, wts)), tile_n=64, interpret=True))
        assert np.abs(out - kern).max() < 1e-4


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64)])
def test_fused_esmoe_on_cpu_still_matches_jax(cin, cout):
    """(d) ops/esmoe.py on CPU tensors against the JAX Pallas kernel in interpret
    mode on JAX's own banks and routing weights: within 2e-5,
    tests/test_torch_esmoe.py's limit."""
    rng = np.random.default_rng(cin)
    jblock = JaxESMOE(cin, cout)
    jblock.finalize("m")
    p = jax.tree_util.tree_map(np.asarray, jblock.init(jax.random.PRNGKey(1)))
    p["norm_bn"]["mean"] = rng.normal(0, 0.2, cout).astype(np.float32)
    p["norm_bn"]["var"] = rng.uniform(0.5, 2.0, cout).astype(np.float32)
    p = jax.tree_util.tree_map(jnp.asarray, p)
    x = rng.normal(0, 1, (2, 16, 16, cin)).astype(np.float32)
    jw, _ = jblock.routing(p["routing"], jnp.asarray(x), Context(training=False))
    jbanks = jax_pack(jblock, p)
    ref = np.asarray(jax_fused_esmoe(jnp.asarray(x), jw.astype(jnp.float32), *jbanks[:5], ks=jbanks[5],
                                     interpret=True))
    banks = [torch.from_numpy(np.array(t)) for t in jbanks[:5]]
    out = fused_esmoe(torch.from_numpy(x), torch.from_numpy(np.array(jw, np.float32)), *banks, jbanks[5]).numpy()
    assert out.shape == (2, 16, 16, cout)
    assert np.abs(out - ref).max() < 2e-5


def test_split_product_check_needs_the_card():
    """The header's self-check launches a kernel: on CPU tensors it raises, it does not fall back."""
    with pytest.raises(ValueError, match="CUDA"):
        split_product_check(torch.zeros(64, 32), torch.zeros(128, 32))
