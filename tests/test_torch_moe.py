"""The port's sparse MoE pieces against the JAX package, on the CPU in fp32:
the gathered expert matmul (ops/moe.py vs ops/pallas_moe.py, the Pallas kernel
in interpret mode as its own tests run it), top-k routing with ties
(nn/moe/routers.py, mixtures.py:process_logits, dispatch.py:top_k_from_weights),
gathered dispatch (nn/moe/dispatch.py, the ports of tests/test_sparse_dispatch.py)
and OptimizedMOEImproved, sparse and dense. Weights come from the JAX init (BN
statistics from numpy seeds) and reach the port through
utils/weights.py:state_dict_from_jax; inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.module import Context
from yolo_master_tpu.nn.moe import dispatch as jdispatch
from yolo_master_tpu.nn.moe import routers as jrouters
from yolo_master_tpu.nn.moe.es_moe import ES_MOE as JaxESMOE
from yolo_master_tpu.nn.moe.mixtures import OptimizedMOEImproved as JaxOptimizedMOE
from yolo_master_tpu.nn.moe.mixtures import process_logits as jax_process_logits
from yolo_master_tpu.ops.pallas_moe import dense_expert_matmul as jax_dense_expert_matmul
from yolo_master_tpu.ops.pallas_moe import gathered_expert_matmul as jax_gathered_expert_matmul
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch.nn.moe import ES_MOE, OptimizedMOEImproved, routers
from yolo_master_tpu_torch.nn.moe.dispatch import (_pad_kernel_center, expert_bank, gather_dispatch,
                                                   stack_expert_params, top_k_from_weights)
from yolo_master_tpu_torch.nn.moe.mixtures import process_logits
from yolo_master_tpu_torch.ops.moe import dense_expert_matmul, gathered_expert_matmul
from yolo_master_tpu_torch.utils.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _seed_bn(tree, rng):
    """Random eval statistics for every BatchNorm leaf group (in place)."""
    if isinstance(tree, dict):
        if {"scale", "bias", "mean", "var"} <= set(tree):
            c = np.asarray(tree["scale"]).shape
            tree["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            tree["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        else:
            for v in tree.values():
                _seed_bn(v, rng)
    return tree


def _pair(jblock, tblock, seed=0):
    """The JAX block's init (BN statistics seeded) loaded strict into the port's block."""
    jblock.finalize("m")
    p = _seed_bn(_np_tree(jax.jit(jblock.init)(jax.random.PRNGKey(seed))), np.random.default_rng(seed))
    sd = state_dict_from_jax({"layers": {"0": p}})
    tblock.load_state_dict({k[len("model.0."):]: v for k, v in sd.items()}, strict=True)
    return jblock, p, tblock.eval()


def _x(b=4, hw=16, c=32, seed=0):
    return np.random.default_rng(seed).normal(size=(b, hw, hw, c)).astype(np.float32)


def _run(tblock, x, sparse=True):
    tblock.sparse_inference = sparse
    with torch.no_grad():
        return tblock(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


# -- the gathered expert matmul ------------------------------------------------------

def _matmul_inputs(b=2, n=128, c=32, o=64, e=8, k=2, seed=0):
    """tests/test_pallas_kernels.py:52's inputs, with a repeated expert in row 0
    and a zero weight in the last row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w = (rng.standard_normal((e, c, o)) * 0.05).astype(np.float32)
    idx = rng.integers(0, e, (b, k)).astype(np.int32)
    idx[0, :] = idx[0, 0]
    wts = rng.uniform(0.2, 0.8, (b, k)).astype(np.float32)
    wts[-1, -1] = 0.0
    return x, w, idx, wts


@pytest.mark.parametrize("n", [128, 100])
def test_dense_expert_matmul_matches_jax(n):
    """The plain version against JAX's dense reference and, at N a multiple of
    the TPU tile, its Pallas kernel (interpret mode): within 1e-4
    (tests/test_pallas_kernels.py:63's limit); the wrapper on a CPU tensor is
    the plain version."""
    x, w, idx, wts = _matmul_inputs(n=n)
    out = dense_expert_matmul(*map(torch.from_numpy, (x, w, idx, wts))).numpy()
    ref = np.asarray(jax_dense_expert_matmul(*map(jnp.asarray, (x, w, idx, wts))))
    assert out.shape == (2, n, 64)
    assert np.abs(out - ref).max() < 1e-4
    if n % 64 == 0:
        kern = np.asarray(jax_gathered_expert_matmul(*map(jnp.asarray, (x, w, idx, wts)), tile_n=64, interpret=True))
        assert np.abs(out - kern).max() < 1e-4
    wrapped = gathered_expert_matmul(*map(torch.from_numpy, (x, w, idx, wts))).numpy()
    np.testing.assert_array_equal(wrapped, out)


def test_dense_expert_matmul_counts_repeats_and_skips_bad_indices():
    """A repeated expert counts once per slot; a slot outside [0, E) adds
    nothing (the kernel's rule, csrc/moe.cu). Exact sums of fp64 references
    within 1e-5."""
    x, w, idx, wts = _matmul_inputs()
    ref0 = (x[0].astype(np.float64) @ w[idx[0, 0]]) * (wts[0, 0] + wts[0, 1])
    out = dense_expert_matmul(*map(torch.from_numpy, (x, w, idx, wts))).numpy()
    assert np.abs(out[0] - ref0).max() < 1e-5
    bad = idx.copy()
    bad[1, 1] = 8
    ref1 = (x[1].astype(np.float64) @ w[idx[1, 0]]) * wts[1, 0]
    out = dense_expert_matmul(*map(torch.from_numpy, (x, w, bad, wts))).numpy()
    assert np.abs(out[1] - ref1).max() < 1e-5


# -- top-k routing with ties -----------------------------------------------------------

TIED = np.array([[1.0, 1.0, 1.0, 0.0], [0.5, 2.0, 2.0, 2.0], [0.0, 0.0, 0.0, 0.0], [3.0, -1.0, 0.2, 0.1]],
                np.float32)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_topk_mask_and_soft_top_k_keep_every_tie_as_jax(k):
    """Ties at the k-th value select every tied entry, as in JAX (more than k);
    the weights agree within 1e-6."""
    mask = routers._topk_mask(torch.from_numpy(TIED), k).numpy()
    np.testing.assert_array_equal(mask, np.asarray(jrouters._topk_mask(jnp.asarray(TIED), k)))
    assert mask[0].sum() == (3 if k <= 3 else 4)
    w = routers.soft_top_k(torch.from_numpy(TIED), k).numpy()
    np.testing.assert_allclose(w, np.asarray(jrouters.soft_top_k(jnp.asarray(TIED), k)), atol=1e-6)
    np.testing.assert_array_equal(routers.hard_top_k(torch.from_numpy(TIED), k).numpy(), w)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_from_weights_and_process_logits_break_ties_as_jax(k):
    """Exactly k experts, the lower index first on ties (jax.lax.top_k and the
    stable jnp.argsort); weights within 1e-6."""
    w = routers.soft_top_k(torch.from_numpy(TIED), k)
    wts, idx = top_k_from_weights(w, k)
    jwts, jidx = jdispatch.top_k_from_weights(jnp.asarray(w.numpy()), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(wts.numpy(), np.asarray(jwts), atol=1e-6)
    ours = process_logits(torch.from_numpy(TIED), k)[0].numpy()
    theirs = jax_process_logits(jnp.asarray(TIED), training=False, noise_std=1.0, top_k=k, num_experts=4)[0]
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-6)
    assert ((ours > 0).sum(-1) == k).all()


# -- gathered dispatch: ports of tests/test_sparse_dispatch.py ----------------------------

@pytest.mark.parametrize("top_k,threshold", [(2, 0.0), (3, 0.0), (3, 0.4)], ids=["k2", "k3", "dynamic_threshold"])
def test_sparse_es_moe_matches_jax_and_masked_dense(top_k, threshold):
    """ES_MOE(32, 32, 8 experts): sparse eval within 1e-4 of JAX's sparse eval
    and of the masked-dense sum over the same retained weights (the
    reference's parity gate, tests/test_sparse_dispatch.py); without the
    threshold that is the dense path itself."""
    jblock, p, block = _pair(JaxESMOE(32, 32, num_experts=8, top_k=top_k, dynamic_threshold=threshold),
                             ES_MOE(32, 32, num_experts=8, top_k=top_k, dynamic_threshold=threshold))
    x = _x(c=32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jblock(p, jnp.asarray(x), Context(training=False, sparse_inference=True)))
    ys = _run(block, x, sparse=True)
    assert np.abs(ys - ref).max() <= 1e-4
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        w = block._sparse_retained_weights(block.routing(xt)[0])
        out = sum(e(xt) * w[:, i, None, None, None] for i, e in enumerate(block.experts))
        yd = block.norm(out).permute(0, 2, 3, 1).numpy()
    assert np.abs(ys - yd).max() <= 1e-4
    if threshold == 0.0:
        assert np.abs(ys - _run(block, x, sparse=False)).max() <= 1e-4
    assert not block.fusable()


def test_sparse_es_moe_bn_folded_and_flags():
    """After fuse_bn (BN in the pointwise bias) the sparse path agrees with the
    unfolded block within 1e-4; use_sparse_inference=False or top_k=E keep
    the dense path, which fused_esmoe_fuse may swap."""
    from yolo_master_tpu_torch.utils.fuse import fuse_bn, fused_esmoe_fuse

    _, _, block = _pair(JaxESMOE(32, 32, num_experts=4, top_k=2), ES_MOE(32, 32, num_experts=4, top_k=2))
    x = _x(b=2, hw=12, c=32, seed=3)
    ref = _run(block, x)
    fuse_bn(block)
    assert np.abs(_run(block, x) - ref).max() <= 1e-4
    assert ES_MOE(32, 32, num_experts=4, top_k=2, use_sparse_inference=False).fusable()
    assert ES_MOE(32, 32, num_experts=4, top_k=4).fusable()
    holder = torch.nn.Module()
    holder.model = torch.nn.ModuleList([block, ES_MOE(32, 32, num_experts=4)])
    for i, m in enumerate(holder.model):
        m.i, m.f = i, -1
    fused_esmoe_fuse(holder)
    assert [type(m).__name__ for m in holder.model] == ["ES_MOE", "FusedESMOE"]  # the sparse block stays
    with pytest.raises(ValueError):
        ES_MOE(32, 32, num_experts=4, top_k=5)


def test_pad_kernel_center_conv_exact_and_as_jax():
    """A 3x3 depthwise kernel centre-padded to 9x9 under pad 4 computes the 3x3
    conv under pad 1 (1e-5), and the padding is JAX's (HWIO <-> OIHW)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 8, 12, 12)).astype(np.float32))
    w3 = rng.normal(size=(8, 1, 3, 3)).astype(np.float32)
    w9 = _pad_kernel_center(torch.from_numpy(w3), 9, 9)
    np.testing.assert_array_equal(w9.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(jdispatch._pad_kernel_center(jnp.asarray(w3.transpose(2, 3, 1, 0)), 9, 9)))
    y1 = F.conv2d(x, torch.from_numpy(w3), padding=1, groups=8)
    y2 = F.conv2d(x, w9, padding=4, groups=8)
    assert (y1 - y2).abs().max() < 1e-5
    with pytest.raises(ValueError):
        _pad_kernel_center(torch.from_numpy(w3), 4, 4)


def test_stack_gather_heterogeneous_kernels():
    """The 3/5/7 experts stack via centred zero padding; gathering any expert
    through the 7x7 expert's gathered forward reproduces its direct output
    (1e-5), at stride 1 and 2."""
    _, _, block = _pair(JaxESMOE(16, 16, num_experts=3, top_k=2), ES_MOE(16, 16, num_experts=3, top_k=2), seed=1)
    bank = stack_expert_params(block.experts)
    assert tuple(bank["conv.depthwise.weight"].shape) == (3, 16, 1, 7, 7)
    x = torch.from_numpy(_x(b=2, hw=8, c=16, seed=1)).permute(0, 3, 1, 2)
    with torch.no_grad():
        for e in range(3):
            idx = torch.full((2, 1), e, dtype=torch.int32)
            gathered = gather_dispatch(block.experts[2], bank, x, idx, torch.ones(2, 1))
            assert (block.experts[e](x) - gathered).abs().max() < 1e-5
        for e in block.experts:  # stride 2: every expert pads (k-1)//2, so padding to kmax stays exact
            e.conv.depthwise.stride = (2, 2)
        gathered = gather_dispatch(block.experts[2], stack_expert_params(block.experts), x,
                                   torch.tensor([[0], [1]], dtype=torch.int32), torch.ones(2, 1))
        assert (block.experts[0](x[:1]) - gathered[:1]).abs().max() < 1e-5
        assert (block.experts[1](x[1:]) - gathered[1:]).abs().max() < 1e-5
    with pytest.raises(ValueError, match="heterogeneous"):
        stack_expert_params([torch.nn.Linear(2, 3), torch.nn.Linear(2, 4)])


@pytest.mark.parametrize("change", ["load_state_dict", "double", "fuse_bn", "train_forward"])
def test_expert_bank_is_kept_until_the_experts_change(change):
    """Sparse eval stacks the banks once and reuses them; a strict load, a dtype
    change, BN folding or a training-mode forward (new BN statistics) rebuilds
    them, and sparse eval then equals masked dense (threshold 0) within 1e-5."""
    from yolo_master_tpu_torch.utils.fuse import fuse_bn

    torch.manual_seed(0)
    block, other = ES_MOE(16, 16, num_experts=4, top_k=2, dynamic_threshold=0.0), ES_MOE(16, 16, num_experts=4, top_k=2)
    x = _x(b=2, hw=8, c=16, seed=4)
    _run(block.eval(), x)
    bank = expert_bank(block.experts)
    _run(block, x)
    assert expert_bank(block.experts) is bank
    if change == "load_state_dict":
        block.load_state_dict(other.state_dict())
    elif change == "double":
        block.double()
        x = x.astype(np.float64)
    elif change == "fuse_bn":
        fuse_bn(block)
    else:
        for bn in (m for m in block.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.momentum = 1.0
        with torch.no_grad():
            block.train()(torch.from_numpy(_x(b=2, hw=8, c=16, seed=5)).permute(0, 3, 1, 2))
        block.eval()
    sparse = _run(block, x)
    assert expert_bank(block.experts) is not bank
    assert np.abs(sparse - _run(block, x, sparse=False)).max() <= 1e-5


def test_top_k_es_moe_tree_round_trips_strict():
    """A top_k ES_MOE tree -> state_dict_from_jax -> strict load -> import_state_dict(strict=True) -> the same tree."""
    jblock, p, block = _pair(JaxESMOE(32, 32, num_experts=8, top_k=2), ES_MOE(32, 32, num_experts=8, top_k=2))
    back = import_state_dict({"layers": {"0": p}},
                             {f"model.0.{k}": v for k, v in block.state_dict().items()}, strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(back["layers"]["0"])):
        np.testing.assert_array_equal(a, b)


# -- OptimizedMOEImproved ---------------------------------------------------------------

@pytest.mark.parametrize("hw", [16, 4], ids=["pooled_router", "unpooled_router"])
@pytest.mark.parametrize("cin,cout,e", [(32, 32, 8), (32, 48, 4)])
def test_optimized_moe_matches_jax_sparse_and_dense(cin, cout, e, hw):
    """Sparse (gathered) and dense (masked) eval within 1e-4 of JAX's, and of
    each other; the router pools 4x only when H and W both exceed 4."""
    jblock, p, block = _pair(JaxOptimizedMOE(cin, cout, num_experts=e, top_k=2, progressive_sparsity=False),
                             OptimizedMOEImproved(cin, cout, num_experts=e, top_k=2))
    x = _x(hw=hw, c=cin, seed=2)
    for sparse in (True, False):
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jblock(p, jnp.asarray(x), Context(training=False, sparse_inference=sparse)))
        out = _run(block, x, sparse)
        assert out.shape == ref.shape == (4, hw, hw, cout)
        assert np.abs(out - ref).max() <= 1e-4
    assert np.abs(_run(block, x, True) - _run(block, x, False)).max() <= 1e-4


def test_optimized_moe_refuses_unported_types():
    """Every expert and router type builds and runs in eval (held against JAX
    in tests/test_torch_yolo26.py) and trains: the train step takes a block of
    each and publishes its aux loss (held against JAX in training in
    tests/test_torch_moe_train.py); an unknown type is a ValueError."""
    from yolo_master_tpu_torch.engine.train_step import make_train_step

    for kw in ({"expert_type": "ghost"}, {"router_type": "local"}, {"expert_type": "spatial", "router_type": "adaptive"}):
        block = OptimizedMOEImproved(32, 32, **kw).eval()
        with torch.no_grad():
            assert block(torch.rand(2, 32, 8, 8)).shape == (2, 32, 8, 8)
        block.train()
        make_train_step(torch.nn.Sequential(block))
        y = block(torch.rand(2, 32, 8, 8))
        (y.sum() + block.aux_record.value).backward()
        assert block.aux_record.family == "moe" and all(p.grad is not None for p in block.experts.parameters())
    with pytest.raises(ValueError):
        OptimizedMOEImproved(32, 32, expert_type="nope")
