"""The port's MoE tools (nn/moe/pruning.py, quantize.py, analysis.py:diagnose_model)
against the JAX package's, on the same weights, on the CPU in fp32.

The cases of tests/test_moe_ecosystem.py:34 and :80, on its MINI graph (an
ES_MOE of 4 experts, top-2) with the port's seeded init and BN calibrated,
carried to the JAX tree (tests/_torch_scale.py:jax_params_of):

1. collect_usage_stats: each MoE block's usage over two batches, within 1e-6
   of JAX's (train-mode forwards at step 0; the port's BN statistics and mode
   left as they were);
2. pruning: the same kept experts, contiguous ([0.5, 0.45, 0.04, 0.01]) and
   not ([0.3, 0.05, 0.6, 0.05]), and the pruned model's forward_predict
   within 1e-5 of JAX's pruned model's;
3. quantization, router-aware and not, at min_size 128 and 512: every int8
   tensor and scale equal to JAX's (transposed to the JAX layout), the same
   entries quantized, the report's byte counts and tensor count equal, and
   the dequantized model's forward within 1e-5 of JAX's; the same on
   yolo-master-v0_10-n's tree (its se_gate, complexity_estimator and
   routers stay fp32);
4. diagnose_model: the report (usage, Gini, shares, active experts, the
   collapsed blocks) that of JAX, usage within 1e-6; on v0_10-n's gated
   blocks too.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.moe import analysis as janalysis
from yolo_master_tpu.nn.moe import pruning as jpruning
from yolo_master_tpu.nn.moe import quantize as jquant
from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu_torch.nn.moe import ES_MOE
from yolo_master_tpu_torch.nn.moe import analysis as tanalysis
from yolo_master_tpu_torch.nn.moe import pruning as tpruning
from yolo_master_tpu_torch.nn.moe import quantize as tquant
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax, wake_mixtures

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_moe_ecosystem import MINI  # noqa: E402

TOL = 1e-5
USAGE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batches(n=2, b=2, px=64, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.random((b, px, px, 3), np.float32)} for _ in range(n)]


@pytest.fixture(scope="module")
def mini():
    """The port's MINI with BN calibrated, its JAX tree, the batches and a test image."""
    port = DetectionModel(MINI)
    batches = _batches()
    calibrate_bn(port, torch.from_numpy(batches[0]["images"]))
    port.eval()
    params = jax_params_of(JaxDetectionModel(MINI), port)
    x = np.random.default_rng(5).random((2, 64, 64, 3)).astype(np.float32)
    return {"port": port, "params": params, "batches": batches, "x": x}


def _forward_pair(port, jm, params, x):
    with torch.no_grad():
        out = port.eval().forward_predict(torch.from_numpy(x)).numpy()
    return out, np.asarray(jm.forward_predict(params, jnp.asarray(x)))


def test_collect_usage_stats_matches_jax(mini):
    port = copy.deepcopy(mini["port"])
    before = {k: v.clone() for k, v in port.state_dict().items()}
    usage = tpruning.collect_usage_stats(port, mini["batches"])
    ref = jpruning.collect_usage_stats(JaxDetectionModel(MINI), mini["params"], mini["batches"])
    assert set(usage) == set(ref) == {"layers.2"}
    np.testing.assert_allclose(usage["layers.2"], ref["layers.2"], rtol=0, atol=USAGE_TOL)
    assert not port.training and all(torch.equal(v, before[k]) for k, v in port.state_dict().items())


@pytest.mark.parametrize("usage,kept", [([0.5, 0.45, 0.04, 0.01], [0, 1]), ([0.3, 0.05, 0.6, 0.05], [0, 2])],
                         ids=["contiguous", "gapped"])
def test_prune_es_moe_matches_jax(mini, usage, kept):
    usage = {"layers.2": np.array(usage)}
    port = tpruning.prune_moe_model(copy.deepcopy(mini["port"]), usage, threshold=0.15)
    jm, new_params = jpruning.prune_moe_model(JaxDetectionModel(MINI), mini["params"], usage, threshold=0.15)
    assert tpruning.select_experts_to_keep(usage["layers.2"]) == jpruning.select_experts_to_keep(usage["layers.2"]) \
        == kept
    block, jblock = port.model[2], jm.layers[2]
    assert isinstance(block, ES_MOE) and block.num_experts == jblock.num_experts == len(kept)
    sizes = [e.conv.depthwise.kernel_size[0] for e in mini["port"].model[2].experts]
    assert [e.conv.depthwise.kernel_size[0] for e in block.experts] == [sizes[i] for i in kept]
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_params))
    assert set(sd) == set(port.state_dict())
    out, ref = _forward_pair(port, jm, new_params, mini["x"])
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= TOL * max(1.0, float(np.abs(ref).max())), np.abs(out - ref).max()


def _check_quantization(port_sd, params, min_size, router_aware):
    q = tquant.quantize_state_dict(port_sd, min_size=min_size, router_aware=router_aware)
    jq = jquant.quantize_params(params, min_size=min_size, router_aware=router_aware)
    qs = state_dict_from_jax(_q_leaves(jq, "q"))
    scales = state_dict_from_jax(_q_leaves(jq, "scale"))
    assert {k for k, v in q.items() if isinstance(v, dict)} == set(qs) and qs
    for k in qs:
        got = q[k]
        assert got["q"].dtype == torch.int8
        np.testing.assert_array_equal(got["q"].numpy(), qs[k].numpy().astype(np.int8), err_msg=k)
        np.testing.assert_array_equal(np.broadcast_to(got["scale"].numpy(), got["q"].shape), scales[k].numpy(),
                                      err_msg=k)
        if router_aware:
            assert not tquant._is_router_name(k)
    rep, jrep = tquant.quantization_report(port_sd, q), jquant.quantization_report(params, jq)
    for k in ("original_bytes", "quantized_bytes", "quantized_tensors"):
        assert rep[k] == jrep[k], (k, rep[k], jrep[k])
    return q, jq, rep


def _q_leaves(tree, field):
    """The tree with each quantized leaf replaced by its ``q`` (as float32) or ``scale``, others dropped."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "q" in v and "scale" in v:
            arr = np.asarray(v[field], np.float32)
            out[k] = arr if field == "q" else np.broadcast_to(arr, np.asarray(v["q"]).shape).copy()
        elif isinstance(v, dict):
            sub = _q_leaves(v, field)
            if sub:
                out[k] = sub
    return out


@pytest.mark.parametrize("min_size,router_aware", [(128, True), (128, False), (512, True)])
def test_quantization_matches_jax(mini, min_size, router_aware):
    q, jq, rep = _check_quantization(mini["port"].state_dict(), mini["params"], min_size, router_aware)
    assert rep["quantized_tensors"] > 0 and rep["ratio"] < 0.7
    port = copy.deepcopy(mini["port"])
    port.load_state_dict(tquant.dequantize_state_dict(q))
    out, ref = _forward_pair(port, JaxDetectionModel(MINI), jquant.dequantize_params(jq), mini["x"])
    assert np.abs(out - ref).max() <= TOL * max(1.0, float(np.abs(ref).max())), np.abs(out - ref).max()


def test_quantization_of_a_gated_model_matches_jax():
    port = DetectionModel("yolo-master-v0_10-n")
    params = jax_params_of(JaxDetectionModel("yolo-master-v0_10-n"), port)
    q, _, rep = _check_quantization(port.state_dict(), params, 512, True)
    for k in ("model.5.se_gate.2.weight", "model.5.complexity_estimator.1.weight", "model.11.routing.global_fc.weight",
              "model.8.routing.local_conv.3.weight"):
        assert not isinstance(q[k], dict), k
    assert isinstance(q["model.5.proj.weight"], dict) and rep["ratio"] < 0.4


def _assert_reports_equal(rep, ref):
    assert set(rep["blocks"]) == set(ref["blocks"]) and rep["blocks"]
    for path, r in ref["blocks"].items():
        got = rep["blocks"][path]
        np.testing.assert_allclose(got["usage"], r["usage"], rtol=0, atol=USAGE_TOL)
        for k in ("gini", "max_share"):
            assert abs(got[k] - r[k]) <= 1e-5, (path, k, got[k], r[k])
        assert got["active_experts"] == r["active_experts"]
    assert [c["block"] for c in rep["collapsed"]] == [c["block"] for c in ref["collapsed"]]


def test_diagnose_model_matches_jax(mini):
    rep = tanalysis.diagnose_model(copy.deepcopy(mini["port"]), mini["batches"])
    ref = janalysis.diagnose_model(JaxDetectionModel(MINI), mini["params"], mini["batches"])
    _assert_reports_equal(rep, ref)


def test_diagnose_a_gated_model_matches_jax():
    """yolo-master-v0_10-n, BN calibrated, one batch of 2 at 64 px: its three
    gated blocks' usage (the router's probabilities, noise-free at step 0 for
    its DualStream routers), as JAX's."""
    port = DetectionModel("yolo-master-v0_10-n")
    batches = _batches(1, seed=3)
    calibrate_bn(port, torch.from_numpy(batches[0]["images"]))
    port.eval()
    jm = JaxDetectionModel("yolo-master-v0_10-n")
    params = jax_params_of(jm, port)
    rep = tanalysis.diagnose_model(port, batches)
    assert set(rep["blocks"]) == {"layers.5", "layers.8", "layers.11"}
    _assert_reports_equal(rep, janalysis.diagnose_model(jm, params, batches))


def test_diagnose_the_latent_graph_matches_jax():
    """yolo26-master-latent-n, woken and BN calibrated, one batch of 2 at 64 px:
    the three LatentMixtures publish an aux record without usage (JAX publishes
    no stats for them) and are left out; the six routed blocks' usage, and the
    report over it, as JAX's (collect_usage_stats and diagnose_model)."""
    port = DetectionModel("yolo26-master-latent-n")
    wake_mixtures(port)
    batches = _batches(1, seed=4)
    calibrate_bn(port, torch.from_numpy(batches[0]["images"]))
    port.eval()
    jm = JaxDetectionModel("yolo26-master-latent-n")
    params = jax_params_of(jm, port)
    rep = tanalysis.diagnose_model(port, batches)
    assert set(rep["blocks"]) == {f"layers.{i}.m.0.{j}.mlp" for i in (4, 6, 8) for j in (0, 1)}
    _assert_reports_equal(rep, janalysis.diagnose_model(jm, params, batches))
