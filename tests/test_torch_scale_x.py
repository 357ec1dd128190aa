"""yolo-master-x (the port) against the JAX package at 64 px on the CPU:
the scale rules of parse_model, forward_predict with calibrated BN, and the
fused uint8 model (BN folded, the fused stem at c0/c1 = 96/192). Helpers and
tolerances: tests/_torch_scale.py.
"""

import pytest
import torch

from _torch_scale import check_forward_predict, check_fused_uint8, check_scale_rules, scale_pair


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    return scale_pair("yolo-master-x")


def test_scale_rules_reach_the_graph(pair):
    check_scale_rules(pair[0])


def test_forward_predict_matches_jax_calibrated_bn(pair):
    port, x, _, ref = pair
    check_forward_predict(port, x, ref)


def test_fused_uint8_model_matches_jax_unfused(pair):
    port, _, x_u8, ref = pair
    check_fused_uint8(port, x_u8, ref)
