"""The gated family's training over steps in the port against the JAX package,
on the CPU in fp32.

1. yolo-master-v0_10-n's five-step trajectory against JAX's make_train_step:
   tests/test_torch_gated_train_model.py's weights and batches (64 px,
   batches of 4, BN calibrated), SGD inside the trainer's warmup,
   accumulate 2 (micro-batches of 2: each computes its own complexity gate,
   as each JAX micro-step does). tests/test_torch_moe_train_steps.py's
   rule: the losses within 1e-5 relative at
   every step, and every parameter, BN statistic and EMA entry after five
   steps within the larger of 1e-6 + 2e-5 x its move and 8x its own
   fp32-vs-fp64 distance (the port's float64 run of the same steps).
2. One step each of yolo-master-v0_13-n (MultiHeadRouterV3: noise and soft
   expert dropout) and yolo-master-v0_15-n (V2 noise, the cross-path gate
   and drop-path), with expert_dropout and drop_prob set to 0.5 on every
   gated block of both packages so that both fire in the batch: the loss
   terms and the gradients by test_torch_gated_train_model.py's gate.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine import train_step as jts
from yolo_master_tpu.nn.mixture_loss import init_aux_ema as jax_init_aux_ema
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_gated_train_model import GATED, METRICS, check_one_step, gated_pair, jax_gated_loss  # noqa: E402
from test_torch_moe_train_model import HYP, _np  # noqa: E402
from test_torch_moe_train_steps import _held, _run_port  # noqa: E402
from test_torch_train_step import _jax_schedules, _jb  # noqa: E402

K = 5
HIGH = 0.5
STEP = 3  # the noise at 0.997 of its scale, the anneal just begun


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def five():
    """Five steps of both packages from the same weights and batches, the port's also in float64."""
    base, jm, params, batches = gated_pair("yolo-master-v0_10-n")
    pol = ts.TrainPolicy(nc=80, epochs=10, nb=100, batch=2, nbs=4, optimizer="SGD")
    assert pol.accumulate == 2
    lr, bias_lr, momentum = _jax_schedules(pol)
    tx = jts.build_optimizer(pol.opt_name, lr, params, momentum=pol.opt_momentum,
                             weight_decay=pol.scaled_weight_decay, momentum_fn=momentum, bias_lr_fn=bias_lr)
    jstate = jts.TrainState(params, tx.init(params), jax.tree_util.tree_map(jnp.copy, params),
                            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32), jax_init_aux_ema())
    jstep = jts.make_train_step(jm, tx=tx, hyp=HYP, accumulate=2)
    jlosses = []
    for b in batches:
        jstate, jmet = jstep(jstate, _jb(b))
        jlosses.append({k: float(jmet[k]) for k in METRICS})
    port, state, losses = _run_port(base, pol, batches, torch.float32)
    port64, state64, _ = _run_port(base, pol, batches, torch.float64)
    own = {k: (v.double() - port64.state_dict()[k]).abs().max().item()
           for k, v in port.state_dict().items() if v.is_floating_point()}
    own_ema = {k: (v.double() - state64.ema_params[k]).abs().max().item() for k, v in state.ema_params.items()}
    return dict(port=port, state=state, jstate=jstate, losses=losses, jlosses=jlosses, own=own, own_ema=own_ema,
                start=state_dict_from_jax(_np(params)))


def test_v0_10_five_steps_match_jax(five):
    """Steps 0-4, accumulate 2: the losses within 1e-5 relative at every step; the
    parameters, BN statistics and EMA after five steps within the module's gate;
    aux_ema within 1e-6 relative; the counters equal."""
    for i, (ref, out) in enumerate(zip(five["jlosses"], five["losses"])):
        for k in METRICS:
            assert abs(out[k] - ref[k]) <= 1e-5 * abs(ref[k]) + 1e-9, (i, k, out[k], ref[k])
        assert out["aux_moe"] > 0
    _held(five["port"].state_dict(), five["jstate"].params, five["start"], five["own"], "params")
    _held(five["state"].ema_params, five["jstate"].ema_params, five["start"], five["own_ema"], "ema")
    np.testing.assert_allclose(five["state"].aux_ema.numpy(), np.asarray(five["jstate"].aux_ema), rtol=1e-6)
    assert five["state"].step == int(five["jstate"].step) == K and five["state"].ema_updates == K
    assert all(five["port"].model[i].step == K - 1 for i in GATED)


@pytest.mark.parametrize("name,setting", [("yolo-master-v0_13-n", ("routing", "expert_dropout", HIGH)),
                                          ("yolo-master-v0_15-n", ("cross_gate", "drop_prob", HIGH))],
                         ids=["v0_13", "v0_15"])
def test_one_step_with_noise_and_dropout_matches_jax(name, setting):
    base, jm, params, batches = gated_pair(name, [setting])
    port = check_one_step(base, jm, params, jax_gated_loss(jm, jnp.float32), batches[0], STEP)
    fired = []
    for i in GATED:
        block = port.model[i]
        router, own = (t.numpy() for t in block.draws(4, "cpu"))  # the step's draws (accumulate 1: B = 4)
        noise = router[:, :block.num_experts]
        assert np.abs(noise).max() > 0  # V2/V3 noise at step 3
        fired.append((router[:, block.num_experts:] == 0.5).any(1) if setting[0] == "routing" else own[:, 0] == 0)
    fired = np.concatenate(fired)
    assert fired.any() and not fired.all(), fired  # the dropout fired on some samples and spared others
