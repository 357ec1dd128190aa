"""yolo-master-v0_1-n's five-step fp32 trajectory in the port against JAX's
make_train_step, on the CPU, and JAX TrainStates carried into the port mid-run.

The setup of tests/test_torch_moe_train_model.py (warmup_steps 4 and
dropout_interval 4 on every routed block: over steps 0-4 k falls from E to 2,
and step 4 drops experts; the port's seeded init, BN calibrated, 64 px,
batches of 4), SGD inside the trainer's warmup, accumulate 2 (micro-batches
of 2).

Tolerance. PR 13's trajectory gate holds every parameter, BN statistic and
EMA entry within 1e-6 + 2e-5 x its largest move over the run. On v0_1-n at
64 px the port's own fp32 rounding reaches past it: the port's fp32 run lies
up to 1.7x that gate from the port's fp64 run (measured), and JAX's fp32 run
up to 1.25x that gate from the port's fp32 one; the worst tensors are BN
running variances of the P5 head, taken over the 2x2 maps of a micro-batch
of two (eight values a channel), and the first BNs' biases, which move at
the warmup bias lr. So each tensor is held within the larger of that gate
and 8x its own fp32-vs-fp64 distance (PR 13's whole-model gradient gate,
tests/test_torch_train_step.py; the largest measured ratio of the
port-vs-JAX distance to that own distance, where it sets the bound, is 2.5). A wrong
rule (a draw on the wrong step, the counts taken before dropout, a second BN
update) moves a tensor by a large share of its move. The losses: 1e-5
relative at every step.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.engine import train_step as jts
from yolo_master_tpu.nn.mixture_loss import init_aux_ema as jax_init_aux_ema
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.nn.tasks import DetectionModel
from yolo_master_tpu_torch.utils.weights import state_dict_from_jax, train_state_from_jax

from test_torch_moe_train_model import HYP, K, METRICS, NAME, ROUTED, _np, _short_schedule  # noqa: E402
from test_torch_moe_train_model import v01  # noqa: E402,F401 (the module fixture)
from test_torch_train_step import _jax_schedules, _jb, _tb  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run_port(base, pol, batches, dtype):
    """The port's five steps from ``base``'s weights in ``dtype`` (float64: the
    own-rounding reference, through the same train step)."""
    port = copy.deepcopy(base).to(dtype)
    ptx = pol.build_optimizer(port)
    state = ts.make_train_state(port, ptx)
    allowed = ts.COMPUTE_DTYPES
    ts.COMPUTE_DTYPES = allowed + (torch.float64,)
    try:
        step = ts.make_train_step(port, ptx, hyp=HYP, accumulate=2, compute_dtype=dtype)
    finally:
        ts.COMPUTE_DTYPES = allowed
    losses = []
    for b in batches:
        tb = {k: v.to(dtype) if v.is_floating_point() else v for k, v in _tb(b).items()}
        state, met = step(state, tb)
        losses.append({k: float(met[k]) for k in METRICS})
    return port, state, losses


@pytest.fixture(scope="module")
def five(v01):  # noqa: F811
    """Five steps of both packages from the same weights and batches, the
    port's also in float64; JAX's states after steps 2 and 4 kept."""
    pol = ts.TrainPolicy(nc=80, epochs=10, nb=100, batch=2, nbs=4, optimizer="SGD")
    assert pol.accumulate == 2
    lr, bias_lr, momentum = _jax_schedules(pol)
    params = v01["params"]
    tx = jts.build_optimizer(pol.opt_name, lr, params, momentum=pol.opt_momentum,
                             weight_decay=pol.scaled_weight_decay, momentum_fn=momentum, bias_lr_fn=bias_lr)
    jstate = jts.TrainState(params, tx.init(params), jax.tree_util.tree_map(jnp.copy, params),
                            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32), jax_init_aux_ema())
    jstep = jts.make_train_step(v01["jm"], tx=tx, hyp=HYP, accumulate=2)
    jlosses, mids = [], {}
    for i, b in enumerate(v01["batches"]):
        jstate, jmet = jstep(jstate, _jb(b))
        jlosses.append({k: float(jmet[k]) for k in METRICS})
        if i + 1 in (2, 4):
            mids[i + 1] = _np(jstate)
    port, state, losses = _run_port(v01["base"], pol, v01["batches"], torch.float32)
    port64, state64, _ = _run_port(v01["base"], pol, v01["batches"], torch.float64)
    own = {k: (v.double() - port64.state_dict()[k]).abs().max().item()
           for k, v in port.state_dict().items() if v.is_floating_point()}
    own_ema = {k: (v.double() - state64.ema_params[k]).abs().max().item() for k, v in state.ema_params.items()}
    return dict(pol=pol, port=port, state=state, jstate=jstate, losses=losses, jlosses=jlosses, mids=mids,
                own=own, own_ema=own_ema, start=state_dict_from_jax(_np(params)))


def _held(port_sd, jax_tree, start_sd, own, what):
    """Every floating tensor within max(1e-6 + 2e-5 x its move, 8 x its own fp32-vs-fp64 distance)."""
    ref = state_dict_from_jax(_np(jax_tree))
    for k, v in port_sd.items():
        if not v.is_floating_point():
            continue
        move = (ref[k] - start_sd[k]).abs().max().item()
        err = (v - ref[k]).abs().max().item()
        assert err <= max(1e-6 + 2e-5 * move, 8 * own[k]), (what, k, err, move, own[k])


def test_five_steps_match_jax(five):
    """Steps 0-4, accumulate 2: the losses within 1e-5 relative at every step;
    the parameters, BN statistics and EMA after five steps within the module's
    gate; aux_ema within 1e-6 relative; the counters equal."""
    for i, (ref, out) in enumerate(zip(five["jlosses"], five["losses"])):
        for k in METRICS:
            assert abs(out[k] - ref[k]) <= 1e-5 * abs(ref[k]) + 1e-9, (i, k, out[k], ref[k])
    _held(five["port"].state_dict(), five["jstate"].params, five["start"], five["own"], "params")
    _held(five["state"].ema_params, five["jstate"].ema_params, five["start"], five["own_ema"], "ema")
    np.testing.assert_allclose(five["state"].aux_ema.numpy(), np.asarray(five["jstate"].aux_ema), rtol=1e-6)
    assert five["state"].step == int(five["jstate"].step) == K and five["state"].ema_updates == K


@pytest.mark.parametrize("at", [2, 4], ids=["inside_warmup", "before_dropout_step"])
def test_jax_state_carried_mid_run_continues_in_step(five, v01, at):  # noqa: F811
    """JAX's fp32 TrainState after ``at`` steps into a fresh port model
    (train_state_from_jax): the port's remaining steps (from ``at`` = 4 the
    one left is the dropout step) land within the module's gate of JAX's
    state after five."""
    port = DetectionModel(NAME)
    _short_schedule(port.model[i] for i in ROUTED)
    ptx = five["pol"].build_optimizer(port)
    state = train_state_from_jax(five["mids"][at], port, ptx)
    assert state.step == at and state.opt_state.count == at
    step = ts.make_train_step(port, ptx, hyp=HYP, accumulate=2)
    for b in v01["batches"][at:]:
        state, _ = step(state, _tb(b))
    assert all((m.dropped_experts().size > 0) for m in (port.model[i] for i in ROUTED))  # step 4 was the last
    _held(port.state_dict(), five["jstate"].params, five["start"], five["own"], "params")
    _held(state.ema_params, five["jstate"].ema_params, five["start"], five["own_ema"], "ema")
