"""The port's training loop in bf16, ``YOLO(...).train()`` with ``amp`` at its
default (True, as in the JAX package), against the JAX package's
DetectionTrainer in fp32 and in bf16, on the CPU.

The setup is tests/test_torch_trainer.py's (the small ES_MOE graph at 64 px
from the port's seeded init with BN calibrated and the class biases at 0, the
synthetic set, 3 epochs of batch 4 accumulated to nbs 8, 'auto' -> AdamW, the
Gini schedule, the EMA's val every epoch, the resume checkpoint every epoch),
with amp left at its default. The final EMA weights are held by the bf16
error statistic of tests/test_torch_train_bf16.py: their distance from the JAX
fp32 trainer's within 1.5x the JAX bf16 trainer's, for the parameters and the
BatchNorm statistics apart. The resume test runs the port alone and is bitwise.
"""

import json

import numpy as np
import pytest
import torch

import jax

from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.engine.trainer import DetectionTrainer
from yolo_master_tpu_torch.utils.checkpoint import load_weights_npz
from yolo_master_tpu_torch.utils.weights import state_dict_from_jax

from test_train import synth_dataset  # noqa: F401 (fixture reuse: 16 train, 8 val 96-px images)
from test_train_trajectory_parity import CFG_MOE  # noqa: E402
from test_torch_trainer import METRICS, RUN, _assert_bitwise, _full_state, _start_weights  # noqa: E402

RUN16 = {k: v for k, v in RUN.items() if k != "amp"}  # amp at its default
STAT = 1.5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(synth_dataset, tmp_path_factory):  # noqa: F811
    """The port's bf16 run and the JAX trainer's fp32 and bf16 runs from the same weights."""
    from yolo_master_tpu.engine.trainer import DetectionTrainer as JaxTrainer

    weights = _start_weights(synth_dataset)
    root = tmp_path_factory.mktemp("trainers_bf16")
    y = YOLO(CFG_MOE, device="cpu").load_state_dict(weights)
    trainer = DetectionTrainer(y, data=synth_dataset, save_dir=str(root / "port"), **RUN16)
    epochs = []
    trainer.callbacks.add("on_fit_epoch_end", lambda e, agg: epochs.append(dict(agg)))
    trainer.train()
    out = {"weights": weights, "port": dict(trainer=trainer, dir=root / "port", epochs=epochs)}

    class Stub:
        pass

    for amp in (False, True):
        jm = JaxDetectionModel(CFG_MOE)
        stub = Stub()
        stub.model = jm
        stub.params = import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), weights, strict=True)
        jt = JaxTrainer(stub, data=synth_dataset, save_dir=str(root / f"jax_amp{amp}"), **{**RUN16, "amp": amp})
        jt.train()
        out[f"jax_amp{amp}"] = dict(trainer=jt, dir=root / f"jax_amp{amp}")
    return out


def _flat(sd, keys):
    return np.concatenate([np.asarray(sd[k], np.float32).ravel() for k in keys])


def test_default_amp_trains_in_bf16_and_its_ema_follows_jax(runs):
    """amp's default trains in bf16: finite epochs, and the final EMA weights'
    distance from the JAX fp32 trainer's within 1.5x the JAX bf16 trainer's,
    parameters and BatchNorm statistics apart; the step counts equal JAX's."""
    p = runs["port"]
    pt = p["trainer"]
    assert pt.compute_dtype == torch.bfloat16
    assert len(p["epochs"]) == 3 and all(np.isfinite(e[k]) and e["finite"] == 1.0 for e in p["epochs"] for k in METRICS)
    j32, j16 = (runs[f"jax_amp{a}"]["trainer"] for a in (False, True))
    assert pt.state.step == int(j32.state.step) == int(j16.state.step) == 6
    ema32, ema16 = (state_dict_from_jax(jax.tree_util.tree_map(np.asarray, t.state.ema_params)) for t in (j32, j16))
    port = {k: v.numpy() for k, v in pt.state.ema_params.items()}
    params = sorted(n for n, _ in pt.model.named_parameters())
    stats = sorted(k for k in port if k.endswith(("running_mean", "running_var")))
    start = {k: v.numpy() for k, v in runs["weights"].items()}
    for what, keys in (("parameters", params), ("BN statistics", stats)):
        ref = _flat(ema32, keys)
        assert np.linalg.norm(ref - _flat(start, keys)) > 0  # the EMA moved
        own, dist = np.linalg.norm(_flat(ema16, keys) - ref), np.linalg.norm(_flat(port, keys) - ref)
        assert 0 < own and dist <= STAT * own, (what, dist, own)


def test_bf16_run_writes_fp32_checkpoints_and_jax_columns(runs):
    """last.npz, best.npz and the resume checkpoint hold fp32 weights (the EMA,
    as JAX's do); results.csv's columns are the JAX bf16 trainer's."""
    d = runs["port"]["dir"]
    for name in ("last.npz", "best.npz"):
        sd, _ = load_weights_npz(d / name)
        assert {v.dtype for v in sd.values()} == {torch.float32, torch.int64}, name
    sd, _ = load_weights_npz(d / "last.npz")
    for k, v in runs["port"]["trainer"].state.ema_params.items():
        assert torch.equal(sd[k], v), k
    snap = torch.load(d / "state" / "train_state.pt", weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int64) for v in snap["model"].values())
    head = [(x / "results.csv").read_text().splitlines()[0] for x in (d, runs["jax_ampTrue"]["dir"])]
    assert head[0].split(",") == head[1].split(",")
    assert json.loads((d / "state_meta.json").read_text())["epoch"] == 3


def test_bf16_resume_equals_uninterrupted_bitwise(synth_dataset, tmp_path):  # noqa: F811
    """In bf16: 4 epochs saved every 2, interrupted in epoch 3, resumed == 4
    epochs uninterrupted, parameters, EMA, optimizer buffers, counters and
    aux_ema bitwise (the CPU's bf16 is repeatable)."""
    weights = _start_weights(synth_dataset)
    kw = dict(RUN16, epochs=4, save_period=2, val=False, close_mosaic=0, moe_schedule=None, workers=0)

    def trainer(save_dir, **over):
        y = YOLO(CFG_MOE, device="cpu").load_state_dict(weights)
        return DetectionTrainer(y, data=synth_dataset, save_dir=str(save_dir), **{**kw, **over})

    full = trainer(tmp_path / "full")
    full.train()
    part = trainer(tmp_path / "part")
    fire = part.callbacks.fire

    def crash(event, *a):
        fire(event, *a)
        if event == "on_fit_epoch_end" and a[0] == 2:
            raise KeyboardInterrupt("interrupted in epoch 3")

    part.callbacks.fire = crash
    with pytest.raises(KeyboardInterrupt):
        part.train()
    resumed = trainer(tmp_path / "part", resume=True)
    assert resumed.compute_dtype == torch.bfloat16 and resumed.start_epoch == 2 and resumed.state.step == 4
    resumed.train()
    assert (resumed.state.step, resumed.state.opt_state.count, resumed.state.ema_updates) == \
           (full.state.step, full.state.opt_state.count, full.state.ema_updates) == (8, 8, 8.0)
    assert torch.equal(resumed.state.aux_ema, full.state.aux_ema)
    _assert_bitwise(_full_state(resumed), _full_state(full))
