"""yolo-master-v0_10-n through the port's training loop and MultiTrainer against
the JAX package's, on the CPU.

The setup of tests/test_torch_moe_trainer.py (tests/test_train.py's synthetic
set at 64 px, batch 4 accumulated to nbs 8, so 2 optimizer steps an epoch;
the Gini schedule of the MoE gain; SGD, as there; the resume checkpoint every
epoch), on v0_10-n from the port's seeded init (BN calibrated on a train
batch, the class biases at 0): one epoch of both trainers, each validating
its EMA. Its tolerances: the epoch's losses within 1e-5 relative, the final
EMA and parameters within 1e-6 + 2e-4 x each tensor's move, each gated
block's mean usage within 1e-6, each widened to 8x the port's own distance
from its float64 run of the same loop where that is larger; val metrics
within 1e-3 (tests/test_torch_validator.py's gate). The resume runs the
port alone, with ``amp`` at its default (bf16), and is bitwise. MultiTrainer
over two yamls with the loop's settings: its first run's val metrics within
1e-3 of the JAX trainer's on that set, the second finite, the base weights
restored bitwise.
"""

import numpy as np
import pytest
import torch

import jax

from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.data.dataset import DataLoader, YOLODataset
from yolo_master_tpu_torch.engine import train_step
from yolo_master_tpu_torch.engine import trainer as trainer_module
from yolo_master_tpu_torch.engine.trainer import DetectionTrainer
from yolo_master_tpu_torch.utils.checkpoint import load_weights_npz
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from _torch_scale import jax_params_of  # noqa: E402 (tests/ is on the path)
from test_train import synth_dataset  # noqa: F401 (fixture reuse: 16 train, 8 val 96-px images)
from test_torch_moe_trainer import OWN, _held  # noqa: E402
from test_torch_multitrainer import _other_set  # noqa: E402
from test_torch_trainer import METRICS, VAL_METRICS, _assert_bitwise, _full_state, _record  # noqa: E402

NAME = "yolo-master-v0_10-n"
GATED = (5, 8, 11)
RUN = dict(epochs=1, batch=4, nbs=8, imgsz=64, max_gt=16, amp=False, close_mosaic=0, moe_schedule="gini",
           val=True, save_period=1, workers=2, seed=0, optimizer="SGD")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def start(synth_dataset):  # noqa: F811
    """The port's seeded init, BN calibrated on the first train batch, class biases at 0."""
    y = YOLO(NAME, device="cpu")
    ds = YOLODataset(synth_dataset, split="train", imgsz=64, max_gt=16)
    calibrate_bn(y.model, torch.from_numpy(next(DataLoader(ds, 8, images=np.float32).epoch())["images"]))
    with torch.no_grad():
        for branch in y.model.head.cv3:
            branch[-1].bias.zero_()
    return {k: v.clone() for k, v in y.model.state_dict().items()}


def _yolo(start):
    return YOLO(NAME, device="cpu").load_state_dict(start)


class _Stub:
    task = "detect"


def _jax_stub(start):
    stub = _Stub()
    stub.model = JaxDetectionModel(NAME)
    stub.params = jax_params_of(stub.model, _yolo(start).model)
    return stub


def _port_run(data, start, save_dir, dtype=torch.float32):
    """The port's loop from ``start``; in float64 (the own-rounding reference) on a
    float64 copy of the model, through the same trainer, without val."""
    y = _yolo(start)
    if dtype == torch.float32:
        trainer = DetectionTrainer(y, data=data, save_dir=str(save_dir), **RUN)
    else:
        y.model.double()
        allowed = train_step.COMPUTE_DTYPES
        train_step.COMPUTE_DTYPES = trainer_module.COMPUTE_DTYPES = allowed + (dtype,)
        try:
            trainer = DetectionTrainer(y, data=data, save_dir=str(save_dir), **{**RUN, "val": False},
                                       compute_dtype=dtype)
        finally:
            train_step.COMPUTE_DTYPES = trainer_module.COMPUTE_DTYPES = allowed
    log = {"epochs": [], "val": []}
    _record(trainer, log)
    trainer.train()
    return dict(yolo=y, trainer=trainer, log=log, dir=save_dir)


@pytest.fixture(scope="module")
def runs(synth_dataset, start, tmp_path_factory):  # noqa: F811
    from yolo_master_tpu.engine.trainer import DetectionTrainer as JaxTrainer

    root = tmp_path_factory.mktemp("v10_trainers")
    out = {"port": _port_run(synth_dataset, start, root / "port"),
           "port64": _port_run(synth_dataset, start, root / "port64", torch.float64)}
    jt = JaxTrainer(_jax_stub(start), data=synth_dataset, save_dir=str(root / "jax"), **RUN)
    jlog = {"epochs": [], "val": []}
    _record(jt, jlog)
    jt.train()
    out["jax"] = dict(trainer=jt, log=jlog, dir=root / "jax")
    return out


def test_v0_10_loop_follows_jax(runs, start):
    """One epoch, two optimizer steps: the losses, the final EMA and parameters,
    the MoE gain and each gated block's usage within the module's tolerances;
    the EMA's val within 1e-3 of JAX's; results.csv's columns the JAX trainer's."""
    p, p64, j = runs["port"], runs["port64"], runs["jax"]
    pt, jt = p["trainer"], j["trainer"]
    assert pt.state.step == int(jt.state.step) == 2 and pt.policy.opt_name == "SGD"
    for (e, pm, pg), (_, om, og), (_, jm, jg) in zip(p["log"]["epochs"], p64["log"]["epochs"], j["log"]["epochs"]):
        assert set(pm) == set(jm), set(pm) ^ set(jm)
        for k in METRICS:
            assert abs(pm[k] - jm[k]) <= max(1e-5 * abs(jm[k]), OWN * abs(pm[k] - om[k])), (e, k, pm[k], jm[k], om[k])
        assert pm["aux_moe"] > 0 and abs(pg - jg) <= max(1e-6, OWN * abs(pg - og)), (e, pg, jg, og)
    jstate = jax.tree_util.tree_map(np.asarray, jt.state)
    ot = p64["trainer"]
    _held(pt.last_weights, state_dict_from_jax(jstate.params), ot.last_weights, start, "parameters")
    _held(pt.state.ema_params, state_dict_from_jax(jstate.ema_params), ot.state.ema_params, start, "EMA")
    pu, ju, ou = (t.usage_tracker.mean_usage() for t in (pt, jt, ot))
    assert set(pu) == set(ju) == {f"layers.{i}" for i in GATED}
    for path in pu:
        err, own = np.abs(pu[path] - ju[path]).max(), np.abs(pu[path] - ou[path]).max()
        assert err <= max(1e-6, OWN * own), (path, err, own)
    rows = [[(r["epoch"], r["block"]) for r in t.routing_history.rows] for t in (pt, jt)]
    assert rows[0] == rows[1], rows
    assert len(p["log"]["val"]) == len(j["log"]["val"]) == 1
    for k in VAL_METRICS:
        pm, jm = p["log"]["val"][0][k], j["log"]["val"][0][k]
        assert np.isfinite(pm) and abs(pm - jm) <= 1e-3, (k, pm, jm)
    pcsv, jcsv = [(x["dir"] / "results.csv").read_text().splitlines() for x in (p, j)]
    assert pcsv[0].split(",") == jcsv[0].split(",") and len(pcsv) == len(jcsv) == 2


def test_v0_10_amp_run_resumes_bitwise(synth_dataset, start, tmp_path):  # noqa: F811
    """``amp`` at its default (bf16), 2 epochs saved every epoch, interrupted in
    epoch 2 and resumed from epoch 1: the same parameters, EMA, optimizer
    buffers, counters and aux_ema, bitwise, as the uninterrupted run (the
    resumed steps draw their temperatures and routings anew); finite losses
    and fp32 EMA weights in last.npz that name the graph."""
    kw = dict(epochs=2, batch=4, nbs=8, imgsz=64, max_gt=16, save_period=1, val=False, close_mosaic=0,
              moe_schedule=None, workers=0, seed=0)
    full = DetectionTrainer(_yolo(start), data=synth_dataset, save_dir=str(tmp_path / "full"), **kw)
    assert full.compute_dtype == torch.bfloat16
    full.train()
    part = DetectionTrainer(_yolo(start), data=synth_dataset, save_dir=str(tmp_path / "part"), **kw)
    fire = part.callbacks.fire

    def crash(event, *a):
        fire(event, *a)
        if event == "on_fit_epoch_end" and a[0] == 1:
            raise KeyboardInterrupt("interrupted in epoch 2")

    part.callbacks.fire = crash
    with pytest.raises(KeyboardInterrupt):
        part.train()
    resumed = DetectionTrainer(_yolo(start), data=synth_dataset, save_dir=str(tmp_path / "part"), resume=True, **kw)
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    resumed.train()
    assert resumed.state.step == full.state.step == 4
    assert torch.equal(resumed.state.aux_ema, full.state.aux_ema)
    _assert_bitwise(_full_state(resumed), _full_state(full))
    rows = (tmp_path / "full" / "results.csv").read_text().splitlines()
    assert len(rows) == 3 and all(np.isfinite(float(x)) for r in rows[1:] for x in r.split(",")[1:])
    sd, meta = load_weights_npz(tmp_path / "full" / "last.npz")
    assert meta["model"] == NAME and all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())


def test_v0_10_multitrainer_follows_jax(runs, synth_dataset, start, tmp_path):  # noqa: F811
    """YOLO(v0_10-n).train(data=[a, b]) with the loop's settings: run "data" is
    the loop's run, its val metrics within 1e-3 of the JAX trainer's on that set
    (the runs fixture), run "other" finite on the second set, and the facade's
    model the base again, bitwise."""
    datasets = [synth_dataset, _other_set(tmp_path / "other")]
    y = _yolo(start)
    port = y.train(data=datasets, save_dir=str(tmp_path / "port"), **RUN)
    assert list(port) == ["data", "other"]
    jval = runs["jax"]["log"]["val"][0]
    for k in VAL_METRICS:
        assert abs(port["data"][k] - jval[k]) <= 1e-3, (k, port["data"][k], jval[k])
        assert np.isfinite(port["other"][k]), k
    assert not y.model.training
    for k, v in y.model.state_dict().items():
        assert torch.equal(v, start[k]), k
