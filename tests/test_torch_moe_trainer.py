"""yolo-master-v0_1-n through the port's training loop against the JAX package's
DetectionTrainer, on the CPU.

The setup of tests/test_torch_trainer.py (its synthetic set at 64 px, 3
epochs of batch 4 accumulated to nbs 8, so 2 optimizer steps an epoch;
mosaic closed for the last epoch; the Gini schedule of the MoE gain; the
resume checkpoint every epoch; the port validates the EMA every epoch, JAX's
trainer, whose val does not touch the trajectory, does not), on v0_1-n from
the port's seeded init (BN calibrated on a train batch, the class biases at
0), with warmup_steps 4 and dropout_interval 4 on the three routed blocks of
both packages: over the six steps k falls from E to 2 and step 4 drops
experts. The optimizer is SGD, not 'auto' (AdamW): AdamW's first steps move
each element by about +-lr whatever its gradient's size, so an element whose
gradient is rounding noise (the BN biases of the A2C2f attention, 84 of 384
signs of a qkv BN bias's gradient differ between the two fp32 programs)
moves by +-lr in either program, and step 1's box loss already differed
8.5e-5 relative (under SGD 9e-6).

Tolerances are tests/test_torch_trainer.py's (losses 1e-5 relative per
epoch; the final EMA and parameters within 1e-6 + 2e-4 x each tensor's move;
each routed block's mean usage within 1e-6), each widened to 8x the port's
own distance from its float64 run of the same loop where that is larger (PR
13's whole-model gradient gate, tests/test_torch_train_step.py), as
tests/test_torch_moe_train_steps.py does: on v0_1-n the fp32 rounding of six
whole-model steps reaches past them (measured, port vs JAX: the first BN's
bias, at the warmup bias lr of 0.1, 5.5x the parameter gate, and the port's
fp32 run lies up to 3.7x that gate from its fp64 run; layer 11's usage 6.1e-6
apart; where the own distance sets the bound, the largest ratio to it is 4.7,
a BN variance of the P4 head). The routing history's rows come in JAX's
order, sorted by block path. The resumes and the amp run are the port's
alone; resume is bitwise.
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
from test_torch_trainer import METRICS, _assert_bitwise, _full_state, _record  # noqa: E402

NAME = "yolo-master-v0_1-n"
ROUTED = (5, 8, 11)
EPOCHS = 3
OWN = 8  # x the port's own fp32-vs-fp64 distance (module docstring)
RUN = dict(epochs=EPOCHS, batch=4, nbs=8, imgsz=64, max_gt=16, amp=False, close_mosaic=1, moe_schedule="gini",
           val=True, save_period=1, workers=2, seed=0, optimizer="SGD")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _short_schedule(blocks) -> None:
    for m in blocks:
        m.warmup_steps, m.dropout_interval = 4, 4


def _yolo(weights=None):
    y = YOLO(NAME, device="cpu")
    if weights is not None:
        y.load_state_dict(weights)
    _short_schedule(y.model.model[i] for i in ROUTED)
    return y


@pytest.fixture(scope="module")
def start(synth_dataset):  # noqa: F811
    """The port's seeded init, BN calibrated on the first train batch, class biases at 0."""
    y = _yolo()
    ds = YOLODataset(synth_dataset, split="train", imgsz=64, max_gt=16)
    calibrate_bn(y.model, torch.from_numpy(next(DataLoader(ds, 8, images=np.float32).epoch())["images"]))
    with torch.no_grad():
        for branch in y.model.head.cv3:
            branch[-1].bias.zero_()
    return {k: v.clone() for k, v in y.model.state_dict().items()}


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

    root = tmp_path_factory.mktemp("v01_trainers")
    out = {"port": _port_run(synth_dataset, start, root / "port"),
           "port64": _port_run(synth_dataset, start, root / "port64", torch.float64)}

    class Stub:
        pass

    jm = JaxDetectionModel(NAME)
    _short_schedule(jm.layers[i] for i in ROUTED)
    stub = Stub()
    stub.model = jm
    stub.params = jax_params_of(jm, _yolo(start).model)
    jt = JaxTrainer(stub, data=synth_dataset, save_dir=str(root / "jax"), **{**RUN, "val": False})
    jlog = {"epochs": [], "val": []}
    _record(jt, jlog)
    jt.train()
    out["jax"] = dict(trainer=jt, log=jlog, dir=root / "jax")
    return out


def _held(port_sd, ref_sd, own_sd, start_sd, what):
    """Every floating tensor within max(1e-6 + 2e-4 x its move, OWN x its own fp32-vs-fp64 distance)."""
    for k, ref in ref_sd.items():
        if not ref.is_floating_point():
            continue
        move = (ref - start_sd[k]).abs().max().item()
        err = (port_sd[k] - ref).abs().max().item()
        own = (port_sd[k].double() - own_sd[k]).abs().max().item()
        assert err <= max(1e-6 + 2e-4 * move, OWN * own), (what, k, err, move, own)


def test_v0_1_loop_follows_jax(runs, start):
    """Six steps (k annealing, step 4 a dropout step): the epoch losses, the final
    EMA and parameters, the MoE gain and each routed block's usage within the
    module's tolerances; results.csv's columns the JAX trainer's."""
    p, p64, j = runs["port"], runs["port64"], runs["jax"]
    pt, jt = p["trainer"], j["trainer"]
    assert pt.state.step == int(jt.state.step) == EPOCHS * 2 and pt.policy.opt_name == "SGD"
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
    assert set(pu) == set(ju) == {f"layers.{i}" for i in ROUTED}
    for path in pu:
        err, own = np.abs(pu[path] - ju[path]).max(), np.abs(pu[path] - ou[path]).max()
        assert err <= max(1e-6, OWN * own), (path, err, own)
    rows = [[(r["epoch"], r["block"]) for r in t.routing_history.rows] for t in (pt, jt)]
    assert rows[0] == rows[1], rows
    pcsv, jcsv = [(x["dir"] / "results.csv").read_text().splitlines() for x in (p, j)]
    assert pcsv[0].split(",") == jcsv[0].split(",") and len(pcsv) == len(jcsv) == EPOCHS + 1, (pcsv[0], jcsv[0])
    assert len(p["log"]["val"]) == EPOCHS, p["log"]["val"]  # the EMA's val ran every epoch (sparse eval, NMS)


def _resumed_equals_uninterrupted(data, start, tmp_path, **kw):
    """3 epochs saved every epoch, interrupted in epoch 2, resumed from epoch 1: the
    same parameters, EMA, optimizer buffers, counters and aux_ema, bitwise, as
    the uninterrupted run (whose steps 4 and 5 the resumed run draws anew)."""
    kw = dict(epochs=3, batch=4, nbs=8, imgsz=64, max_gt=16, save_period=1, val=False, close_mosaic=0,
              moe_schedule=None, workers=0, seed=0, **kw)
    full = DetectionTrainer(_yolo(start), data=data, save_dir=str(tmp_path / "full"), **kw)
    full.train()
    part = DetectionTrainer(_yolo(start), data=data, save_dir=str(tmp_path / "part"), **kw)
    fire = part.callbacks.fire

    def crash(event, *a):
        fire(event, *a)
        if event == "on_fit_epoch_end" and a[0] == 1:
            raise KeyboardInterrupt("interrupted in epoch 2")

    part.callbacks.fire = crash
    with pytest.raises(KeyboardInterrupt):
        part.train()
    resumed = DetectionTrainer(_yolo(start), data=data, save_dir=str(tmp_path / "part"), resume=True, **kw)
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    resumed.train()
    assert resumed.state.step == full.state.step == 6
    assert torch.equal(resumed.state.aux_ema, full.state.aux_ema)
    _assert_bitwise(_full_state(resumed), _full_state(full))
    return full


def test_v0_1_fp32_resume_equals_uninterrupted_bitwise(synth_dataset, start, tmp_path):  # noqa: F811
    _resumed_equals_uninterrupted(synth_dataset, start, tmp_path, amp=False)


def test_v0_1_amp_default_run_is_finite_fp32_and_resumes_bitwise(synth_dataset, start, tmp_path):  # noqa: F811
    """``amp`` at its default (bf16): finite losses, fp32 EMA weights in
    last.npz that name their graph, and a bitwise resume."""
    full = _resumed_equals_uninterrupted(synth_dataset, start, tmp_path)
    assert full.compute_dtype == torch.bfloat16
    rows = (tmp_path / "full" / "results.csv").read_text().splitlines()
    assert len(rows) == 4 and all(np.isfinite(float(x)) for r in rows[1:] for x in r.split(",")[1:])
    sd, meta = load_weights_npz(tmp_path / "full" / "last.npz")
    assert meta["model"] == NAME and all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    for k, v in full.state.ema_params.items():
        assert torch.equal(sd[k], v), k
