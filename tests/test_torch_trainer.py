"""The port's training loop (yolo_master_tpu_torch/engine/trainer.py) against the
JAX package's DetectionTrainer, on the CPU in fp32.

Both trainers run once per module, from the same weights (the port's seeded
init of the small ES_MOE graph of tests/test_train_trajectory_parity.py,
BatchNorm calibrated on a train batch and the class biases at 0, so that the
val finds candidates above conf 0.001), on tests/test_train.py's synthetic
set at 64 px: 3 epochs of batch 4 accumulated to nbs 8 (2 optimizer steps an
epoch), the default augmentations with mosaic closed for the last epoch,
'auto' -> AdamW inside the warmup, the Gini schedule of the MoE gain, val of
the EMA weights every epoch, and the resume checkpoint every epoch. Every
parity test reads those two runs.

Tolerances. Losses 1e-5 relative per epoch (tests/test_torch_train_step.py's
gate). The EMA and the parameters after the run: within 1e-6 + 2e-4 x the
tensor's largest move over the run, ten times the five-step SGD/AdamW gate of
tests/test_torch_train_step.py. Here 'auto' gives AdamW, whose update divides
each gradient by its own running RMS, so a gradient's relative rounding error,
not its absolute one, reaches the update; the BatchNorm biases, at the bias
group's warmup lr of 0.1, have gradients that are small sums of large terms
of both signs. Measured: the worst tensors are BN biases at 8.8e-5 of their
move (4.6e-5 on moves of 0.5), every other tensor below 2e-5; the losses of
the same runs agree to 1e-6 relative. A wrong rule (a lost or repeated step,
the decay on the wrong group, a second BN update) moves a tensor by a sixth
of its move or more. The MoE gain
and the routing usage within 1e-6 (the usage is a batch mean of softmax
weights near 1/4; the history's rows round it to 5 decimals, as both
packages write them). Val metrics within 1e-3 (tests/test_torch_validator.py's
gate). The resume, recovery and refusal tests run the port alone; resume is
bitwise.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_master_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_master_tpu.utils.torch_import import import_state_dict
from yolo_master_tpu_torch import YOLO
from yolo_master_tpu_torch.data.dataset import DataLoader, YOLODataset
from yolo_master_tpu_torch.engine import train_step as ts
from yolo_master_tpu_torch.engine.recovery import TrainingRecoveryController
from yolo_master_tpu_torch.engine.trainer import DetectionTrainer
from yolo_master_tpu_torch.utils.checkpoint import load_weights_npz
from yolo_master_tpu_torch.utils.weights import calibrate_bn, state_dict_from_jax

from test_train import synth_dataset  # noqa: F401 (fixture reuse: 16 train, 8 val 96-px images)
from test_train_trajectory_parity import CFG_MOE  # noqa: E402

EPOCHS = 3
METRICS = ("loss", "box_loss", "cls_loss", "dfl_loss", "aux_loss")
VAL_METRICS = ("precision", "recall", "mAP50", "mAP50-95", "fitness")
RUN = dict(epochs=EPOCHS, batch=4, nbs=8, imgsz=64, max_gt=16, amp=False, close_mosaic=1, moe_schedule="gini",
           val=True, save_period=1, workers=2, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _start_weights(data):
    """The port's seeded init, BN calibrated on the first train batch, class biases at 0."""
    y = YOLO(CFG_MOE, device="cpu")
    ds = YOLODataset(data, split="train", imgsz=64, max_gt=16)
    calibrate_bn(y.model, torch.from_numpy(next(DataLoader(ds, 8, images=np.float32).epoch())["images"]))
    with torch.no_grad():
        for branch in y.model.head.cv3:
            branch[-1].bias.zero_()
    return {k: v.clone() for k, v in y.model.state_dict().items()}


def _record(trainer, log):
    """Each epoch's metrics and the MoE gain after the schedule, and each val's metrics."""
    trainer.callbacks.add("on_fit_epoch_end",
                          lambda epoch, agg: log["epochs"].append((epoch, dict(agg), float(trainer.moe_gain))))
    if trainer.validator is not None:
        inner = trainer.validator

        def val(**kw):
            out = inner(**kw)
            log["val"].append({k: float(out[k]) for k in VAL_METRICS})
            return out

        trainer.validator = val


def _port_trainer(data, weights, save_dir, **over):
    y = YOLO(CFG_MOE, device="cpu").load_state_dict(weights)
    return y, DetectionTrainer(y, data=data, save_dir=str(save_dir), **{**RUN, **over})


@pytest.fixture(scope="module")
def runs(synth_dataset, tmp_path_factory):  # noqa: F811
    from yolo_master_tpu.engine.trainer import DetectionTrainer as JaxTrainer

    weights = _start_weights(synth_dataset)
    out = {"weights": weights}
    root = tmp_path_factory.mktemp("trainers")
    y, trainer = _port_trainer(synth_dataset, weights, root / "port")
    log = {"epochs": [], "val": []}
    _record(trainer, log)
    trainer.train()
    out["port"] = dict(yolo=y, trainer=trainer, log=log, dir=root / "port")

    class Stub:
        pass

    jm = JaxDetectionModel(CFG_MOE)
    stub = Stub()
    stub.model = jm
    stub.params = import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), weights, strict=True)
    jt = JaxTrainer(stub, data=synth_dataset, save_dir=str(root / "jax"), **RUN)
    jlog = {"epochs": [], "val": []}
    _record(jt, jlog)
    jt.train()
    out["jax"] = dict(trainer=jt, log=jlog, dir=root / "jax", model=jm)
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the loop against the JAX package's ----------------------------------------------------------

def test_trainer_policy_and_epoch_losses_follow_jax(runs):
    p, j = runs["port"], runs["jax"]
    pt, jt = p["trainer"], j["trainer"]
    assert (pt.accumulate, pt.nb_opt, pt.policy.warmup_steps) == (jt.accumulate, jt.nb_opt, 100) == (2, 2, 100)
    assert pt.policy.opt_name == "AdamW" and pt.state.step == int(jt.state.step) == EPOCHS * 2
    assert pt.state.opt_state.count == EPOCHS * 2 and pt.state.ema_updates == float(jt.state.ema_updates)
    assert [e for e, _, _ in p["log"]["epochs"]] == [e for e, _, _ in j["log"]["epochs"]] == list(range(EPOCHS))
    for (e, pm, _), (_, jm, _) in zip(p["log"]["epochs"], j["log"]["epochs"]):
        assert set(pm) == set(jm), (set(pm) ^ set(jm))
        for k in METRICS:
            assert abs(pm[k] - jm[k]) <= 1e-5 * max(abs(jm[k]), 1e-12), (e, k, pm[k], jm[k])
        assert pm["finite"] == jm["finite"] == 1.0
    assert not pt.train_set.mosaic_enabled and not jt.train_set.mosaic_enabled  # closed for the last epoch


def test_moe_gain_and_routing_history_follow_jax(runs):
    p, j = runs["port"], runs["jax"]
    pg = [g for _, _, g in p["log"]["epochs"]]
    jg = [g for _, _, g in j["log"]["epochs"]]
    assert np.allclose(pg, jg, rtol=0, atol=1e-6) and pg[0] != 0.01  # the Gini rule moved it
    prow, jrow = p["trainer"].routing_history.rows, j["trainer"].routing_history.rows
    assert [(r["epoch"], r["block"]) for r in prow] == [(r["epoch"], r["block"]) for r in jrow]
    assert [r["block"] for r in prow] == ["layers.2"] * EPOCHS
    for a, b in zip(prow, jrow):
        assert abs(a["gini"] - b["gini"]) <= 1e-6
        assert np.allclose(json.loads(a["usage"]), json.loads(b["usage"]), rtol=0, atol=1e-5 + 1e-6)
    pu, ju = p["trainer"].usage_tracker.mean_usage(), j["trainer"].usage_tracker.mean_usage()
    assert set(pu) == set(ju) == {"layers.2"}
    np.testing.assert_allclose(pu["layers.2"], ju["layers.2"], rtol=0, atol=1e-6)
    csv_p = (p["dir"] / "routing_history.csv").read_text().splitlines()
    assert csv_p[0] == (j["dir"] / "routing_history.csv").read_text().splitlines()[0] and len(csv_p) == EPOCHS + 1


def test_val_of_the_ema_follows_jax(runs):
    p, j = runs["port"], runs["jax"]
    assert len(p["log"]["val"]) == len(j["log"]["val"]) == EPOCHS
    for e, (pm, jm) in enumerate(zip(p["log"]["val"], j["log"]["val"])):
        for k in VAL_METRICS:
            assert np.isfinite(pm[k]) and abs(pm[k] - jm[k]) <= 1e-3, (e, k, pm[k], jm[k])
    assert max(m["recall"] for m in p["log"]["val"]) > 0  # detections are matched, not 0 against 0


def _held(port_sd, ref_sd, start_sd, what):
    """Every floating tensor within 1e-6 + 2e-4 x its largest move over the run (module docstring)."""
    for k, ref in ref_sd.items():
        if not ref.is_floating_point():
            continue
        move = (ref - start_sd[k]).abs().max().item()
        err = (port_sd[k] - ref).abs().max().item()
        assert err <= 1e-6 + 2e-4 * move, (what, k, err, move)


def test_final_ema_and_parameters_follow_jax(runs):
    p, j = runs["port"], runs["jax"]
    jstate = _np_tree(j["trainer"].state)
    start = runs["weights"]
    _held(p["trainer"].last_weights, state_dict_from_jax(jstate.params), start, "parameters")
    _held(p["trainer"].state.ema_params, state_dict_from_jax(jstate.ema_params), start, "EMA")
    # the facade ends with the EMA weights, in eval mode
    model = p["yolo"].model
    assert not model.training
    for k, v in p["trainer"].state.ema_params.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_checkpoint_files_match_jax(runs):
    p, j = runs["port"], runs["jax"]
    names = sorted(x.name for x in p["dir"].iterdir())
    assert names == sorted(x.name for x in j["dir"].iterdir())
    assert {"best.npz", "last.npz", "healthy.npz", "results.csv", "routing_history.csv", "routing_dashboard.html",
            "state", "state_meta.json"} <= set(names)
    assert json.loads((p["dir"] / "state_meta.json").read_text()) == json.loads((j["dir"] / "state_meta.json").read_text())
    pcsv, jcsv = [(p["dir"] / "results.csv").read_text().splitlines() for p in (p, j)]
    assert pcsv[0].split(",") == jcsv[0].split(",") and len(pcsv) == len(jcsv) == EPOCHS + 1
    # last.npz holds the EMA by state_dict names, and names its graph
    sd, meta = load_weights_npz(p["dir"] / "last.npz")
    assert json.loads(meta["model"]) == CFG_MOE
    for k, v in p["trainer"].state.ema_params.items():
        assert torch.equal(sd[k], v), k
    again = YOLO(str(p["dir"] / "last.npz"), device="cpu")
    for k, v in sd.items():
        assert torch.equal(again.model.state_dict()[k], v), k


def test_jax_weights_file_loads_and_predicts_the_same(runs):
    """The JAX trainer's best.npz (its parameter tree's dotted keys) in the port:
    the same decoded outputs as the JAX model on those weights, within 4x the
    port's own fp32-vs-fp64 error (tests/test_torch_model.py's gate)."""
    import copy

    from yolo_master_tpu.utils.checkpoint import load_params_npz

    j = runs["jax"]
    path = j["dir"] / "best.npz"
    assert any(k.startswith("layers.") for k in np.load(path).files)
    with pytest.raises(ValueError, match="cfg="):
        YOLO(str(path), device="cpu")
    port = YOLO(str(path), device="cpu", cfg=CFG_MOE)
    assert port.model.nc == 4
    x = np.random.default_rng(3).random((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(j["model"].forward_predict)(load_params_npz(str(path)), jnp.asarray(x)))
    with torch.no_grad():
        y = port.model.forward_predict(torch.from_numpy(x)).numpy()
        y64 = copy.deepcopy(port.model).double().forward_predict(torch.from_numpy(x).double()).numpy()
    noise = np.abs(y - y64)
    for sl, floor in ((np.s_[..., :4], 2e-3), (np.s_[..., 4:], 1e-5)):
        assert np.abs(y[sl] - ref[sl]).max() <= max(4 * noise[sl].max(), floor)
    dets = port.predict([(xi * 255).astype(np.uint8) for xi in x], imgsz=64, conf=0.0)
    assert len(dets) == 2 and all(len(r.boxes) > 0 for r in dets)


# -- resume, recovery and refusals: the port alone -------------------------------------------------

def _full_state(trainer):
    return {"params": trainer.last_weights, "ema": trainer.state.ema_params,
            **{f"opt.{kind}": bufs for kind, bufs in trainer.state.opt_state.buffers.items()}}


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for part in a:
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


@pytest.mark.parametrize("change_loader", [False, True], ids=["same_loader", "loader_length_change"])
def test_resume_equals_uninterrupted_bitwise(synth_dataset, tmp_path, change_loader):  # noqa: F811
    """4 epochs saved every 2, interrupted in epoch 3, resumed == 4 epochs
    uninterrupted: parameters, EMA, optimizer buffers, counters and aux_ema
    bitwise. With a loader-length change (nbs 8 -> 4, so nb_opt 2 -> 4) the
    resumed run starts at state_meta.json's epoch, 2, not at step // nb_opt."""
    weights = _start_weights(synth_dataset)
    kw = dict(epochs=4, save_period=2, val=False, close_mosaic=0, moe_schedule=None, workers=0)
    if change_loader:
        _, part = _port_trainer(synth_dataset, weights, tmp_path / "run", **{**kw, "epochs": 2})
        part.train()
        _, resumed = _port_trainer(synth_dataset, weights, tmp_path / "run", resume=True, **{**kw, "nbs": 4})
        assert resumed.nb_opt == 4 != part.nb_opt and resumed.start_epoch == 2 != resumed.state.step // 4
        assert resumed.state.step == part.state.step == 4
        return
    _, full = _port_trainer(synth_dataset, weights, tmp_path / "full", **kw)
    full.train()
    _, part = _port_trainer(synth_dataset, weights, tmp_path / "part", **kw)
    fire = part.callbacks.fire

    def crash(event, *a):
        fire(event, *a)
        if event == "on_fit_epoch_end" and a[0] == 2:
            raise KeyboardInterrupt("interrupted in epoch 3")

    part.callbacks.fire = crash
    with pytest.raises(KeyboardInterrupt):
        part.train()
    assert json.loads((tmp_path / "part" / "state_meta.json").read_text())["epoch"] == 2
    _, resumed = _port_trainer(synth_dataset, weights, tmp_path / "part", resume=True, **kw)
    assert resumed.start_epoch == 2 and resumed.state.step == 4
    resumed.train()
    assert (resumed.state.step, resumed.state.opt_state.count, resumed.state.ema_updates) == \
           (full.state.step, full.state.opt_state.count, full.state.ema_updates) == (8, 8, 8.0)
    assert torch.equal(resumed.state.aux_ema, full.state.aux_ema)
    _assert_bitwise(_full_state(resumed), _full_state(full))


def test_recovery_restores_the_healthy_state_and_keeps_step(tmp_path):
    model = YOLO(CFG_MOE, device="cpu").model.train()
    pol = ts.TrainPolicy(nc=4, epochs=3, nb=4, batch=4, nbs=4)
    tx = pol.build_optimizer(model)
    state = ts.make_train_state(model, tx)
    state.step, state.opt_state.count, state.ema_updates = 5, 5, 5.0
    rc = TrainingRecoveryController(model, str(tmp_path), smoke_imgsz=64)
    assert model.training and rc.refresh(state, epoch=0, metrics={"loss": 1.0})
    assert model.training  # the smoke test puts the mode back
    assert (tmp_path / "healthy.npz").exists()
    healthy = {k: v.clone() for k, v in model.state_dict().items()}
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    with torch.no_grad():  # a poisoned epoch
        for p in model.parameters():
            p.fill_(float("nan"))
        for v in state.ema_params.values():
            v.add_(1.0)
        model.head.cv2[0][0].bn.running_mean.fill_(7.0)
    state.step, state.opt_state.count, state.ema_updates = 9, 9, 9.0
    assert not rc.refresh(state, epoch=1, metrics={"loss": 1.0})  # NaN weights fail the smoke test
    assert not rc.refresh(state, epoch=1, metrics={"loss": float("nan")})
    restored, recovered = rc.maybe_recover(state, {"loss": float("nan")})
    assert recovered and restored is state and rc.recoveries == 1
    assert state.step == 9 and state.opt_state.count == 5 and state.ema_updates == 5.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, healthy[k]), k
    for k, v in state.ema_params.items():
        assert torch.equal(v, ema[k]), k
    assert rc.maybe_recover(state, {"loss": 0.5}) == (state, False)


def test_refusals_name_their_roadmap_items(synth_dataset, tmp_path):  # noqa: F811
    y = YOLO(CFG_MOE, device="cpu")
    cases = [
        (dict(amp=False, mesh=object()), r"§1\.H item 19"),
        (dict(amp=False, expert_parallel=2), r"§1\.H item 20"),
        (dict(amp=False, peft={"enabled": True}), r"§1\.I item 22"),
        (dict(amp=False, batch=-1), r"§1\.G item 18"),
        (dict(amp=False, optimizer="Muon"), r"§1\.I item 23"),
    ]
    for kw, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            y.train(data=synth_dataset, save_dir=str(tmp_path), imgsz=64, workers=0, **kw)
    with pytest.raises(ValueError, match="compute_dtype"):  # fp32 and bf16 only
        y.train(data=synth_dataset, save_dir=str(tmp_path), imgsz=64, workers=0, compute_dtype=torch.float16)
    with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
        YOLO("yolo-master-seg-n", device="cpu").train(data=synth_dataset, save_dir=str(tmp_path))
    # the latent mixtures train (their aux loss, the latent family's): one fp32 epoch at 64 px runs, finite;
    # a graph whose mixture blocks are not ported yet still names item 14
    res = YOLO("yolo26-master-latent-n", device="cpu").train(data=synth_dataset, amp=False, workers=0, epochs=1,
                                                            batch=8, nbs=8, imgsz=64, val=False,
                                                            save_dir=str(tmp_path / "latent"))
    assert res is not None and (tmp_path / "latent" / "last.npz").exists()
    with pytest.raises(FileNotFoundError, match=r"§1\.F item 14"):
        YOLO("yolo-master-v0_2-n", device="cpu")
    # diagnose_model reports what JAX's reports on the same weights
    from yolo_master_tpu.nn.moe.analysis import diagnose_model as jax_diagnose_model
    from yolo_master_tpu_torch.nn.moe.analysis import diagnose_model

    batches = [{"images": np.random.default_rng(2).random((2, 64, 64, 3), np.float32)}]
    jm = JaxDetectionModel(CFG_MOE)
    params = import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), y.model.state_dict(), strict=True)
    rep, ref = diagnose_model(y.model, batches), jax_diagnose_model(jm, params, batches)
    assert list(rep["blocks"]) == list(ref["blocks"]) == ["layers.2"]
    np.testing.assert_allclose(rep["blocks"]["layers.2"]["usage"], ref["blocks"]["layers.2"]["usage"], rtol=0, atol=1e-6)
    assert [c["block"] for c in rep["collapsed"]] == [c["block"] for c in ref["collapsed"]]


def test_moe_stats_under_accumulation_are_the_micro_batch_mean():
    """return_stats: each routed block's usage and balance loss by its JAX path,
    the mean of the micro-batches' (accumulate 2 against two accumulate-1 forwards)."""
    model = YOLO(CFG_MOE, device="cpu").model
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.random((4, 64, 64, 3), np.float32)),
             "boxes": torch.tensor([[[8.0, 8.0, 30.0, 30.0]]]).repeat(4, 1, 1), "classes": torch.zeros(4, 1, dtype=torch.long),
             "mask": torch.ones(4, 1, dtype=torch.bool)}
    model.train()
    with torch.no_grad():
        per = [model.forward_train(batch["images"][i * 2:(i + 1) * 2])[1]["model.2"] for i in range(2)]
    tx = ts.make_optimizer(0.0, model)
    state = ts.make_train_state(model, tx)
    _, m = ts.make_train_step(model, tx, accumulate=2, return_stats=True)(state, batch)
    stats = m["moe_stats"]
    assert list(stats) == ["layers.2"] and set(stats["layers.2"]) == {"expert_usage", "balance_loss"}
    torch.testing.assert_close(stats["layers.2"]["expert_usage"], (per[0].usage + per[1].usage) / 2,
                               rtol=0, atol=1e-7)
    torch.testing.assert_close(stats["layers.2"]["balance_loss"], (per[0].value + per[1].value) / 2,
                               rtol=0, atol=1e-7)
    assert ts.moe_stats_path("model.12") == "layers.12" and ts.moe_stats_path("head.x") == "head.x"
