"""The port's MultiTrainer (``YOLO(...).train(data=[...])``) against the JAX
package's, on the CPU in fp32.

Both fine-tune the same base weights (tests/test_torch_trainer.py's: the small
ES_MOE graph at 64 px, BN calibrated, class biases at 0) on the list
[a, b, a, missing]: two tiny synthetic sets, one given twice, and a yaml that
does not exist, one epoch each at batch 4. Per-run val metrics within 1e-3
(the loop's gate, tests/test_torch_trainer.py), the runs' names, the error
record, multitrain_results.json's keys and mean as JAX's; each run starts
from the base weights bitwise, and the facade's model is the base again
afterwards.
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

from test_train import synth_dataset  # noqa: F401 (fixture reuse: 16 train, 8 val 96-px images)
from test_train_trajectory_parity import CFG_MOE  # noqa: E402
from test_torch_trainer import VAL_METRICS, _start_weights  # noqa: E402

RUN = dict(epochs=1, batch=4, nbs=4, imgsz=64, max_gt=16, amp=False, val=True, workers=0, seed=0)
NAMES = ["data", "other", "data-2", "missing"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _other_set(root):
    """A second synthetic set, tests/test_train.py's form from another seed, as other.yaml."""
    import cv2

    rng = np.random.default_rng(1)
    for split, n in (("train", 8), ("val", 4)):
        (root / f"images/{split}").mkdir(parents=True)
        (root / f"labels/{split}").mkdir(parents=True)
        for i in range(n):
            img = np.full((96, 96, 3), 120, np.uint8)
            cls, w, h = int(rng.integers(0, 2)), int(rng.integers(25, 45)), int(rng.integers(25, 45))
            x1, y1 = int(rng.integers(0, 96 - w)), int(rng.integers(0, 96 - h))
            cv2.rectangle(img, (x1, y1), (x1 + w, y1 + h), (0, 0, 220) if cls == 0 else (220, 0, 0), -1)
            cv2.imwrite(str(root / f"images/{split}/{i:03d}.jpg"), img)
            (root / f"labels/{split}/{i:03d}.txt").write_text(
                f"{cls} {(x1 + w / 2) / 96:.4f} {(y1 + h / 2) / 96:.4f} {w / 96:.4f} {h / 96:.4f}")
    (root / "other.yaml").write_text(f"path: {root}\ntrain: images/train\nval: images/val\n"
                                     "names:\n  0: red\n  1: blue\n")
    return str(root / "other.yaml")


@pytest.fixture(scope="module")
def sweeps(synth_dataset, tmp_path_factory):  # noqa: F811
    """Both packages' MultiTrainer over [a, b, a, missing] from the same base weights."""
    from yolo_master_tpu.engine.trainer import MultiTrainer as JaxMultiTrainer

    root = tmp_path_factory.mktemp("multi")
    datasets = [synth_dataset, _other_set(root / "other"), synth_dataset, str(root / "missing.yaml")]
    weights = _start_weights(synth_dataset)
    y = YOLO(CFG_MOE, device="cpu").load_state_dict(weights)
    starts = []

    class Recorded(DetectionTrainer):  # each run's starting weights
        def __init__(self, yolo, **kw):
            starts.append({k: v.clone() for k, v in yolo.model.state_dict().items()})
            super().__init__(yolo, **kw)

    from yolo_master_tpu_torch.engine.trainer import MultiTrainer

    port = MultiTrainer(y, datasets, trainer_cls=Recorded, save_dir=str(root / "port"), **RUN).train()

    class Stub:
        task = "detect"

    jm = JaxDetectionModel(CFG_MOE)
    stub = Stub()
    stub.model = jm
    stub.params = import_state_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), weights, strict=True)
    jax_runs = JaxMultiTrainer(stub, datasets, save_dir=str(root / "jax"), **RUN).train()
    return dict(y=y, weights=weights, starts=starts, port=port, jax=jax_runs, root=root)


def test_runs_names_and_metrics_follow_jax(sweeps):
    """The same runs under the same names (the repeat as data-2, the missing
    yaml as {"error": 1.0}); each run's val metrics and best fitness within 1e-3
    of JAX's, with detections matched; the same metric keys."""
    p, j = sweeps["port"], sweeps["jax"]
    assert list(p) == list(j) == NAMES
    assert p["missing"] == j["missing"] == {"error": 1.0}
    for name in NAMES[:3]:
        assert set(p[name]) == set(j[name]), (set(p[name]) ^ set(j[name]))
        assert p[name]["images"] == j[name]["images"]
        for k in (*VAL_METRICS, "best_fitness"):
            assert np.isfinite(p[name][k]) and abs(p[name][k] - j[name][k]) <= 1e-3, (name, k, p[name][k], j[name][k])
    assert max(p[n]["recall"] for n in NAMES[:3]) > 0


def test_each_run_starts_from_the_base_and_the_base_is_restored(sweeps):
    """Every run's trainer sees the base weights bitwise (the repeat after two
    runs too), and the facade's model is the base again, in eval mode."""
    y, weights, starts = sweeps["y"], sweeps["weights"], sweeps["starts"]
    assert len(starts) == 4  # the missing yaml's trainer fails while it builds its dataset
    for sd in starts:
        assert sd.keys() == weights.keys() and all(torch.equal(sd[k], weights[k]) for k in weights)
    assert not y.model.training
    for k, v in y.model.state_dict().items():
        assert torch.equal(v, weights[k]), k


def test_results_json_matches_jax(sweeps):
    """multitrain_results.json: the runs and their mean over the runs that
    finished, with JAX's keys and values (1e-3; ``sec`` is each run's own wall
    time); each finished run's directory holds its last.npz."""
    root = sweeps["root"]
    p, j = (json.loads((root / d / "multitrain_results.json").read_text()) for d in ("port", "jax"))
    assert set(p) == set(j) == {"runs", "mean"}
    assert list(p["runs"]) == list(j["runs"]) == NAMES and set(p["mean"]) == set(j["mean"])
    for k, v in j["mean"].items():
        if k != "sec":
            assert abs(p["mean"][k] - v) <= 1e-3, (k, p["mean"][k], v)
    assert p["runs"] == sweeps["port"]
    for name in NAMES[:3]:
        assert (root / "port" / name / "last.npz").exists()
    assert (root / "port" / "multitrain_results.png").exists() == (root / "jax" / "multitrain_results.png").exists()
