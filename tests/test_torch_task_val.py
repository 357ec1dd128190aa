"""The task datasets and validators of the port against the JAX package's, on
the CPU in fp32, on synthetic sets written by the test (tests/_torch_tasks.py:
six noise PNGs with rectangles, long sides 40-120 px at imgsz 64, labelled
from the port's own detections).

1. The datasets' val half: each sample (image, boxes, masks, keypoints,
   rotated boxes, class) and each collated batch (``images=np.float32``)
   equal JAX's bit for bit; the default uint8 batch is JAX's times 255.
2. The validators, through ``YOLO(...).val(data=...)`` unfused and after
   ``fuse()``, against JAX's on the same weights: every metric within 1e-3
   (the detection validator's gate, tests/test_torch_validator.py), and the
   labels matched (box mAP50 above 0.1, top-5 accuracy 1).
3. The refusals: training a task model, bf16, the datasets' train half and
   SemanticDataset.
"""

import numpy as np
import pytest
import torch

from yolo_master_tpu.data import dataset as jdataset
from yolo_master_tpu.engine import validators_task as jvt
from yolo_master_tpu_torch.data import dataset as tdataset
from yolo_master_tpu_torch.engine.train_step import make_train_step

from _torch_tasks import IMGSZ, label_task_set, noise_images, task_weights, write_class_set, write_images  # noqa: E402

BATCH = 4  # six images: a batch of 4, then 2 + 2 wrapped
METRIC_TOL = 1e-3
KEYS = {"segment": ("mAP50", "mAP50-95", "mask_mAP50", "mask_mAP50-95", "fitness"),
        "pose": ("mAP50", "mAP50-95", "pose_mAP50", "pose_mAP50-95", "fitness"),
        "obb": ("mAP50", "mAP50-95", "fitness"), "classify": ("top1", "top5", "fitness")}
DATASETS = {"segment": ("SegmentDataset", {}), "pose": ("PoseDataset", {"kpt_shape": (17, 3)}),
            "obb": ("OBBDataset", {})}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def images():
    return noise_images()


@pytest.fixture(scope="module", params=["segment", "pose", "obb", "classify"])
def task_set(request, images, tmp_path_factory):
    """(task, data, JAX model, params, the port's facade): a set labelled from the port's predictions."""
    task = request.param
    jm, params, y = task_weights(task, images)
    root = tmp_path_factory.mktemp(f"task_{task}")
    if task == "classify":
        data = write_class_set(root, y, images)
    else:
        write_images(root, images)
        data = label_task_set(root, task, y, images)
    return task, str(data), jm, params, y


def test_task_dataset_matches_jax(task_set):
    task, data, *_ = task_set
    if task == "classify":
        ours, ref = tdataset.ClassificationDataset(f"{data}/val", IMGSZ), jdataset.ClassificationDataset(
            f"{data}/val", IMGSZ)
        assert ours.names == ref.names and ours.samples == ref.samples
    else:
        name, kw = DATASETS[task]
        ours = getattr(tdataset, name)(data, split="val", imgsz=IMGSZ, max_gt=8, **kw)
        ref = getattr(jdataset, name)(data, split="val", imgsz=IMGSZ, max_gt=8, augment=False, **kw)
    n_labels = 0
    for i in range(len(ref)):
        a, b = ours.load_sample(i), ref.load_sample(i, None)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
        n_labels += 0 if task == "classify" else len(a[1])
    assert task == "classify" or n_labels >= len(ref)
    for dt in (np.float32, np.uint8):
        got = list(tdataset.DataLoader(ours, BATCH, images=dt).epoch())
        want = list(jdataset.DataLoader(ref, BATCH, shuffle=False).epoch(0))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                if k == "images" and dt is np.uint8:
                    assert g[k].dtype == np.uint8
                    np.testing.assert_array_equal(g[k].astype(np.float32) / 255.0, w[k])
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if task == "segment":
        assert want[0]["masks"].shape[2:] == (IMGSZ // 4, IMGSZ // 4) and want[0]["masks"].sum() > 0


def _jax_validator(task, jm, params, data):
    if task == "classify":
        return jvt.ClassificationValidator(jm, params=params, data=data, imgsz=IMGSZ, batch=BATCH)()
    cls = {"segment": jvt.SegmentationValidator, "pose": jvt.PoseValidator, "obb": jvt.OBBValidator}[task]
    return cls(jm, params=params, data=data, imgsz=IMGSZ, batch=BATCH)()


def test_task_validator_matches_jax(task_set):
    task, data, jm, params, y = task_set
    ref = _jax_validator(task, jm, params, data)
    assert ref["images"] == 6
    m = y.val(data=data, imgsz=IMGSZ, batch=BATCH)
    y.fuse()
    mf = y.val(data=data, imgsz=IMGSZ, batch=BATCH)
    for out in (m, mf):
        assert out["images"] == 6 and set(out["speed"]) == {"load", "device", "match"}
        for k in KEYS[task]:
            assert np.isfinite(out[k]) and abs(out[k] - ref[k]) <= METRIC_TOL, (k, out[k], ref[k])
    if task == "classify":
        assert ref["top5"] == 1.0 and ref["top1"] == 0.5
    else:
        assert ref["mAP50"] > 0.1  # real matches, not 0 against 0


def test_task_refusals(task_set, tmp_path):
    task, data, _, _, y = task_set
    with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
        y.train(data=data, epochs=1, imgsz=IMGSZ, save_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
        y.predict(np.zeros((32, 32, 3), np.uint8), compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
        y.val(data=data, imgsz=IMGSZ, compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
        make_train_step(y.model)
    with pytest.raises(TypeError, match="unknown val arguments"):  # the detection validator's COCO rows; conf
        y.val(data=data, **({"conf": 0.1} if task == "classify" else {"save_json": str(tmp_path / "x.json")}))
    if task == "classify":
        with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
            tdataset.ClassificationDataset(f"{data}/val", IMGSZ, augment=True)
        with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
            tdataset.SemanticDataset  # noqa: B018
    else:
        name, kw = DATASETS[task]
        with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
            getattr(tdataset, name)(data, split="val", imgsz=IMGSZ, augment=True, **kw)
