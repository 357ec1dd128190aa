"""The port's train half of the dataset (yolo_master_tpu_torch/data/dataset.py)
against the JAX package's, on the CPU: samples byte for byte, batches bit for bit.

A seeded set of PNGs of varied shapes (every sample is resized, and some
have no labels) goes through both packages' ``load_sample(idx, Random(s))``
under each augmentation: the images must be the same bytes and the labels
the same values of the same dtype. The loaders' batches (the synchronous
``DataLoader`` with a shuffle, and ``PrefetchLoader`` at 1 and 3 workers)
must equal the JAX package's for epochs 0 and 1. No model is built.
"""

import random

import numpy as np
import pytest

from yolo_master_tpu.data import dataset as jdataset
from yolo_master_tpu_torch.data import dataset as tdataset

IMGSZ = 64
N_TRAIN = 10
SEEDS = (0, 1, 2)
# (h, w) of the set's images: smaller and larger than IMGSZ, both orientations
SHAPES = ((48, 80), (96, 64), (64, 64), (90, 120), (40, 40), (128, 72), (70, 50), (64, 100), (33, 90), (80, 80))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """data.yaml of a train split (N_TRAIN images; image 4 has no label file) and a val split."""
    import cv2

    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.default_rng(0)
    for split, n in (("train", N_TRAIN), ("val", 4)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = SHAPES[i % len(SHAPES)]
            im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 5))):
                bw, bh = rng.uniform(0.1, 0.6, 2)
                xc, yc = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
                x1, y1 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
                cv2.rectangle(im, (x1, y1), (int((xc + bw / 2) * w), int((yc + bh / 2) * h)),
                              tuple(int(c) for c in rng.integers(0, 256, 3)), -1)
                rows.append(f"{int(rng.integers(0, 3))} {xc:.6f} {yc:.6f} {bw:.6f} {bh:.6f}")
            cv2.imwrite(str(root / "images" / split / f"{i:03d}.png"), im)
            if i != 4:
                (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n  0: a\n  1: b\n  2: c\n")
    return yaml_path


# each case: hyp (over the defaults: mosaic 1.0, scale 0.5, translate 0.1, HSV, fliplr 0.5), cache
CASES = {
    "mosaic4": ({}, None),
    "mosaic9": ({"mosaic9": 1.0}, None),
    "mosaic_off": ({"mosaic": 0.0}, None),  # rect resize, letterbox (up-scaling), perspective, HSV, flips
    "perspective": ({"mosaic": 0.0, "degrees": 15.0, "shear": 5.0, "translate": 0.2, "scale": 0.6}, None),
    "hsv_flips": ({"mosaic": 0.0, "scale": 0.0, "translate": 0.0, "hsv_h": 0.5, "hsv_s": 0.9, "hsv_v": 0.9,
                   "fliplr": 0.5, "flipud": 0.5, "bgr": 0.5}, None),
    "mixup": ({"mixup": 1.0}, None),
    "cutmix": ({"cutmix": 1.0}, None),
    "copy_paste": ({"copy_paste": 1.0}, None),
    "all_at_once": ({"mosaic9": 0.5, "degrees": 5.0, "shear": 2.0, "mixup": 0.5, "cutmix": 0.5, "copy_paste": 0.5,
                     "flipud": 0.5}, None),
    "cache_ram": ({"mixup": 1.0}, "ram"),
}


def _pair(yaml_path, hyp, cache=None, split="train", augment=True):
    kw = dict(split=split, imgsz=IMGSZ, max_gt=16, augment=augment, hyp=hyp)
    return tdataset.YOLODataset(str(yaml_path), cache=cache, **kw), jdataset.YOLODataset(str(yaml_path), **kw)


def _assert_samples_equal(t, j, what):
    (ti, tl), (ji, jl) = t, j
    assert ti.dtype == ji.dtype == np.uint8 and ti.shape == ji.shape == (IMGSZ, IMGSZ, 3), what
    assert ti.tobytes() == ji.tobytes(), f"{what}: image bytes differ"
    assert tl.dtype == jl.dtype and tl.shape == jl.shape, (what, tl.dtype, jl.dtype, tl.shape, jl.shape)
    assert tl.tobytes() == jl.tobytes(), f"{what}: labels differ"


@pytest.mark.parametrize("case", list(CASES))
def test_load_sample_is_jax_byte_for_byte(synth, case):
    hyp, cache = CASES[case]
    td, jd = _pair(synth, hyp, cache)
    n_labels = 0
    for seed in SEEDS:
        for idx in range(len(td)):
            t = td.load_sample(idx, random.Random(seed * 100 + idx))
            j = jd.load_sample(idx, random.Random(seed * 100 + idx))
            _assert_samples_equal(t, j, f"{case} idx {idx} seed {seed}")
            n_labels += len(t[1])
    assert n_labels > 0  # boxes survive the augmentation somewhere
    if cache == "ram":
        assert sorted(td._ram) == list(range(len(td)))


def test_disk_cache_writes_npy_and_reads_it_back(synth, tmp_path):
    """The first pass decodes and writes each image's .npy; the second reads
    them; both give the JAX package's samples (uncached) byte for byte."""
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(synth.parent, root)
    yaml_path = root / "data.yaml"
    yaml_path.write_text(synth.read_text().replace(str(synth.parent), str(root)))
    td, jd = _pair(yaml_path, {"mixup": 1.0}, cache="disk")
    for pass_ in range(2):
        for idx in range(len(td)):
            _assert_samples_equal(td.load_sample(idx, random.Random(idx)), jd.load_sample(idx, random.Random(idx)),
                                  f"disk cache pass {pass_} idx {idx}")
        cached = sorted(p.name for p in (root / "images" / "train").glob(".ymt_cache_*.npy"))
        assert cached == [f".ymt_cache_{i:03d}.npy" for i in range(N_TRAIN)]
    assert not list((root / "images" / "train").glob("*.tmp"))


def test_albumentations_absent_warns_once_and_skips(synth, caplog):
    """albumentations is not installed: the port warns once and leaves the
    image as it is, as the JAX package does; the samples stay equal."""
    try:
        import albumentations  # noqa: F401
        pytest.fail("this gate expects albumentations to be absent, as it is where the port runs")
    except ImportError:
        pass
    td, jd = _pair(synth, {"albumentations": True})
    tdataset.YOLODataset._warned_album = False
    with caplog.at_level("WARNING"):
        for idx in range(3):
            _assert_samples_equal(td.load_sample(idx, random.Random(idx)), jd.load_sample(idx, random.Random(idx)),
                                  f"albumentations idx {idx}")
    port = [r for r in caplog.records if r.name.startswith("yolo_master_tpu_torch")]
    assert sum("albumentations not installed" in r.getMessage() for r in port) == 1


def test_close_mosaic_switch(synth):
    """mosaic_enabled False (the trainer's close_mosaic) takes the rect path and
    draws no mosaic choice: equal to JAX's, and to a dataset with mosaic 0."""
    td, jd = _pair(synth, {})
    off, _ = _pair(synth, {"mosaic": 0.0})
    td.mosaic_enabled = jd.mosaic_enabled = False
    for idx in range(len(td)):
        t = td.load_sample(idx, random.Random(idx))
        _assert_samples_equal(t, jd.load_sample(idx, random.Random(idx)), f"closed mosaic idx {idx}")
        _assert_samples_equal(t, off.load_sample(idx, random.Random(idx)), f"mosaic 0 idx {idx}")
    td.mosaic_enabled = True
    assert any(td.load_sample(i, random.Random(i))[0].tobytes() != off.load_sample(i, random.Random(i))[0].tobytes()
               for i in range(len(td)))


def _batches_equal(tb, jb, what):
    assert len(tb) == len(jb), what
    for i, (t, j) in enumerate(zip(tb, jb)):
        assert set(t) == set(j), what
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, (what, i, k)
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{what}: batch {i} {k}")


@pytest.mark.parametrize("drop_last", [False, True], ids=["wrap", "drop_last"])
def test_dataloader_epochs_equal_jax(synth, drop_last):
    """shuffle with seed: epochs 0 and 1 (another order and other draws), float32 /255 images."""
    td, jd = _pair(synth, {"mixup": 0.5})
    tl = tdataset.DataLoader(td, 4, shuffle=True, seed=3, drop_last=drop_last, images=np.float32)
    jl = jdataset.DataLoader(jd, 4, shuffle=True, seed=3, drop_last=drop_last)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    epochs = []
    for e in (0, 1):
        tb = list(tl.epoch(e))
        _batches_equal(tb, list(jl.epoch(e)), f"DataLoader epoch {e}")
        epochs.append(tb)
    assert not np.array_equal(epochs[0][0]["images"], epochs[1][0]["images"])


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetch_loader_epochs_equal_jax(synth, workers):
    """Per-sample streams keyed by (seed + epoch, batch, position): the same
    batches as the JAX package's PrefetchLoader at any worker count."""
    td, jd = _pair(synth, {"mosaic9": 0.5, "mixup": 0.5})
    tl = tdataset.PrefetchLoader(td, 4, shuffle=True, seed=5, workers=workers, prefetch=2, images=np.float32)
    jl = jdataset.PrefetchLoader(jd, 4, shuffle=True, seed=5, workers=2, prefetch=3)
    for e in (0, 1):
        _batches_equal(list(tl.epoch(e)), list(jl.epoch(e)), f"PrefetchLoader workers {workers} epoch {e}")


def test_val_api_returns_the_val_loader_batches(synth):
    """The repaired val API: split="val" without augmentation; load_sample needs
    no rng and draws none; uint8 batches in order, the last wrapped, equal to
    the JAX package's /255 (its val loader) and to the float32 form."""
    td, jd = _pair(synth, None, split="val", augment=False)
    assert td.img_files == jd.img_files and len(td) == 4 and td.img_files[0].split("/")[-2] == "val"
    rng = random.Random(0)
    for idx in range(len(td)):
        t = td.load_sample(idx)
        _assert_samples_equal(t, jd.load_sample(idx, rng), f"val idx {idx}")
        _assert_samples_equal(t, td.load_sample(idx, rng), f"val idx {idx} with an rng")
    assert rng.random() == random.Random(0).random()  # no draw
    tb = list(tdataset.DataLoader(td, 3).epoch())
    jb = list(jdataset.DataLoader(jd, 3, shuffle=False).epoch(0))
    fb = list(tdataset.DataLoader(td, 3, images=np.float32).epoch())
    assert len(tb) == len(jb) == 2 and tb[0]["images"].dtype == np.uint8
    for t, j, f in zip(tb, jb, fb):
        np.testing.assert_array_equal(t["images"].astype(np.float32) / 255.0, j["images"])
        for k in j:
            np.testing.assert_array_equal(f[k], j[k])
    np.testing.assert_array_equal(tb[1]["images"][1:], tb[0]["images"][:2])  # the wrap


def test_refusals(synth):
    td, _ = _pair(synth, {})
    with pytest.raises(ValueError, match="rng"):
        td.load_sample(0)
    with pytest.raises(NotImplementedError, match=r"§1\.H item 19"):
        tdataset.PrefetchLoader(td, 4, sharding=object())
    for cls in (tdataset.DataLoader, tdataset.PrefetchLoader):
        with pytest.raises(NotImplementedError, match=r"§1\.H items 19-20"):
            cls(td, 4, process_shard=(0, 2))
    with pytest.raises(ValueError, match="np.uint8 or np.float32"):
        tdataset.collate([td.load_sample(0, random.Random(0))], 4, images=np.float16)
    with pytest.raises(NotImplementedError, match=r"§1\.E item 13"):
        tdataset.SemanticDataset  # noqa: B018
