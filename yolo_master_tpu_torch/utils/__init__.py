"""Helpers shared by the port (counterpart of ``yolo_master_tpu/utils/__init__.py``).

The graph and dataset YAMLs live in the JAX package's ``cfg/`` tree; both
packages build from the same files. They are read by path with PyYAML, without
an import of ``yolo_master_tpu.cfg``.
"""

from __future__ import annotations

import math
from pathlib import Path

import yaml

CFG_DIR = Path(__file__).resolve().parents[2] / "yolo_master_tpu" / "cfg"
MODELS_DIR = CFG_DIR / "models"
DATASETS_DIR = CFG_DIR / "datasets"


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round a channel count up to the nearest multiple of ``divisor``."""
    return math.ceil(x / divisor) * divisor


def find_model_yaml(name: str) -> Path:
    """Resolve 'yolo-master-n', 'yolo-master-n.yaml' or a path to a yaml file.

    A trailing scale letter resolves to the base yaml ('yolo-master-n' ->
    'yolo-master.yaml', scale 'n'), as in the JAX package.
    """
    p = Path(name)
    if p.suffix in {".yaml", ".yml"} and p.exists():
        return p
    stem = p.stem if p.suffix else str(name)
    cand = MODELS_DIR / f"{stem}.yaml"
    if cand.exists():
        return cand
    if len(stem) > 2 and stem[-2] == "-" and stem[-1] in "nsmlx":
        cand = MODELS_DIR / f"{stem[:-2]}.yaml"
        if cand.exists():
            return cand
    raise FileNotFoundError(f"model yaml not found for '{name}' (searched {MODELS_DIR})")


def guess_scale(name: str) -> str | None:
    stem = Path(name).stem
    if len(stem) > 2 and stem[-2] == "-" and stem[-1] in "nsmlx":
        return stem[-1]
    return None


def yaml_load(path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def coco_names() -> dict:
    """{class index: name} from the shared ``cfg/datasets/coco.yaml``."""
    return dict(enumerate(yaml_load(DATASETS_DIR / "coco.yaml")["names"]))
