"""Helpers shared by the port (counterpart of ``yolo_master_tpu/utils/__init__.py``).

The port keeps its own copies of the graph and dataset YAMLs it builds, byte
for byte those of the JAX package, under ``yolo_master_tpu_torch/cfg/``. A
YAML is copied when a slice of the port builds it; a model name with no copy
yet raises, naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import math
from pathlib import Path

import yaml

CFG_DIR = Path(__file__).resolve().parents[1] / "cfg"
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
    raise FileNotFoundError(f"model yaml not found for '{name}' in {MODELS_DIR}: the port holds only the "
                            f"graphs it builds so far (ROADMAP.md {_unported_item(stem)})")


def _unported_item(stem: str) -> str:
    """The ROADMAP item that brings a graph the port does not hold yet."""
    if stem.startswith(("yolo-master-v0_2", "yolo-master-v0_3", "yolo-master-uomoe", "yolo-master-dymoe")):
        return "§1.F item 14, their MoE blocks; §1.F item 15, every YAML in cfg/models"
    if "semantic" in stem:
        return "§1.E item 13, SemanticSegment; §1.F item 15, every YAML in cfg/models"
    return "§1.F item 15, every YAML in cfg/models"


def guess_scale(name: str) -> str | None:
    stem = Path(name).stem
    if len(stem) > 2 and stem[-2] == "-" and stem[-1] in "nsmlx":
        return stem[-1]
    return None


def yaml_load(path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def coco_names() -> dict:
    """{class index: name} from the port's ``cfg/datasets/coco.yaml``."""
    return dict(enumerate(yaml_load(DATASETS_DIR / "coco.yaml")["names"]))
