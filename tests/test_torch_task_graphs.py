"""The 52 task YAMLs the port copies (yolo-master-{seg,pose,obb,cls} and
yolo-master-v0_{4..15}-{seg,pose,obb,cls}) against the JAX package's, on the
CPU with no JAX compile:

- each copy is its original byte for byte;
- each graph at n builds with JAX's parameter count (the leaves of
  ``jax.eval_shape``'s tree that the JAX package counts as parameters; the
  tree traced layer by layer, each shared layer once a generation), and
  its weights go to the JAX tree (``import_state_dict``, strict) and back
  (``state_dict_from_jax``, strict), unchanged;
- the head is the task's, on the layers the YAML names.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from yolo_master_tpu.nn.tasks import ClassificationModel as JaxClassificationModel
from yolo_master_tpu.nn.tasks import SegmentationModel as JaxSegmentationModel
from yolo_master_tpu_torch.nn import heads as theads
from yolo_master_tpu_torch.nn.tasks import TASK_MODELS
from yolo_master_tpu_torch.utils import MODELS_DIR
from yolo_master_tpu_torch.utils.weights import state_dict_from_jax

from _torch_tasks import jax_tree_of  # noqa: E402 (tests/ is on the path)
from test_torch_model import _trainable  # noqa: E402

JAX_MODELS = Path(__file__).resolve().parents[1] / "yolo_master_tpu" / "cfg" / "models"
TASKS = {"seg": "segment", "pose": "pose", "obb": "obb", "cls": "classify"}
HEADS = {"segment": theads.Segment, "pose": theads.Pose, "obb": theads.OBB, "classify": theads.Classify}
STEMS = ["yolo-master"] + [f"yolo-master-v0_{v}" for v in range(4, 16)]
YAMLS = [f"{stem}-{t}" for stem in STEMS for t in TASKS]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_the_task_yamls_are_the_52_copied():
    assert len(YAMLS) == 52
    port = {p.stem for p in MODELS_DIR.glob("*.yaml")}
    assert set(YAMLS) <= port
    assert not ({"yolo-master-semantic"} | {f"yolo-master-v0_2-{t}" for t in TASKS}) & port


@pytest.mark.parametrize("name", YAMLS)
def test_task_yaml_copy_is_byte_equal(name):
    assert (MODELS_DIR / f"{name}.yaml").read_bytes() == (JAX_MODELS / f"{name}.yaml").read_bytes()


@pytest.mark.parametrize("name", YAMLS)
def test_task_graph_builds_with_the_jax_parameter_count_and_round_trips(name):
    task = TASKS[name.rsplit("-", 1)[1]]
    port = TASK_MODELS[task](f"{name}-n")
    assert port.task == task and type(port.head) is HEADS[task]
    jcls = JaxClassificationModel if task == "classify" else JaxSegmentationModel  # the tree: any task class
    tree = jax_tree_of(jcls(f"{name}-n"), port)  # port -> JAX, strict
    assert sum(p.numel() for p in port.parameters()) == _trainable(tree)
    assert port.head.i == (12 if name.startswith("yolo-master-v0") and task == "classify" else
                           13 if task == "classify" else 24 if name.startswith("yolo-master-v0") else 25)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for t in port.state_dict().values():
        t.zero_()
    port.load_state_dict(state_dict_from_jax(tree), strict=True)  # JAX -> port, strict
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    if name == "yolo-master-v0_10-seg":  # every leaf of JAX's tree, BN statistics included
        assert sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(tree)) == 3_689_547
