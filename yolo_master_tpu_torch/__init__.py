"""yolo_master_tpu_torch: the YOLO-Master detector in PyTorch (and its segment,
pose, oriented-box and classify heads, in eval), with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``yolo_master_tpu`` (JAX/Pallas), module by module, held against it
on the same weights and inputs. This package imports ``torch`` and never
``jax`` nor any module of ``yolo_master_tpu``: it keeps its own copies of the
host code (letterbox, Results) and of the YAMLs it builds.
The CUDA kernels in ``csrc/`` are built with ``nvcc`` at first use on a CUDA
tensor; a CPU tensor takes each kernel's plain PyTorch version.
"""

from .models.yolo import YOLO
from .nn.tasks import ClassificationModel, DetectionModel, OBBModel, PoseModel, SegmentationModel

__all__ = ["YOLO", "DetectionModel", "SegmentationModel", "PoseModel", "OBBModel", "ClassificationModel"]
