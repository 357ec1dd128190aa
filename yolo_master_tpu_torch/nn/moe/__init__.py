"""ES-MoE blocks of the yolo-master-n graph (dense eval path)."""

from .es_moe import ES_MOE
from .experts import DepthwiseSeparableConv, EfficientExpertGroup
from .routers import DynamicRoutingLayer

__all__ = ["ES_MOE", "DepthwiseSeparableConv", "EfficientExpertGroup", "DynamicRoutingLayer"]
