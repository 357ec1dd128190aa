"""ES-MoE blocks of the yolo-master-n graph (dense eval path and its fused deploy form)."""

from .es_moe import ES_MOE, FusedESMOE
from .experts import DepthwiseSeparableConv, EfficientExpertGroup
from .routers import DynamicRoutingLayer

__all__ = ["ES_MOE", "FusedESMOE", "DepthwiseSeparableConv", "EfficientExpertGroup", "DynamicRoutingLayer"]
