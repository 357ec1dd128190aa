"""MoE blocks of the ported graphs: ES_MOE (dense and sparse eval, and its fused
deploy form) and OptimizedMOEImproved / ModularRouterExpertMoE (sparse and
dense eval, and training)."""

from .es_moe import ES_MOE, FusedESMOE
from .experts import DepthwiseSeparableConv, EfficientExpertGroup
from .mixtures import EfficientSpatialRouter, ModularRouterExpertMoE, OptimizedMOEImproved, SimpleExpert
from .routers import DynamicRoutingLayer

__all__ = ["ES_MOE", "FusedESMOE", "DepthwiseSeparableConv", "EfficientExpertGroup", "DynamicRoutingLayer",
           "EfficientSpatialRouter", "ModularRouterExpertMoE", "OptimizedMOEImproved", "SimpleExpert"]
