"""MoE blocks of the ported graphs: ES_MOE (dense and sparse eval, and its fused
deploy form), OptimizedMOEImproved / ModularRouterExpertMoE (sparse and
dense eval, and training; every expert and router type), ABlockMoE /
A2C2fMoE (yolo26-master's mixture, eval and training) and the AdaptiveGate family
(``gated.py``, eval and training); the MoE tools: ``pruning.py``,
``quantize.py`` and ``analysis.py``."""

from .es_moe import ES_MOE, FusedESMOE
from .experts import DepthwiseSeparableConv, EfficientExpertGroup
from .gated import GATED_BLOCKS, AdaptiveGateMoE
from .mixtures import (A2C2fMoE, ABlockMoE, AdaptiveRoutingLayer, EfficientSpatialRouter, GhostExpert,
                       InvertedResidualExpert, LocalRoutingLayer, ModularRouterExpertMoE, OptimizedMOEImproved,
                       SimpleExpert, SpatialExpert)
from .routers import DynamicRoutingLayer

__all__ = ["ES_MOE", "FusedESMOE", "DepthwiseSeparableConv", "EfficientExpertGroup", "DynamicRoutingLayer",
           "GATED_BLOCKS", "AdaptiveGateMoE", "A2C2fMoE", "ABlockMoE", "AdaptiveRoutingLayer",
           "EfficientSpatialRouter", "GhostExpert", "InvertedResidualExpert", "LocalRoutingLayer",
           "ModularRouterExpertMoE", "OptimizedMOEImproved", "SimpleExpert", "SpatialExpert"]
