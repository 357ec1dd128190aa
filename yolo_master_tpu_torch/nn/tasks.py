"""Model assembly: YAML graph -> ``nn.ModuleList`` -> task model.

Counterpart of ``yolo_master_tpu/nn/tasks.py`` (``parse_model``,
``DetectionModel`` and the task models) with the same scaling rules, over the
same YAML files. The registry holds the modules of the yolo-master,
yolo-master-v0_1 and yolo26-master graphs (yolo26-master-latent's
LatentMixture and yolo26-master-moa-mot's C2fMoA and C2fMoT included, with
NeckMoAFusion and MultiScaleLatentMixture, which no YAML uses), the gated
blocks of yolo-master-v0_4 to v0_15, and the task heads Segment, Pose, OBB and
Classify; any other module name raises ``KeyError`` naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..utils import find_model_yaml, guess_scale, make_divisible, yaml_load
from .heads import OBB, Classify, Detect, Pose, Segment
from .latent_mixture import LatentMixture, MultiScaleLatentMixture
from .layers import (A2C2f, ABlock, Bottleneck, C2f, C2PSA, C3, C3k, C3k2, Concat, Conv, DWConv, FusedStem, Linear,
                     SPPF, Upsample)
from .losses import composite_loss
from .mixture_loss import AuxRecord
from .moa import C2fMoA, NeckMoAFusion
from .moe import ES_MOE, GATED_BLOCKS, A2C2fMoE, OptimizedMOEImproved
from .mot import C2fMoT

MODULE_REGISTRY = {
    "Conv": Conv,
    "DWConv": DWConv,
    "Bottleneck": Bottleneck,
    "C2f": C2f,
    "C3": C3,
    "C3k": C3k,
    "C3k2": C3k2,
    "SPPF": SPPF,
    "C2PSA": C2PSA,
    "A2C2f": A2C2f,
    "A2C2fMoE": A2C2fMoE,
    "C2fMoA": C2fMoA,
    "C2fMoT": C2fMoT,
    "LatentMixture": LatentMixture,
    "MultiScaleLatentMixture": MultiScaleLatentMixture,
    "NeckMoAFusion": NeckMoAFusion,
    "Concat": Concat,
    "Upsample": Upsample,
    "nn.Upsample": Upsample,
    "Detect": Detect,
    "Segment": Segment,
    "Pose": Pose,
    "OBB": OBB,
    "Classify": Classify,
    "ES_MOE": ES_MOE,
    "ModularRouterExpertMoE": OptimizedMOEImproved,
    "OptimizedMOEImproved": OptimizedMOEImproved,
    **GATED_BLOCKS,
}
REPEAT_MODULES = {C2f, C3, C3k, C3k2, C2PSA, A2C2f, A2C2fMoE, C2fMoA, C2fMoT}
# c2 scales with the width and args become [c1, c2, ...]; for the MoE blocks this is the
# JAX package's mixture rule (yolo_master_tpu/nn/tasks.py:218-227): A2C2fMoE, C2fMoA and C2fMoT
# take n as A2C2f does, but none of A2C2f's scale rules
SCALED_MODULES = {Conv, DWConv, Bottleneck, C2f, C3, C3k, C3k2, SPPF, C2PSA, A2C2f, A2C2fMoE, C2fMoA, C2fMoT,
                  ES_MOE, OptimizedMOEImproved, Classify, *GATED_BLOCKS.values()}
HEAD_MODULES = {Detect, Segment, Pose, OBB}  # args become [*args, reg_max, end2end, input widths]
_LITERALS = {"None": None, "True": True, "False": False, "none": None, "true": True, "false": False}


def _roadmap_item(name: str) -> str:
    if name.endswith("Detect") or name == "SemanticSegment":
        return "§1.E item 13 (task heads) / §1.F item 15 (every YAML)"
    if "MoE" in name or "MOE" in name or name.startswith(("Dy", "C2fMo", "MoA", "MoT", "Latent")):
        return "§1.F item 14 (mixture modules) / §1.D items 10-12 (MoE dispatch and tools)"
    if name in {"HGStem", "HGBlock", "AIFI", "RepC3", "RTDETRDecoder"}:
        return "§1.I item 21 (other model families)"
    return "§1.F item 15 (every YAML in cfg/models)"


def parse_model(cfg: dict, ch: int = 3, scale: Optional[str] = None) -> Tuple[nn.ModuleList, List[int]]:
    """Build the layer list and the sorted save-list from a model dict.

    Each layer carries ``i`` (its index) and ``f`` (its input index or list).
    """
    nc = cfg.get("nc", 80)
    scales = cfg.get("scales")
    reg_max = cfg.get("reg_max", 16)
    end2end = bool(cfg.get("end2end", False))
    depth, width, max_channels = cfg.get("depth_multiple", 1.0), cfg.get("width_multiple", 1.0), float("inf")
    if scales:
        scale = scale or next(iter(scales))
        depth, width, max_channels = scales[scale]

    legacy = True
    channels = [ch]
    layers, save = [], []
    for i, (f, n, mname, args) in enumerate(list(cfg["backbone"]) + list(cfg["head"])):
        if mname not in MODULE_REGISTRY:
            raise KeyError(f"module '{mname}' is not ported to yolo_master_tpu_torch yet: "
                           f"ROADMAP.md {_roadmap_item(mname)}")
        m = MODULE_REGISTRY[mname]
        args = [_LITERALS.get(a, a) if isinstance(a, str) else a for a in args]
        args = [nc if a == "nc" else cfg.get("kpt_shape", (17, 3)) if a == "kpt_shape" else a for a in args]
        n = max(round(n * depth), 1) if n > 1 else n
        kwargs = {}
        if m in SCALED_MODULES:
            c1, c2 = channels[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
            if m in REPEAT_MODULES:
                args.insert(2, n)
                n = 1
            if m is C3k2:
                legacy = False
                if scale and scale in "mlx":
                    args[3] = True
            if m is A2C2f:
                legacy = False
                if scale and scale in "lx":
                    args.extend((True, 1.2))
            if m is A2C2fMoE:
                legacy = False
        elif m in (LatentMixture, NeckMoAFusion):  # several inputs: c1 is the list of their widths
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [[channels[x] for x in f], c2, *args[1:]]
        elif m is Concat:
            c2 = sum(channels[x] for x in f)
            args = []
        elif m in HEAD_MODULES:
            if m is Segment:  # npr, the prototype width, scales with the width
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
            args = [*args, reg_max, end2end, [channels[x] for x in f]]
            kwargs = {"legacy": legacy}
            c2 = None
        elif m is Upsample:
            c2 = channels[f]
            args = [None, args[1] if len(args) > 1 else 2]
        else:
            c2 = channels[f]
        mod = nn.Sequential(*(m(*args) for _ in range(n))) if n > 1 else m(*args, **kwargs)
        mod.i, mod.f = i, f
        layers.append(mod)
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            channels = []
        channels.append(c2)
    return nn.ModuleList(layers), sorted(set(save))


def jax_module_path(name: str) -> str:
    """A module's name in the port (``model.3``) -> its path in the JAX package
    (``layers.3``): the key of the JAX step's ``moe_stats`` and of the routed
    blocks' draws."""
    head, _, rest = name.partition(".")
    return f"layers.{rest}" if head == "model" else name


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight from ``generator``, as PyTorch's and the JAX package's
    defaults do: convs and Linears U(+-1/sqrt(fan_in)) for weight and bias
    (a transposed conv's bias by its input's fan-in, as JAX's), BN
    identity, area-attention blocks' conv weights trunc_normal(0.02), and the
    draws a module's ``seeded_init`` makes over those (the gated routers'
    normal(0.05) and normal(0.02) projections, CrossPathGate's zeroed last
    layer), as the JAX modules' ``init`` overrides do."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, Linear)):
                fan_in = mod.weight[0].numel()
                bound = 1.0 / fan_in ** 0.5
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, nn.ConvTranspose2d):  # weight [cin, cout, kh, kw]; JAX's fan-ins
                bound = mod.weight[0].numel() ** -0.5
                mod.weight.uniform_(-bound, bound, generator=generator)
                bound = (mod.weight.shape[0] * mod.weight[0, 0].numel()) ** -0.5
                mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
        for mod in model.modules():
            if isinstance(mod, ABlock):
                for conv in mod.modules():
                    if isinstance(conv, nn.Conv2d):
                        nn.init.trunc_normal_(conv.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
            elif hasattr(mod, "seeded_init"):
                mod.seeded_init(generator)


class BaseModel(nn.Module):
    """A model built from a graph YAML, whose last layer is a ``head_type``.

    :meth:`forward` takes an NHWC image batch, float (0..1) or uint8 (0..255
    with /255 folded into the first layer by ``utils/fuse.py``), and returns
    the head's output.
    """

    task = ""
    head_type = nn.Module

    def __init__(self, cfg="yolo-master-n", ch: int = 3, nc: Optional[int] = None, scale: Optional[str] = None,
                 seed: int = 0):
        super().__init__()
        if not isinstance(cfg, dict):
            yaml_file = find_model_yaml(str(cfg))
            scale = scale or guess_scale(str(cfg))
            cfg = yaml_load(yaml_file)
        self.yaml = dict(cfg)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        self.nc = self.yaml.get("nc", 80)
        self.uint8_input = False  # set by utils/fuse.py when /255 is folded into layer 0
        self._sparse_inference = True
        self.model, self.save = parse_model(self.yaml, ch, scale=scale)
        if type(self.head) is not self.head_type:
            raise ValueError(f"a {self.task} model must end with {self.head_type.__name__}, this graph ends with "
                             f"{type(self.head).__name__}")
        for name, m in self.named_modules():
            if hasattr(m, "jax_path"):  # the routed blocks key their draws by the JAX package's path
                m.jax_path = jax_module_path(name)
        init_weights(self, torch.Generator().manual_seed(seed))

    @property
    def sparse_inference(self) -> bool:
        """Whether the MoE blocks with top-k routing evaluate sparsely, computing
        only the selected experts (default True, the JAX package's
        ``Context.sparse_inference``); False evaluates them masked-dense."""
        return self._sparse_inference

    @sparse_inference.setter
    def sparse_inference(self, on: bool) -> None:
        self._sparse_inference = bool(on)
        for m in self.model.modules():
            if hasattr(m, "sparse_inference"):
                m.sparse_inference = bool(on)

    @property
    def head(self) -> nn.Module:
        return self.model[-1]

    def _forward_graph(self, x_nhwc: torch.Tensor, stop_before_head: bool = False):
        if isinstance(self.model[0], FusedStem):
            x = x_nhwc
        else:  # uint8 (/255 folded into layer 0) or float, in layer 0's weights' dtype, or in a lower
            # precision than those (bf16 images into fp32 weights: bf16 training), which every op keeps
            w_dtype = next(self.model[0].parameters()).dtype
            lower = x_nhwc.is_floating_point() and x_nhwc.dtype.itemsize < w_dtype.itemsize
            x = (x_nhwc if lower else x_nhwc.to(w_dtype)).permute(0, 3, 1, 2)  # channels_last NCHW view
        saved = {}
        for m in self.model:
            if m.f != -1:  # a negative index other than -1 counts back from this layer
                x = saved[m.f % m.i] if isinstance(m.f, int) else [x if j == -1 else saved[j % m.i] for j in m.f]
            if stop_before_head and m is self.head:
                return x
            x = m(x)
            if m.i in self.save:
                saved[m.i] = x
        return x

    def forward(self, x_nhwc: torch.Tensor):
        return self._forward_graph(x_nhwc)


class DetectionModel(BaseModel):
    """YOLO detection model: :meth:`forward` returns the head's dict,
    :meth:`forward_predict` the decoded [B, A, 4+nc], in fp32 whatever the
    model's compute dtype."""

    task = "detect"
    head_type = Detect

    def __init__(self, cfg="yolo-master-n", ch: int = 3, nc: Optional[int] = None, scale: Optional[str] = None,
                 seed: int = 0):
        super().__init__(cfg, ch, nc, scale, seed)
        self.head.set_strides(self._probe_strides())
        self.head.bias_init()
        self.stride = max(self.head.strides)

    @torch.no_grad()
    def _probe_strides(self, size: int = 256) -> Tuple[int, ...]:
        """Run a zero image through the graph; stride = input size / map size."""
        was_training = self.training
        self.eval()
        feats = self._forward_graph(torch.zeros(1, size, size, 3), stop_before_head=True)
        self.train(was_training)
        return tuple(size // f.shape[-2] for f in feats)

    def forward_predict(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """Decoded [B, A, 4+nc(+extra)]: xywh boxes (xyxy for an end2end head) in input pixels, sigmoid
        scores, and a task head's extra columns (``Segment.decode``, ``Pose.decode``, ``OBB.decode``)."""
        return self.head.decode(self.forward(x_nhwc))

    def forward_train(self, x_nhwc: torch.Tensor, step: int = 0) -> Tuple[dict, Dict[str, AuxRecord]]:
        """Train-mode forward at optimizer step ``step``, set on every module that
        reads it (the routed blocks' draws, progressive sparsity and expert
        dropout; the gated blocks' and their routers' temperature, noise,
        expert dropout and drop-path), as the JAX ``Context.step``): (the
        head's training dict, the aux records of the blocks that publish one,
        keyed by module path in forward order). The
        caller puts the model in train mode (BatchNorm on batch statistics).
        bf16 images run the fp32 parameters in bf16 through each op's cast, as
        JAX's ``forward_train`` on ``images.astype(compute_dtype)``; the head's
        dict is then bf16 and the aux records fp32."""
        if not self.training:
            raise RuntimeError("forward_train needs a model in train mode (model.train())")
        publishers = [(name, m) for name, m in self.named_modules() if hasattr(m, "aux_record")]
        for _, m in publishers:
            m.aux_record = None
        for m in self.modules():
            if hasattr(m, "step"):
                m.step = int(step)
        preds = self.forward(x_nhwc)
        aux = {}
        for name, m in publishers:
            if m.aux_record is not None:
                aux[name] = m.aux_record
                m.aux_record = None  # the model keeps no graph past this call
        return preds, aux

    def compute_loss(self, preds: dict, batch: dict, aux_total: torch.Tensor, hyp: dict):
        """(total, metrics) of the v8 loss of ``preds`` against ``batch`` (boxes [B, M, 4]
        xyxy px, classes [B, M], mask [B, M]) plus ``hyp["moe"] * aux_total``; metrics
        loss, box_loss, cls_loss, dfl_loss and aux_loss, in fp32 whatever the
        head's dtype (``nn/losses.py`` widens the head outputs)."""
        lb = composite_loss(preds, preds["hw_shapes"], self.head.strides, batch["boxes"], batch["classes"],
                            batch["mask"], nc=self.nc, aux_total=aux_total, reg_max=self.head.reg_max,
                            box_gain=hyp.get("box", 7.5), cls_gain=hyp.get("cls", 0.5), dfl_gain=hyp.get("dfl", 1.5),
                            moe_gain=hyp.get("moe", 0.01), end2end=self.head.end2end)
        return lb.total, {"loss": lb.total, "box_loss": lb.box, "cls_loss": lb.cls, "dfl_loss": lb.dfl,
                          "aux_loss": lb.aux}


class SegmentationModel(DetectionModel):
    """Instance segmentation: a graph ending with :class:`~.heads.Segment`."""

    task = "segment"
    head_type = Segment


class PoseModel(DetectionModel):
    """Keypoints: a graph ending with :class:`~.heads.Pose` (``kpt_shape`` from the YAML)."""

    task = "pose"
    head_type = Pose

    @property
    def kpt_shape(self):
        return self.head.kpt_shape


class OBBModel(DetectionModel):
    """Oriented boxes: a graph ending with :class:`~.heads.OBB`."""

    task = "obb"
    head_type = OBB


class ClassificationModel(BaseModel):
    """Classification: a graph ending with :class:`~.heads.Classify`; its forward
    gives logits in train mode and probabilities [B, nc] in eval."""

    task = "classify"
    head_type = Classify

    def forward_predict(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """Class probabilities [B, nc] (an eval-mode forward), fp32."""
        return self.forward(x_nhwc).float()


TASK_MODELS = {m.task: m for m in (DetectionModel, SegmentationModel, PoseModel, OBBModel, ClassificationModel)}
