"""Necks: the FPN (lateral 1x1s, nearest-2x top-down sums, 3x3 outputs, and
a top block: the max-pool p6, or RetinaNet's p6 and p7), or none.

Port of the JAX package's ``models/necks/fpn.py`` for sum fusion and the
``MAXPOOL`` and ``P6P7`` top blocks, with no norm or any of the trunk's (FrozenBN, BN,
SyncBN, GN) on the lateral and output convs (``NECK.NORM``; a conv with a norm has no bias), and of its identity neck
(``DummyNeck``, ``NECK.NAME ""``) for the single-level C4 and DC5 models.
Module names follow Detectron2 (``fpn_lateral3``, ``fpn_output3``,
``fpn_lateral3.norm``); without a neck the trunk is the model's
``backbone`` itself (``backbone.res2.0.conv1.weight``), as in Detectron2.

The ``P6P7`` block (``backbone.top_block.p6`` / ``.p7``, Detectron2's
``LastLevelP6P7`` names) is a 3x3 stride-2 conv on the coarsest FPN output
(p5 over ``res3..res5``), then another on ``relu(p6)``. Its input is always
that output, as in the JAX package, whose ``top_block_in_feature`` no config
key sets; Detectron2's RetinaNet takes ``res5`` there instead.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.resnet import NORMS
from ..layers import Conv2d, max_pool
from .yolov4 import build_yolov4_neck

# The ported top blocks and the levels each adds above the coarsest output.
TOP_BLOCKS = {"MAXPOOL": 1, "P6P7": 2}


class FPN(nn.Module):
    """Trunk plus pyramid: images -> ``{p2..p6: [B, C, H, W]}``.

    As in Detectron2, the FPN module owns the trunk (``bottom_up``), so
    parameter names read ``backbone.bottom_up.res2.0.conv1.weight`` and
    ``backbone.fpn_lateral2.weight``.
    """

    def __init__(self, bottom_up: nn.Module, in_features: List[str],
                 in_channels: List[int], strides: List[int], out_channels: int,
                 norm: str = "", top_block: str = "MAXPOOL"):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = list(in_features)
        self.stages = [int(math.log2(s)) for s in strides]
        for name_stage, ch in zip(self.stages, in_channels):
            self.add_module(f"fpn_lateral{name_stage}",
                            Conv2d(ch, out_channels, 1, norm=norm))
            self.add_module(f"fpn_output{name_stage}",
                            Conv2d(out_channels, out_channels, 3, norm=norm))
        if top_block == "P6P7":
            self.top_block = LastLevelP6P7(out_channels)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.pyramid(self.bottom_up(images))

    def pyramid(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """in_features (fine to coarse, res2..res5) -> ``{p2..p6}``."""
        results = {}
        prev = None
        for idx in reversed(range(len(self.in_features))):
            stage = self.stages[idx]
            lateral = getattr(self, f"fpn_lateral{stage}")(features[self.in_features[idx]])
            if prev is not None:
                lateral = lateral + F.interpolate(prev, scale_factor=2, mode="nearest")
            prev = lateral
            results[f"p{stage}"] = getattr(self, f"fpn_output{stage}")(lateral)
        last = self.stages[-1]
        if hasattr(self, "top_block"):
            results[f"p{last + 1}"], results[f"p{last + 2}"] = self.top_block(results[f"p{last}"])
        else:
            results[f"p{last + 1}"] = max_pool(results[f"p{last}"], 1, 2)
        return dict(sorted(results.items()))


class LastLevelP6P7(nn.Module):
    """RetinaNet's top block: ``p6 = conv(p5)``, ``p7 = conv(relu(p6))``, 3x3
    stride-2 convs with bias and no norm."""

    def __init__(self, channels: int):
        super().__init__()
        self.p6 = Conv2d(channels, channels, 3, stride=2)
        self.p7 = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor):
        p6 = self.p6(x)
        return p6, self.p7(F.relu(p6))


def build_fpn(cfg, bottom_up: nn.Module, trunk_shapes: Dict[str, tuple]) -> FPN:
    n = cfg.MODEL.NECK
    if (n.NAME != "FPN" or n.ACTIVATION != ""
            or n.FUSE_TYPE != "sum" or n.TOP_BLOCK_TYPE not in TOP_BLOCKS):
        raise NotImplementedError(f"only the sum-fused FPN with a {' or '.join(TOP_BLOCKS)} top "
                                  "block is ported")
    if n.NORM not in ("",) + NORMS:
        raise NotImplementedError(f"MODEL.NECK.NORM '{n.NORM}' is not ported "
                                  f"(none and {NORMS} are)")
    return FPN(
        bottom_up,
        n.IN_FEATURES,
        [trunk_shapes[f][0] for f in n.IN_FEATURES],
        [trunk_shapes[f][1] for f in n.IN_FEATURES],
        n.OUT_CHANNELS,
        n.NORM,
        n.TOP_BLOCK_TYPE,
    )


def output_strides(cfg, trunk_shapes: Dict[str, tuple]) -> Dict[str, int]:
    """``{p_k: stride}`` of the FPN's outputs, the top block's p6 (and p7)
    included."""
    strides = [trunk_shapes[f][1] for f in cfg.MODEL.NECK.IN_FEATURES]
    out = {f"p{int(math.log2(s))}": s for s in strides}
    last = int(math.log2(strides[-1]))
    for extra in range(1, TOP_BLOCKS[cfg.MODEL.NECK.TOP_BLOCK_TYPE] + 1):
        out[f"p{last + extra}"] = strides[-1] * 2 ** extra
    return out


def build_neck(cfg, trunk: nn.Module,
               trunk_shapes: Dict[str, tuple]) -> Tuple[nn.Module, Dict[str, tuple]]:
    """``(backbone, {feature: (channels, stride)})``: the FPN or the YOLOv4
    neck around the trunk, or for ``NECK.NAME ""`` the trunk itself with its
    ``OUT_FEATURES`` (the JAX ``build_neck``)."""
    name = cfg.MODEL.NECK.NAME
    if name == "":
        return trunk, {f: trunk_shapes[f] for f in cfg.MODEL.RESNETS.OUT_FEATURES}
    if name == "YOLOV4":
        return build_yolov4_neck(cfg, trunk, trunk_shapes)
    if name != "FPN":
        raise NotImplementedError(f"MODEL.NECK.NAME '{name}' is not ported "
                                  "(FPN, YOLOV4 and none are)")
    ch = cfg.MODEL.NECK.OUT_CHANNELS
    return (build_fpn(cfg, trunk, trunk_shapes),
            {f: (ch, s) for f, s in output_strides(cfg, trunk_shapes).items()})
