"""Necks: the FPN (lateral 1x1s, nearest-2x top-down sums, 3x3 outputs, and
the max-pool top block p6), or none.

Port of the JAX package's ``models/necks/fpn.py`` for sum fusion and the
``MAXPOOL`` top block, with no norm or GN on the lateral and output convs
(``NECK.NORM``; a GN conv has no bias), and of its identity neck
(``DummyNeck``, ``NECK.NAME ""``) for the single-level C4 and DC5 models.
Module names follow Detectron2 (``fpn_lateral3``, ``fpn_output3``,
``fpn_lateral3.norm``); without a neck the trunk is the model's
``backbone`` itself (``backbone.res2.0.conv1.weight``), as in Detectron2.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, max_pool


class FPN(nn.Module):
    """Trunk plus pyramid: images -> ``{p2..p6: [B, C, H, W]}``.

    As in Detectron2, the FPN module owns the trunk (``bottom_up``), so
    parameter names read ``backbone.bottom_up.res2.0.conv1.weight`` and
    ``backbone.fpn_lateral2.weight``.
    """

    def __init__(self, bottom_up: nn.Module, in_features: List[str],
                 in_channels: List[int], strides: List[int], out_channels: int,
                 norm: str = ""):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = list(in_features)
        self.stages = [int(math.log2(s)) for s in strides]
        for name_stage, ch in zip(self.stages, in_channels):
            self.add_module(f"fpn_lateral{name_stage}",
                            Conv2d(ch, out_channels, 1, norm=norm))
            self.add_module(f"fpn_output{name_stage}",
                            Conv2d(out_channels, out_channels, 3, norm=norm))

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
        results[f"p{last + 1}"] = max_pool(results[f"p{last}"], 1, 2)
        return dict(sorted(results.items()))


def build_fpn(cfg, bottom_up: nn.Module, trunk_shapes: Dict[str, tuple]) -> FPN:
    n = cfg.MODEL.NECK
    if (n.NAME != "FPN" or n.ACTIVATION != ""
            or n.FUSE_TYPE != "sum" or n.TOP_BLOCK_TYPE != "MAXPOOL"):
        raise NotImplementedError("only the sum-fused FPN with a MAXPOOL top block is ported")
    if n.NORM not in ("", "GN"):
        raise NotImplementedError(f"MODEL.NECK.NORM '{n.NORM}' is not ported (none and GN are)")
    return FPN(
        bottom_up,
        n.IN_FEATURES,
        [trunk_shapes[f][0] for f in n.IN_FEATURES],
        [trunk_shapes[f][1] for f in n.IN_FEATURES],
        n.OUT_CHANNELS,
        n.NORM,
    )


def output_strides(cfg, trunk_shapes: Dict[str, tuple]) -> Dict[str, int]:
    """``{p_k: stride}`` of the FPN's outputs, p6 included."""
    strides = [trunk_shapes[f][1] for f in cfg.MODEL.NECK.IN_FEATURES]
    out = {f"p{int(math.log2(s))}": s for s in strides}
    out[f"p{int(math.log2(strides[-1])) + 1}"] = strides[-1] * 2
    return out


def build_neck(cfg, trunk: nn.Module,
               trunk_shapes: Dict[str, tuple]) -> Tuple[nn.Module, Dict[str, tuple]]:
    """``(backbone, {feature: (channels, stride)})``: the FPN around the
    trunk, or for ``NECK.NAME ""`` the trunk itself with its
    ``OUT_FEATURES`` (the JAX ``build_neck``)."""
    name = cfg.MODEL.NECK.NAME
    if name == "":
        return trunk, {f: trunk_shapes[f] for f in cfg.MODEL.RESNETS.OUT_FEATURES}
    if name != "FPN":
        raise NotImplementedError(f"MODEL.NECK.NAME '{name}' is not ported (FPN and none are)")
    ch = cfg.MODEL.NECK.OUT_CHANNELS
    return (build_fpn(cfg, trunk, trunk_shapes),
            {f: (ch, s) for f, s in output_strides(cfg, trunk_shapes).items()})
