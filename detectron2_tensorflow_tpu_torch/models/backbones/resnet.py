"""ResNet trunk: the R50 FrozenBN path with ``STRIDE_IN_1X1=True``.

Port of the JAX package's ``models/backbones/resnet.py`` for the
bottleneck, FrozenBN, non-dilated configuration the Mask R-CNN R50-FPN slice
uses. Module names follow Detectron2 (``stem.conv1``, ``res2.0.conv1``,
``res2.0.shortcut``, ``conv1.norm``), so a D2 state dict maps by name.
Stages up to ``FREEZE_AT`` (1 = the stem, 2 = the stem and res2) are
frozen as in the JAX package: their outputs are detached (its
``stop_gradient``), and the solver leaves their parameters out of the
optimizer (``solver.trainable_parameters``).

``build_resnet_backbone`` reads the user's switch for the fused bottleneck
tail (``D2TPU_ENABLE_FUSED_EPILOGUE``, see ``ops/fused_residual.py``) once,
when the model is built, as the JAX package reads it when it traces; with it
on, every block's ``conv3`` runs the tail as one fused kernel, in frozen
stages too (their forward still runs).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ...ops.fused_residual import fused_epilogue_enabled
from ..layers import Conv2d, max_pool

BLOCKS_PER_STAGE = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class BasicStem(nn.Module):
    """7x7/2 conv + FrozenBN + relu + 3x3/2 max pool (stride 4)."""

    def __init__(self, in_channels: int, out_channels: int, norm: str):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 7, stride=2, norm=norm,
                            activation="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(self.conv1(x), 3, 2)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 with a projection shortcut on the first block."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int, num_groups: int,
                 stride_in_1x1: bool, norm: str, has_shortcut: bool,
                 fused_tail: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = (
            Conv2d(in_channels, out_channels, 1, stride=stride, norm=norm)
            if has_shortcut else None
        )
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride=s1,
                            norm=norm, activation="relu")
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3,
                            stride=s3, groups=num_groups, norm=norm,
                            activation="relu")
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, norm=norm,
                            fuse_residual=fused_tail)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        sc = self.shortcut(x) if self.shortcut is not None else x
        return self.conv3(out, residual=sc)


class ResNet(nn.Module):
    """Stem + res2..res5; returns ``{name: [B, C, H, W]}`` for ``out_features``."""

    def __init__(self, depth: int, num_groups: int, width_per_group: int,
                 stem_out_channels: int, res2_out_channels: int,
                 stride_in_1x1: bool, norm: str, out_features: List[str],
                 freeze_at: int = 0, fused_tail: bool = False):
        super().__init__()
        self.freeze_at = freeze_at
        if depth not in BLOCKS_PER_STAGE:
            raise NotImplementedError(f"ResNet depth {depth} is not ported")
        self.out_features = list(out_features)
        self.stem = BasicStem(3, stem_out_channels, norm)
        in_ch = stem_out_channels
        out_ch = res2_out_channels
        bott = num_groups * width_per_group
        num_stages = max(int(f[3:]) for f in self.out_features) - 1
        self.stage_names = []
        for idx in range(num_stages):
            name = f"res{idx + 2}"
            blocks = []
            for i in range(BLOCKS_PER_STAGE[depth][idx]):
                stride = 2 if (i == 0 and idx > 0) else 1
                blocks.append(BottleneckBlock(in_ch, out_ch, bott, stride,
                                              num_groups, stride_in_1x1, norm,
                                              has_shortcut=i == 0, fused_tail=fused_tail))
                in_ch = out_ch
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            out_ch *= 2
            bott *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        outputs = {}
        for idx, name in enumerate(self.stage_names):
            x = getattr(self, name)(x)
            if self.freeze_at >= idx + 2:
                x = x.detach()
            if name in self.out_features:
                outputs[name] = x
        return outputs


def output_shapes(cfg) -> Dict[str, tuple]:
    """``{res_k: (channels, stride)}`` of the trunk's stages."""
    r = cfg.MODEL.RESNETS
    return {
        f"res{i + 2}": (r.RES2_OUT_CHANNELS * 2 ** i, 4 * 2 ** i) for i in range(4)
    }


def build_resnet_backbone(cfg) -> ResNet:
    r = cfg.MODEL.RESNETS
    if r.NORM != "FrozenBN" or r.RES5_DILATION != 1:
        raise NotImplementedError("only the FrozenBN, non-dilated ResNet is ported")
    return ResNet(
        depth=r.DEPTH,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        stride_in_1x1=r.STRIDE_IN_1X1,
        norm=r.NORM,
        out_features=r.OUT_FEATURES,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
        fused_tail=fused_epilogue_enabled(),
    )
