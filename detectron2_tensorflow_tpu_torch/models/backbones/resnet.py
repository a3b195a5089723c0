"""ResNet trunk: depths 18 to 152, FrozenBN or GN, res5 dilated or not; and
the res5 stage alone, as the ROI head of C4 models.

Port of the JAX package's ``models/backbones/resnet.py``: bottleneck blocks
for depth 50 and up, basic blocks (two 3x3 convs) for 18 and 34, whose
stages are a quarter of ``RES2_OUT_CHANNELS`` wide, as there. As in the JAX
package, the first block of every stage has a projection shortcut, res2's
too. Module names follow Detectron2 (``stem.conv1``, ``res2.0.conv1``,
``res2.0.shortcut``, ``conv1.norm``), so a D2 state dict maps by name; a GN
layer is a conv's ``norm`` too, which is how the solver finds it.
Stages up to ``FREEZE_AT`` (1 = the stem, 2 = the stem and res2) are
frozen as in the JAX package: their outputs are detached (its
``stop_gradient``), and the solver leaves their parameters out of the
optimizer (``solver.trainable_parameters``).

``build_resnet_backbone`` reads the user's switch for the fused bottleneck
tail (``D2TPU_ENABLE_FUSED_EPILOGUE``, see ``ops/fused_residual.py``) once,
when the model is built, as the JAX package reads it when it traces; with it
on, every bottleneck block's ``conv3`` runs the tail as one fused kernel when
its norm is FrozenBN, in frozen stages too (their forward still runs). A
basic block ends in a 3x3 conv and a GN block in GN, so neither takes it.
``RES5_DILATION`` above 1 (2 in the DC5 configs) keeps res5 at stride 16:
its first block does not stride and its 3x3 convs are dilated (padding =
dilation), as in the JAX package. :func:`build_res5_head` builds res5 on
its own, as the JAX package's ``Res5ROIHeads`` does: bottleneck blocks
whatever the depth, ``RES2_OUT_CHANNELS * 8`` wide, first stride 2, the
trunk's norm, fed by the trunk's res4 channels. BN/SyncBN, deformable
convs, the space-to-depth stem and rematerialization raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ...ops.fused_residual import fused_epilogue_enabled
from ..layers import Conv2d, max_pool

BLOCKS_PER_STAGE = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class BasicStem(nn.Module):
    """7x7/2 conv + norm + relu + 3x3/2 max pool (stride 4)."""

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
                 fused_tail: bool = False, dilation: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = (
            Conv2d(in_channels, out_channels, 1, stride=stride, norm=norm)
            if has_shortcut else None
        )
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride=s1,
                            norm=norm, activation="relu")
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3,
                            stride=s3, dilation=dilation, groups=num_groups, norm=norm,
                            activation="relu")
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, norm=norm,
                            fuse_residual=fused_tail)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        sc = self.shortcut(x) if self.shortcut is not None else x
        return self.conv3(out, residual=sc)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 with a projection shortcut on the first block (R18/R34)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, norm: str,
                 has_shortcut: bool):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, stride=stride, norm=norm,
                            activation="relu")
        self.shortcut = (
            Conv2d(in_channels, out_channels, 1, stride=stride, norm=norm)
            if has_shortcut else None
        )
        self.conv2 = Conv2d(out_channels, out_channels, 3, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        sc = self.shortcut(x) if self.shortcut is not None else x
        return self.conv2(out, residual=sc)


class ResNet(nn.Module):
    """Stem + res2..res5; returns ``{name: [B, C, H, W]}`` for ``out_features``."""

    def __init__(self, depth: int, num_groups: int, width_per_group: int,
                 stem_out_channels: int, res2_out_channels: int,
                 stride_in_1x1: bool, norm: str, out_features: List[str],
                 freeze_at: int = 0, fused_tail: bool = False, res5_dilation: int = 1):
        super().__init__()
        self.freeze_at = freeze_at
        if depth not in BLOCKS_PER_STAGE:
            raise NotImplementedError(f"ResNet depth {depth} is not ported")
        self.out_features = list(out_features)
        self.stem = BasicStem(3, stem_out_channels, norm)
        bottleneck = depth >= 50
        in_ch = stem_out_channels
        out_ch = res2_out_channels if bottleneck else res2_out_channels // 4
        bott = num_groups * width_per_group
        num_stages = max(int(f[3:]) for f in self.out_features) - 1
        self.stage_names = []
        for idx in range(num_stages):
            name = f"res{idx + 2}"
            dilation = res5_dilation if name == "res5" else 1
            first_stride = 1 if idx == 0 or dilation > 1 else 2
            blocks = []
            for i in range(BLOCKS_PER_STAGE[depth][idx]):
                stride = first_stride if i == 0 else 1
                if bottleneck:
                    blocks.append(BottleneckBlock(in_ch, out_ch, bott, stride,
                                                  num_groups, stride_in_1x1, norm,
                                                  has_shortcut=i == 0, fused_tail=fused_tail,
                                                  dilation=dilation))
                else:
                    blocks.append(BasicBlock(in_ch, out_ch, stride, norm, has_shortcut=i == 0))
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
    """``{res_k: (channels, stride)}`` of the trunk's stages; a dilated res5
    keeps res4's stride."""
    r = cfg.MODEL.RESNETS
    res2 = r.RES2_OUT_CHANNELS if r.DEPTH >= 50 else r.RES2_OUT_CHANNELS // 4
    shapes = {f"res{i + 2}": (res2 * 2 ** i, 4 * 2 ** i) for i in range(4)}
    if r.RES5_DILATION > 1:
        shapes["res5"] = (shapes["res5"][0], shapes["res4"][1])
    return shapes


def build_res5_head(cfg, in_channels: int) -> nn.Sequential:
    """The C4 ROI head's res5 stage (``roi_heads.res5.{b}.*``): bottleneck
    blocks on pooled ``in_channels``-wide features, first stride 2, as the
    JAX package's ``Res5ROIHeads`` builds it. Its tails take the fused
    kernel as the trunk's do (``D2TPU_ENABLE_FUSED_EPILOGUE``, read here)."""
    r = cfg.MODEL.RESNETS
    if r.DEPTH not in BLOCKS_PER_STAGE:
        raise NotImplementedError(f"ResNet depth {r.DEPTH} is not ported")
    out_ch = r.RES2_OUT_CHANNELS * 8
    bott = r.NUM_GROUPS * r.WIDTH_PER_GROUP * 8
    fused = fused_epilogue_enabled()
    blocks = []
    for i in range(BLOCKS_PER_STAGE[r.DEPTH][3]):
        blocks.append(BottleneckBlock(in_channels if i == 0 else out_ch, out_ch, bott,
                                      2 if i == 0 else 1, r.NUM_GROUPS, r.STRIDE_IN_1X1,
                                      r.NORM, has_shortcut=i == 0, fused_tail=fused))
    return nn.Sequential(*blocks)


def build_resnet_backbone(cfg) -> ResNet:
    r = cfg.MODEL.RESNETS
    if cfg.MODEL.BACKBONE.NAME != "ResNet":
        raise NotImplementedError(f"backbone '{cfg.MODEL.BACKBONE.NAME}' is not ported")
    if r.NORM not in ("FrozenBN", "GN"):
        raise NotImplementedError(f"MODEL.RESNETS.NORM '{r.NORM}' is not ported "
                                  "(FrozenBN and GN are)")
    for key in ("STEM_SPACE_TO_DEPTH", "REMAT"):
        if r[key]:
            raise NotImplementedError(f"MODEL.RESNETS.{key} is not ported")
    if any(r.DEFORM_ON_PER_STAGE):
        raise NotImplementedError("deformable convolutions (MODEL.RESNETS.DEFORM_ON_PER_STAGE) "
                                  "are not ported")
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
        res5_dilation=r.RES5_DILATION,
    )
