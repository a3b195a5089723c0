"""ResNet trunk: depths 18 to 152, FrozenBN, BN/SyncBN or GN, res5 dilated or not; and
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
optimizer (``solver.trainable_parameters``). No norm is swapped for FrozenBN
there (Detectron2 would): a trainable BN in a frozen stage still normalizes
with batch moments in training and still updates its running statistics,
as in the JAX package.

``build_resnet_backbone`` reads the user's switch for the fused bottleneck
tail (``D2TPU_ENABLE_FUSED_EPILOGUE``, see ``ops/fused_residual.py``) once,
when the model is built, as the JAX package reads it when it traces; with it
on, every bottleneck block's ``conv3`` runs the tail as one fused kernel when
its norm is FrozenBN, in frozen stages too (their forward still runs). A
basic block ends in a 3x3 conv and a GN or BN block in its norm, so none
of them takes it.
``RES5_DILATION`` above 1 (2 in the DC5 configs) keeps res5 at stride 16:
its first block does not stride and its 3x3 convs are dilated (padding =
dilation), as in the JAX package. :func:`build_res5_head` builds res5 on
its own, as the JAX package's ``Res5ROIHeads`` does: bottleneck blocks
whatever the depth, ``RES2_OUT_CHANNELS * 8`` wide, first stride 2, the
trunk's norm, fed by the trunk's res4 channels.

``DEFORM_ON_PER_STAGE`` makes every bottleneck block of a stage deformable,
as in the JAX package: its ``conv2`` is a :class:`~..deform_conv.DeformConv2d`
(``DEFORM_MODULATED``, ``DEFORM_NUM_GROUPS``; stride and dilation as the
3x3 it replaces) with the norm after it, then ReLU; ``conv3`` keeps its
fused tail. Like the JAX ``DeformConv2D`` its kernel is dense over the
channels, in a ResNeXt too (``NUM_GROUPS`` does not split it). A basic-block
trunk (R18/R34) with a deformable stage raises, as Detectron2 does: the JAX
package would build it without a deformable conv. ``REMAT`` recomputes each
block's activations in the backward pass (``torch.utils.checkpoint``,
non-reentrant) in the stages after ``FREEZE_AT``, as the JAX package's
``nn.remat`` does; a trainable BN does not update its running statistics
a second time in the recomputation (``layers.recomputing``). The
space-to-depth stem raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.fused_residual import fused_epilogue_enabled
from ..deform_conv import DeformConv2d
from ..layers import Conv2d, max_pool, recompute_context

NORMS = ("FrozenBN", "BN", "SyncBN", "GN")
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
                 fused_tail: bool = False, dilation: int = 1, deform: bool = False,
                 deform_modulated: bool = False, deform_groups: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = (
            Conv2d(in_channels, out_channels, 1, stride=stride, norm=norm)
            if has_shortcut else None
        )
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride=s1,
                            norm=norm, activation="relu")
        self.deform = deform
        if deform:  # dense over the channels, as the JAX DeformConv2D (module doc)
            self.conv2 = DeformConv2d(bottleneck_channels, bottleneck_channels, 3, stride=s3,
                                      dilation=dilation, deform_groups=deform_groups,
                                      modulated=deform_modulated, norm=norm)
        else:
            self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3,
                                stride=s3, dilation=dilation, groups=num_groups, norm=norm,
                                activation="relu")
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, norm=norm,
                            fuse_residual=fused_tail)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if self.deform:
            out = torch.relu(out)
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


class RematStage(nn.Sequential):
    """A stage whose blocks each run under ``torch.utils.checkpoint`` while
    gradients are recorded: the backward pass recomputes a block's
    activations from its input (the JAX package's per-block ``nn.remat``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self:
            if torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False, context_fn=recompute_context)
            else:
                x = block(x)
        return x


class ResNet(nn.Module):
    """Stem + res2..res5; returns ``{name: [B, C, H, W]}`` for ``out_features``."""

    def __init__(self, depth: int, num_groups: int, width_per_group: int,
                 stem_out_channels: int, res2_out_channels: int,
                 stride_in_1x1: bool, norm: str, out_features: List[str],
                 freeze_at: int = 0, fused_tail: bool = False, res5_dilation: int = 1,
                 deform_on_per_stage: Sequence[bool] = (False,) * 4,
                 deform_modulated: bool = False, deform_groups: int = 1,
                 remat: bool = False):
        super().__init__()
        self.freeze_at = freeze_at
        if depth not in BLOCKS_PER_STAGE:
            raise NotImplementedError(f"ResNet depth {depth} is not ported")
        bottleneck = depth >= 50
        if any(deform_on_per_stage) and not bottleneck:
            raise NotImplementedError(
                f"deformable convolutions (MODEL.RESNETS.DEFORM_ON_PER_STAGE "
                f"{list(deform_on_per_stage)}) need bottleneck blocks: ResNet-{depth} has basic "
                f"blocks, which Detectron2 does not deform either")
        self.out_features = list(out_features)
        self.stem = BasicStem(3, stem_out_channels, norm)
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
                                                  dilation=dilation,
                                                  deform=deform_on_per_stage[idx],
                                                  deform_modulated=deform_modulated,
                                                  deform_groups=deform_groups))
                else:
                    blocks.append(BasicBlock(in_ch, out_ch, stride, norm, has_shortcut=i == 0))
                in_ch = out_ch
            # Frozen stages do no backward work: remat would only slow them down.
            stage = RematStage if remat and idx + 2 > freeze_at else nn.Sequential
            self.add_module(name, stage(*blocks))
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
    if r.NORM not in NORMS:
        raise NotImplementedError(f"MODEL.RESNETS.NORM '{r.NORM}' is not ported "
                                  f"(known: {NORMS})")
    if r.STEM_SPACE_TO_DEPTH:
        raise NotImplementedError("MODEL.RESNETS.STEM_SPACE_TO_DEPTH is not ported")
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
        deform_on_per_stage=tuple(r.DEFORM_ON_PER_STAGE),
        deform_modulated=r.DEFORM_MODULATED,
        deform_groups=r.DEFORM_NUM_GROUPS,
        remat=r.REMAT,
    )
