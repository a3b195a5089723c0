"""CSP-DarkNet53, the YOLOv4 trunk.

Port of the JAX package's ``models/backbones/darknet.py``. A 3x3 stem, then
stages ``res1`` .. ``res5`` of ``NUM_BLOCKS`` residual blocks each. A stage
is a stride-2 3x3 ``preconv`` (D2's symmetric padding, as every stride-2
``Conv2d`` here), the CSP split into a 1x1 ``shortcut`` and a 1x1 ``main``
branch, the residual blocks on ``main`` (a 1x1 then a 3x3, each with its
norm and activation, then the add, with no activation after it), a 1x1
``postconv``, the concatenation ``[main, shortcut]`` and a 1x1 ``final``.
``res1`` is wide (its blocks keep the stage's width, their 1x1 halves it);
the other stages are narrow (blocks at half the stage's width, no
bottleneck). Stage ``res{i}`` is ``RES2_OUT_CHANNELS * 2 ** (i - 1)`` wide at
stride ``2 ** i``: at 608x608, ``res3`` / ``res4`` / ``res5`` are 76 / 38 /
19 cells of 256 / 512 / 1024 channels.

The trunk reads the ``MODEL.RESNETS`` block, as the JAX package's does
(``STEM_OUT_CHANNELS``, ``RES2_OUT_CHANNELS``, ``OUT_FEATURES``, ``NORM``,
``ACTIVATION``; ``MODEL.BACKBONE.FREEZE_AT``: the stem's output is
detached from 1 on and ``res{i}``'s from ``i + 1`` on, the JAX
``stop_gradient``). The optimizer freezes exactly those modules
(:meth:`DarkNet53.frozen_modules`: the stem and ``res1`` at the YAML's
``FREEZE_AT 2``), so ``res2`` trains. The JAX solver's
``trainable_mask`` freezes ``stem`` and ``res2`` by the ResNet's names
instead, and ``optax.masked`` hands a masked leaf its raw gradient as its
update: JAX's ``res2`` climbs its gradient, and its ``res1`` takes weight
decay and momentum on a zero gradient. The port does not copy that. Module names are
the JAX package's (``stem``, ``res1.preconv``, ``res1.block_1.conv1``,
``res1.final``), so ``convert.py`` carries its weights by name. The ResNet
trunk's other keys (``REMAT``, ``DEFORM_ON_PER_STAGE``, ``RES5_DILATION``,
``STEM_SPACE_TO_DEPTH``), which the JAX DarkNet does not read, raise when
set, and no block takes the fused bottleneck tail: a DarkNet block ends in a
3x3 conv, its norm and activation, then the add.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from ..layers import Conv2d
from .resnet import NORMS

NUM_BLOCKS = (1, 2, 8, 8, 4)


class DarkNetResidualBlock(nn.Module):
    """``x + conv2(conv1(x))``: a 1x1 to ``bottleneck_channels`` and a 3x3
    back, each with its norm and activation."""

    def __init__(self, channels: int, bottleneck_channels: int, norm: str, activation: str):
        super().__init__()
        self.conv1 = Conv2d(channels, bottleneck_channels, 1, norm=norm, activation=activation)
        self.conv2 = Conv2d(bottleneck_channels, channels, 3, norm=norm, activation=activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.conv1(x))


class DarkNetStage(nn.Module):
    """One CSP stage (module docstring), ``in_channels`` -> ``out_channels``
    at half the input's resolution."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int, all_narrow: bool,
                 norm: str, activation: str):
        super().__init__()

        def conv(cin, cout, k, stride=1):
            return Conv2d(cin, cout, k, stride=stride, norm=norm, activation=activation)

        self.preconv = conv(in_channels, out_channels, 3, stride=2)
        block = out_channels // 2 if all_narrow else out_channels
        bottleneck = block if all_narrow else block // 2
        self.shortcut = conv(out_channels, block, 1)
        self.main = conv(out_channels, block, 1)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i + 1}",
                            DarkNetResidualBlock(block, bottleneck, norm, activation))
        self.postconv = conv(block, block, 1)
        self.final = conv(2 * block, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.preconv(x)
        shortcut = self.shortcut(x)
        main = self.main(x)
        for i in range(self.num_blocks):
            main = getattr(self, f"block_{i + 1}")(main)
        main = self.postconv(main)
        return self.final(torch.cat([main, shortcut], dim=1))


class DarkNet53(nn.Module):
    """Stem + res1 .. res{max of out_features}; returns ``{name: [B, C, H, W]}``
    for ``out_features``."""

    def __init__(self, stem_out_channels: int, res2_out_channels: int,
                 out_features: Sequence[str], norm: str, activation: str, freeze_at: int = 0):
        super().__init__()
        self.out_features = list(out_features)
        self.freeze_at = freeze_at
        self.stem = Conv2d(3, stem_out_channels, 3, norm=norm, activation=activation)
        in_ch, out_ch = stem_out_channels, res2_out_channels
        self.stage_names = []
        for idx in range(1, max(int(f[3:]) for f in self.out_features) + 1):
            name = f"res{idx}"
            self.add_module(name, DarkNetStage(in_ch, out_ch, NUM_BLOCKS[idx - 1],
                                               all_narrow=idx != 1, norm=norm,
                                               activation=activation))
            self.stage_names.append(name)
            in_ch, out_ch = out_ch, out_ch * 2

    @staticmethod
    def frozen_modules(freeze_at: int) -> List[str]:
        """The children whose outputs the forward detaches at ``freeze_at``,
        which the optimizer leaves out: the stem from 1 on, then res1 ..
        res{freeze_at - 1}."""
        return ["stem"] * (freeze_at >= 1) + [f"res{i}" for i in range(1, freeze_at)]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        outputs = {}
        for idx, name in enumerate(self.stage_names, start=1):
            x = getattr(self, name)(x)
            if self.freeze_at >= idx + 1:
                x = x.detach()
            if name in self.out_features:
                outputs[name] = x
        return outputs


def output_shapes(cfg) -> Dict[str, tuple]:
    """``{res_k: (channels, stride)}`` of the stages in ``OUT_FEATURES``, as the
    JAX ``build_darknet_backbone`` returns them."""
    r = cfg.MODEL.RESNETS
    return {f: (r.RES2_OUT_CHANNELS * 2 ** (int(f[3:]) - 1), 2 ** int(f[3:]))
            for f in r.OUT_FEATURES}


def build_darknet_backbone(cfg) -> DarkNet53:
    r = cfg.MODEL.RESNETS
    if r.NORM not in NORMS:
        raise NotImplementedError(f"MODEL.RESNETS.NORM '{r.NORM}' is not ported "
                                  f"(known: {NORMS})")
    unread = {"MODEL.RESNETS.REMAT": r.REMAT,
              "MODEL.RESNETS.DEFORM_ON_PER_STAGE": any(r.DEFORM_ON_PER_STAGE),
              "MODEL.RESNETS.RES5_DILATION": r.RES5_DILATION != 1,
              "MODEL.RESNETS.STEM_SPACE_TO_DEPTH": r.STEM_SPACE_TO_DEPTH}
    for key, value in unread.items():
        if value:
            raise NotImplementedError(f"{key} is read by the ResNet trunk only: the DarkNet53 "
                                      "trunk has no such option")
    return DarkNet53(
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        out_features=r.OUT_FEATURES,
        norm=r.NORM,
        activation=r.ACTIVATION,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
    )
