"""Box and mask heads: ``FastRCNNConvFCHead`` (2 FC) and
``MaskRCNNConvUpsampleHead`` (4 convs, or none on C4, 2x deconv, 1x1
predictor).

Port of the JAX package's ``models/roi_heads/heads.py``. Module
names follow Detectron2 (``fc1``, ``mask_fcn1``, ``deconv``, ``predictor``).
Pooled features arrive NHWC ``[N, S, S, C]``; ``fc1`` flattens them in that
(h, w, c) order as the JAX package does, so its weight is the JAX kernel
transposed (a D2 checkpoint, flattened (c, h, w), needs its columns
permuted; see ``convert.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, ConvTranspose2d, Linear


class FastRCNNConvFCHead(nn.Module):
    """``num_fc`` FC + relu layers on pooled ``[N, S, S, C]`` -> ``[N, fc_dim]``."""

    def __init__(self, in_channels: int, resolution: int, num_conv: int,
                 num_fc: int, fc_dim: int, norm: str):
        super().__init__()
        if num_conv != 0 or norm != "":
            raise NotImplementedError("only the conv-free, norm-free box head is ported")
        in_dim = resolution * resolution * in_channels
        self.fcs = []
        for i in range(num_fc):
            fc = Linear(in_dim, fc_dim)
            self.add_module(f"fc{i + 1}", fc)
            self.fcs.append(fc)
            in_dim = fc_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return x


class MaskRCNNConvUpsampleHead(nn.Module):
    """``num_conv`` 3x3 convs + 2x deconv + relu + 1x1 per-class logits
    (C4's head has no conv: its deconv reads the res5 features).

    Input NHWC ``[N, S, S, C]`` -> logits NHWC ``[N, 2S, 2S, K]``.
    """

    def __init__(self, in_channels: int, num_classes: int, num_conv: int,
                 conv_dim: int, norm: str, cls_agnostic: bool):
        super().__init__()
        if norm != "":
            raise NotImplementedError("only the norm-free mask head is ported")
        self.convs = []
        ch = in_channels
        for i in range(num_conv):
            conv = Conv2d(ch, conv_dim, 3, activation="relu")
            self.add_module(f"mask_fcn{i + 1}", conv)
            self.convs.append(conv)
            ch = conv_dim
        self.deconv = ConvTranspose2d(ch, conv_dim, kernel_size=2, stride=2)
        self.predictor = Conv2d(conv_dim, 1 if cls_agnostic else num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW (channels_last)
        for conv in self.convs:
            x = conv(x)
        x = F.relu(self.deconv(x))
        return self.predictor(x).permute(0, 2, 3, 1)
