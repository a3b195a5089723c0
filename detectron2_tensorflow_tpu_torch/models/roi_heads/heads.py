"""Box, mask and keypoint heads: ``FastRCNNConvFCHead`` (``NUM_CONV`` 3x3
convs, then ``NUM_FC`` FCs), ``MaskRCNNConvUpsampleHead`` (4 convs, or none
on C4, 2x deconv, 1x1 predictor), their convs with the config's norm or
none, and ``KRCNNConvDeconvUpsampleHead`` (``CONV_DIMS`` 3x3 convs, a 4x4
stride-2 deconv, a bilinear 2x upsample).

Port of the JAX package's ``models/roi_heads/heads.py``. Module
names follow Detectron2 (``conv1``, ``conv1.norm``, ``fc1``, ``mask_fcn1``,
``mask_fcn1.norm``, ``deconv``, ``predictor``, ``conv_fcn1``,
``score_lowres``); a conv with a norm has no
bias. Pooled features arrive NHWC ``[N, S, S, C]``; ``fc1`` flattens them
(after the convs) in that (h, w, c) order as the JAX package's
``_FlattenDense`` does, so its weight is the JAX kernel transposed (a D2
checkpoint, flattened (c, h, w), needs its columns permuted; see
``convert.py``). A BN in a head takes its training moments over every
fixed-capacity ROI slot, padded slots (which pool zeros) included, as the
JAX package's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, ConvTranspose2d, Linear


class FastRCNNConvFCHead(nn.Module):
    """``num_conv`` 3x3 conv (+ norm) + relu layers, then ``num_fc`` FC +
    relu layers on pooled ``[N, S, S, C]`` -> ``[N, fc_dim]``."""

    def __init__(self, in_channels: int, resolution: int, num_conv: int, conv_dim: int,
                 num_fc: int, fc_dim: int, norm: str):
        super().__init__()
        self.convs = []
        for i in range(num_conv):
            conv = Conv2d(in_channels, conv_dim, 3, norm=norm, activation="relu")
            self.add_module(f"conv{i + 1}", conv)
            self.convs.append(conv)
            in_channels = conv_dim
        in_dim = resolution * resolution * in_channels
        self.fcs = []
        for i in range(num_fc):
            fc = Linear(in_dim, fc_dim)
            self.add_module(f"fc{i + 1}", fc)
            self.fcs.append(fc)
            in_dim = fc_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.convs:
            x = x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW (channels_last)
            for conv in self.convs:
                x = conv(x)
            x = x.permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return x


class MaskRCNNConvUpsampleHead(nn.Module):
    """``num_conv`` 3x3 convs (+ norm) + 2x deconv + relu + 1x1 per-class
    logits (C4's head has no conv: its deconv reads the res5 features).

    Input NHWC ``[N, S, S, C]`` -> logits NHWC ``[N, 2S, 2S, K]``.
    """

    def __init__(self, in_channels: int, num_classes: int, num_conv: int,
                 conv_dim: int, norm: str, cls_agnostic: bool):
        super().__init__()
        self.convs = []
        ch = in_channels
        for i in range(num_conv):
            conv = Conv2d(ch, conv_dim, 3, norm=norm, activation="relu")
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


class KRCNNConvDeconvUpsampleHead(nn.Module):
    """``conv_dims`` 3x3 conv + relu layers (``conv_fcn{i}``), the
    ``score_lowres`` deconv (kernel 4, stride 2) to ``num_keypoints``
    channels, then a bilinear 2x upsample.

    Input NHWC ``[N, S, S, C]`` -> logits NHWC ``[N, 4S, 4S, K]``. The JAX
    deconv pads ``"SAME"`` (kernel != stride), which for kernel 4 and stride
    2 is PyTorch's ``padding=1`` on the spatially flipped kernel (the flip is
    ``convert.py``'s, as for the mask head's deconv). The JAX
    ``jax.image.resize(..., "bilinear")`` at 2x has half-pixel centres and
    renormalizes the taps at the border, which is what
    ``F.interpolate(mode="bilinear", align_corners=False)`` gives.
    """

    def __init__(self, in_channels: int, num_keypoints: int, conv_dims):
        super().__init__()
        self.convs = []
        ch = in_channels
        for i, dim in enumerate(conv_dims):
            conv = Conv2d(ch, dim, 3, activation="relu")
            self.add_module(f"conv_fcn{i + 1}", conv)
            self.convs.append(conv)
            ch = dim
        self.score_lowres = ConvTranspose2d(ch, num_keypoints, kernel_size=4, stride=2,
                                            padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW (channels_last)
        for conv in self.convs:
            x = conv(x)
        x = self.score_lowres(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1)
