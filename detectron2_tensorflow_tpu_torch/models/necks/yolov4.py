"""The YOLOv4 neck: SPP, then PANet's top-down and bottom-up paths.

Port of the JAX package's ``models/necks/yolov4.py``. On the trunk's
``res3`` / ``res4`` / ``res5`` (``NECK.IN_FEATURES``), with C =
``NECK.OUT_CHANNELS`` (128 in ``Base-YOLO``), every conv carrying
``NECK.NORM`` and ``NECK.ACTIVATION``:

  * SPP on ``res5``: 1x1 (4C), 3x3 (8C), 1x1 (4C), then stride-1 max pools
    of 13, 9 and 5 padded with ``-inf`` (``F.max_pool2d``'s padding, as
    the JAX package's max pool), concatenated ``[13, 9, 5, x]``, then 1x1 (4C), 3x3 (8C), 1x1
    (4C): ``p5_td``;
  * top-down to p4: a 1x1 route (2C) of ``p5_td`` upsampled 2x by nearest
    neighbour, concatenated after a 1x1 lateral (2C) of ``res4``, then five
    convs alternating 1x1 (2C) and 3x3 (4C): ``p4_td``; the same to p3 at C
    from ``p4_td`` and ``res3``: ``p3``;
  * bottom-up: a stride-2 3x3 (2C) of ``p3`` concatenated before ``p4_td``,
    five convs: ``p4``; a stride-2 3x3 (4C) of ``p4`` before ``p5_td``, five
    convs at 4C / 8C: ``p5``.

Outputs ``{p3, p4, p5}`` at C, 2C and 4C channels. As the FPN does, the
module owns the trunk (``bottom_up``), so parameter names read
``backbone.bottom_up.res1.preconv.weight`` and ``backbone.spp_conv1.weight``
(the JAX module names). In serving the BN layers normalize with their
running statistics.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d

SPP_POOLS = (13, 9, 5)


def _max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool2d(x, k, 1, padding=k // 2)


class YOLOV4Neck(nn.Module):
    """Trunk plus SPP/PAN: images -> ``{p3, p4, p5: [B, C_l, H, W]}``."""

    def __init__(self, bottom_up: nn.Module, in_features: Sequence[str],
                 in_channels: Sequence[int], out_channels: int, norm: str, activation: str):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = list(in_features)
        c = out_channels
        c3, c4, c5 = in_channels

        def conv(name, cin, cout, k, stride=1):
            self.add_module(name, Conv2d(cin, cout, k, stride=stride, norm=norm,
                                         activation=activation))

        conv("spp_conv1", c5, 4 * c, 1)
        conv("spp_conv2", 4 * c, 8 * c, 3)
        conv("spp_conv3", 8 * c, 4 * c, 1)
        conv("spp_conv4", 16 * c, 4 * c, 1)
        conv("spp_conv5", 4 * c, 8 * c, 3)
        conv("spp_conv6", 8 * c, 4 * c, 1)
        conv("td4_route", 4 * c, 2 * c, 1)
        conv("td4_lateral", c4, 2 * c, 1)
        self._five("td4", 4 * c, 2 * c, conv)
        conv("td3_route", 2 * c, c, 1)
        conv("td3_lateral", c3, c, 1)
        self._five("td3", 2 * c, c, conv)
        conv("bu4_down", c, 2 * c, 3, stride=2)
        self._five("bu4", 4 * c, 2 * c, conv)
        conv("bu5_down", 2 * c, 4 * c, 3, stride=2)
        self._five("bu5", 8 * c, 4 * c, conv)

    @staticmethod
    def _five(prefix: str, cin: int, width: int, conv) -> None:
        """``{prefix}_conv1..5``: 1x1 to ``width``, 3x3 to 2 ``width``, in turns."""
        for i in range(5):
            k = 3 if i % 2 else 1
            cout = 2 * width if k == 3 else width
            conv(f"{prefix}_conv{i + 1}", cin, cout, k)
            cin = cout

    def _run(self, names: List[str], x: torch.Tensor) -> torch.Tensor:
        for name in names:
            x = getattr(self, name)(x)
        return x

    def _path(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return self._run([f"{prefix}_conv{i}" for i in range(1, 6)], x)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.pyramid(self.bottom_up(images))

    def pyramid(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        c3, c4, c5 = (features[f] for f in self.in_features)
        x = self._run(["spp_conv1", "spp_conv2", "spp_conv3"], c5)
        spp = torch.cat([_max_pool_same(x, k) for k in SPP_POOLS] + [x], dim=1)
        p5_td = self._run(["spp_conv4", "spp_conv5", "spp_conv6"], spp)

        up = F.interpolate(self.td4_route(p5_td), scale_factor=2, mode="nearest")
        p4_td = self._path("td4", torch.cat([self.td4_lateral(c4), up], dim=1))
        up = F.interpolate(self.td3_route(p4_td), scale_factor=2, mode="nearest")
        p3 = self._path("td3", torch.cat([self.td3_lateral(c3), up], dim=1))

        p4 = self._path("bu4", torch.cat([self.bu4_down(p3), p4_td], dim=1))
        p5 = self._path("bu5", torch.cat([self.bu5_down(p4), p5_td], dim=1))
        return {"p3": p3, "p4": p4, "p5": p5}


def build_yolov4_neck(cfg, bottom_up: nn.Module,
                      trunk_shapes: Dict[str, tuple]) -> Tuple[YOLOV4Neck, Dict[str, tuple]]:
    """``(neck, {p3: (C, s3), p4: (2C, s4), p5: (4C, s5)})``, the strides the
    trunk's of ``NECK.IN_FEATURES``."""
    n = cfg.MODEL.NECK
    if len(n.IN_FEATURES) != 3:
        raise ValueError(f"the YOLOv4 neck takes three features, not {list(n.IN_FEATURES)}")
    c = n.OUT_CHANNELS
    neck = YOLOV4Neck(bottom_up, n.IN_FEATURES, [trunk_shapes[f][0] for f in n.IN_FEATURES],
                      c, n.NORM, n.ACTIVATION)
    strides = [trunk_shapes[f][1] for f in n.IN_FEATURES]
    return neck, {f"p{3 + i}": (c * 2 ** i, s) for i, s in enumerate(strides)}
