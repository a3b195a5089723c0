"""What the meta-architectures share: input preprocessing, and the trunk,
neck and serving entry point of :class:`Detector`.

``preprocess_images`` is the port of the one in the JAX package's
``models/meta_arch/common.py``.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch import nn

from ...structures import Instances
from ..backbones.resnet import ResNet, build_resnet_backbone, output_shapes
from ..layers import BatchNorm2d
from ..necks.fpn import build_neck


def preprocess_images(images: torch.Tensor, pixel_mean, pixel_std,
                      input_format: str, dtype=torch.float32) -> torch.Tensor:
    """Normalize raw ``[B, H, W, 3]`` RGB images in float32, flip to BGR if the
    weights expect it (normalize first, then flip), and cast to ``dtype``."""
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=images.device)
    images = (images.float() - mean) / std
    if input_format == "BGR":
        images = images.flip(-1)
    return images.to(dtype)


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Detector(nn.Module):
    """What every meta-architecture here shares: preprocessing, the trunk
    and neck (``backbone``), and ``predict`` with the norms in eval mode."""

    def _build_backbone(self, cfg) -> Dict[str, tuple]:
        m = cfg.MODEL
        self.dtype = DTYPES[m.DTYPE]
        self.pixel_mean = list(m.PIXEL_MEAN)
        self.pixel_std = list(m.PIXEL_STD)
        self.input_format = m.INPUT_FORMAT
        self.backbone, shapes = build_neck(cfg, build_resnet_backbone(cfg), output_shapes(cfg))
        self.feature_shapes = shapes
        return shapes

    @property
    def trunk(self) -> ResNet:
        """The ResNet trunk (``backbone.bottom_up`` with an FPN, else ``backbone``)."""
        return getattr(self.backbone, "bottom_up", self.backbone)

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw ``[B, H, W, 3]`` images -> the neck's ``{p2..p6}`` (or the
        trunk's ``{res4}`` / ``{res5}``) ``[B, C, H, W]`` (NHWC memory)."""
        x = preprocess_images(images, self.pixel_mean, self.pixel_std,
                              self.input_format, self.dtype)
        return self.backbone(x.permute(0, 3, 1, 2))

    def predict(self, batch: Dict[str, torch.Tensor]) -> Instances:
        """Serving: ``_predict`` without gradients, with every trainable BN on
        its running statistics (a model built for training returns to its
        mode after)."""
        with torch.inference_mode(), norms_in_eval(self):
            return self._predict(batch)


@contextlib.contextmanager
def norms_in_eval(model: nn.Module):
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d) and m.training]
    for m in norms:
        m.train(False)
    try:
        yield
    finally:
        for m in norms:
            m.train(True)
