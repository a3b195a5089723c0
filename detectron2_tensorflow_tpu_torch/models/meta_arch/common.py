"""Input preprocessing shared by the meta-architectures.

Port of ``preprocess_images`` in
the JAX package's ``models/meta_arch/common.py``.
"""

from __future__ import annotations

import torch


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
