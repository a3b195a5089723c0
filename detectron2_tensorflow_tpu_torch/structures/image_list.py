"""ImageList: a batch of images padded to one static shape.

Port of the JAX package's ``structures/image_list.py``: images are
``[H, W, C]`` (NHWC once batched) and padded to a bucket; the true sizes
ride along as ``image_sizes`` ``[B, 2]`` (h, w) for clipping and pasting.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


class ImageList:
    """``tensor``: [B, H, W, C] padded images; ``image_sizes``: [B, 2] (h, w)."""

    def __init__(self, tensor: torch.Tensor, image_sizes: torch.Tensor):
        self.tensor = tensor
        self.image_sizes = image_sizes

    def __len__(self) -> int:
        return self.tensor.shape[0]

    @property
    def padded_size(self) -> Tuple[int, int]:
        return self.tensor.shape[1], self.tensor.shape[2]

    @staticmethod
    def from_tensors(
        tensors: Sequence[torch.Tensor],
        size_divisibility: int = 0,
        pad_value: float = 0.0,
        pad_to: Tuple[int, int] | None = None,
    ) -> "ImageList":
        """Pad ``[Hi, Wi, C]`` images to one shape: ``pad_to``, or the max size
        rounded up to ``size_divisibility``."""
        if not tensors:
            raise ValueError("from_tensors needs at least one image")
        sizes = [(int(t.shape[0]), int(t.shape[1])) for t in tensors]
        if pad_to is not None:
            max_h, max_w = pad_to
        else:
            max_h = max(h for h, _ in sizes)
            max_w = max(w for _, w in sizes)
        if size_divisibility > 0:
            d = size_divisibility
            max_h = -(-max_h // d) * d
            max_w = -(-max_w // d) * d
        batch = []
        for t, (h, w) in zip(tensors, sizes):
            if h > max_h or w > max_w:
                raise ValueError(f"image {(h, w)} larger than bucket {(max_h, max_w)}")
            batch.append(F.pad(t, (0, 0, 0, max_w - w, 0, max_h - h), value=pad_value))
        image_sizes = torch.tensor(sizes, dtype=torch.int32, device=tensors[0].device)
        return ImageList(torch.stack(batch), image_sizes)
