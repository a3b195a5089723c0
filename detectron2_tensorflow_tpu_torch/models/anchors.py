"""Anchor generation (Detectron2's DefaultAnchorGenerator, and YOLO's).

Port of the JAX package's ``models/anchors.py``: cell anchors are
centered at the origin and shifted by ``stride * (x, y)`` for every grid
cell (``DefaultAnchorGenerator``) or by ``stride * (x + 0.5, y + 0.5)``, the
cell's centre (``YOLOAnchorGenerator``, whose anchors are ``(w, h)`` pixel
shapes, one set per level); per level the result is ``[H * W * A, 4]`` in
(y, x, a) order. The grid is computed in numpy, as in the JAX package, so
both give identical coordinates.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch


def _broadcast_params(params, num_levels):
    params = list(params)
    if len(params) == 1:
        return params * num_levels
    if len(params) != num_levels:
        raise ValueError(f"{len(params)} anchor parameter sets for {num_levels} levels")
    return params


def generate_cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """``[len(sizes) * len(ratios), 4]`` xyxy anchors centered at (0, 0)."""
    anchors = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, np.float32)


class DefaultAnchorGenerator:
    """Grid-shifted cell anchors per pyramid level."""

    def __init__(self, sizes, aspect_ratios, strides):
        num_levels = len(strides)
        sizes = _broadcast_params(sizes, num_levels)
        aspect_ratios = _broadcast_params(aspect_ratios, num_levels)
        self.strides = list(strides)
        self.cell_anchors = [
            generate_cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)
        ]

    @property
    def num_anchors_per_location(self) -> List[int]:
        return [len(c) for c in self.cell_anchors]

    def __call__(self, grid_sizes, device=None) -> List[torch.Tensor]:
        """grid_sizes: per-level (h, w). Returns per-level ``[h*w*A, 4]`` xyxy."""
        out = []
        for (gh, gw), stride, cell in zip(grid_sizes, self.strides, self.cell_anchors):
            shift_x = np.arange(gw, dtype=np.float32) * stride
            shift_y = np.arange(gh, dtype=np.float32) * stride
            sx, sy = np.meshgrid(shift_x, shift_y)
            shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
            anchors = (shifts + cell[None, :, :]).reshape(-1, 4)
            out.append(torch.from_numpy(anchors).to(device))
        return out


class YOLOAnchorGenerator:
    """YOLO's anchors: ``sizes[level]`` lists ``(w, h)`` pairs in input
    pixels, centred on the level's cell centres."""

    def __init__(self, sizes, strides):
        if len(sizes) != len(strides):
            raise ValueError(f"{len(sizes)} anchor size sets for {len(strides)} levels")
        self.strides = list(strides)
        self.cell_anchors = []
        for level_sizes in sizes:
            half = np.asarray(level_sizes, np.float32).reshape(-1, 2) / 2.0
            self.cell_anchors.append(np.concatenate([-half, half], axis=1))

    @property
    def num_anchors_per_location(self) -> List[int]:
        return [len(c) for c in self.cell_anchors]

    def __call__(self, grid_sizes, device=None) -> List[torch.Tensor]:
        """grid_sizes: per-level (h, w). Returns per-level ``[h*w*A, 4]`` xyxy."""
        out = []
        for (gh, gw), stride, cell in zip(grid_sizes, self.strides, self.cell_anchors):
            shift_x = (np.arange(gw, dtype=np.float32) + 0.5) * stride
            shift_y = (np.arange(gh, dtype=np.float32) + 0.5) * stride
            sx, sy = np.meshgrid(shift_x, shift_y)
            shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
            out.append(torch.from_numpy((shifts + cell[None]).reshape(-1, 4)).to(device))
        return out


def build_anchor_generator(cfg, strides: Sequence[int]):
    ag = cfg.MODEL.ANCHOR_GENERATOR
    if ag.NAME == "DefaultAnchorGenerator":
        return DefaultAnchorGenerator(ag.SIZES, ag.ASPECT_RATIOS, strides)
    if ag.NAME == "YOLOAnchorGenerator":
        return YOLOAnchorGenerator(ag.SIZES, strides)
    raise NotImplementedError(f"anchor generator '{ag.NAME}' is not ported")
