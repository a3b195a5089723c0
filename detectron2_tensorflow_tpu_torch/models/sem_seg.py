"""The semantic segmentation FPN head, its loss, and the panoptic fusion.

Port of the JAX package's ``models/sem_seg.py``:

* :class:`SemSegFPNHead`: per FPN level ``max(1, log2(stride / COMMON_STRIDE))``
  conv+norm+ReLU blocks, each followed (below the common stride) by a 2x
  bilinear upsample, summed over the levels, a 1x1 ``predictor`` and an
  upsample by ``COMMON_STRIDE`` to the input's resolution. Modules carry
  Detectron2's names: level ``f``'s ``i``-th conv is ``f.{2 i}`` (the
  upsamples sit between the convs of the ``nn.Sequential``, as in
  Detectron2), its norm ``f.{2 i}.norm``, then ``predictor``.
* The bilinear upsample by an integer factor is ``F.interpolate(mode=
  "bilinear", align_corners=False)``, which equals ``jax.image.resize(...,
  "bilinear")`` there: at the border the half-pixel sample falls outside
  the input, where JAX renormalizes the weight of the one tap inside and
  PyTorch clamps to that tap, both giving the edge value
  (``tests/test_torch_panoptic.py`` holds it). In bf16 both resize in the
  input dtype; JAX rounds after each axis, PyTorch once, so they differ by
  up to two bf16 roundings of the taps' magnitudes.
* :func:`sem_seg_loss`: the masked cross entropy at input resolution over
  clipped labels, normalized by ``max(valid pixels, 1)``, with JAX's
  ``log_softmax`` formula (the max subtracted without gradient, then the
  log of the summed exponentials), which PyTorch's CPU kernel does not
  follow to the last bit.
* :func:`combine_semantic_and_instance_outputs`: the panoptic fusion,
  batched: instances in a stable descending order of their scores (invalid
  slots at -1) paste their masks (``structures.masks.paste_masks_in_image``
  at 0.5) onto free pixels when their score reaches the confidence
  threshold and the free share of the mask, in float32, exceeds ``1 -
  overlap``; then each stuff label ``1 .. NUM_CLASSES - 1`` (0 is the
  merged thing class) whose free area reaches ``STUFF_AREA_LIMIT``. Segment
  ids count accepted segments only, from 1 (0 is void); the tables have ``D
  + NUM_CLASSES + 1`` slots. It is a loop of tensor operations over the
  slots, on the tensors' device, that never reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..structures import Instances
from ..structures.masks import paste_masks_in_image
from .layers import Conv2d


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, C, factor H, factor W]``, half-pixel bilinear."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


class Upsample2x(nn.Module):
    """The 2x bilinear upsample between a level's convs (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_bilinear(x, 2)


class SemSegFPNHead(nn.Module):
    """FPN features ``{p2..p5: [B, C, H, W]}`` -> logits ``[B, K, H_in, W_in]``
    at the input's resolution, in the features' dtype (GN in float32)."""

    def __init__(self, in_features: Sequence[str], in_channels: int, strides: Sequence[int],
                 num_classes: int, convs_dim: int = 128, common_stride: int = 4,
                 norm: str = "GN"):
        super().__init__()
        self.in_features = list(in_features)
        self.common_stride = common_stride
        for f, stride in zip(self.in_features, strides):
            ups = stride > common_stride
            length = max(1, int(math.log2(stride) - math.log2(common_stride))) if ups else 1
            ops = []
            for i in range(length):
                ops.append(Conv2d(in_channels if i == 0 else convs_dim, convs_dim, 3,
                                  norm=norm, activation="relu"))
                if ups:
                    ops.append(Upsample2x())
            self.add_module(f, nn.Sequential(*ops))
        self.predictor = Conv2d(convs_dim, num_classes, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        total = None
        for f in self.in_features:
            x = getattr(self, f)(features[f])
            total = x if total is None else total + x
        return upsample_bilinear(self.predictor(total), self.common_stride)


def build_sem_seg_head(cfg, feature_shapes: Dict[str, tuple]) -> SemSegFPNHead:
    """The head ``MODEL.SEM_SEG_HEAD`` describes over the neck's
    ``{feature: (channels, stride)}``."""
    h = cfg.MODEL.SEM_SEG_HEAD
    if h.NAME != "SemSegFPNHead":
        raise NotImplementedError(f"MODEL.SEM_SEG_HEAD.NAME '{h.NAME}' is not ported")
    shapes = [feature_shapes[f] for f in h.IN_FEATURES]
    return SemSegFPNHead(h.IN_FEATURES, shapes[0][0], [s for _, s in shapes], h.NUM_CLASSES,
                         h.CONVS_DIM, h.COMMON_STRIDE, h.NORM)


def sem_seg_loss(logits: torch.Tensor, gt: torch.Tensor, ignore_value: int,
                 loss_weight: float = 1.0) -> torch.Tensor:
    """Float32 logits ``[B, K, H, W]`` and labels ``gt [B, H, W]`` (``ignore_value``
    where unlabelled) -> the masked mean cross entropy, a float32 scalar."""
    valid = gt != ignore_value
    labels = torch.clamp(gt.long(), 0, logits.shape[1] - 1)
    shifted = logits - logits.amax(1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(1))
    ce = lse - torch.gather(shifted, 1, labels[:, None])[:, 0]
    den = torch.clamp(valid.sum().float(), min=1.0)
    return loss_weight * torch.sum(ce * valid) / den


def combine_semantic_and_instance_outputs(
        detections: Instances, sem_seg: torch.Tensor, overlap_threshold: float = 0.5,
        stuff_area_limit: int = 4096, instances_confidence_threshold: float = 0.5,
        num_stuff_classes: int = 54) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The panoptic fusion of a batch (module docstring).

    ``detections``: ``boxes [B, D, 4]``, ``scores [B, D]``, ``pred_classes
    [B, D]``, ``is_valid [B, D]``, ``pred_masks [B, D, M, M]`` (probabilities);
    ``sem_seg [B, H, W]`` int stuff labels. Returns ``(panoptic_map [B, H, W]
    int32 segment ids, {"category_id": int32, "is_thing": bool, "score":
    float32, "valid": bool}`` each ``[B, D + num_stuff_classes + 1]``).
    """
    b, h, w = sem_seg.shape
    d = detections.boxes.shape[1]
    dev = sem_seg.device
    pasted = torch.stack([paste_masks_in_image(m, bx, (h, w), threshold=0.5)
                          for m, bx in zip(detections.pred_masks, detections.boxes)])
    order_scores = torch.where(detections.is_valid, detections.scores.float(),
                               torch.full_like(detections.scores, -1.0, dtype=torch.float32))
    order = torch.argsort(-order_scores, dim=1, stable=True)
    classes = detections.pred_classes.to(torch.int32)
    cap = d + num_stuff_classes + 1
    rows = torch.arange(b, device=dev)
    pixel_map = torch.zeros((b, h, w), dtype=torch.int32, device=dev)
    next_id = torch.ones((b,), dtype=torch.int32, device=dev)
    seg_cat = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
    seg_thing = torch.zeros((b, cap), dtype=torch.bool, device=dev)
    seg_score = torch.zeros((b, cap), dtype=torch.float32, device=dev)
    seg_valid = torch.zeros((b, cap), dtype=torch.bool, device=dev)
    keep_share = torch.tensor(1 - overlap_threshold, dtype=torch.float32, device=dev)

    def record(ok, table, value):
        """``table[i, next_id[i]] = value[i]`` where ``ok[i]``."""
        slot = next_id.long()[:, None]
        table.scatter_(1, slot, torch.where(ok[:, None], value[:, None], table.gather(1, slot)))

    for i in range(d):
        det = order[:, i]
        mask = pasted[rows, det]
        score = order_scores[rows, det]
        mask_area = mask.sum((1, 2))
        free = mask & (pixel_map == 0)
        free_area = free.sum((1, 2))
        ok = ((score >= instances_confidence_threshold) & (mask_area > 0)
              & (free_area.float() / torch.clamp(mask_area, min=1).float() > keep_share))
        pixel_map = torch.where(ok[:, None, None] & free, next_id[:, None, None], pixel_map)
        record(ok, seg_cat, classes[rows, det])
        record(ok, seg_thing, torch.ones_like(ok))
        record(ok, seg_score, score)
        record(ok, seg_valid, torch.ones_like(ok))
        next_id = next_id + ok.to(torch.int32)

    for c in range(1, num_stuff_classes):
        region = (sem_seg == c) & (pixel_map == 0)
        ok = region.sum((1, 2)) >= stuff_area_limit
        pixel_map = torch.where(ok[:, None, None] & region, next_id[:, None, None], pixel_map)
        record(ok, seg_cat, torch.full_like(next_id, c))
        record(ok, seg_thing, torch.zeros_like(ok))
        record(ok, seg_valid, torch.ones_like(ok))
        next_id = next_id + ok.to(torch.int32)
    return pixel_map, {"category_id": seg_cat, "is_thing": seg_thing, "score": seg_score,
                       "valid": seg_valid}
