"""The training step: train state, one optimizer step per batch.

Port of ``create_train_state`` and the step of ``build_train_step`` in the
JAX package's ``engine/train.py``, on one device (no mesh). The JAX state is
an immutable pytree that the jitted step returns anew; here
:class:`TrainState` holds the model (float32 parameters), the optimizer and
the sampler's generator, and the step updates them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.meta_arch.rcnn import GeneralizedRCNN
from ..solver import Optimizer, build_optimizer


@dataclasses.dataclass
class TrainState:
    model: GeneralizedRCNN
    optimizer: Optimizer
    generator: torch.Generator  # the samplers' noise, on the model's device
    step: int = 0


def create_train_state(cfg, model: GeneralizedRCNN,
                       generator: torch.Generator) -> TrainState:
    """State for training ``model`` (built with ``build_model(...,
    training=True)``); the samplers draw from ``generator``."""
    return TrainState(model=model, optimizer=build_optimizer(cfg, model),
                      generator=generator)


def build_train_step(cfg, state: TrainState) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, noise=None) -> metrics``: losses, backward and one
    optimizer update of ``state``. ``metrics`` holds ``total_loss`` and each
    loss as detached scalars on the device (reading them synchronizes).
    ``noise`` is passed on to ``GeneralizedRCNN.losses``."""
    del cfg  # the optimizer was built from it in create_train_state

    def step_fn(batch: Dict[str, torch.Tensor],
                noise: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        losses = state.model.losses(batch, state.generator, noise)
        total = sum(losses.values())
        state.optimizer.zero_grad()
        total.backward()
        state.optimizer.step()
        state.step += 1
        return {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    return step_fn


def make_train_batch(cfg, height: int = 800, width: int = 1344) -> Dict[str, np.ndarray]:
    """A synthetic COCO-shaped training batch as numpy arrays, drawn as
    ``bench_train.py`` ``make_train_batch`` draws it (equal to it at the
    defaults): ``IMS_PER_BATCH`` images of ``height x width`` with image size
    ``(height, min(width, 1333))``, ``MAX_GT_INSTANCES`` random GT boxes per
    image (scaled by ``height / 800``), classes and 56x56 mini-masks."""
    b = cfg.SOLVER.IMS_PER_BATCH
    g = cfg.INPUT.MAX_GT_INSTANCES
    rng = np.random.default_rng(0)
    k = height / 800
    boxes = np.zeros((b, g, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 600, (b, g, 2)) * k
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(20, 200, (b, g, 2)) * k
    image = rng.uniform(0, 255, (b, height, width, 3)).astype(np.float32)
    classes = rng.integers(0, cfg.MODEL.ROI_HEADS.NUM_CLASSES, (b, g)).astype(np.int32)
    masks = rng.uniform(0, 1, (b, g, 56, 56)).astype(np.float32)
    return {
        "image": image,
        "image_size": np.tile(np.array([[height, min(width, 1333)]], np.int32), (b, 1)),
        "gt_boxes": boxes,
        "gt_classes": classes,
        "gt_valid": np.ones((b, g), bool),
        "gt_is_crowd": np.zeros((b, g), bool),
        "gt_masks": masks,
    }
