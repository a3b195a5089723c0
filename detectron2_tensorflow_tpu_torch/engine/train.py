"""Training: the train state, one optimizer step per batch, and the loop.

Port of ``create_train_state``, the step of ``build_train_step`` and
``train`` in the JAX package's ``engine/train.py``, on one device. The JAX
state is an immutable pytree that the jitted step returns anew; here
:class:`TrainState` holds the model (float32 parameters), the optimizer and
the samplers' generator, and the step updates them in place. ``train``
resumes from the newest checkpoint or loads ``PRETRAINS``, saves and keeps
checkpoints as the JAX package's Orbax manager does, and evaluates every
``TEST.EVAL_PERIOD`` steps. The JAX package's mesh, multi-host feeding and
TensorBoard logger have no counterpart here yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import num_classes_of
from ..solver import Optimizer, build_optimizer, scaled_max_iter
from .checkpoint import CheckpointManager, load_pretrained

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module  # a GeneralizedRCNN, ProposalNetwork or SingleStageDetector
    optimizer: Optimizer
    generator: torch.Generator  # the samplers' noise, on the model's device
    step: int = 0
    # (step, {metric: value}, seconds per iteration) of each line train() logs.
    history: List[Tuple[int, Dict[str, float], float]] = dataclasses.field(default_factory=list)


def create_train_state(cfg, model: torch.nn.Module,
                       generator: torch.Generator) -> TrainState:
    """State for training ``model`` (built with ``build_model(...,
    training=True)``); the samplers draw from ``generator``."""
    return TrainState(model=model, optimizer=build_optimizer(cfg, model),
                      generator=generator)


def build_train_step(cfg, state: TrainState) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, noise=None) -> metrics``: losses, backward and one
    optimizer update of ``state``. ``metrics`` holds ``total_loss`` and each
    loss as detached scalars on the device (reading them synchronizes).
    ``noise`` is passed on to the model's ``losses`` (a RetinaNet's moves
    its ``loss_normalizer`` there, which the checkpoints carry)."""
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
    image (scaled by ``height / 800``), classes (of the model's class count:
    ``ROI_HEADS`` or, for a single-stage model, ``SINGLE_STAGE_HEAD``),
    56x56 mini-masks and, with ``KEYPOINT_ON``, ``NUM_KEYPOINTS`` keypoints
    per GT box, uniform in the box, visibility 0, 1 or 2 (drawn last, so
    the other fields do not depend on it)."""
    b = cfg.SOLVER.IMS_PER_BATCH
    g = cfg.INPUT.MAX_GT_INSTANCES
    rng = np.random.default_rng(0)
    k = height / 800
    boxes = np.zeros((b, g, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 600, (b, g, 2)) * k
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(20, 200, (b, g, 2)) * k
    image = rng.uniform(0, 255, (b, height, width, 3)).astype(np.float32)
    classes = rng.integers(0, num_classes_of(cfg), (b, g)).astype(np.int32)
    masks = rng.uniform(0, 1, (b, g, 56, 56)).astype(np.float32)
    batch = {
        "image": image,
        "image_size": np.tile(np.array([[height, min(width, 1333)]], np.int32), (b, 1)),
        "gt_boxes": boxes,
        "gt_classes": classes,
        "gt_valid": np.ones((b, g), bool),
        "gt_is_crowd": np.zeros((b, g), bool),
        "gt_masks": masks,
    }
    if cfg.MODEL.KEYPOINT_ON:
        k = cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS
        at = rng.uniform(0, 1, (b, g, k, 2))
        kp = np.zeros((b, g, k, 3), np.float32)
        kp[..., :2] = boxes[:, :, None, :2] + at * (boxes[:, :, None, 2:] - boxes[:, :, None, :2])
        kp[..., 2] = rng.integers(0, 3, (b, g, k))
        batch["gt_keypoints"] = kp
    return batch


def add_proposal_slots(cfg, batch: Dict[str, np.ndarray], training: bool,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """``batch`` with the precomputed-proposal slots a ``MODEL.LOAD_PROPOSALS``
    model reads: per image, ``data.jittered_proposals`` of its ``gt_boxes``
    (8 jittered copies of each valid GT box, scored U(0, 10)) in the
    loader's top-k slots (``PRECOMPUTED_PROPOSAL_TOPK_TRAIN`` or ``_TEST``)."""
    from ..data.loader import proposal_slots
    from ..data.synthetic import jittered_proposals

    rng = np.random.default_rng(seed)
    topk = (cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if training
            else cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)
    slots = []
    for boxes, valid, (h, w) in zip(batch["gt_boxes"], batch["gt_valid"], batch["image_size"]):
        props, scores = jittered_proposals(boxes[valid], int(h), int(w), rng)
        slots.append(proposal_slots(props, scores, topk))
    return {**batch, **{k: np.stack([s[k] for s in slots]) for k in slots[0]}}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def checkpoint_payload(state: TrainState) -> Dict[str, Any]:
    """What a checkpoint holds: the model, the SGD state (its momentum
    buffers), the optimizer's step count, the generator and the step."""
    return {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.sgd.state_dict(),
        "count": state.optimizer.count,
        "generator": state.generator.get_state(),
    }


def restore_train_state(state: TrainState, payload: Dict[str, Any]) -> None:
    """Load a :func:`checkpoint_payload` into ``state``, in place."""
    state.model.load_state_dict(payload["model"])
    state.optimizer.sgd.load_state_dict(payload["optimizer"])
    state.optimizer.count = int(payload["count"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])


def train(
    cfg,
    model: torch.nn.Module,
    data_iter: Iterator[Dict[str, Any]],
    max_iter: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    log_every: int = 10,
    eval_fn: Optional[Callable[[TrainState, int], Dict[str, float]]] = None,
) -> TrainState:
    """Train ``model`` (built with ``build_model(..., training=True)``) on the
    batches of ``data_iter`` (numpy arrays or tensors, as
    ``data.build_dataloader`` yields them) up to step ``max_iter``
    (``scaled_max_iter(cfg)`` when not given). Returns the final state.

    If ``checkpoint_dir`` holds checkpoints, training resumes from the
    newest (model, momentum, optimizer count, generator, step); otherwise
    ``PRETRAINS`` initializes the weights. The samplers' generator is seeded
    with ``max(cfg.SEED, 0)``. Checkpoints are saved every
    ``SOLVER.SHORT_TERM_SAVE_STEPS`` steps; the newest
    ``SHORT_TERM_NUM_STEPS // SHORT_TERM_SAVE_STEPS`` stay, and so does every
    multiple of ``LONG_TERM_SAVE_STEPS``; the last step is saved unless it is
    on disk already. ``eval_fn(state, step) -> metrics`` runs every
    ``TEST.EVAL_PERIOD`` steps and at the end. Every ``log_every`` steps
    the metrics are read (which waits for the device), logged and kept in
    ``state.history``, where the JAX package writes them to TensorBoard.
    """
    if not model.training:
        raise ValueError("train: build the model with build_model(..., training=True)")
    max_iter = max_iter if max_iter is not None else scaled_max_iter(cfg)
    device = next(model.parameters()).device
    first = next(data_iter)
    generator = torch.Generator(device).manual_seed(max(cfg.SEED, 0))
    state = create_train_state(cfg, model, generator)

    s = cfg.SOLVER
    manager = None
    if checkpoint_dir:
        manager = CheckpointManager(
            checkpoint_dir,
            save_interval_steps=s.SHORT_TERM_SAVE_STEPS,
            max_to_keep=max(1, s.SHORT_TERM_NUM_STEPS // max(s.SHORT_TERM_SAVE_STEPS, 1)),
            keep_period=s.LONG_TERM_SAVE_STEPS,
        )
    start_step = 0
    resume_step = manager.latest_step() if manager is not None else None
    if resume_step is not None:
        restore_train_state(state, manager.restore(resume_step))
        start_step = state.step
        logger.info("resumed from checkpoint step %d", start_step)
    else:
        load_pretrained(cfg, model)
    step_fn = build_train_step(cfg, state)

    def run_eval(step):
        metrics = eval_fn(state, step)
        logger.info("eval @ %d: %s", step, {k: round(float(v), 4) for k, v in metrics.items()})

    eval_period = cfg.TEST.EVAL_PERIOD if eval_fn is not None else 0
    batch = first
    t_last = time.time()
    for it in range(start_step, max_iter):
        metrics = step_fn(to_device(batch, device))
        if it + 1 < max_iter:
            batch = next(data_iter)
        if (it + 1) % log_every == 0:
            values = {k: float(v) for k, v in metrics.items()}
            dt = (time.time() - t_last) / log_every
            t_last = time.time()
            state.history.append((it + 1, values, dt))
            logger.info("iter %d/%d  %s  (%.3fs/it)", it + 1, max_iter,
                        {k: round(v, 4) for k, v in values.items()}, dt)
        if manager is not None:
            manager.save(it + 1, checkpoint_payload(state))
        if eval_period > 0 and (it + 1) % eval_period == 0 and it + 1 < max_iter:
            run_eval(it + 1)
    if manager is not None and max_iter > start_step and manager.latest_step() != max_iter:
        manager.save(max_iter, checkpoint_payload(state), force=True)
    if eval_fn is not None and max_iter > start_step:
        run_eval(max_iter)
    return state
