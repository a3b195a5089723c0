"""Checkpoints: the train loop's saves and resume, and pretrained weights.

Port of the JAX package's ``engine/checkpoint.py`` and of the Orbax
``CheckpointManager`` its ``train()`` drives. A checkpoint is one
``torch.save`` file, ``<directory>/<step>.pt``, holding the model's
``state_dict``, the SGD state (its momentum buffers), ``Optimizer.count``,
the samplers' generator state and the step; tensors are saved on the CPU.

:class:`CheckpointManager` keeps the Orbax manager's rules: a step is saved
when it is a multiple of the save interval, or when the directory holds no
checkpoint yet, and only when it is past the latest one; after each save the
newest ``max_to_keep`` checkpoints stay, and so does every step that is a
multiple of ``keep_period``.

``load_pretrained`` reads ``PRETRAINS.*`` into a model, keeping tensors
whose name and shape the model has and warning about the rest: ``WEIGHTS``
names a port checkpoint (a train-loop checkpoint or a bare ``state_dict``),
``DETECTRON2`` a Detectron2 ``.pkl``/``.pth`` file, ``BACKBONE`` an
ImageNet trunk for the model's ``trunk`` (a ``.pkl`` is an MSRA/caffe2
pickle, ``convert.convert_caffe2_backbone``; any other file a torchvision
state dict, ``convert.convert_torchvision_backbone``), ``MMDET`` an
mmdetection SOLOv2 checkpoint (``convert.convert_solo_weights``),
``DARKNET`` a darknet ``.weights`` file read through the JSON manifest beside
it, ``<path>.json`` (``convert.convert_darknet_weights``; one manifest serves
both packages). A file that is not there is skipped with a warning, and
training starts from the model's own weights, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def overlay_compatible(state: Dict[str, torch.Tensor],
                       restored: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state`` with each ``restored`` tensor whose name it has at the same
    shape (cast to the model tensor's dtype and device); every other
    restored tensor is skipped with a warning."""
    out = dict(state)
    for name, value in restored.items():
        if name not in state:
            logger.warning("pretrained leaf %s not in model — skipped", name)
            continue
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(state[name].shape):
            logger.warning("pretrained leaf %s has shape %s, model wants %s — skipped",
                           name, tuple(value.shape), tuple(state[name].shape))
            continue
        out[name] = value.to(dtype=state[name].dtype, device=state[name].device)
    return out


def restore_variables(path: str, model: Optional[torch.nn.Module] = None):
    """The ``state_dict`` in a port checkpoint file: a train-loop checkpoint
    (its model part; the optimizer state is dropped) or a bare state dict.
    With ``model``, the compatible tensors are loaded into it and the
    model's new ``state_dict`` is returned."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    restored = data["model"] if "model" in data and "step" in data else data
    if model is None:
        return restored
    model.load_state_dict(overlay_compatible(model.state_dict(), restored))
    return model.state_dict()


def latest_step(checkpoint_dir: str) -> Optional[int]:
    steps = all_steps(checkpoint_dir)
    return steps[-1] if steps else None


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Path of the newest checkpoint under ``checkpoint_dir``, if any."""
    step = latest_step(checkpoint_dir)
    return None if step is None else os.path.join(os.path.abspath(checkpoint_dir), f"{step}.pt")


def all_steps(checkpoint_dir: str) -> List[int]:
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(checkpoint_dir)) if m)


class CheckpointManager:
    """Saves, keeps and restores the train loop's checkpoints."""

    def __init__(self, directory: str, save_interval_steps: int, max_to_keep: int,
                 keep_period: int):
        if save_interval_steps <= 0 or keep_period == 0:
            raise ValueError("the save interval and keep period must be positive")
        self.directory = os.path.abspath(directory)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return all_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def should_save(self, step: int) -> bool:
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return step % self.save_interval_steps == 0 or not steps

    def save(self, step: int, payload: Dict, force: bool = False) -> bool:
        """Write ``payload`` as ``step`` if the rules (or ``force``) say so,
        then drop the checkpoints no rule keeps. Returns whether it wrote."""
        if not force and not self.should_save(step):
            return False
        path = os.path.join(self.directory, f"{step}.pt")
        torch.save(_to_cpu(payload), path + ".tmp")
        os.replace(path + ".tmp", path)
        steps = self.all_steps()
        keep = set(steps[-self.max_to_keep:]) if self.max_to_keep else set(steps)
        keep |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in keep:
                os.remove(os.path.join(self.directory, f"{s}.pt"))
        return True

    def restore(self, step: int) -> Dict:
        return torch.load(os.path.join(self.directory, f"{step}.pt"), map_location="cpu",
                          weights_only=True)


def load_pretrained(cfg, model: torch.nn.Module) -> bool:
    """Initialize ``model`` from the configured ``PRETRAINS`` source.
    Returns whether weights were loaded."""
    pre = cfg.PRETRAINS
    root = pre.ROOT

    def missing(path):
        if not os.path.exists(path):
            logger.warning("PRETRAINS source %s not found — skipped", path)
            return True
        return False

    if pre.WEIGHTS:
        path = os.path.join(root, pre.WEIGHTS)
        if not missing(path):
            logger.info("initializing from checkpoint %s", path)
            restore_variables(path, model)
            return True

    if pre.DETECTRON2:
        from ..convert import convert_d2_weights, load_state_dict

        path = os.path.join(root, pre.DETECTRON2)
        if missing(path):
            return False
        logger.info("initializing from Detectron2 checkpoint %s", path)
        converted, leftovers = convert_d2_weights(load_state_dict(path), cfg)
        if leftovers:
            logger.warning("unconverted checkpoint keys: %s", leftovers)
        if pre.ONLY_BACKBONE:
            converted = _backbone_only(converted, model)
        model.load_state_dict(overlay_compatible(model.state_dict(), converted))
        return True

    if pre.BACKBONE:
        from ..convert import (
            convert_caffe2_backbone,
            convert_torchvision_backbone,
            load_caffe2_pickle,
            load_state_dict,
        )

        path = os.path.join(root, pre.BACKBONE)
        if missing(path):
            return False
        logger.info("initializing backbone from %s", path)
        if path.endswith(".pkl"):
            converted, leftovers = convert_caffe2_backbone(load_caffe2_pickle(path),
                                                           _trunk_name(model))
        else:
            converted, leftovers = convert_torchvision_backbone(load_state_dict(path),
                                                                trunk=_trunk_name(model))
        if leftovers:
            logger.warning("unconverted backbone blobs: %s", leftovers)
        model.load_state_dict(overlay_compatible(model.state_dict(), converted))
        return True

    if pre.MMDET:
        from ..convert import convert_solo_weights, load_state_dict

        path = os.path.join(root, pre.MMDET)
        if missing(path):
            return False
        logger.info("initializing from mmdet checkpoint %s", path)
        converted, leftovers = convert_solo_weights(load_state_dict(path), cfg)
        if leftovers:
            logger.warning("unconverted mmdet keys: %s", leftovers)
        model.load_state_dict(overlay_compatible(model.state_dict(), converted))
        return True

    if pre.DARKNET:
        from ..convert import convert_darknet_weights, read_darknet_blob

        path = os.path.join(root, pre.DARKNET)
        if missing(path):
            return False
        logger.info("initializing from darknet weights %s", path)
        with open(path + ".json") as f:
            manifest = json.load(f)
        converted, _ = convert_darknet_weights(read_darknet_blob(path), manifest)
        model.load_state_dict(overlay_compatible(model.state_dict(), converted))
        return True
    return False


def _trunk_name(model: torch.nn.Module) -> str:
    """The module name of ``model.trunk`` (``backbone.bottom_up`` under an
    FPN, ``backbone`` without one): the JAX package's ``backbone`` subtree,
    which holds the trunk and not the FPN (nor the C4 ROI head's res5)."""
    return next(n for n, m in model.named_modules() if m is model.trunk)


def _backbone_only(converted: Dict[str, torch.Tensor],
                   model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The trunk's tensors only (``PRETRAINS.ONLY_BACKBONE``)."""
    prefix = _trunk_name(model) + "."
    return {k: v for k, v in converted.items() if k.startswith(prefix)}
