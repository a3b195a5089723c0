"""Solver: the warmup-multistep and warmup-cosine LR schedules and SGD with
momentum.

Port of the JAX package's ``solver/__init__.py``. The JAX package chains
optax transforms over the trainable parameters (the frozen trunk stages are
masked out): global-norm clipping, per-group decayed weights, ``trace``
(momentum without dampening), the bias LR factor, then the schedule. Here the
same chain is :class:`Optimizer`: the clip (optax's rule, over the trainable
gradients only), then ``torch.optim.SGD`` with one parameter group per decay
group, whose step is ``d = g + wd * p``, ``buf = momentum * buf + d`` (``buf
= d`` on the first step, as ``trace`` starts from zero), ``p -= lr * buf``;
the bias group's LR carries ``BIAS_LR_FACTOR``. ``tests/test_torch_train.py``
holds it against the optax chain step for step.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn


def lr_scale(cfg) -> float:
    """Global-batch LR multiplier (the linear scaling rule)."""
    if not cfg.SOLVER.AUTO_SCALE_LR_SCHEDULE:
        return 1.0
    return cfg.SOLVER.IMS_PER_BATCH / cfg.SOLVER.IMS_PER_BATCH_BASE


def scaled_max_iter(cfg) -> int:
    """``MAX_ITER`` shrunk as the batch grows."""
    return int(round(cfg.SOLVER.MAX_ITER / lr_scale(cfg)))


@functools.cache
def _libm_cosf():
    cosf = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    cosf.argtypes, cosf.restype = [ctypes.c_float], ctypes.c_float
    return cosf


def cosf(x: np.float32) -> np.float32:
    """The C library's float32 cosine, which XLA's CPU backend calls for
    ``jnp.cos``. Near the end of a cosine schedule ``1 + cos`` cancels, so one
    ulp of another float32 cosine (numpy's, torch's) moves the LR by
    hundreds of ulps there."""
    return np.float32(_libm_cosf()(float(x)))


def build_lr_schedule(cfg) -> Callable[[int], float]:
    """``step -> lr`` of ``SOLVER.LR_SCHEDULER_NAME``: ``WarmupMultiStepLR``
    (``GAMMA`` at each of ``STEPS``) or ``WarmupCosineLR`` (``0.5 * (1 +
    cos(pi * t / T))`` over ``T = scaled_max_iter``), each times the linear
    (or constant) warmup; computed in float32, as the JAX schedule is."""
    s = cfg.SOLVER
    name = s.LR_SCHEDULER_NAME
    if name not in ("WarmupMultiStepLR", "WarmupCosineLR"):
        raise ValueError(f"unknown SOLVER.LR_SCHEDULER_NAME: {name!r}")
    scale = lr_scale(cfg)
    f32 = np.float32
    base_lr = f32(s.BASE_LR * scale)
    steps = [int(round(x / scale)) for x in s.STEPS]
    max_iter = f32(max(scaled_max_iter(cfg), 1))
    warmup_iters, warmup_factor = s.WARMUP_ITERS, f32(s.WARMUP_FACTOR)

    def schedule(step: int) -> float:
        t = f32(step)
        if s.WARMUP_METHOD == "constant":
            warm = warmup_factor if t < warmup_iters else f32(1.0)
        else:
            alpha = np.clip(t / f32(max(warmup_iters, 1)), f32(0.0), f32(1.0))
            warm = warmup_factor * (f32(1.0) - alpha) + alpha if t < warmup_iters else f32(1.0)
        if name == "WarmupCosineLR":
            frac = np.clip(t / max_iter, f32(0.0), f32(1.0))
            decay = f32(0.5) * (f32(1.0) + cosf(f32(np.pi) * frac))
        else:
            decay = f32(1.0)
            for x in steps:
                decay = decay * (f32(s.GAMMA) if t >= x else f32(1.0))
        return float(base_lr * warm * decay)

    return schedule


def param_group(name: str) -> str:
    """``norm`` (a norm layer's affine), ``bias`` or ``weight``."""
    if ".norm." in name:
        return "norm"
    return "bias" if name.endswith(".bias") else "weight"


def trainable_parameters(model: nn.Module, freeze_at: int) -> Dict[str, nn.Parameter]:
    """Parameters outside the frozen trunk stages, by name: those the trunk
    (``model.trunk``, wherever the neck puts it) names in its
    ``frozen_modules(freeze_at)``. A ResNet's are the stem and res2 ..
    ``res{freeze_at}``, the JAX ``trainable_mask``'s; as that keys on the
    trunk's own stage names, the C4 ROI head's ``res5`` trains. A DarkNet's
    are the modules its forward detaches (``models/backbones/darknet.py``)."""
    trunk = model.trunk
    skip = {id(p) for f in trunk.frozen_modules(freeze_at) if hasattr(trunk, f)
            for p in getattr(trunk, f).parameters()}
    return {n: p for n, p in model.named_parameters() if id(p) not in skip}


class Optimizer:
    """The JAX package's optax chain over a model's trainable parameters."""

    def __init__(self, cfg, model: nn.Module):
        s = cfg.SOLVER
        self.schedule = build_lr_schedule(cfg)
        self.clip = s.CLIP_GRADIENTS_BY_NORM
        self.params: List[nn.Parameter] = list(
            trainable_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT).values())
        names = {id(p): n for n, p in model.named_parameters()}
        groups = []
        for group, decay, factor in (("weight", s.WEIGHT_DECAY, 1.0),
                                     ("bias", s.WEIGHT_DECAY_BIAS, s.BIAS_LR_FACTOR),
                                     ("norm", s.WEIGHT_DECAY_NORM, 1.0)):
            ps = [p for p in self.params if param_group(names[id(p)]) == group]
            if ps:
                groups.append({"params": ps, "weight_decay": decay, "lr_factor": factor})
        self.sgd = torch.optim.SGD(groups, lr=0.0, momentum=s.MOMENTUM, dampening=0.0,
                                   nesterov=False)
        self.count = 0

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Apply one update from the parameters' ``.grad`` (missing ones are
        zeros)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.clip > 0:
            # optax.clip_by_global_norm: g * max / |g| where |g| >= max.
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.count)
        for g in self.sgd.param_groups:
            g["lr"] = lr * g["lr_factor"]
        self.sgd.step()
        self.count += 1


def build_optimizer(cfg, model: nn.Module) -> Optimizer:
    """SGD with momentum, per-group weight decay, global-norm clipping,
    the warmup LR schedule, the bias LR factor and the frozen-stage mask."""
    return Optimizer(cfg, model)
