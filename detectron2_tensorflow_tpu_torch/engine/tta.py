"""Precise BN: re-estimate BatchNorm statistics before evaluating.

Port of ``precise_bn`` of the JAX package's ``engine/tta.py``
(``TEST.PRECISE_BN``); its ``tta_predict`` waits for its family. The trunk
and the neck (the JAX package's ``compute_features``; the ROI heads keep
their statistics) run in training mode over ``num_iters`` batches, and each
BN layer's running mean and variance become the average over those batches
of its input's batch moments, taken as in training (float32, biased
variance ``max(E[x^2] - E[x]^2, 0)``). The JAX package recovers each
batch's moments from its running-average write, ``(new - 0.9 * old) /
0.1``, which loses ~1e-5 relative to float32 cancellation; here they are
read directly. A model without trainable BN is returned unchanged.

The JAX function hands the raw ``image`` batch to ``compute_features``
without the normalization its training and serving apply first, so its
statistics describe inputs the model never sees. The port normalizes as
training does (``model.features``).
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from ..models.layers import BatchNorm2d, batch_moments


@torch.no_grad()
def precise_bn(model, data_iter: Iterable[Dict], num_iters: int) -> int:
    """Set the running statistics of every BN layer in ``model.backbone`` to
    the average of its batch moments over the first ``num_iters`` batches of
    ``data_iter`` (numpy arrays or tensors; ``image`` is read). Returns the
    number of batches used (0 leaves the model as it was)."""
    norms = [m for m in model.backbone.modules() if isinstance(m, BatchNorm2d)]
    if not norms or num_iters <= 0:
        return 0
    device = norms[0].running_mean.device
    sums = {id(m): [torch.zeros_like(m.running_mean), torch.zeros_like(m.running_var)]
            for m in norms}

    def record(mod, inputs, _):
        mean, var = batch_moments(inputs[0])
        sums[id(mod)][0] += mean
        sums[id(mod)][1] += var

    hooks = [m.register_forward_hook(record) for m in norms]
    was_training = [m.training for m in norms]
    saved = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    n = 0
    try:
        for m in norms:
            m.train(True)
        for batch in data_iter:
            if n >= num_iters:
                break
            model.features(torch.as_tensor(batch["image"]).to(device))
            n += 1
    finally:
        for h in hooks:
            h.remove()
        for m, t, (mean, var) in zip(norms, was_training, saved):
            m.train(t)
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)
    if n:
        for m in norms:
            mean, var = sums[id(m)]
            m.running_mean.copy_(mean / n)
            m.running_var.copy_(var / n)
    return n
