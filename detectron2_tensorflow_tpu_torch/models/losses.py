"""Detection losses, elementwise and unreduced: callers apply validity
masks and normalizers.

Port of ``smooth_l1_loss``, ``sigmoid_focal_loss``, ``sigmoid_cross_entropy``,
``softmax_cross_entropy`` and ``dice_loss`` in the JAX package's
``models/losses.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with the gradient 1 at 0, as ``jnp.abs`` has (``torch.abs``: 0)."""
    return torch.where(x >= 0, x, -x)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Huber-style loss; ``beta = 0`` is pure L1."""
    diff = _abs(pred - target)
    if beta <= 0.0:
        return diff
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


def sigmoid_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy. At a logit of exactly 0 its
    gradient is ``-targets``, the JAX package's (``jnp.maximum`` gives 1/2
    there and ``jnp.abs`` 1): ``torch.relu`` and ``torch.abs`` give 0 each."""
    return (torch.relu(logits) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Focal loss on sigmoid logits (Lin et al. 2017), ``targets`` in {0, 1}:
    :func:`sigmoid_cross_entropy` (and its subgradients at 0) scaled by
    ``(1 - p_t) ** gamma`` and, for ``alpha >= 0``, by ``alpha_t``."""
    p = torch.sigmoid(logits)
    ce = sigmoid_cross_entropy(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with integer labels over the last axis; labels are
    clipped into range (callers mask invalid rows)."""
    labels = torch.clamp(labels, 0, logits.shape[-1] - 1).long()
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def dice_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-instance dice loss ``[N]`` of ``[N, ...]`` sigmoid probabilities:
    ``1 - (2 sum(p t) + eps) / (sum(p^2) + sum(t^2) + eps)``."""
    p = pred.reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    inter = torch.sum(p * t, dim=1)
    denom = torch.sum(p * p, dim=1) + torch.sum(t * t, dim=1)
    return 1.0 - (2.0 * inter + eps) / (denom + eps)
