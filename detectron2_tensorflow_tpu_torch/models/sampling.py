"""Random foreground/background subsampling to fixed counts.

Port of the JAX package's ``models/sampling.py``, batched over images.
Uniform noise is added to an eligibility mask and the top-k is taken, which
samples without replacement among the eligible items. The JAX package draws
the noise from ``jax.random``; here it is an argument, drawn by the caller
from a ``torch.Generator`` (:func:`draw_noise`) or handed in by a test so
that both packages see the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.topk import flat_top_k


def draw_noise(generator: torch.Generator, shape, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positive, negative) uniform ``[0, 1)`` draws of ``shape`` for
    :func:`subsample_labels`, from ``generator`` (on ``device``'s type),
    which must be given: no draw comes from a global generator."""
    if generator is None:
        raise ValueError("draw_noise: pass a torch.Generator (or hand the noise in)")
    u = torch.rand((2,) + tuple(shape), generator=generator, device=device)
    return u[0], u[1]


def _sample_topk(noise: torch.Tensor, eligible: torch.Tensor, k: int):
    """Up to ``k`` of the eligible items per row -> (indices ``[B, k]``,
    picked ``[B, k]``); past the eligible count the tail is not picked."""
    score = torch.where(eligible, noise, torch.full_like(noise, -1.0))
    kk = min(k, eligible.shape[-1])
    vals, idx = flat_top_k(score, kk)
    if kk < k:
        pad = k - kk
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (pad,))], -1)
        vals = torch.cat([vals, vals.new_full(vals.shape[:-1] + (pad,), -1.0)], -1)
    return idx, vals >= 0.0


def subsample_labels(labels: torch.Tensor, num_samples: int, positive_fraction: float,
                     noise: Tuple[torch.Tensor, torch.Tensor]):
    """Sample positives (label 1) and negatives (label 0) of ``[B, N]``
    labels, ignoring -1, with ``noise = (positive, negative)`` uniform
    ``[B, N]`` draws.

    Returns ``(indices, is_positive, valid)``, each ``[B, num_samples]``:
    positives first (up to ``num_samples * positive_fraction``), then
    negatives filling the rest, valid slots compacted to the front.
    """
    pos_noise, neg_noise = noise
    num_pos_max = int(num_samples * positive_fraction)
    pos_idx, pos_picked = _sample_topk(pos_noise, labels == 1, num_pos_max)
    num_pos = pos_picked.sum(dim=-1, keepdim=True)

    # Negatives may backfill unused positive slots: sample the most that
    # could be needed, then enable exactly num_samples - num_pos.
    neg_idx, neg_picked = _sample_topk(neg_noise, labels == 0, num_samples)
    neg_rank = torch.cumsum(neg_picked.long(), dim=-1) - 1
    neg_take = neg_picked & (neg_rank < num_samples - num_pos)

    all_idx = torch.cat([pos_idx, neg_idx], -1)
    all_pos = torch.cat([torch.ones_like(pos_picked), torch.zeros_like(neg_picked)], -1)
    all_valid = torch.cat([pos_picked, neg_take], -1)
    _, order = torch.sort((~all_valid).to(torch.uint8), dim=-1, stable=True)
    take = order[..., :num_samples]
    return (torch.gather(all_idx, -1, take), torch.gather(all_pos, -1, take),
            torch.gather(all_valid, -1, take))
