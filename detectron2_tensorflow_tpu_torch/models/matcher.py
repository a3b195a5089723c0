"""IoU matcher: give each prediction (anchor or proposal) a GT index and a label.

Port of the JAX package's ``models/matcher.py`` (``Matcher.__call__``),
batched over leading dimensions. The quality matrix is ``[..., G, A]`` with
padded GT rows masked to -1e10; ``torch.argmax``, like ``jnp.argmax``,
returns the first maximum, so ties pick the same GT.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


class Matcher:
    """``thresholds = [t1, ..., tk]`` ascending, ``labels`` has k+1 entries.

    quality < t1 -> labels[0]; t1 <= q < t2 -> labels[1]; ... q >= tk ->
    labels[k]. ``allow_low_quality_matches`` also marks, for every valid GT,
    the predictions tying its best IoU as positive.
    """

    def __init__(self, thresholds: Sequence[float], labels: Sequence[int],
                 allow_low_quality_matches: bool = False):
        thresholds = list(thresholds)
        if any(lo > hi for lo, hi in zip(thresholds[:-1], thresholds[1:])):
            raise ValueError(f"thresholds {thresholds} are not ascending")
        if len(labels) != len(thresholds) + 1 or any(l not in (-1, 0, 1) for l in labels):
            raise ValueError(f"labels {labels} do not fit thresholds {thresholds}")
        self.thresholds = [-float("inf")] + thresholds + [float("inf")]
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(self, quality: torch.Tensor,
                 gt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``quality [..., G, A]``, ``gt_valid [..., G]`` -> (matched GT index
        ``[..., A]`` int64, labels ``[..., A]`` int8). With no valid GT every
        prediction gets ``labels[0]`` and index 0."""
        neg_inf = -1e10
        masked = torch.where(gt_valid[..., :, None], quality,
                             torch.full_like(quality, neg_inf))
        matched_vals, _ = masked.max(dim=-2)
        matched_idx = masked.argmax(dim=-2)
        q = torch.where(matched_vals > neg_inf / 2, matched_vals,
                        torch.zeros_like(matched_vals))

        labels = torch.full(q.shape, self.labels[0], dtype=torch.int8, device=q.device)
        for lbl, lo, hi in zip(self.labels, self.thresholds[:-1], self.thresholds[1:]):
            labels = torch.where((q >= lo) & (q < hi),
                                 torch.full_like(labels, lbl), labels)

        if self.allow_low_quality_matches:
            best_per_gt, _ = masked.max(dim=-1, keepdim=True)  # [..., G, 1]
            is_best = (masked >= best_per_gt) & gt_valid[..., :, None] & (best_per_gt > 0)
            labels = torch.where(is_best.any(dim=-2), torch.ones_like(labels), labels)
        return matched_idx, labels
