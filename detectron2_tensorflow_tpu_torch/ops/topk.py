"""Exact top-k with the JAX package's tie order.

Port of the JAX package's ``ops/topk.py``. ``lax.top_k`` is stable
(equal values keep index order); ``torch.topk`` on CUDA is not. So every
top-k here is a stable descending sort plus a slice (:func:`top_k`), and
``flat_top_k`` / ``spatial_top_k`` keep the JAX package's windowed
preselect step for step. Their results, tie order included, are then the
JAX package's, not a flat sort's.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: (values, indices), ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def flat_top_k(scores: torch.Tensor, k: int, window: int = 8):
    """Exact top-k over ``[..., N]`` via a windowed preselect.

    If s ranks in the top-k, its window's max is >= s; if that window is not
    among the top-k windows by max, k other windows each hold an element
    > s, a contradiction. Falls back to :func:`top_k` when fewer than k
    windows exist.
    """
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    k = min(k, n)
    if (n + window - 1) // window < k:
        return top_k(scores, k)
    if n % window:
        pad = window - n % window
        scores = torch.cat(
            [scores, scores.new_full(lead + (pad,), float("-inf"))], dim=-1
        )
    nw = scores.shape[-1] // window
    mat = scores.reshape(lead + (nw, window))
    wmax = mat.amax(dim=-1)
    _, widx = top_k(wmax, k)
    cand = torch.gather(mat, -2, widx[..., None].expand(lead + (k, window)))
    vals, ci = top_k(cand.reshape(lead + (k * window,)), k)
    idx = torch.gather(widx, -1, ci // window) * window + ci % window
    return vals, torch.clamp(idx, max=n - 1)


def spatial_top_k(scores: torch.Tensor, k: int):
    """Exact top-k over ``[B, H, W, A]`` score maps, per image.

    Returns (values ``[B, k]``, flat (y, x, a) indices ``[B, k]``). Windows
    are the 2x2 spatial cells; falls back to a flat :func:`top_k` when the
    map is small.
    """
    b, h, w, a = scores.shape
    n = h * w * a
    k = min(k, n)
    gh, gw = -(-h // 2), -(-w // 2)
    if gh * gw < k or n < 4 * k:
        return top_k(scores.reshape(b, n), k)
    if h % 2 or w % 2:
        padded = scores.new_full((b, gh * 2, gw * 2, a), float("-inf"))
        padded[:, :h, :w] = scores
        scores = padded
    views = [
        scores[:, dy::2, dx::2].reshape(b, gh * gw, a)
        for dy in (0, 1)
        for dx in (0, 1)
    ]
    stackv = torch.cat(views, dim=-1)  # [B, gh*gw, 4A], slot = (q, a)
    wmax = stackv.amax(dim=-1)
    _, gidx = top_k(wmax, k)
    cand = torch.gather(stackv, 1, gidx[..., None].expand(b, k, 4 * a))
    vals, ci = top_k(cand.reshape(b, k * 4 * a), k)
    wi = torch.gather(gidx, 1, ci // (4 * a))
    si = ci % (4 * a)
    q = si // a
    dy, dx = q // 2, q % 2
    y = (wi // gw) * 2 + dy
    x = (wi % gw) * 2 + dx
    return vals, (y * w + x) * a + si % a
