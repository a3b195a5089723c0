"""Fixed-shape exact greedy NMS, batched over images.

Port of the JAX package's ``ops/nms.py`` (``nms``, ``nms_fixed``,
``class_aware_nms``). Boxes are score-sorted once; the keep mask over the
sorted order comes from :func:`greedy_keep`; outputs are fixed-capacity
tensors with validity masks. Every function takes ``[B, N, ...]`` inputs
and treats each image independently, as the JAX package's per-image vmap
does.

:func:`greedy_keep` dispatches on the device of its input: a CPU tensor goes
to the plain PyTorch version (:func:`greedy_keep_reference`), a CUDA tensor
to the hand-written kernel ``csrc/nms_keep.cu``, which replaces the TPU
kernel ``ops/pallas/nms_keep.py`` ``greedy_keep``. Both give the keep mask
of the JAX package bit for bit (the IoU is ``structures.boxes.pairwise_iou``'s
float32 arithmetic). :func:`nms_fixed_levels` runs the NMS of several
candidate sets (the RPN's levels) as one batch, so one keep-mask launch
serves them all.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..structures import boxes as box_ops
from .topk import top_k

NEG_INF = -1e10
MAX_N = 16384  # csrc/nms_keep.cu: the sweep's "removed" vector of N / 64 words
PAD_BOX = -1e8  # csrc/nms_keep.cu: a far-away box, which overlaps nothing


def _mk(max_keep, n):
    return None if max_keep is None or max_keep >= n else int(max_keep)


def greedy_keep_reference(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor,
                          iou_threshold: float, max_keep=None) -> torch.Tensor:
    """Plain PyTorch keep mask ``[B, N]`` of exact greedy NMS.

    ``sorted_boxes`` ``[B, N, 4]`` are score-sorted per image. Box i is kept
    iff it is valid and no kept box before it overlaps it above the
    threshold. Solved as the fixed point of ``alive = valid & ~any_{j<i}
    (over[j, i] & alive[j])``, which is unique and reached after at most N
    rounds (each round fixes one more prefix position). With ``max_keep``
    only the first ``max_keep`` survivors are kept, as the kernel's early
    exit does.
    """
    n = sorted_boxes.shape[-2]
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=sorted_boxes.device)
    iou = box_ops.pairwise_iou(sorted_boxes.float(), sorted_boxes.float())
    later = torch.ones(n, n, dtype=torch.bool, device=sorted_boxes.device).triu(1)
    over = (iou > thr) & later  # over[i, j]: earlier i suppresses later j
    alive = sorted_valid.clone()
    while True:
        sup = (over & alive[..., :, None]).any(dim=-2)
        new = sorted_valid & ~sup
        if torch.equal(new, alive):
            break
        alive = new
    mk = _mk(max_keep, n)
    if mk is not None:
        alive = alive & (torch.cumsum(alive.int(), dim=-1) <= mk)
    return alive


def _greedy_keep_cuda(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor,
                      iou_threshold: float, max_keep=None) -> torch.Tensor:
    if sorted_boxes.dtype != torch.float32 or not sorted_boxes.is_contiguous():
        raise ValueError("greedy_keep: boxes must be contiguous float32 [B, N, 4]")
    if sorted_boxes.dim() != 3 or sorted_boxes.shape[-1] != 4:
        raise ValueError(f"greedy_keep: boxes shape {tuple(sorted_boxes.shape)} is not [B, N, 4]")
    b, n, _ = sorted_boxes.shape
    if (sorted_valid.dtype != torch.bool or not sorted_valid.is_contiguous()
            or tuple(sorted_valid.shape) != (b, n)
            or sorted_valid.device != sorted_boxes.device):
        raise ValueError("greedy_keep: valid must be a contiguous bool [B, N] on the boxes' device")
    if n > MAX_N:
        raise ValueError(f"greedy_keep: N={n} exceeds the kernel's {MAX_N}")
    if sorted_boxes.data_ptr() % 16:
        raise ValueError("greedy_keep: boxes must be 16-byte aligned")
    lib = kernels.load("nms_keep")
    # The mask pass writes the upper triangle of [B, N, ceil(N / 64)] words
    # and the sweep reads nothing else, so the scratch is left uninitialized.
    mask = torch.empty((b, n, -(-n // 64)), dtype=torch.int64, device=sorted_boxes.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=sorted_boxes.device)
    mk = _mk(max_keep, n)
    stream = torch.cuda.current_stream(sorted_boxes.device).cuda_stream
    rc = lib.nms_keep_launch(
        sorted_boxes.data_ptr(), sorted_valid.data_ptr(), mask.data_ptr(),
        keep.data_ptr(), b, n, ctypes.c_float(iou_threshold),
        n if mk is None else mk, stream,
    )
    greedy_keep.launches += 1
    kernels.check(rc, "nms_keep_launch")
    return keep


def greedy_keep(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor,
                iou_threshold: float, max_keep=None) -> torch.Tensor:
    """Keep mask ``[B, N]`` bool of exact greedy NMS over score-sorted boxes.

    CPU tensors take :func:`greedy_keep_reference`; CUDA tensors the kernel
    (``greedy_keep.launches`` counts its launches). Anything else raises.
    """
    dev = sorted_boxes.device.type
    if dev == "cpu":
        return greedy_keep_reference(sorted_boxes, sorted_valid, iou_threshold, max_keep)
    if dev == "cuda":
        return _greedy_keep_cuda(sorted_boxes, sorted_valid, iou_threshold, max_keep)
    raise RuntimeError(f"greedy_keep: no implementation for device '{dev}'")


greedy_keep.launches = 0


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i]]`` for ``x`` ``[B, N, ...]`` and ``idx`` ``[B, K]``."""
    b, k = idx.shape
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    out = torch.gather(flat, 1, idx[..., None].expand(b, k, flat.shape[-1]))
    return out.reshape((b, k) + x.shape[2:])


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        valid: torch.Tensor | None = None, max_keep: int | None = None,
        presorted: bool = False):
    """Exact greedy NMS over ``[B, N, 4]`` boxes.

    Returns ``(order, keep, kept_scores)``, each ``[B, N]``: ``order`` sorts
    the input by descending score, ``keep`` marks the survivors in that
    order, ``kept_scores`` holds their scores and NEG_INF elsewhere.
    ``presorted`` promises the valid scores are already descending. With
    ``max_keep`` only the first ``max_keep`` survivors are kept, which is
    exact for any consumer of at most that many.
    """
    b, n = scores.shape
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    if presorted:
        order = torch.arange(n, device=scores.device).expand(b, n)
        sorted_scores, sorted_boxes = masked, boxes
    else:
        sorted_scores, order = top_k(masked, n)
        sorted_boxes = _gather_rows(boxes, order)
    sorted_valid = sorted_scores > NEG_INF / 2
    keep = greedy_keep(sorted_boxes.float().contiguous(), sorted_valid.contiguous(),
                       iou_threshold, max_keep=max_keep)
    return order, keep, torch.where(keep, sorted_scores, torch.full_like(sorted_scores, NEG_INF))


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              max_outputs: int, valid: torch.Tensor | None = None,
              presorted: bool = False):
    """NMS with a fixed-size result: the top ``max_outputs`` survivors.

    Returns ``(boxes [B, M, 4], scores [B, M], indices [B, M], valid [B, M])``;
    ``indices`` point into the input, empty slots score NEG_INF.
    """
    order, keep, kept_scores = nms(boxes, scores, iou_threshold, valid,
                                   max_keep=max_outputs, presorted=presorted)
    b, n = scores.shape
    k = min(max_outputs, n)
    top_scores, top_pos = top_k(kept_scores, k)
    out_indices = torch.gather(order, 1, top_pos)
    out_valid = top_scores > NEG_INF / 2
    out_boxes = _gather_rows(boxes, out_indices)
    if k < max_outputs:
        pad = max_outputs - k
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros(b, pad, 4)], 1)
        top_scores = torch.cat([top_scores, top_scores.new_full((b, pad), NEG_INF)], 1)
        out_indices = torch.cat([out_indices, out_indices.new_zeros(b, pad)], 1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(b, pad)], 1)
    return out_boxes, top_scores, out_indices, out_valid


def class_aware_nms(boxes: torch.Tensor, scores: torch.Tensor,
                    classes: torch.Tensor, iou_threshold: float,
                    max_outputs: int, valid: torch.Tensor | None = None,
                    class_agnostic: bool = False, presorted: bool = False):
    """Per-class NMS by the coordinate-offset trick.

    Each image's boxes are shifted by ``class * (max coordinate + 1)`` so
    boxes of different classes never overlap and one NMS equals per-class
    NMS; the float32 operations are the JAX package's, in its order.
    Returns the tuple of :func:`nms_fixed` with the unshifted boxes.
    """
    if class_agnostic:
        return nms_fixed(boxes, scores, iou_threshold, max_outputs, valid,
                         presorted=presorted)
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    max_coord = finite.amax(dim=(1, 2)) + 1.0  # [B]
    offsets = classes.to(boxes.dtype) * max_coord[:, None]
    shifted = boxes + offsets[..., None]
    _, out_scores, out_indices, out_valid = nms_fixed(
        shifted, scores, iou_threshold, max_outputs, valid, presorted=presorted
    )
    out_boxes = _gather_rows(boxes, out_indices)
    out_boxes = torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    return out_boxes, out_scores, out_indices, out_valid


def nms_fixed_levels(levels, iou_threshold: float, max_outputs: int):
    """:func:`nms_fixed` of each candidate set in ``levels``, in one batch.

    ``levels`` holds ``(boxes [B, k_l, 4], scores [B, k_l], valid [B, k_l])``
    per set, each score-sorted (``presorted``). The sets are padded at the
    end to the largest ``k_l`` with invalid rows (score NEG_INF, the kernel's
    far-away box) and stacked as ``[B x L, N]`` rows of one
    :func:`nms_fixed` call with ``min(max_outputs, N)`` outputs. Returns
    ``(boxes, scores, valid)`` per set, each cut to ``min(max_outputs,
    k_l)`` slots: equal to the set's own ``nms_fixed(..., min(max_outputs,
    k_l), presorted=True)``, since an invalid row is never kept and
    suppresses nothing, a cap of ``min(max_outputs, N)`` binds only where
    ``min(max_outputs, k_l)`` does, and the stable top-k puts the padded
    rows after the set's own.
    """
    b = levels[0][1].shape[0]
    n = max(scores.shape[1] for _, scores, _ in levels)

    def pad(x, value):
        extra = n - x.shape[1]
        return x if extra == 0 else torch.cat([x, x.new_full((b, extra) + x.shape[2:], value)], 1)

    boxes = torch.stack([pad(bx, PAD_BOX) for bx, _, _ in levels], 1).reshape(-1, n, 4)
    scores = torch.stack([pad(s, NEG_INF) for _, s, _ in levels], 1).reshape(-1, n)
    valid = torch.stack([pad(v, False) for _, _, v in levels], 1).reshape(-1, n)
    m = min(max_outputs, n)
    out_boxes, out_scores, _, out_valid = nms_fixed(boxes, scores, iou_threshold, m,
                                                    valid=valid, presorted=True)
    out_boxes = out_boxes.reshape(b, len(levels), m, 4)
    out_scores = out_scores.reshape(b, len(levels), m)
    out_valid = out_valid.reshape(b, len(levels), m)
    cuts = [min(max_outputs, s.shape[1]) for _, s, _ in levels]
    return [(out_boxes[:, l, :k], out_scores[:, l, :k], out_valid[:, l, :k])
            for l, k in enumerate(cuts)]
