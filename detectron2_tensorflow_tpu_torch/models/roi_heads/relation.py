"""Relation Networks (Hu et al., CVPR 2018): ROI-to-ROI attention in the box
head and the learned duplicate removal that replaces the box head's NMS, in
serving and in training.

Port of the JAX package's ``models/roi_heads/relation.py``
(``sinusoid_embedding``, ``geometry_embeddings``, ``ObjectRelationModule``,
``RelationBoxHead``, ``build_duplicate_removal_candidates``,
``duplicate_removal_targets_multi``, ``DuplicateRemovalModule``) and of the
``RelationROIHeads`` wiring of its ``models/meta_arch/rcnn.py`` (``box``
with the proposal boxes, ``dup_removal_inference``, ``dup_removal_loss``).
Module names are the JAX ones
(``roi_heads.box_head.{fc1, relation1, fc2, relation2}``,
``roi_heads.duplicate_removal.{appearance_proj, rank_proj, relation,
logit}``, each relation module's ``geometry_weight``, ``query``, ``key``,
``value`` and ``output``), so ``convert.py`` carries the JAX weights by its
generic ``Dense`` rule.

The geometry feature follows the paper: ``log(max(|dc| / wh, 1e-3))`` and the
log size ratios, x100, embedded by sines and cosines of wavelength
``1000 ** (i / half)``. It is computed in float32 from float32 boxes and cast
to the model dtype before ``geometry_weight``, as in the JAX package. One box
head call computes the ``[B, R, R, 64]`` embedding once and both of its
relation modules read it (the JAX modules each compute the same tensor). The
attention keeps the JAX order of operations in the model dtype:
``max(wg, 1e-6)``, ``q.k / sqrt(key_dim) + log(wg)``, invalid keys at -1e9,
the softmax over the keys by ``jax.nn.softmax``'s formula, ``x +
output(...)``; it stays within each image.

In training the box head attends over each image's sampled ROIs, and with
the duplicate removal every sampled slot is a candidate: ``loss_dup`` is
the BCE of its final score (class score x sigmoid of each keep logit)
against one-positive-per-GT targets, one column per IoU threshold. Nothing
is detached: the loss reaches the class logits through the candidates'
scores, the box deltas through their decoded boxes' geometry, and the box
head through the appearance features.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.topk import top_k
from ...structures import Instances, boxes as box_ops
from ..layers import Linear
from .fast_rcnn import FastRCNNOutputLayers
from .roi_heads import SampledProposals, StandardROIHeads

# The keep-logit combinations of ``DUPLICATE_REMOVAL_COMBINE``.
COMBINE = ("mean", "max")
# The duplicate-removal module's width (a fixed 128 in the JAX package, no key).
DUP_FEATURES = 128


def sinusoid_embedding(x: torch.Tensor, dim: int, wave_length: float = 1000.0) -> torch.Tensor:
    """``[..., F]`` -> ``[..., F * dim]``: per feature ``dim / 2`` sines, then
    as many cosines, of ``x / wave_length ** (i / (dim / 2))``."""
    half = dim // 2
    feat_range = torch.arange(half, dtype=torch.float32, device=x.device)
    dim_mat = wave_length ** (feat_range / half)
    div = x[..., None] / dim_mat  # [..., F, half]
    emb = torch.cat([torch.sin(div), torch.cos(div)], dim=-1)  # [..., F, dim]
    return emb.reshape(x.shape[:-1] + (x.shape[-1] * dim,))


def geometry_embeddings(boxes: torch.Tensor, embedding_dim: int = 64) -> torch.Tensor:
    """``[..., R, 4]`` xyxy -> ``[..., R, R, embedding_dim]``: row ``m``, column
    ``n`` embeds box ``n`` seen from box ``m``."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1.0)
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    dx = torch.log(torch.clamp(torch.abs(cx[..., :, None] - cx[..., None, :]) / w[..., :, None],
                               min=1e-3))
    dy = torch.log(torch.clamp(torch.abs(cy[..., :, None] - cy[..., None, :]) / h[..., :, None],
                               min=1e-3))
    dw = torch.log(w[..., None, :] / w[..., :, None])
    dh = torch.log(h[..., None, :] / h[..., :, None])
    feats = torch.stack([dx, dy, dw, dh], dim=-1)  # [..., R, R, 4]
    return sinusoid_embedding(100.0 * feats, embedding_dim // 4)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``'s formula in ``x``'s dtype (PyTorch's softmax
    computes a bf16 input in float32, and its CPU exp rounds otherwise)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True).detach())  # the shift cancels
    return e / e.sum(dim=dim, keepdim=True)


class ObjectRelationModule(nn.Module):
    """Multi-group ROI attention with a geometric bias, added to its input."""

    def __init__(self, features: int, num_groups: int = 16, key_dim: int = 64,
                 geometry_dim: int = 64):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"relation features {features} are not divisible by "
                             f"{num_groups} groups")
        self.num_groups, self.key_dim = num_groups, key_dim
        self.geometry_weight = Linear(geometry_dim, num_groups)
        self.query = Linear(features, num_groups * key_dim)
        self.key = Linear(features, num_groups * key_dim)
        self.value = Linear(features, features)
        self.output = Linear(features, features)

    def forward(self, x: torch.Tensor, geometry: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [B, R, D]``, ``geometry [B, R, R, geometry_dim]`` (float32 from
        :func:`geometry_embeddings`, or already in ``x``'s dtype), ``valid
        [B, R]`` (the keys attended to) -> ``[B, R, D]``."""
        b, r, d = x.shape
        g, kd = self.num_groups, self.key_dim
        wg = torch.clamp(self.geometry_weight(geometry.to(x.dtype)), min=1e-6)  # [B, R, R, g]
        q = self.query(x).reshape(b, r, g, kd)
        k = self.key(x).reshape(b, r, g, kd)
        v = self.value(x).reshape(b, r, g, d // g)
        logits = torch.einsum("bigk,bjgk->bijg", q, k) / math.sqrt(float(kd))
        logits = logits + torch.log(wg)
        if valid is not None:
            logits = torch.where(valid[:, None, :, None], logits,
                                 torch.full((), -1e9, dtype=logits.dtype, device=x.device))
        attn = softmax(logits, dim=2)  # over the keys j
        out = torch.einsum("bijg,bjgc->bigc", attn, v).reshape(b, r, d)
        return x + self.output(out)


class RelationBoxHead(nn.Module):
    """fc1 -> ReLU -> relation1 -> fc2 -> ReLU -> relation2 on pooled ROIs
    ``[B*R, S, S, C]``, flattened in (h, w, c) order; no conv, and
    ``NUM_FC`` is not read (the JAX ``RelationBoxHead``)."""

    def __init__(self, in_dim: int, fc_dim: int, num_groups: int, key_dim: int,
                 geometry_dim: int):
        super().__init__()
        self.geometry_dim = geometry_dim
        self.fc1 = Linear(in_dim, fc_dim)
        self.relation1 = ObjectRelationModule(fc_dim, num_groups, key_dim, geometry_dim)
        self.fc2 = Linear(fc_dim, fc_dim)
        self.relation2 = ObjectRelationModule(fc_dim, num_groups, key_dim, geometry_dim)

    def forward(self, x: torch.Tensor, boxes: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [B*R, S, S, C]``, the ROIs' ``boxes [B, R, 4]`` and ``valid
        [B, R]`` -> ``[B*R, fc_dim]``."""
        b, r = boxes.shape[:2]
        x = x.reshape(b, r, -1)
        geometry = geometry_embeddings(boxes.float(), self.geometry_dim).to(x.dtype)
        for fc, relation in ((self.fc1, self.relation1), (self.fc2, self.relation2)):
            x = relation(F.relu(fc(x)), geometry, valid)
        return x.reshape(b * r, -1)


def build_duplicate_removal_candidates(class_logits, deltas, proposal_boxes, valid, image_sizes,
                                       box2box, num_classes: int, cls_agnostic: bool, topk: int):
    """One candidate per proposal: its first most likely foreground class
    (softmax over the K+1 float32 logits ``[B, P, K+1]``), that class's
    decoded box (the one box with ``cls_agnostic``) clipped to the image,
    and its score (0 on an invalid proposal); then each image's top
    ``min(topk, P)`` by score, ties in proposal order. Returns ``(scores,
    classes, boxes, valid & (score > 0), gather index)``, each ``[B, k,
    ...]``; the index maps a candidate to its proposal slot."""
    b, p = class_logits.shape[:2]
    sc = softmax(class_logits, dim=-1)[..., :num_classes]  # [B, P, K]
    cls = torch.argmax(sc, dim=-1)  # the first maximum, as jnp.argmax
    best = torch.where(valid, torch.gather(sc, 2, cls[..., None])[..., 0],
                       torch.zeros((), dtype=sc.dtype, device=sc.device))
    dec = box2box.apply_deltas(deltas, proposal_boxes)
    if not cls_agnostic:
        dec = torch.gather(dec.reshape(b, p, num_classes, 4), 2,
                           cls[..., None, None].expand(b, p, 1, 4))[:, :, 0]
    bbox = box_ops.clip(dec, image_sizes)
    top_s, idx = top_k(best, min(topk, p))
    top_boxes = torch.gather(bbox, 1, idx[..., None].expand(-1, -1, 4))
    return (top_s, torch.gather(cls, 1, idx), top_boxes,
            torch.gather(valid, 1, idx) & (top_s > 0), idx)


def duplicate_removal_targets(cand_boxes, cand_classes, cand_scores, cand_valid, gt_boxes,
                              gt_classes, gt_valid, iou_threshs) -> torch.Tensor:
    """One-positive-per-GT targets ``[B, N, T]`` (float32), one column per
    IoU threshold: a candidate ``[B, N, ...]`` is eligible for a GT ``[B, G,
    ...]`` when both are valid, their classes match and their IoU is at least
    the threshold, and each GT marks the eligible candidate of the highest
    score positive, the earlier one at a tie (the JAX
    ``duplicate_removal_targets_multi``, batched over images). One ``[N, G]``
    IoU serves every threshold."""
    n = cand_boxes.shape[-2]
    iou = box_ops.pairwise_iou(cand_boxes, gt_boxes)  # [B, N, G]
    base = ((cand_classes[..., :, None] == gt_classes[..., None, :])
            & cand_valid[..., :, None] & gt_valid[..., None, :])
    rows = torch.arange(n, device=cand_boxes.device)[:, None]
    scores = cand_scores[..., None].expand(iou.shape)
    cols = []
    for t in iou_threshs:
        eligible = base & (iou >= t)
        masked = torch.where(eligible, scores, torch.full_like(scores, float("-inf")))
        winner = torch.argmax(masked, dim=-2)  # [B, G], the first maximum as jnp.argmax
        onehot = (rows == winner[..., None, :]) & eligible.any(dim=-2)[..., None, :]
        cols.append(onehot.any(dim=-1).float())
    return torch.stack(cols, dim=-1)


class DuplicateRemovalModule(nn.Module):
    """The learned NMS: score-ranked candidates' appearance features plus
    their rank's embedding, one relation module, and a keep logit per
    IoU-threshold head (``[B, R, num_thresholds]``)."""

    def __init__(self, appearance_dim: int, num_groups: int = 16, key_dim: int = 64,
                 geometry_dim: int = 64, rank_dim: int = 128, num_thresholds: int = 1,
                 features: int = DUP_FEATURES):
        super().__init__()
        self.geometry_dim, self.rank_dim = geometry_dim, rank_dim
        self.appearance_proj = Linear(appearance_dim, features)
        self.rank_proj = Linear(rank_dim, features)
        self.relation = ObjectRelationModule(features, num_groups, key_dim, geometry_dim)
        self.logit = Linear(features, num_thresholds)

    def forward(self, appearance: torch.Tensor, scores: torch.Tensor, boxes: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``appearance [B, R, D]``, ``scores [B, R]`` (sorted descending; only
        their count is read), ``boxes [B, R, 4]``, ``valid [B, R]``."""
        r = scores.shape[1]
        ranks = torch.arange(r, dtype=torch.float32, device=scores.device)[:, None]
        rank_emb = sinusoid_embedding(ranks, self.rank_dim)  # the raw rank, no x100
        x = self.appearance_proj(appearance) + self.rank_proj(rank_emb.to(appearance.dtype))[None]
        x = self.relation(x, geometry_embeddings(boxes.float(), self.geometry_dim), valid)
        return self.logit(x)


class RelationROIHeads(StandardROIHeads):
    """``StandardROIHeads`` with the relation box head, which reads the
    proposal boxes, and, with ``ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_ON``,
    the learned duplicate removal in place of the class-aware NMS (the JAX
    ``rcnn.py`` ``RelationROIHeads`` branches)."""

    def _build_box_branch(self, cfg, in_channels: int) -> int:
        bh, rel = cfg.MODEL.ROI_BOX_HEAD, cfg.MODEL.ROI_BOX_RELATION_HEAD
        if rel.DUPLICATE_REMOVAL_COMBINE not in COMBINE:
            raise ValueError(f"MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_COMBINE must be "
                             f"one of {COMBINE}, got {rel.DUPLICATE_REMOVAL_COMBINE!r}")
        self.dup_combine = rel.DUPLICATE_REMOVAL_COMBINE
        # One keep-logit head and target column per IoU threshold.
        self.dup_ious = tuple(rel.DUPLICATE_REMOVAL_IOUS) or (rel.DUPLICATE_REMOVAL_IOU,)
        self.box_head = RelationBoxHead(bh.POOLER_RESOLUTION ** 2 * in_channels, bh.FC_DIM,
                                        rel.NUM_GROUPS, rel.KEY_DIM, rel.GEOMETRY_EMBEDDING_DIM)
        self.box_predictor = FastRCNNOutputLayers(bh.FC_DIM, self.num_classes,
                                                  self.cls_agnostic_bbox_reg)
        self.duplicate_removal = None
        if rel.DUPLICATE_REMOVAL_ON:
            self.duplicate_removal = DuplicateRemovalModule(
                bh.FC_DIM, rel.NMS_NUM_GROUP, rel.KEY_DIM, rel.GEOMETRY_EMBEDDING_DIM,
                rel.RANK_EMBEDDING_DIM, len(self.dup_ious))
        return in_channels

    def box_outputs(self, pooled: torch.Tensor, boxes: torch.Tensor,
                    valid: Optional[torch.Tensor] = None):
        """Pooled ``[B*R, S, S, C]`` of the ROIs ``boxes [B, R, 4]`` ->
        ``(class logits, deltas, appearance features [B*R, FC_DIM])``."""
        x = self.box_head(pooled, boxes, valid)
        scores, deltas = self.box_predictor(x)
        return scores, deltas, x

    def sample_box_losses(self, pooled: torch.Tensor, sampled: SampledProposals,
                          gt: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The relation box head over each image's sampled ROIs (their boxes
        and validity), ``loss_cls`` and ``loss_box_reg``, then with the
        duplicate removal ``loss_dup`` (the JAX ``loss_fn``'s order)."""
        scores, deltas, app = self.box_outputs(pooled, sampled.boxes, sampled.valid)
        scores, deltas = scores.float(), deltas.float()
        losses = self.box_losses(scores, deltas, sampled)
        if self.duplicate_removal is not None:
            losses["loss_dup"] = self.dup_removal_loss(scores, deltas, app, sampled, gt)
        return losses

    def dup_removal_loss(self, class_logits, deltas, appearance: torch.Tensor,
                         sampled: SampledProposals, gt: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The duplicate removal's BCE (the JAX ``dup_removal_loss``): every
        sampled slot is a candidate (``build_duplicate_removal_candidates``
        with ``topk`` = the sample size), its appearance features gathered by
        the candidate's slot, final score = class score x sigmoid of each
        float32 keep logit, clipped to [1e-6, 1 - 1e-6], against
        :func:`duplicate_removal_targets` from the GT (``gt_valid`` and not
        ``gt_is_crowd``); summed over valid candidates and divided by
        ``max(valid candidates x thresholds, 1)``. A positive whose final
        score is below 1e-6 sits on the clip and gets no gradient, as in the
        JAX package."""
        b, s = sampled.boxes.shape[:2]
        cs, cc, cb, cv, idx = build_duplicate_removal_candidates(
            class_logits.reshape(b, s, -1), deltas.reshape(b, s, -1), sampled.boxes,
            sampled.valid, gt["image_size"], self.box2box, self.num_classes,
            self.cls_agnostic_bbox_reg, s)
        app = appearance.reshape(b, s, -1)
        app = torch.gather(app, 1, idx[..., None].expand(-1, -1, app.shape[-1]))
        keep = self.duplicate_removal(app, cs, cb, cv).float()  # [B, S, T]
        final = cs[..., None] * torch.sigmoid(keep)
        gt_valid = gt["gt_valid"]
        if "gt_is_crowd" in gt:
            gt_valid = gt_valid & ~gt["gt_is_crowd"]
        targets = duplicate_removal_targets(cb.detach(), cc, cs.detach(), cv, gt["gt_boxes"],
                                            gt["gt_classes"], gt_valid, self.dup_ious)
        prob = torch.clamp(final, 1e-6, 1.0 - 1e-6)
        bce = -(targets * torch.log(prob) + (1 - targets) * torch.log1p(-prob))
        cvf = cv.float()[..., None]
        return torch.sum(bce * cvf) / torch.clamp(torch.sum(cvf) * len(self.dup_ious), min=1.0)

    def box_detections(self, proposals: Instances, storage_pack, image_sizes) -> Instances:
        """Pool every proposal slot, the relation box head over each image's
        proposals, then the learned duplicate removal or, without it,
        ``box_inference`` (class-aware NMS)."""
        boxes, valid = proposals.proposal_boxes, proposals.is_valid
        pooled = self.pool_box_features(boxes, storage_pack, valid=valid)
        scores, deltas, app = self.box_outputs(pooled, boxes, valid)
        if self.duplicate_removal is None:
            return self.box_inference(scores.float(), deltas.float(), proposals, image_sizes)
        return self.dup_removal_inference(scores.float(), deltas.float(), proposals, app,
                                          image_sizes)

    def dup_removal_inference(self, class_logits, deltas, proposals: Instances,
                              appearance: torch.Tensor, image_sizes) -> Instances:
        """The learned NMS: the top ``4 * DETECTIONS_PER_IMAGE`` candidates,
        their keep logits (float32), score = class score x the mean (or max,
        ``DUPLICATE_REMOVAL_COMBINE``) of the heads' sigmoids, 0 on an
        invalid slot or a class score <= ``SCORE_THRESH_TEST``, then a plain
        top-k to ``DETECTIONS_PER_IMAGE`` slots (padded when there are fewer
        candidates). No greedy suppression."""
        boxes = proposals.proposal_boxes
        b, p = boxes.shape[:2]
        d = self.detections_per_image
        topk = min(p, 4 * d)
        cs, cc, cb, cv, idx = build_duplicate_removal_candidates(
            class_logits.reshape(b, p, -1), deltas.reshape(b, p, -1), boxes, proposals.is_valid,
            image_sizes, self.box2box, self.num_classes, self.cls_agnostic_bbox_reg, topk)
        app = appearance.reshape(b, p, -1)
        app = torch.gather(app, 1, idx[..., None].expand(-1, -1, app.shape[-1]))
        keep = torch.sigmoid(self.duplicate_removal(app, cs, cb, cv).float())  # [B, k, T]
        final = cs * (keep.amax(dim=-1) if self.dup_combine == "max" else keep.mean(dim=-1))
        final = torch.where(cv & (cs > self.score_thresh), final, torch.zeros_like(final))
        det_scores, di = top_k(final, min(d, topk))
        det_boxes = torch.gather(cb, 1, di[..., None].expand(-1, -1, 4))
        det_classes = torch.gather(cc, 1, di)
        if topk < d:  # fewer candidates than slots: pad to the fixed contract
            det_scores = F.pad(det_scores, (0, d - topk))
            det_boxes = F.pad(det_boxes, (0, 0, 0, d - topk))
            det_classes = F.pad(det_classes, (0, d - topk))
        det_valid = det_scores > 0
        return Instances(
            boxes=torch.where(det_valid[..., None], det_boxes, torch.zeros_like(det_boxes)),
            scores=torch.where(det_valid, det_scores, torch.zeros_like(det_scores)),
            pred_classes=torch.where(det_valid, det_classes, torch.full_like(det_classes, -1)),
            is_valid=det_valid,
        )
