"""SOLOv2: grid-cell instance segmentation with dynamic mask kernels.

Port of the JAX package's ``models/single_stage/solov2.py`` (``SOLOv2Head``
and the ``SOLOv2`` class around it), the same computation in the same order.

The head (``SOLOv2Head``) resizes each level (p2-p6) to its ``S x S`` grid
with ``jax.image.resize``'s antialiased bilinear rule (every level shrinks at
800 x 1344, where plain bilinear differs by up to ~1 on unit normals), then
runs two towers of ``MASK_KERNEL_NUM_CONVS`` 3x3 convs with GN and ReLU,
shared across levels: the kernel tower on the level and two coord-conv
channels (x, then y, in [-1, 1]), the category tower on the level alone;
``kernel_pred`` and ``cate_pred`` (bias ``-log((1 - p) / p)``) follow. The
mask-feature branch chains each of p2-p5 to stride 4 (a conv, GN, ReLU and a
2x bilinear upsample per octave; coord channels on p5), sums them and
applies a 1x1 conv with GN and ReLU. ``MODEL.SOLO.USE_DEFORM_CONV`` makes
every tower conv a :class:`~..deform_conv.DeformConv2d` with its norm,
followed by a ReLU. Modules carry the JAX names (``head.cate_tower_{i}``,
``head.kernel_tower_{i}``, ``head.cate_pred``, ``head.kernel_pred``,
``head.mask_{f}_{i}``, ``head.mask_pred``), so ``convert.py`` maps them one
to one.

The ``SOLOv2`` class, batched over images where the JAX one maps a
per-image function:

  * GT assignment per level (``assign_level``): a GT of the level's scale
    range claims the cells of its sigma-shrunk centre region (its mass
    centre from the mini-mask, the region clipped to one cell around the
    centre cell); a cell claimed twice goes to the smallest ``sqrt(area)``,
    ties to the first GT;
  * losses: the sigmoid focal loss over every level's cells; the positive
    cells capped at ``MAX_POS`` (the top 256 of ``pos + U(0, 0.5)``, the
    uniform draws from a ``torch.Generator`` or handed in as
    ``noise["solo"]``); their kernels against the mask features (one float32
    product), the GT masks pasted from the mini-masks at stride 4, the dice
    loss (``dice+bce`` adds a saturation-safe BCE);
  * inference: point NMS (a 2x2 max pool padded with ``-inf`` on the top and
    left), a stable top-k over ``[cells x K]``, the dynamic conv in float32,
    the maskness rescore, a stable sort, :func:`~...ops.nms.matrix_nms`, a
    top-k of ``DETECTIONS_PER_IMAGE`` and boxes from the masks' extents
    times 4. The masks are whole frames at stride 4 (``[B, D, H/4, W/4]``
    bool), not box crops.

The products (the dynamic conv and the matrix NMS's intersections) are
XLA in the JAX package, no Pallas kernel, and are ``torch`` products here.
``MODEL.SOLO.MASK_KERNEL_SIZE`` other than 1 raises: the JAX head emits
``size^2 * D`` kernel channels but convolves them as 1x1 kernels of ``D``,
so any other size fails on its shapes there. ``MODEL.SOLO.NMS_CLS_AGNOSTIC``
is read by neither package (matrix NMS is class-aware), and neither reads
``SINGLE_STAGE_HEAD.SCORE_THRESH_TEST`` (``SOLOv2`` reads
``MODEL.SOLO.SCORE_THRESH_TEST``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import matrix_nms
from ...ops.topk import top_k
from ...structures import Instances
from ...structures.masks import paste_masks_in_image
from ..deform_conv import DeformConv2d
from ..layers import Conv2d
from ..losses import dice_loss, sigmoid_focal_loss
from ..sem_seg import upsample_bilinear

# Positive cells per image whose masks the loss computes (a fixed shape).
MAX_POS = 256
# The mask features' stride, by which the JAX package scales the boxes.
MASK_STRIDE = 4


def coord_grids(b: int, h: int, w: int, dtype, device) -> torch.Tensor:
    """``[B, 2, h, w]`` coord-conv channels in [-1, 1], x then y (computed in
    float32, cast to ``dtype``)."""
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
    return grid.to(dtype)[None].expand(b, 2, h, w)


def resize_to_grid(x: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, C, size, size]`` as ``jax.image.resize(...,
    "bilinear")`` resizes (antialiased: a shrinking axis spreads its
    triangle kernel over the scale), computed in float32, cast back."""
    out = F.interpolate(x.float(), size=(size, size), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.to(x.dtype)


class SOLOv2Head(nn.Module):
    """FPN levels ``{p2..p6: [B, C, H, W]}`` -> (category logits ``[B, S, S,
    K]`` per level, kernels ``[B, S, S, E]`` per level, mask features ``[B,
    D, H2, W2]`` at stride 4), in the features' dtype (GN in float32)."""

    def __init__(self, in_channels: int, num_classes: int, in_features: Sequence[str],
                 num_grids: Sequence[int], num_convs: int = 4, convs_dim: int = 512,
                 kernel_out: int = 256, norm: str = "GN", prior_prob: float = 0.01,
                 mask_in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
                 mask_strides: Sequence[int] = (4, 8, 16, 32), mask_convs_dim: int = 128,
                 mask_out_dims: int = 256, mask_norm: str = "GN", use_deform: bool = False,
                 deform_modulated: bool = False):
        super().__init__()
        self.in_features = list(in_features)
        self.num_grids = list(num_grids)
        self.num_convs = num_convs
        self.mask_in_features = list(mask_in_features)
        self.use_deform = use_deform
        self.deform_modulated = deform_modulated
        for i in range(num_convs):
            self.add_module(f"cate_tower_{i}", self._tower_conv(
                in_channels if i == 0 else convs_dim, convs_dim, norm))
            self.add_module(f"kernel_tower_{i}", self._tower_conv(
                in_channels + 2 if i == 0 else convs_dim, convs_dim, norm))
        self.cate_pred = Conv2d(convs_dim, num_classes, 3)
        self.kernel_pred = Conv2d(convs_dim, kernel_out, 3)
        # The classifier's initial bias: every cell starts at prior_prob.
        self.prior_bias = -math.log((1 - prior_prob) / prior_prob)
        self.mask_chains = []
        for f, stride in zip(self.mask_in_features, mask_strides):
            names = []
            for i in range(max(1, int(math.log2(stride)) - 2)):
                cin = mask_convs_dim if i else in_channels + 2 * (f == self.mask_in_features[-1])
                self.add_module(f"mask_{f}_{i}", self._tower_conv(cin, mask_convs_dim,
                                                                 mask_norm))
                names.append(f"mask_{f}_{i}")
            self.mask_chains.append((f, stride, names))
        self.mask_pred = Conv2d(mask_convs_dim, mask_out_dims, 1, norm=mask_norm,
                                activation="relu")

    def _tower_conv(self, cin: int, cout: int, norm: str) -> nn.Module:
        if self.use_deform:
            return DeformConv2d(cin, cout, 3, modulated=self.deform_modulated, norm=norm)
        return Conv2d(cin, cout, 3, norm=norm, activation="relu")

    def _tower(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        return F.relu(x) if self.use_deform else x

    def forward(self, features: Dict[str, torch.Tensor]):
        cate_logits, kernels = [], []
        for f, s in zip(self.in_features, self.num_grids):
            x = resize_to_grid(features[f], s)
            k = torch.cat([x, coord_grids(x.shape[0], s, s, x.dtype, x.device)], 1)
            for i in range(self.num_convs):
                k = self._tower(f"kernel_tower_{i}", k)
            kernels.append(self.kernel_pred(k).permute(0, 2, 3, 1))
            c = x
            for i in range(self.num_convs):
                c = self._tower(f"cate_tower_{i}", c)
            cate_logits.append(self.cate_pred(c).permute(0, 2, 3, 1))

        total = None
        for f, stride, names in self.mask_chains:
            x = features[f]
            if f == self.mask_in_features[-1]:  # coord conv on the coarsest
                x = torch.cat([x, coord_grids(x.shape[0], x.shape[2], x.shape[3], x.dtype,
                                              x.device)], 1)
            for name in names:
                x = self._tower(name, x)
                if stride > MASK_STRIDE:
                    x = upsample_bilinear(x, 2)
                    stride //= 2
            total = x if total is None else total + x
        return cate_logits, kernels, self.mask_pred(total)


def mask_extent_boxes(masks: torch.Tensor, stride: float = MASK_STRIDE) -> torch.Tensor:
    """``[B, D, Hm, Wm]`` bool masks -> ``[B, D, 4]`` xyxy boxes of their
    extents times ``stride`` (an empty mask gives ``(1e9, 1e9, -1e9, -1e9)``
    times ``stride``, which the caller masks)."""
    hm, wm = masks.shape[2:]
    ys = torch.arange(hm, dtype=torch.float32, device=masks.device)
    xs = torch.arange(wm, dtype=torch.float32, device=masks.device)
    any_y, any_x = masks.any(dim=3), masks.any(dim=2)
    big = torch.tensor(1e9, device=masks.device)
    y0 = torch.where(any_y, ys, big).amin(-1)
    y1 = torch.where(any_y, ys + 1, -big).amax(-1)
    x0 = torch.where(any_x, xs, big).amin(-1)
    x1 = torch.where(any_x, xs + 1, -big).amax(-1)
    return torch.stack([x0, y0, x1, y1], -1) * stride


class SOLOv2:
    """What runs around the head: GT assignment, losses and inference. It
    holds configuration only."""

    def __init__(self, cfg):
        h = cfg.MODEL.SINGLE_STAGE_HEAD
        s = cfg.MODEL.SOLO
        if s.MASK_KERNEL_SIZE != 1:
            raise NotImplementedError(
                f"MODEL.SOLO.MASK_KERNEL_SIZE {s.MASK_KERNEL_SIZE}: the dynamic conv is a 1x1 "
                f"product over MASK_FEATURE_OUT_DIMS channels, so only size 1 fits the "
                f"kernel head's {s.MASK_KERNEL_SIZE}^2 x {s.MASK_FEATURE_OUT_DIMS} channels "
                f"(the JAX package fails on these shapes too)")
        self.num_classes = h.NUM_CLASSES
        self.in_features = list(h.IN_FEATURES)
        self.num_grids = list(s.NUM_GRIDS)
        self.scale_ranges = [tuple(r) for r in s.SCALE_RANGES]
        self.sigma = s.SIGMA
        self.focal_alpha = s.FOCAL_LOSS_ALPHA
        self.focal_gamma = s.FOCAL_LOSS_GAMMA
        self.ins_loss_weight = s.INS_LOSS_WEIGHT
        self.ins_loss_type = s.INS_LOSS_TYPE
        if self.ins_loss_type not in ("dice", "dice+bce"):
            raise ValueError(f"MODEL.SOLO.INS_LOSS_TYPE '{self.ins_loss_type}' is not one of "
                             "'dice', 'dice+bce'")
        self.score_thresh = s.SCORE_THRESH_TEST
        self.update_thresh = s.UPDATE_SCORE_THRESH_TEST
        self.mask_thresh = s.MASK_THRESH_TEST
        self.topk = s.TOPK_CANDIDATES_TEST
        self.nms_kernel = s.NMS_KERNEL
        self.nms_sigma = s.NMS_SIGMA
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE

    def build_head(self, cfg, in_channels: int) -> SOLOv2Head:
        s = cfg.MODEL.SOLO
        return SOLOv2Head(
            in_channels, self.num_classes, self.in_features, self.num_grids,
            num_convs=s.MASK_KERNEL_NUM_CONVS, convs_dim=s.MASK_KERNEL_CONVS_DIM,
            kernel_out=s.MASK_KERNEL_SIZE ** 2 * s.MASK_FEATURE_OUT_DIMS,
            norm=s.MASK_KERNEL_NORM, prior_prob=s.PRIOR_PROB,
            mask_in_features=s.MASK_FEATURE_IN_FEATURES,
            mask_convs_dim=s.MASK_FEATURE_CONVS_DIM, mask_out_dims=s.MASK_FEATURE_OUT_DIMS,
            mask_norm=s.MASK_FEATURE_NORM, use_deform=s.USE_DEFORM_CONV,
            deform_modulated=s.DEFORM_MODULATED)

    def num_cells(self) -> int:
        """Grid cells over every level (the length of one image's noise)."""
        return sum(s * s for s in self.num_grids)

    # -- GT assignment -----------------------------------------------------------------
    def assign_level(self, gt: Dict[str, torch.Tensor], grid: int, lo: float, hi: float,
                     input_size: Tuple[int, int]):
        """One level's dense assignment of every image: (category target ``[B,
        S, S]`` with background ``K``, GT index ``[B, S, S]``, positive ``[B,
        S, S]``) from the padded GT fields ``gt_boxes [B, G, 4]``,
        ``gt_classes``, ``gt_valid`` and the mini-masks ``gt_masks [B, G, M,
        M]``; ``input_size`` is the padded input's (h, w)."""
        boxes, classes, valid = gt["gt_boxes"], gt["gt_classes"], gt["gt_valid"]
        mini = gt["gt_masks"].float()
        ih, iw = input_size
        dev = boxes.device
        w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
        h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
        area_sqrt = torch.sqrt(w * h)
        in_level = valid & (area_sqrt >= lo) & (area_sqrt <= hi) & (w > 0) & (h > 0)

        mm = mini.shape[-1]
        ys = (torch.arange(mm, dtype=torch.float32, device=dev) + 0.5) / mm
        mass = torch.clamp(mini.sum(dim=(2, 3)), min=1e-6)
        com_y = torch.matmul(mini.sum(dim=3), ys) / mass  # [B, G] in the box's [0, 1]
        com_x = torch.matmul(mini.sum(dim=2), ys) / mass
        cy = boxes[..., 1] + com_y * h
        cx = boxes[..., 0] + com_x * w

        def cell(c, size):
            return torch.floor(c / size * grid)

        coord_y, coord_x = cell(cy, ih), cell(cx, iw)
        half_h, half_w = 0.5 * h * self.sigma, 0.5 * w * self.sigma
        top = torch.clamp(torch.maximum(coord_y - 1, cell(cy - half_h, ih)), 0, grid - 1)
        down = torch.clamp(torch.minimum(coord_y + 1, cell(cy + half_h, ih)), 0, grid - 1)
        left = torch.clamp(torch.maximum(coord_x - 1, cell(cx - half_w, iw)), 0, grid - 1)
        right = torch.clamp(torch.minimum(coord_x + 1, cell(cx + half_w, iw)), 0, grid - 1)

        yy = torch.arange(grid, dtype=torch.float32, device=dev)[:, None, None]
        xx = torch.arange(grid, dtype=torch.float32, device=dev)[None, :, None]
        claims = (in_level[:, None, None, :]
                  & (yy >= top[:, None, None, :]) & (yy <= down[:, None, None, :])
                  & (xx >= left[:, None, None, :]) & (xx <= right[:, None, None, :]))
        # Overlaps: the smallest claimant wins, ties to the first GT.
        big = torch.tensor(1e10, device=dev)
        areas = torch.where(in_level, area_sqrt, big)
        masked = torch.where(claims, areas[:, None, None, :], big)
        gt_idx = torch.argmin(masked, dim=-1)  # [B, S, S]
        pos = claims.any(dim=-1)
        picked = torch.gather(classes.long(), 1, gt_idx.reshape(gt_idx.shape[0], -1))
        cate = torch.where(pos, picked.reshape(gt_idx.shape),
                           torch.full_like(gt_idx, self.num_classes))
        return cate, gt_idx, pos

    # -- losses ----------------------------------------------------------------------
    def losses(self, cate_logits: List[torch.Tensor], kernels: List[torch.Tensor],
               mask_features: torch.Tensor, gt: Dict[str, torch.Tensor],
               input_size: Tuple[int, int], generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Float32 head outputs and the GT fields -> ``{"loss_ins",
        "loss_cate"}``. ``noise``: the ``U(0, 0.5)`` draws ``[B, cells]`` of
        the positive cap; without it they come from ``generator``."""
        b, k = cate_logits[0].shape[0], self.num_classes
        hm, wm = mask_features.shape[2:]
        dev = mask_features.device
        cate_loss = torch.zeros(b, device=dev)
        pos_l, idx_l, kern_l = [], [], []
        for (lo, hi), grid, logit, kern in zip(self.scale_ranges, self.num_grids,
                                               cate_logits, kernels):
            cate, gt_idx, pos = self.assign_level(gt, grid, lo, hi, input_size)
            target = F.one_hot(cate, k + 1)[..., :k].to(logit.dtype)
            cate_loss = cate_loss + sigmoid_focal_loss(
                logit, target, self.focal_alpha, self.focal_gamma).sum(dim=(1, 2, 3))
            pos_l.append(pos.reshape(b, -1))
            idx_l.append(gt_idx.reshape(b, -1))
            kern_l.append(kern.reshape(b, -1, kern.shape[-1]))
        pos, gt_idx, kerns = torch.cat(pos_l, 1), torch.cat(idx_l, 1), torch.cat(kern_l, 1)

        if noise is None:
            if generator is None:
                raise ValueError("SOLOv2.losses: pass a torch.Generator (or hand the noise in)")
            noise = torch.rand(pos.shape, generator=generator, device=generator.device) * 0.5
        score = pos.float() + noise.to(dev)
        _, cells = top_k(score, MAX_POS)  # [B, P]
        sel_pos = torch.gather(pos, 1, cells).float()
        sel_gt = torch.gather(gt_idx, 1, cells)
        sel_kern = torch.gather(kerns, 1, cells[..., None].expand(-1, -1, kerns.shape[-1]))

        # The dynamic conv: one float32 product per image.
        feat = mask_features.reshape(b, mask_features.shape[1], hm * wm)
        pred = torch.sigmoid(torch.bmm(sel_kern, feat)).reshape(b, -1, hm, wm)

        # The GT masks at the mask features' resolution, from the mini-masks.
        g = gt["gt_boxes"].shape[1]
        gt_masks = paste_masks_in_image(gt["gt_masks"].reshape(b * g, *gt["gt_masks"].shape[2:]),
                                        gt["gt_boxes"].reshape(b * g, 4) / float(MASK_STRIDE),
                                        (hm, wm), threshold=-1.0)
        gt_masks = (gt_masks > 0.5).to(pred.dtype).reshape(b, g, hm, wm)
        sel_masks = torch.gather(gt_masks, 1, sel_gt[..., None, None].expand(-1, -1, hm, wm))
        d = dice_loss(pred.reshape(-1, hm, wm), sel_masks.reshape(-1, hm, wm)).reshape(b, -1)
        if self.ins_loss_type == "dice+bce":
            # A saturation-safe BCE keeps the mask gradient alive where the
            # dice's dies (the JAX package's from-scratch variant).
            eps = 1e-6
            p = pred.reshape(b, pred.shape[1], -1)
            t = sel_masks.reshape(b, sel_masks.shape[1], -1)
            d = d - (t * torch.log(p + eps) + (1.0 - t) * torch.log(1.0 - p + eps)).mean(-1)
        ins_loss = torch.sum(d * sel_pos, 1) / torch.clamp(sel_pos.sum(1), min=1.0)
        num_pos = pos.float().sum()
        return {"loss_ins": self.ins_loss_weight * ins_loss.mean(),
                "loss_cate": cate_loss.sum() / torch.clamp(num_pos, min=1.0)}

    # -- inference ---------------------------------------------------------------------
    @torch.no_grad()
    def candidates(self, cate_logits: List[torch.Tensor], kernels: List[torch.Tensor],
                   mask_features: torch.Tensor):
        """The ``TOPK_CANDIDATES_TEST`` candidates of each image after point
        NMS: (scores ``[B, k]``, classes ``[B, k]``, their masks' float32
        sigmoids ``[B, k, Hm*Wm]``)."""
        b, kc = cate_logits[0].shape[0], self.num_classes
        scores_l, kerns_l = [], []
        for logit, kern in zip(cate_logits, kernels):
            s = torch.sigmoid(logit).permute(0, 3, 1, 2)  # [B, K, S, S]
            # Point NMS: keep the maxima of the 2x2 windows that end at each cell.
            pooled = F.max_pool2d(F.pad(s, (1, 0, 1, 0), value=float("-inf")), 2, stride=1)
            s = torch.where(s == pooled, s, torch.zeros_like(s))
            scores_l.append(s.permute(0, 2, 3, 1).reshape(b, -1, kc))
            kerns_l.append(kern.reshape(b, -1, kern.shape[-1]))
        scores, kerns = torch.cat(scores_l, 1), torch.cat(kerns_l, 1)
        flat = scores.reshape(b, -1)
        top_scores, top_idx = top_k(flat, min(self.topk, flat.shape[1]))
        cell = torch.div(top_idx, kc, rounding_mode="floor")
        sel_kern = torch.gather(kerns, 1, cell[..., None].expand(-1, -1, kerns.shape[-1]))
        feat = mask_features.reshape(b, mask_features.shape[1], -1)
        return top_scores, top_idx % kc, torch.sigmoid(torch.bmm(sel_kern, feat))

    @torch.no_grad()
    def inference(self, cate_logits: List[torch.Tensor], kernels: List[torch.Tensor],
                  mask_features: torch.Tensor) -> Instances:
        """Float32 head outputs -> ``Instances`` with ``boxes [B, D, 4]`` (mask
        extents x 4), ``scores [B, D]`` (matrix-NMS decayed), ``pred_classes
        [B, D]`` (-1 on empty slots), ``pred_masks [B, D, Hm, Wm]`` (bool,
        whole frames at stride 4) and ``is_valid [B, D]``."""
        top_scores, cls, pred = self.candidates(cate_logits, kernels, mask_features)
        b = pred.shape[0]
        hm, wm = mask_features.shape[2:]
        binary = pred > self.mask_thresh
        areas = binary.sum(-1).float()
        maskness = torch.sum(pred * binary, -1) / torch.clamp(areas, min=1e-6)
        valid = (top_scores > self.score_thresh) & (areas > 0)
        scores2 = torch.where(valid, top_scores * maskness, torch.zeros_like(top_scores))
        del pred

        # Matrix NMS takes the masks in descending score order (a stable sort).
        order = torch.sort(-scores2, dim=1, stable=True).indices
        binary_sorted = torch.gather(binary, 1, order[..., None].expand_as(binary))
        cls_sorted = torch.gather(cls, 1, order)
        decayed = matrix_nms(binary_sorted, cls_sorted, torch.gather(scores2, 1, order),
                             sigma=self.nms_sigma, kernel=self.nms_kernel)
        keep_scores, keep_idx = top_k(
            torch.where(decayed > self.update_thresh, decayed, torch.zeros_like(decayed)),
            self.detections_per_image)
        masks = torch.gather(binary_sorted, 1, keep_idx[..., None].expand(-1, -1, hm * wm))
        masks = masks.reshape(b, -1, hm, wm)
        final_valid = keep_scores > 0
        boxes = mask_extent_boxes(masks)
        return Instances(
            boxes=torch.where(final_valid[..., None], boxes, torch.zeros_like(boxes)),
            scores=torch.where(final_valid, keep_scores, torch.zeros_like(keep_scores)),
            pred_classes=torch.where(final_valid, torch.gather(cls_sorted, 1, keep_idx),
                                     torch.full_like(keep_idx, -1)),
            pred_masks=masks,
            is_valid=final_valid,
        )
