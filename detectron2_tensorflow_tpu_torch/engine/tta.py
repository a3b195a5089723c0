"""Test-time augmentation and precise BN.

Port of the JAX package's ``engine/tta.py``. :func:`tta_predict` serves one
image at each ``TEST.AUG.MIN_SIZES`` scale (capped by ``MAX_SIZE``) and,
with ``FLIP``, its horizontal flip, maps every detection slot back to the
input's frame and merges them with one class-aware NMS at
``MODEL.ROI_HEADS.NMS_THRESH_TEST`` keeping ``TEST.DETECTIONS_PER_IMAGE``;
a model with a mask head then runs its mask (and keypoint) head on the
merged boxes at the input's own resolution (``predict_with_boxes``, as
Detectron2 attaches masks). As there:
  * every scale is padded into one bucket that holds this image's largest
    scale, rounded up to a multiple of 128;
  * each scale is a bilinear resize of the float32 image (``cv2.resize``'s
    float path, ``data.transforms.resize_bilinear``), never rounded to
    uint8;
  * a flip reverses only the image's content columns, and its boxes are
    flipped back in the scaled frame (its width ``nw``) before they are
    scaled, by ``(w / nw, h / nh)`` in float32;
  * the merge takes the slots of every run, valid or not, with the classes
    of invalid slots (-1) raised to 0 for the class offsets.
The outputs are in the input batch's frame, as ``model.predict``'s, so an
evaluator un-resizes them the same way.

Precise BN: ``precise_bn``. The trunk
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

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..data.transforms import resize_bilinear
from ..models.layers import BatchNorm2d, batch_moments
from ..ops.nms import class_aware_nms
from ..structures import Instances


def tta_scale(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int]:
    """``(nh, nw)`` of an ``h`` x ``w`` image at the TTA scale ``min_size``:
    the short side at ``min_size``, the long side capped at ``max_size``."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def tta_bucket(cfg, h: int, w: int) -> Tuple[int, int]:
    """The one padded size of every TTA scale of an ``h`` x ``w`` image: its
    largest scaled height and width (at least 32), each rounded up to a
    multiple of 128 (a wide image's width may reach ``TEST.AUG.MAX_SIZE``)."""
    aug = cfg.TEST.AUG
    need_h = need_w = 32
    for min_size in aug.MIN_SIZES:
        nh, nw = tta_scale(h, w, min_size, aug.MAX_SIZE)
        need_h, need_w = max(need_h, nh), max(need_w, nw)
    return -(-need_h // 128) * 128, -(-need_w // 128) * 128


def resize_to_scale(image: np.ndarray, size, min_size: int, max_size: int,
                    bucket: Tuple[int, int]):
    """One image's TTA input: its ``size`` (h, w) content of ``image [H, W,
    3]`` resized to the scale (float32, unrounded), padded with zeros into
    ``bucket``. Returns ``({"image": [1, bh, bw, 3], "image_size": [1, 2]},
    (sx, sy))``, the float32 factors that map the scale's boxes back."""
    h, w = (int(v) for v in size)
    nh, nw = tta_scale(h, w, min_size, max_size)
    out = np.zeros((1, *bucket, 3), np.float32)
    out[0, :nh, :nw] = resize_bilinear(np.asarray(image, np.float32)[:h, :w], nh, nw)
    return ({"image": out, "image_size": np.array([[nh, nw]], np.int32)},
            np.array([w / nw, h / nh], np.float32))


def flip_content(scaled: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The batch with only its content region ``[:nh, :nw]`` flipped
    horizontally: flipping the padded canvas would move the image into the
    padding while ``image_size`` still puts it at ``[0, nw)``."""
    nh, nw = (int(v) for v in scaled["image_size"][0])
    img = np.asarray(scaled["image"])
    flipped = np.zeros_like(img)
    flipped[0, :nh, :nw] = img[0, :nh, :nw][:, ::-1]
    return {"image": flipped, "image_size": scaled["image_size"]}


def tta_predict(cfg, model, batch: Dict) -> Instances:
    """Multi-scale (and flipped) inference of ONE image, merged by NMS.

    ``batch``: ``image [1, H, W, 3]``, ``image_size [1, 2]`` (numpy arrays or
    tensors). Runs ``model.predict`` on the model's device once per scale
    (twice with ``TEST.AUG.FLIP``) and returns ``Instances`` there with
    ``boxes [1, D, 4]``, ``scores``, ``pred_classes`` (-1 in empty slots),
    ``is_valid`` and, with ``MODEL.MASK_ON``, the masks (and keypoints) of
    ``predict_with_boxes`` on the merged boxes, all in ``batch``'s frame.
    """
    if cfg.MODEL.LOAD_PROPOSALS:
        raise NotImplementedError("TEST.AUG with MODEL.LOAD_PROPOSALS: the JAX tta_predict "
                                  "hands the scaled images no proposals")
    image = np.asarray(torch.as_tensor(batch["image"]).cpu())
    size = np.asarray(torch.as_tensor(batch["image_size"]).cpu())
    if image.shape[0] != 1:
        raise ValueError(f"tta_predict takes one image, got {image.shape[0]}")
    device = next(model.parameters()).device
    aug = cfg.TEST.AUG
    bucket = tta_bucket(cfg, *(int(v) for v in size[0]))
    boxes, scores, classes, valid = [], [], [], []

    def add(det, factors, width=None):
        b = det.boxes[:1].float()
        if width is not None:  # flip back in the scaled frame
            b = torch.stack([width - b[..., 2], b[..., 1], width - b[..., 0], b[..., 3]], -1)
        sx, sy = (float(v) for v in factors)
        boxes.append(b * torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=b.device))
        scores.append(det.scores[:1].float())
        classes.append(det.pred_classes[:1])
        valid.append(det.is_valid[:1])

    def predict(inputs):
        return model.predict({k: torch.from_numpy(v).to(device) for k, v in inputs.items()})

    for min_size in aug.MIN_SIZES:
        scaled, factors = resize_to_scale(image[0], size[0], min_size, aug.MAX_SIZE, bucket)
        add(predict(scaled), factors)
        if aug.FLIP:
            nw = torch.tensor(float(scaled["image_size"][0][1]), dtype=torch.float32)
            add(predict(flip_content(scaled)), factors, width=nw.to(device))

    classes_all = torch.cat(classes, 1)
    out_boxes, out_scores, out_idx, out_valid = class_aware_nms(
        torch.cat(boxes, 1), torch.cat(scores, 1), torch.clamp(classes_all, min=0),
        cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, cfg.TEST.DETECTIONS_PER_IMAGE,
        valid=torch.cat(valid, 1))
    merged = Instances(
        boxes=out_boxes,
        scores=torch.where(out_valid, out_scores, torch.zeros_like(out_scores)),
        pred_classes=torch.where(out_valid, torch.gather(classes_all, 1, out_idx),
                                 torch.full_like(out_idx, -1).to(classes_all.dtype)),
        is_valid=out_valid)
    if cfg.MODEL.MASK_ON and hasattr(model, "predict_with_boxes"):
        merged = model.predict_with_boxes(
            {"image": torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(device),
             "image_size": torch.from_numpy(size.astype(np.int32)).to(device)}, merged)
    return merged


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
