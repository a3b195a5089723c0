"""Evaluation loop: predict on padded batches, un-resize, feed evaluators.

Port of the detection family of the JAX package's ``engine/evaluator.py``
(``build_predict``, ``build_detection_evaluators``, ``evaluate``,
``run_evaluation``, ``check_expected_results``; ``num_classes_of`` is in
``config``).
``model.predict`` runs on the model's device (the card, unless the model was
built on the CPU) and gives fixed-shape detections in network-input
coordinates; the host scales the boxes and keypoints to the original
resolution, pastes the masks there and streams each image into the COCO
bbox, segm and keypoint (OKS) evaluators; a ``ProposalNetwork``'s proposals go to the proposal-recall
evaluator (``box_proposals/AR@100``, ``box_proposals/AR@1000``) instead.
A RetinaNet (``SingleStageDetector``) predicts no masks, so it gets the bbox
evaluator alone. ``EVAL.CLASS_AGNOSTIC`` zeroes the GT and predicted classes before the
evaluators see them. ``TEST.KEYPOINT_OKS_SIGMAS`` replaces COCO's person
sigmas of the keypoint evaluator. Test-time augmentation, the VOC, semantic
and panoptic evaluators and the drawn examples raise
``NotImplementedError``: they wait for their families.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import num_classes_of
from ..evaluation.coco_eval import CocoEvaluator, ProposalEvaluator
from ..evaluation.np_masks import paste_masks
from .train import to_device

logger = logging.getLogger(__name__)

# EVAL.METRICS vocabulary -> (prefix, factory).
_DETECTION_METRICS = {
    "coco_detection_metrics": ("bbox", lambda n: CocoEvaluator(n, "bbox")),
    "coco_instance_segmentation_metrics": ("segm", lambda n: CocoEvaluator(n, "segm")),
    "coco_keypoint_metrics": ("keypoints", lambda n: CocoEvaluator(n, "keypoints")),
}
_NOT_PORTED_METRICS = (
    "pascal_voc_detection_metrics",
    "weighted_pascal_voc_detection_metrics", "pascal_voc_instance_segmentation_metrics",
    "weighted_pascal_voc_instance_segmentation_metrics", "semantic_segmentation_metrics",
    "panoptic_segmentation_metrics",
)


# What ``predict`` reads of a batch: the images, and a Fast R-CNN's proposal slots.
_PREDICT_INPUTS = ("image", "image_size", "proposal_boxes", "proposal_scores", "proposal_valid")


def build_predict(cfg, model) -> Callable[[Dict], Dict[str, np.ndarray]]:
    """``predict(batch) -> outputs``: the batch's inputs (numpy arrays) go to the
    model's device, ``model.predict`` runs there, and the outputs come back
    as numpy arrays (``boxes``, ``scores``, ``pred_classes``, ``is_valid``
    and, from a model with a mask or keypoint head, ``pred_masks`` or
    ``pred_keypoints``)."""
    del cfg  # one device: no mesh to build
    device = next(model.parameters()).device

    def predict(batch: Dict) -> Dict[str, np.ndarray]:
        inputs = to_device({k: v for k, v in batch.items() if k in _PREDICT_INPUTS}, device)
        out = model.predict(inputs).get_fields()
        return {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                for k, v in out.items()
                if k in ("boxes", "scores", "pred_classes", "is_valid", "pred_masks",
                         "pred_keypoints")}

    return predict


def build_detection_evaluators(cfg) -> Dict[str, tuple]:
    """The evaluators ``EVAL.METRICS`` names: ``{prefix: (evaluator, kind)}``
    with kind ``bbox``, ``segm`` or ``keypoints``."""
    num_classes = num_classes_of(cfg)
    out = {}
    for name in cfg.EVAL.METRICS:
        if name in _NOT_PORTED_METRICS:
            raise NotImplementedError(f"EVAL.METRICS entry '{name}' is not ported")
        if name not in _DETECTION_METRICS:
            raise ValueError(f"unknown EVAL.METRICS entry '{name}' "
                             f"(known: {sorted(_DETECTION_METRICS) + list(_NOT_PORTED_METRICS)})")
        prefix, factory = _DETECTION_METRICS[name]
        out[prefix] = (factory(num_classes), prefix)
    return out


def keypoint_evaluator(cfg, num_classes: int) -> CocoEvaluator:
    """A keypoint evaluator with ``TEST.KEYPOINT_OKS_SIGMAS``, if any."""
    ev = CocoEvaluator(num_classes, "keypoints")
    if list(cfg.TEST.KEYPOINT_OKS_SIGMAS):
        ev.kp_sigmas = np.asarray(list(cfg.TEST.KEYPOINT_OKS_SIGMAS), np.float64)
    return ev


def _check_supported(cfg) -> None:
    if cfg.MODEL.META_ARCHITECTURE not in ("GeneralizedRCNN", "ProposalNetwork",
                                           "SingleStageDetector"):
        raise NotImplementedError(
            f"evaluating {cfg.MODEL.META_ARCHITECTURE} is not ported")
    if cfg.TEST.AUG.ENABLED:
        raise NotImplementedError("TEST.AUG (test-time augmentation) is not ported")


def evaluate(cfg, model, dataset, data_iter: Iterable[Dict],
             max_images: Optional[int] = None, results_writer=None) -> Dict[str, float]:
    """The detection evaluation loop: ``{"bbox/AP": ..., "segm/AP": ...}``.

    ``dataset`` gives the original-resolution GT by image id (indexing, and
    ``images`` as a COCO dataset has or ``image_id(i)`` as a record dataset
    has); ``data_iter`` yields
    the eval batches of ``build_dataloader(cfg, dataset, training=False)``.
    ``results_writer`` (an ``evaluation.coco_results.CocoResultsWriter``)
    also records every kept detection, in the original image's frame. With
    the default ``EVAL.METRICS`` (bbox only) the segm evaluator is
    added when the model predicts masks, and the keypoint evaluator at the
    first image that has keypoints (a dataset without any gets none), as in
    the JAX package; a segm or keypoint evaluator gets no images from a
    model without masks or keypoints.
    """
    _check_supported(cfg)
    num_classes = num_classes_of(cfg)
    auto_keypoints = False
    if cfg.MODEL.META_ARCHITECTURE == "ProposalNetwork":
        evaluators = {"box_proposals": (ProposalEvaluator(), "bbox")}
    else:
        evaluators = build_detection_evaluators(cfg)
        if "keypoints" in evaluators:
            evaluators["keypoints"] = (keypoint_evaluator(cfg, num_classes), "keypoints")
        if tuple(cfg.EVAL.METRICS) == ("coco_detection_metrics",):
            auto_keypoints = True
            if cfg.MODEL.MASK_ON:
                evaluators["segm"] = (CocoEvaluator(num_classes, "segm"), "segm")
    class_names = getattr(dataset, "class_names", None) or getattr(dataset, "thing_classes", None)
    if (cfg.EVAL.INCLUDE_METRICS_PER_CATEGORY or cfg.EVAL.ALL_METRICS_PER_CATEGORY) and class_names:
        for ev, _ in evaluators.values():
            if not isinstance(ev, CocoEvaluator):
                continue
            ev.per_category = cfg.EVAL.INCLUDE_METRICS_PER_CATEGORY
            ev.all_per_category = cfg.EVAL.ALL_METRICS_PER_CATEGORY
            ev.class_names = list(class_names)

    predict = build_predict(cfg, model)
    seen = set()
    n_done = 0
    for batch in data_iter:
        out = predict(batch)
        for i in range(batch["image"].shape[0]):
            image_id = int(batch["image_id"][i])
            if image_id < 0 or image_id in seen:  # batch padding / duplicate
                continue
            seen.add(image_id)
            raw = dataset[_index_of(dataset, image_id)]
            oh, ow = raw["image"].shape[:2]
            rh, rw = batch["image_size"][i]
            sx, sy = ow / float(rw), oh / float(rh)

            valid = out["is_valid"][i]
            boxes = out["boxes"][i][valid] * np.array([sx, sy, sx, sy], np.float32)
            classes = out["pred_classes"][i][valid]
            gt_classes = np.asarray(raw["classes"])
            if cfg.EVAL.CLASS_AGNOSTIC:  # localization only
                classes, gt_classes = np.zeros_like(classes), np.zeros_like(gt_classes)
            det = {"boxes": boxes, "scores": out["scores"][i][valid], "classes": classes}
            gt = {"boxes": raw["boxes"], "classes": gt_classes,
                  "is_crowd": raw["is_crowd"], "areas": raw.get("areas")}
            if (auto_keypoints and "pred_keypoints" in out and "keypoints" in raw
                    and "keypoints" not in evaluators):
                evaluators["keypoints"] = (keypoint_evaluator(cfg, num_classes), "keypoints")
            det_masks = None
            if "pred_masks" in out and any(kind == "segm" for _, kind in evaluators.values()):
                det_masks = paste_masks(out["pred_masks"][i][valid], boxes, oh, ow)
            det_kps = None
            if "pred_keypoints" in out:  # x, y to the original frame
                det_kps = out["pred_keypoints"][i][valid].copy()
                det_kps[..., 0] *= sx
                det_kps[..., 1] *= sy
            for ev, kind in evaluators.values():
                if kind == "bbox":
                    ev.add_image(gt, det)
                elif kind == "segm" and det_masks is not None:
                    gt_m = dict(gt)
                    gt_m["masks"] = raw.get("masks", np.zeros((len(raw["boxes"]), oh, ow))).astype(bool)
                    ev.add_image(gt_m, {**det, "masks": det_masks})
                elif kind == "keypoints" and det_kps is not None and "keypoints" in raw:
                    ev.add_image({**gt, "keypoints": raw["keypoints"]},
                                 {**det, "keypoints": det_kps})
            if results_writer is not None:
                results_writer.add_image(image_id, boxes, det["scores"], det["classes"],
                                         det_masks, det_kps)
            n_done += 1
        if max_images is not None and n_done >= max_images:
            break
        if n_done and n_done % 100 == 0:
            logger.info("evaluated %d images", n_done)

    metrics = {}
    for prefix in sorted(evaluators, key=lambda p: (p != "bbox", p)):
        ev, _ = evaluators[prefix]
        metrics.update({f"{prefix}/{k}": v for k, v in ev.evaluate().items()})
    return metrics


def run_evaluation(cfg, model, dataset, data_iter, max_images: Optional[int] = None,
                   results_writer=None) -> Dict[str, float]:
    """Dispatch on ``EVAL.METRICS``: the detection family, the one ported.
    ``data_iter`` is an iterable of batches or a callable that makes one."""
    names = tuple(cfg.EVAL.METRICS)
    if not names:
        raise ValueError(f"EVAL.METRICS selects no evaluator: {names}")
    batches = data_iter() if callable(data_iter) else iter(data_iter)
    return evaluate(cfg, model, dataset, batches, max_images, results_writer)


def _index_of(dataset, image_id: int) -> int:
    if not hasattr(dataset, "_id_to_index"):
        if hasattr(dataset, "images"):
            dataset._id_to_index = {info["id"]: i for i, (info, _) in enumerate(dataset.images)}
        else:  # a record dataset: ids come from image_id(i)
            dataset._id_to_index = {dataset.image_id(i): i for i in range(len(dataset))}
    return dataset._id_to_index[image_id]


# Upstream-D2 EXPECTED_RESULTS task names -> this framework's metric prefixes.
_TASK_ALIASES = {"panoptic_seg": "panoptic"}


def check_expected_results(cfg, metrics: Dict[str, float]) -> List[str]:
    """Failures of ``TEST.EXPECTED_RESULTS`` (``[[task, metric, value, tol],
    ...]``) against ``metrics``."""
    failures = []
    for task, metric, value, tol in cfg.TEST.EXPECTED_RESULTS:
        task = _TASK_ALIASES.get(task, task)
        key = f"{task}/{metric}"
        actual = metrics.get(key)
        if actual is None or abs(actual - value) > tol:
            failures.append(f"{key}: expected {value} ± {tol}, got {actual}")
    return failures
