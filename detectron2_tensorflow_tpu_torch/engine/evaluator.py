"""Evaluation loop: predict on padded batches, un-resize, feed evaluators.

Port of the detection family of the JAX package's ``engine/evaluator.py``
(``build_predict``, ``build_detection_evaluators``, ``evaluate``,
``run_evaluation``, ``num_classes_of``, ``check_expected_results``).
``model.predict`` runs on the model's device (the card, unless the model was
built on the CPU) and gives fixed-shape detections in network-input
coordinates; the host scales the boxes to the original resolution, pastes
the masks there and streams each image into the COCO bbox and segm
evaluators. Test-time augmentation, the VOC, semantic and panoptic
evaluators, keypoint and proposal evaluation and the drawn examples raise
``NotImplementedError``: they wait for their families.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..evaluation.coco_eval import CocoEvaluator
from ..evaluation.np_masks import paste_masks
from .train import to_device

logger = logging.getLogger(__name__)

# EVAL.METRICS vocabulary -> (prefix, factory).
_DETECTION_METRICS = {
    "coco_detection_metrics": ("bbox", lambda n: CocoEvaluator(n, "bbox")),
    "coco_instance_segmentation_metrics": ("segm", lambda n: CocoEvaluator(n, "segm")),
}
_NOT_PORTED_METRICS = (
    "coco_keypoint_metrics", "pascal_voc_detection_metrics",
    "weighted_pascal_voc_detection_metrics", "pascal_voc_instance_segmentation_metrics",
    "weighted_pascal_voc_instance_segmentation_metrics", "semantic_segmentation_metrics",
    "panoptic_segmentation_metrics",
)


def build_predict(cfg, model) -> Callable[[Dict], Dict[str, np.ndarray]]:
    """``predict(batch) -> outputs``: the batch (numpy arrays) goes to the
    model's device, ``model.predict`` runs there, and the outputs come back
    as numpy arrays (``boxes``, ``scores``, ``pred_classes``, ``is_valid``
    and, from a model with a mask head, ``pred_masks``)."""
    del cfg  # one device: no mesh to build
    device = next(model.parameters()).device

    def predict(batch: Dict) -> Dict[str, np.ndarray]:
        inputs = to_device({k: batch[k] for k in ("image", "image_size")}, device)
        out = model.predict(inputs).get_fields()
        return {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                for k, v in out.items()
                if k in ("boxes", "scores", "pred_classes", "is_valid", "pred_masks")}

    return predict


def build_detection_evaluators(cfg) -> Dict[str, tuple]:
    """The evaluators ``EVAL.METRICS`` names: ``{prefix: (evaluator, kind)}``
    with kind ``bbox`` or ``segm``."""
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


def _check_supported(cfg) -> None:
    if cfg.MODEL.META_ARCHITECTURE != "GeneralizedRCNN":
        raise NotImplementedError(
            f"evaluating {cfg.MODEL.META_ARCHITECTURE} is not ported")
    if cfg.TEST.AUG.ENABLED:
        raise NotImplementedError("TEST.AUG (test-time augmentation) is not ported")
    if cfg.EVAL.CLASS_AGNOSTIC:
        raise NotImplementedError("EVAL.CLASS_AGNOSTIC is not ported")


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
    added when the model predicts masks; a segm evaluator gets no images
    from a model without them, as in the JAX package.
    """
    _check_supported(cfg)
    num_classes = num_classes_of(cfg)
    evaluators = build_detection_evaluators(cfg)
    if tuple(cfg.EVAL.METRICS) == ("coco_detection_metrics",) and cfg.MODEL.MASK_ON:
        evaluators["segm"] = (CocoEvaluator(num_classes, "segm"), "segm")
    class_names = getattr(dataset, "class_names", None) or getattr(dataset, "thing_classes", None)
    if (cfg.EVAL.INCLUDE_METRICS_PER_CATEGORY or cfg.EVAL.ALL_METRICS_PER_CATEGORY) and class_names:
        for ev, _ in evaluators.values():
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
            det = {"boxes": boxes, "scores": out["scores"][i][valid],
                   "classes": out["pred_classes"][i][valid]}
            gt = {"boxes": raw["boxes"], "classes": np.asarray(raw["classes"]),
                  "is_crowd": raw["is_crowd"], "areas": raw.get("areas")}
            det_masks = None
            if "pred_masks" in out and any(kind == "segm" for _, kind in evaluators.values()):
                det_masks = paste_masks(out["pred_masks"][i][valid], boxes, oh, ow)
            for ev, kind in evaluators.values():
                if kind == "bbox":
                    ev.add_image(gt, det)
                elif det_masks is not None:
                    gt_m = dict(gt)
                    gt_m["masks"] = raw.get("masks", np.zeros((len(raw["boxes"]), oh, ow))).astype(bool)
                    ev.add_image(gt_m, {**det, "masks": det_masks})
            if results_writer is not None:
                results_writer.add_image(image_id, boxes, det["scores"], det["classes"],
                                         det_masks)
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


def num_classes_of(cfg) -> int:
    """Detection class count: ``SINGLE_STAGE_HEAD`` for single-stage
    detectors, ``ROI_HEADS`` for R-CNNs."""
    if cfg.MODEL.META_ARCHITECTURE == "SingleStageDetector":
        return cfg.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES
    return cfg.MODEL.ROI_HEADS.NUM_CLASSES


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
