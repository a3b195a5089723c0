"""Evaluation loop: predict on padded batches, un-resize, feed evaluators.

Port of the JAX package's ``engine/evaluator.py`` (``build_predict``,
``build_detection_evaluators``, ``evaluate``, ``evaluate_sem_seg``,
``evaluate_panoptic``, ``run_evaluation``, ``check_expected_results``;
``num_classes_of`` is in ``config``).
``model.predict`` runs on the model's device (the card, unless the model was
built on the CPU) and gives fixed-shape detections in network-input
coordinates; the host scales the boxes and keypoints to the original
resolution, pastes the masks there and streams each image into the COCO
bbox, segm and keypoint (OKS) evaluators and the Pascal VOC ones
(``voc_bbox``, ``voc_bbox_weighted``, ``voc_segm``, ``voc_segm_weighted``:
mAP and CorLoc at ``EVAL.PASCAL_MATCHING_IOU_THRESH``, crowd GT read as
group-of boxes weighted by ``EVAL.PASCAL_GROUP_OF_WEIGHT``, masks matched
against the full-frame GT masks); a ``ProposalNetwork``'s proposals go to the proposal-recall
evaluator (``box_proposals/AR@100``, ``box_proposals/AR@1000``) instead.
A RetinaNet (``SingleStageDetector``) predicts no masks, so it gets the bbox
evaluator alone. SOLOv2's masks are whole frames at stride 4: their content
region is resized to the original image (``fullframe_masks_to_image``)
rather than pasted into boxes. ``EVAL.CLASS_AGNOSTIC`` zeroes the GT and predicted classes before the
evaluators see them. ``TEST.KEYPOINT_OKS_SIGMAS`` replaces COCO's person
sigmas of the keypoint evaluator.

``evaluate_sem_seg`` takes each prediction's ``sem_seg`` over the image's
content, resizes it to the original resolution by ``cv2.INTER_NEAREST``'s
rule (``data.transforms.resize_nearest``) and feeds the confusion-matrix
evaluator (``sem_seg/mIoU``, ``mACC``, ``pACC``, ``fwIoU``) against the
dataset's ``sem_seg``. ``evaluate_panoptic`` runs ``panoptic_fusion`` on
the model's device after ``predict``, un-resizes the panoptic map the same
way and feeds the PQ evaluator (``panoptic/PQ`` ...) against the dataset's
``get_panoptic_gt``, thing categories by their contiguous class and stuff
categories by 1000 + their stuff label. ``run_evaluation`` runs each family
that ``EVAL.METRICS`` names. With ``TEST.AUG.ENABLED`` the detection loop
predicts each image through ``engine.tta.tta_predict`` (the JAX
evaluator's dispatch): its merged detections are in the input batch's
frame, so the loop un-resizes them as it does ``predict``'s. The semantic
and panoptic loops raise on ``TEST.AUG``: the JAX semantic loop reads a
``sem_seg`` that ``tta_predict``'s merged detections do not have, so it
fails there too, and the JAX panoptic loop has no TTA. The drawn examples
(``EVAL.MAX_EXAMPLE_TO_DRAW``, TensorBoard images) wait for the metric
logger.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import num_classes_of
from ..data.transforms import resize_nearest
from ..evaluation.coco_eval import CocoEvaluator, ProposalEvaluator
from ..evaluation.np_masks import fullframe_masks_to_image, paste_masks
from ..evaluation.panoptic_eval import PanopticEvaluator
from ..evaluation.pascal_voc_eval import PascalVocEvaluator
from ..evaluation.sem_seg_eval import SemSegEvaluator
from ..models.meta_arch.postprocess import fullframe_masks
from .train import to_device
from .tta import tta_predict

logger = logging.getLogger(__name__)

# EVAL.METRICS vocabulary -> (prefix, factory).
_DETECTION_METRICS = {
    "coco_detection_metrics": ("bbox", lambda n: CocoEvaluator(n, "bbox")),
    "coco_instance_segmentation_metrics": ("segm", lambda n: CocoEvaluator(n, "segm")),
    "coco_keypoint_metrics": ("keypoints", lambda n: CocoEvaluator(n, "keypoints")),
}


def _voc_factories(cfg) -> Dict[str, tuple]:
    iou, gow = cfg.EVAL.PASCAL_MATCHING_IOU_THRESH, cfg.EVAL.PASCAL_GROUP_OF_WEIGHT
    return {
        "pascal_voc_detection_metrics": (
            "voc_bbox", lambda n: PascalVocEvaluator(n, iou, group_of_weight=gow)),
        "weighted_pascal_voc_detection_metrics": (
            "voc_bbox_weighted",
            lambda n: PascalVocEvaluator(n, iou, weighted=True, group_of_weight=gow)),
        "pascal_voc_instance_segmentation_metrics": (
            "voc_segm",
            lambda n: PascalVocEvaluator(n, iou, use_masks=True, group_of_weight=gow)),
        "weighted_pascal_voc_instance_segmentation_metrics": (
            "voc_segm_weighted",
            lambda n: PascalVocEvaluator(n, iou, weighted=True, use_masks=True,
                                         group_of_weight=gow)),
    }

# The segmentation families, which run_evaluation routes past the detection loop.
SEGMENTATION_METRICS = ("semantic_segmentation_metrics", "panoptic_segmentation_metrics")


# What ``predict`` reads of a batch: the images, and a Fast R-CNN's proposal slots.
_PREDICT_INPUTS = ("image", "image_size", "proposal_boxes", "proposal_scores", "proposal_valid")


_OUTPUTS = ("boxes", "scores", "pred_classes", "is_valid", "pred_masks", "pred_keypoints",
            "sem_seg")


def _to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
            for k, v in out.items() if k in _OUTPUTS}


def build_predict(cfg, model) -> Callable[[Dict], Dict[str, np.ndarray]]:
    """``predict(batch) -> outputs``: the batch's inputs (numpy arrays) go to the
    model's device, ``model.predict`` runs there, and the outputs come back
    as numpy arrays (``boxes``, ``scores``, ``pred_classes``, ``is_valid``
    and, from a model with a mask or keypoint head, ``pred_masks`` or
    ``pred_keypoints``, and from one with a semantic head ``sem_seg``)."""
    del cfg  # one device: no mesh to build
    device = next(model.parameters()).device

    def predict(batch: Dict) -> Dict[str, np.ndarray]:
        inputs = to_device({k: v for k, v in batch.items() if k in _PREDICT_INPUTS}, device)
        return _to_numpy(model.predict(inputs).get_fields())

    return predict


def build_tta_predict(cfg, model) -> Callable[[Dict], Dict[str, np.ndarray]]:
    """``predict(batch) -> outputs`` as :func:`build_predict`'s, each image of
    the batch through ``tta_predict`` and the outputs stacked."""
    def predict(batch: Dict) -> Dict[str, np.ndarray]:
        outs = [_to_numpy(tta_predict(cfg, model, {"image": batch["image"][i:i + 1],
                                                   "image_size": batch["image_size"][i:i + 1]}
                                      ).get_fields())
                for i in range(batch["image"].shape[0])]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    return predict


def build_detection_evaluators(cfg) -> Dict[str, tuple]:
    """The evaluators ``EVAL.METRICS`` names: ``{prefix: (evaluator, kind)}``
    with kind ``bbox``, ``segm`` or ``keypoints`` (what each reads of the
    predictions)."""
    num_classes = num_classes_of(cfg)
    table = {**_DETECTION_METRICS, **_voc_factories(cfg)}
    out = {}
    for name in cfg.EVAL.METRICS:
        if name in SEGMENTATION_METRICS:
            continue
        if name not in table:
            raise ValueError(f"unknown EVAL.METRICS entry '{name}' "
                             f"(known: {sorted(table) + list(SEGMENTATION_METRICS)})")
        prefix, factory = table[name]
        kind = ("segm" if "segm" in prefix else "keypoints" if "keypoint" in name
                else "bbox")
        out[prefix] = (factory(num_classes), kind)
    return out


def keypoint_evaluator(cfg, num_classes: int) -> CocoEvaluator:
    """A keypoint evaluator with ``TEST.KEYPOINT_OKS_SIGMAS``, if any."""
    ev = CocoEvaluator(num_classes, "keypoints")
    if list(cfg.TEST.KEYPOINT_OKS_SIGMAS):
        ev.kp_sigmas = np.asarray(list(cfg.TEST.KEYPOINT_OKS_SIGMAS), np.float64)
    return ev


def _check_supported(cfg) -> None:
    if cfg.MODEL.META_ARCHITECTURE not in ("GeneralizedRCNN", "ProposalNetwork",
                                           "SingleStageDetector", "PanopticFPN"):
        raise NotImplementedError(
            f"evaluating {cfg.MODEL.META_ARCHITECTURE} is not ported")


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

    predict = (build_tta_predict if cfg.TEST.AUG.ENABLED else build_predict)(cfg, model)
    fullframe = fullframe_masks(cfg)
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
            # The VOC evaluators read crowd boxes as Open-Images group-of boxes.
            gt = {"boxes": raw["boxes"], "classes": gt_classes, "is_crowd": raw["is_crowd"],
                  "is_group_of": raw["is_crowd"], "areas": raw.get("areas")}
            if (auto_keypoints and "pred_keypoints" in out and "keypoints" in raw
                    and "keypoints" not in evaluators):
                evaluators["keypoints"] = (keypoint_evaluator(cfg, num_classes), "keypoints")
            det_masks = None
            if "pred_masks" in out and any(kind == "segm" for _, kind in evaluators.values()):
                masks = out["pred_masks"][i][valid]
                # SOLOv2's masks are whole frames at stride 4, not box crops.
                det_masks = (fullframe_masks_to_image(masks, int(rh), int(rw), oh, ow)
                             if fullframe else paste_masks(masks, boxes, oh, ow))
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


def _original_map(pred: np.ndarray, size, shape) -> np.ndarray:
    """A ``[H, W]`` map over the network input, its ``size`` (h, w) content
    resized to the original ``shape`` by the nearest rule."""
    rh, rw = (int(v) for v in size)
    return resize_nearest(pred[:rh, :rw].astype(np.int32), *shape)


def evaluate_sem_seg(cfg, model, dataset, data_iter: Iterable[Dict],
                     max_images: Optional[int] = None) -> Dict[str, float]:
    """The semantic evaluation loop: ``{"sem_seg/mIoU": ...}`` (module
    docstring). ``dataset``'s samples carry their original-resolution
    ``sem_seg``. ``TEST.AUG`` raises (module docstring)."""
    if cfg.TEST.AUG.ENABLED:
        raise NotImplementedError(
            "TEST.AUG (test-time augmentation) of a semantic evaluation: tta_predict merges "
            "detections and has no sem_seg (the JAX evaluator fails on it too)")
    ev = SemSegEvaluator(cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                         ignore_label=cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE)
    predict = build_predict(cfg, model)
    seen = set()
    n_done = 0
    for batch in data_iter:
        sem = predict(batch)["sem_seg"]
        for i in range(batch["image"].shape[0]):
            image_id = int(batch["image_id"][i])
            if image_id < 0 or image_id in seen:
                continue
            seen.add(image_id)
            gt_map = dataset[_index_of(dataset, image_id)]["sem_seg"]
            ev.add_image(gt_map, _original_map(sem[i], batch["image_size"][i], gt_map.shape))
            n_done += 1
        if max_images is not None and n_done >= max_images:
            break
    return {f"sem_seg/{k}": v for k, v in ev.evaluate().items()}


def evaluate_panoptic(cfg, model, dataset, data_iter: Iterable[Dict],
                      max_images: Optional[int] = None) -> Dict[str, float]:
    """The panoptic evaluation loop: ``{"panoptic/PQ": ...}`` (module
    docstring). ``dataset`` is a ``CocoPanopticDataset``: its
    ``get_panoptic_gt`` and its thing and stuff category tables."""
    from ..models.meta_arch.rcnn import panoptic_fusion

    if cfg.TEST.AUG.ENABLED:
        raise NotImplementedError(
            "TEST.AUG (test-time augmentation) of a panoptic evaluation: the JAX package has "
            "no TTA there")
    cat_table = {cid: True for cid in dataset.thing_contiguous.values()}
    cat_table.update({1000 + cid: False for cid in dataset.stuff_contiguous.values()})
    pq = PanopticEvaluator(cat_table)
    device = next(model.parameters()).device
    seen = set()
    n_done = 0
    for batch in data_iter:
        inputs = to_device({k: v for k, v in batch.items() if k in _PREDICT_INPUTS}, device)
        pan_maps, infos = panoptic_fusion(cfg, model.predict(inputs))
        pan_maps = pan_maps.cpu().numpy()
        infos = {k: v.cpu().numpy() for k, v in infos.items()}
        for i in range(batch["image"].shape[0]):
            image_id = int(batch["image_id"][i])
            if image_id < 0 or image_id in seen:
                continue
            seen.add(image_id)
            gt_map, gt_segments = dataset.get_panoptic_gt(_index_of(dataset, image_id))
            pred_map = _original_map(pan_maps[i], batch["image_size"][i], gt_map.shape)
            segments = [{"id": sid, "category_id": int(infos["category_id"][i, sid])
                         + (0 if infos["is_thing"][i, sid] else 1000)}
                        for sid in range(infos["valid"].shape[1]) if infos["valid"][i, sid]]
            gt_segs = [{"id": seg["id"],
                        "category_id": (dataset.thing_contiguous[seg["category_id"]]
                                        if seg["category_id"] in dataset.thing_contiguous
                                        else 1000 + dataset.stuff_contiguous[seg["category_id"]]),
                        "iscrowd": seg.get("iscrowd", 0)} for seg in gt_segments]
            pq.add_image(gt_map, gt_segs, pred_map, segments)
            n_done += 1
        if max_images is not None and n_done >= max_images:
            break
    return {f"panoptic/{k}": v for k, v in pq.evaluate().items()}


def run_evaluation(cfg, model, dataset, data_iter, max_images: Optional[int] = None,
                   results_writer=None) -> Dict[str, float]:
    """Dispatch on ``EVAL.METRICS`` across the three families: detection
    (``evaluate``), semantic (``evaluate_sem_seg``) and panoptic
    (``evaluate_panoptic``), in that order. ``data_iter`` is an iterable of
    batches or a callable that makes one (a callable when more than one
    family runs: each takes a fresh pass)."""
    names = tuple(cfg.EVAL.METRICS)
    families = []
    if any(n not in SEGMENTATION_METRICS for n in names):
        families.append(evaluate)
    if "semantic_segmentation_metrics" in names:
        families.append(evaluate_sem_seg)
    if "panoptic_segmentation_metrics" in names:
        families.append(evaluate_panoptic)
    if not families:
        raise ValueError(f"EVAL.METRICS selects no evaluator: {names}")
    metrics = {}
    for family in families:
        batches = data_iter() if callable(data_iter) else iter(data_iter)
        kwargs = {"results_writer": results_writer} if family is evaluate else {}
        metrics.update(family(cfg, model, dataset, batches, max_images, **kwargs))
    return metrics


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
