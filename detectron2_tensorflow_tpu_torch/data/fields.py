"""Canonical field-name vocabulary for sample/batch dicts (a copy of the
JAX package's ``data/fields.py``): one place naming the arrays that flow
between the loader, the models and the evaluators.
"""


class InputFields:
    image = "image"
    image_id = "image_id"
    image_size = "image_size"  # (h, w) after resize, before padding
    original_size = "original_size"  # (h, w) of the source image
    gt_boxes = "gt_boxes"
    gt_classes = "gt_classes"
    gt_valid = "gt_valid"
    gt_is_crowd = "gt_is_crowd"
    gt_masks = "gt_masks"  # mini-masks [N, M, M] in gt-box frame
    gt_sem_seg = "gt_sem_seg"


class ResultFields:
    boxes = "boxes"
    scores = "scores"
    classes = "pred_classes"
    masks = "pred_masks"
    valid = "is_valid"
    sem_seg = "sem_seg"
    panoptic = "panoptic"


class ServingFields:
    num_detections = "num_detections"
    detection_boxes = "detection_boxes"
    detection_scores = "detection_scores"
    detection_classes = "detection_classes"
    detection_masks = "detection_masks"
    detection_class_names = "detection_class_names"
