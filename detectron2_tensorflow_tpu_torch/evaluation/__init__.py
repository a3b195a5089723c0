from . import rle
from .coco_eval import CocoEvaluator
from .np_masks import fullframe_masks_to_image, paste_masks

__all__ = ["CocoEvaluator", "fullframe_masks_to_image", "paste_masks", "rle"]
