from . import rle
from .coco_eval import CocoEvaluator, ProposalEvaluator
from .np_masks import fullframe_masks_to_image, paste_masks

__all__ = ["CocoEvaluator", "ProposalEvaluator", "fullframe_masks_to_image", "paste_masks", "rle"]
