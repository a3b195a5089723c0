from . import rle
from .coco_eval import CocoEvaluator, ProposalEvaluator
from .np_masks import fullframe_masks_to_image, paste_masks
from .panoptic_eval import PanopticEvaluator
from .sem_seg_eval import SemSegEvaluator

__all__ = ["CocoEvaluator", "PanopticEvaluator", "ProposalEvaluator", "SemSegEvaluator",
           "fullframe_masks_to_image", "paste_masks", "rle"]
