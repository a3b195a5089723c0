from .build import build_model
from .postprocess import detector_postprocess, sem_seg_postprocess
from .rcnn import (
    GeneralizedRCNN,
    PanopticFPN,
    ProposalNetwork,
    SemanticSegmentor,
    meta_architecture,
    panoptic_fusion,
)
from .single_stage import SingleStageDetector

__all__ = ["build_model", "detector_postprocess", "sem_seg_postprocess", "GeneralizedRCNN",
           "PanopticFPN", "ProposalNetwork", "SemanticSegmentor", "SingleStageDetector",
           "meta_architecture", "panoptic_fusion"]
