from .build import build_model
from .postprocess import detector_postprocess
from .rcnn import GeneralizedRCNN, ProposalNetwork, meta_architecture
from .single_stage import SingleStageDetector

__all__ = ["build_model", "detector_postprocess", "GeneralizedRCNN", "ProposalNetwork",
           "SingleStageDetector", "meta_architecture"]
