from .build import build_model
from .postprocess import detector_postprocess
from .rcnn import GeneralizedRCNN, ProposalNetwork, meta_architecture

__all__ = ["build_model", "detector_postprocess", "GeneralizedRCNN", "ProposalNetwork",
           "meta_architecture"]
