from .build import build_model
from .postprocess import detector_postprocess
from .rcnn import GeneralizedRCNN

__all__ = ["build_model", "detector_postprocess", "GeneralizedRCNN"]
