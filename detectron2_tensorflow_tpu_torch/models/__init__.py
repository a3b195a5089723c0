from .meta_arch import (
    GeneralizedRCNN,
    PanopticFPN,
    ProposalNetwork,
    SemanticSegmentor,
    SingleStageDetector,
    build_model,
    panoptic_fusion,
)

__all__ = ["build_model", "GeneralizedRCNN", "PanopticFPN", "ProposalNetwork",
           "SemanticSegmentor", "SingleStageDetector", "panoptic_fusion"]
