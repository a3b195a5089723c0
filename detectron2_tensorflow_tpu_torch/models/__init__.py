from .meta_arch import GeneralizedRCNN, ProposalNetwork, SingleStageDetector, build_model

__all__ = ["build_model", "GeneralizedRCNN", "ProposalNetwork", "SingleStageDetector"]
