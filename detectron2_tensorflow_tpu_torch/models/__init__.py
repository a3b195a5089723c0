from .meta_arch import GeneralizedRCNN, ProposalNetwork, build_model

__all__ = ["build_model", "GeneralizedRCNN", "ProposalNetwork"]
