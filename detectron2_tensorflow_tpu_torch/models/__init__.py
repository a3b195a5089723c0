from .meta_arch import build_model

__all__ = ["build_model"]
