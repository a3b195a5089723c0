from .nms import class_aware_nms, greedy_keep, matrix_nms, nms, nms_fixed
from .topk import flat_top_k, spatial_top_k, top_k

__all__ = [
    "class_aware_nms", "greedy_keep", "matrix_nms", "nms", "nms_fixed",
    "flat_top_k", "spatial_top_k", "top_k",
]
