from .config import CfgNode, get_cfg, num_classes_of
from .finalize import finalize
from .presets import bench_cfg, small_cfg, train_cfg

__all__ = ["CfgNode", "get_cfg", "bench_cfg", "train_cfg", "small_cfg", "finalize",
           "num_classes_of"]
