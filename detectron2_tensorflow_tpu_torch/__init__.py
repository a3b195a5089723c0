"""PyTorch + CUDA port of the JAX detection package beside it, for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports ``torch``
and never JAX; its hand-written CUDA kernels (``csrc/``) are built by
``kernels.py`` on first use on a CUDA device.
"""

from .config import bench_cfg, get_cfg, train_cfg
from .models import build_model

__all__ = ["get_cfg", "bench_cfg", "train_cfg", "build_model"]
