"""Config finalization: derived keys, then freeze.

Port of the JAX package's ``config/finalize.py``. The device count comes
from the device the caller names (``torch.cuda.device_count()`` on the card,
1 on the CPU) instead of from JAX; the JAX package's XLA compilation-cache
setup has no counterpart here.
"""

from __future__ import annotations

import json
import os

import torch


def finalize(cfg, training: bool = True, device="cuda"):
    """Set ``SOLVER.NUM_GPUS`` and ``SOLVER.IMS_PER_BATCH`` from the device
    count, check ``INPUT.PAD_BUCKETS`` against ``INPUT.SIZE_DIVISIBILITY``,
    take the class counts from ``DATASETS.CATEGORY_MAP_NAME`` when that file
    exists, and freeze ``cfg`` (a frozen ``cfg`` is returned as it is)."""
    del training  # as in the JAX package: training mode is explicit per call
    if torch.device(device).type == "cuda":
        num_devices = torch.cuda.device_count()
        if num_devices == 0:
            raise RuntimeError("finalize: no CUDA device; pass device='cpu' on the CPU")
    else:
        num_devices = 1
    if not cfg.is_frozen():
        cfg.SOLVER.NUM_GPUS = num_devices  # the reference's name; devices here
        cfg.SOLVER.IMS_PER_BATCH = cfg.SOLVER.IMS_PER_GPU * num_devices

        # Every pad bucket must satisfy INPUT.SIZE_DIVISIBILITY, or the
        # trunk's strides would give misaligned feature shapes.
        d = cfg.INPUT.SIZE_DIVISIBILITY
        if d > 1:
            for bh, bw in cfg.INPUT.PAD_BUCKETS:
                if bh % d or bw % d:
                    raise ValueError(
                        f"INPUT.PAD_BUCKETS entry ({bh}, {bw}) is not "
                        f"divisible by INPUT.SIZE_DIVISIBILITY={d}"
                    )

        cat_map = os.path.join(cfg.DATASETS.ROOT_DIR, cfg.DATASETS.CATEGORY_MAP_NAME)
        if os.path.isfile(cat_map):
            with open(cat_map) as f:
                cats = json.load(f)
            if "thing_classes" in cats:
                n = len(cats["thing_classes"])
                cfg.MODEL.ROI_HEADS.NUM_CLASSES = n
                cfg.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES = n
            if "stuff_classes" in cats:
                cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES = len(cats["stuff_classes"])
        cfg.freeze()
    return cfg
