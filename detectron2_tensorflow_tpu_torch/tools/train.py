"""Train a detector from a COCO-format dataset or its TFRecords.

    python -m detectron2_tensorflow_tpu_torch.tools.train --config_file CFG [--max_iter N]
        [--device cpu] [KEY VALUE ...]

The port's counterpart of the repo's ``train.py``. The dataset is
``<DATASETS.ROOT_DIR>/<DATASETS.TRAIN>.record-*`` or
``<DATASETS.TRAIN>.json`` + ``<DATASETS.TRAIN>/`` by ``DATASETS.TRAIN_FORMAT``
(``build_train_dataset``); with ``MODEL.LOAD_PROPOSALS`` and
``DATASETS.PROPOSAL_FILES_TRAIN``, the COCO JSON whatever the format, with
the first proposal file (a Detectron2 pickle under ``DATASETS.ROOT_DIR``)
attached, as the repo's ``train.py`` does; with ``MODEL.KEYPOINT_ON``, the
COCO JSON too (TFRecords carry no keypoints), without the images that have
fewer than ``ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE`` labelled keypoints.
A ``PanopticFPN`` or ``SemanticSegmentor`` reads records built with
``BUILD_RECORDS.TYPE coco_pano`` (records without ``image/sem_seg`` raise,
naming it) or, without records, the COCO-panoptic layout
``<TRAIN>_panoptic.json`` + ``<TRAIN>_panoptic/`` + ``<TRAIN>/``
(``data.CocoPanopticDataset``, unlabelled pixels at
``SEM_SEG_HEAD.IGNORE_VALUE``), as the repo's ``train.py`` does.
The model starts from the JAX package's
initializers (seed ``max(SEED, 0)``), or ``PRETRAINS``, or resumes from the
newest checkpoint in ``<LOGS.ROOT_DIR or OUTPUT_DIR>/<LOGS.TRAIN>``; it
trains to ``--max_iter`` (else ``SOLVER.MAX_ITER``, scaled with the batch),
saving checkpoints there, and evaluates the ``DATASETS.VAL`` split every
``TEST.EVAL_PERIOD`` steps. It runs on the card unless ``--device cpu``.
The last line is ``train summary {json}``: the steps run, seconds, the final
losses and the hand-written kernels' launches during training.

The JAX package's native (C++ JPEG) train loader is not ported: with
``DATALOADER.NATIVE_TRAIN_IO`` on, one line says so and ``build_dataloader``
serves, as in the JAX CLI where the native loader is unusable. An
``AUGMENT.*`` augmentation the port does not have raises before any data
is read.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import time

import torch

from ..config import finalize, get_cfg
from ..data import (
    CocoDataset,
    CocoPanopticDataset,
    TFRecordDataset,
    build_dataloader,
    transforms,
)
from ..engine import train
from ..engine.train import SEMANTIC_ARCHITECTURES
from ..engine.checkpoint import latest_step
from ..engine.evaluator import SEGMENTATION_METRICS, run_evaluation
from ..models import build_model
from ..models.poolers import roi_patch_backward, roi_patch_interpolate
from ..ops.fused_residual import fused_conv1x1_bn_add_relu
from ..ops.nms import greedy_keep
from ..solver import scaled_max_iter

LOG_EVERY = 20  # steps between the metric reads (and log lines) of train()
# The hand-written kernels' wrappers; each counts its launches in ``launches``.
KERNELS = {"nms_keep": greedy_keep, "roi_patch_fwd": roi_patch_interpolate,
           "roi_patch_bwd": roi_patch_backward, "fused_residual": fused_conv1x1_bn_add_relu}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config_file", required=True)
    p.add_argument("--max_iter", type=int, default=None, help="override MAX_ITER")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    return p.parse_args(argv)


def panoptic_dataset(cfg, split: str, ignore_label: int = -1) -> CocoPanopticDataset:
    """``<ROOT>/<split>_panoptic.json`` with its id maps and images."""
    root = cfg.DATASETS.ROOT_DIR
    return CocoPanopticDataset(os.path.join(root, split + "_panoptic.json"),
                               os.path.join(root, split + "_panoptic"),
                               os.path.join(root, split), ignore_label=ignore_label)


def load_dataset(cfg, split: str, proposal_files, training: bool = False):
    """``<ROOT>/<split>``: its records when ``DATASETS.TRAIN_FORMAT`` is
    ``records``, or ``auto`` and ``<ROOT>/<split>.record-*`` exist, unless
    proposals are loaded (their ids key to the annotations file) or, in
    ``training``, a keypoint model reads it (records carry no keypoints);
    else, for a model with a semantic head, the COCO-panoptic layout, and
    otherwise the COCO JSON, with ``proposal_files[0]`` attached under
    ``MODEL.LOAD_PROPOSALS`` and, for training a keypoint model, the images
    with fewer than ``MIN_KEYPOINTS_PER_IMAGE`` labelled keypoints left out.
    Records read for a model with a semantic head must carry its map."""
    transforms.check_supported(cfg)
    root = cfg.DATASETS.ROOT_DIR
    pattern = os.path.join(root, split + ".record-*")
    fmt = cfg.DATASETS.TRAIN_FORMAT
    json_only = cfg.MODEL.LOAD_PROPOSALS and len(proposal_files) > 0
    keypoints = training and cfg.MODEL.KEYPOINT_ON
    semantic = cfg.MODEL.META_ARCHITECTURE in SEMANTIC_ARCHITECTURES
    if keypoints and fmt == "records":
        raise ValueError("MODEL.KEYPOINT_ON trains from the COCO JSON (TFRecords carry no "
                         "keypoints): DATASETS.TRAIN_FORMAT must be auto or json, not records")
    if fmt == "records" or (fmt == "auto" and glob.glob(pattern) and not (json_only or keypoints)):
        logging.info("reading records: %s", pattern)
        ds = TFRecordDataset(pattern, load_masks=cfg.MODEL.MASK_ON)
        if semantic and training and ds[0].get("sem_seg") is None:
            raise ValueError(f"{cfg.MODEL.META_ARCHITECTURE} needs semantic GT but the records at "
                             f"{pattern} carry none: rebuild them with BUILD_RECORDS.TYPE "
                             "coco_pano (tools.build_records)")
        return ds
    if semantic:
        return panoptic_dataset(cfg, split, cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE)
    min_keypoints = cfg.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE if keypoints else 0
    ds = CocoDataset(os.path.join(root, split + ".json"), os.path.join(root, split),
                     load_masks=cfg.MODEL.MASK_ON, min_keypoints=min_keypoints)
    if json_only:
        ds.set_proposals(os.path.join(root, proposal_files[0]))
    return ds


def build_train_dataset(cfg):
    """The ``DATASETS.TRAIN`` split (:func:`load_dataset`, with
    ``PROPOSAL_FILES_TRAIN``)."""
    return load_dataset(cfg, cfg.DATASETS.TRAIN, cfg.DATASETS.PROPOSAL_FILES_TRAIN,
                        training=True)


def build_eval_dataset(cfg):
    """The ``DATASETS.VAL`` split: the COCO-panoptic layout when
    ``EVAL.METRICS`` names the semantic or panoptic metrics (their GT lives
    there), else :func:`load_dataset` with ``PROPOSAL_FILES_TEST``, as the
    repo's ``eval.py`` chooses."""
    if any(name in SEGMENTATION_METRICS for name in cfg.EVAL.METRICS):
        transforms.check_supported(cfg)
        return panoptic_dataset(cfg, cfg.DATASETS.VAL)
    return load_dataset(cfg, cfg.DATASETS.VAL, cfg.DATASETS.PROPOSAL_FILES_TEST)


def checkpoint_dir(cfg) -> str:
    return os.path.join(cfg.LOGS.ROOT_DIR or cfg.OUTPUT_DIR, cfg.LOGS.TRAIN)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    finalize(cfg, training=True, device=args.device)

    seed = max(cfg.SEED, 0)
    model = build_model(cfg, device=args.device, training=True, init="jax",
                        generator=torch.Generator().manual_seed(seed))
    dataset = build_train_dataset(cfg)
    if cfg.DATALOADER.NATIVE_TRAIN_IO:
        logging.info("DATALOADER.NATIVE_TRAIN_IO: the native train loader is not ported; "
                     "build_dataloader serves")
    data_iter = build_dataloader(cfg, dataset, training=True,
                                 batch_size=cfg.SOLVER.IMS_PER_BATCH, seed=seed)

    eval_fn = None
    if cfg.TEST.EVAL_PERIOD > 0:
        if any(name in SEGMENTATION_METRICS for name in cfg.EVAL.METRICS):
            val_ds = panoptic_dataset(cfg, cfg.DATASETS.VAL)
        else:
            val_ds = CocoDataset(os.path.join(cfg.DATASETS.ROOT_DIR, cfg.DATASETS.VAL + ".json"),
                                 os.path.join(cfg.DATASETS.ROOT_DIR, cfg.DATASETS.VAL),
                                 load_masks=cfg.MODEL.MASK_ON)
            if cfg.MODEL.LOAD_PROPOSALS and cfg.DATASETS.PROPOSAL_FILES_TEST:
                val_ds.set_proposals(os.path.join(cfg.DATASETS.ROOT_DIR,
                                                  cfg.DATASETS.PROPOSAL_FILES_TEST[0]))

        def eval_fn(state, step):
            return run_evaluation(cfg, state.model, val_ds,
                                  lambda: build_dataloader(cfg, val_ds, training=False),
                                  max_images=cfg.EVAL.NUM_EVAL or None)

    ckpt = checkpoint_dir(cfg)
    start = latest_step(ckpt) or 0
    max_iter = args.max_iter if args.max_iter is not None else scaled_max_iter(cfg)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state = train(cfg, model, data_iter, max_iter=max_iter, checkpoint_dir=ckpt,
                  log_every=max(1, min(LOG_EVERY, max_iter - start)), eval_fn=eval_fn)
    if args.device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    data_iter.close()
    steps = state.step - start
    summary = {
        "start_step": start, "step": state.step, "steps": steps, "seconds": seconds,
        "seconds_per_iteration": seconds / steps if steps else None,
        "final_losses": state.history[-1][1] if state.history else None,
        "launches": {k: fn.launches for k, fn in KERNELS.items()},
        "fused_tail_convs": sum(bool(getattr(m, "fuse_residual", False))
                                for m in model.modules()),
        "checkpoint_dir": ckpt,
    }
    print("train summary " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
