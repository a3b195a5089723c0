"""Train a detector from a COCO-format dataset or its TFRecords.

    python -m detectron2_tensorflow_tpu_torch.tools.train --config_file CFG [--max_iter N]
        [--device cpu] [KEY VALUE ...]

The port's counterpart of the repo's ``train.py``. The dataset is
``<DATASETS.ROOT_DIR>/<DATASETS.TRAIN>.record-*`` or
``<DATASETS.TRAIN>.json`` + ``<DATASETS.TRAIN>/`` by ``DATASETS.TRAIN_FORMAT``
(``build_train_dataset``). The model starts from the JAX package's
initializers (seed ``max(SEED, 0)``), or ``PRETRAINS``, or resumes from the
newest checkpoint in ``<LOGS.ROOT_DIR or OUTPUT_DIR>/<LOGS.TRAIN>``; it
trains to ``--max_iter`` (else ``SOLVER.MAX_ITER``, scaled with the batch),
saving checkpoints there, and evaluates the ``DATASETS.VAL`` split every
``TEST.EVAL_PERIOD`` steps. It runs on the card unless ``--device cpu``.
The last line is ``train summary {json}``: the steps run, seconds, the final
losses and the hand-written kernels' launches during training.

The JAX package's native (C++ JPEG) train loader is not ported: with
``DATALOADER.NATIVE_TRAIN_IO`` on, one line says so and ``build_dataloader``
serves, as in the JAX CLI where the native loader is unusable. Keypoint and
precomputed-proposal training raise: their families are not ported.
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
from ..data import CocoDataset, TFRecordDataset, build_dataloader
from ..engine import train
from ..engine.checkpoint import latest_step
from ..engine.evaluator import run_evaluation
from ..models import build_model
from ..models.poolers import roi_patch_backward, roi_patch_interpolate
from ..ops.fused_residual import fused_conv1x1_bn_add_relu
from ..ops.nms import greedy_keep
from ..solver import scaled_max_iter

LOG_EVERY = 20  # steps between the metric reads (and log lines) of train()
# The hand-written kernels' wrappers; each counts its launches in ``launches``.
KERNELS = {"nms_keep": greedy_keep, "roi_patch_fwd": roi_patch_interpolate,
           "roi_patch_bwd": roi_patch_backward, "fused_residual": fused_conv1x1_bn_add_relu}

_PANOPTIC_ARCHS = ("PanopticFPN", "SemanticSegmentor")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config_file", required=True)
    p.add_argument("--max_iter", type=int, default=None, help="override MAX_ITER")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    return p.parse_args(argv)


def check_family(cfg) -> None:
    """Raise for the configs whose data or model families are not ported."""
    if cfg.MODEL.KEYPOINT_ON:
        raise NotImplementedError("MODEL.KEYPOINT_ON: the keypoint family is not ported")
    if cfg.MODEL.LOAD_PROPOSALS:
        raise NotImplementedError(
            "MODEL.LOAD_PROPOSALS: precomputed proposals (DATASETS.PROPOSAL_FILES_*) are "
            "not ported")
    if cfg.MODEL.META_ARCHITECTURE in _PANOPTIC_ARCHS:
        raise NotImplementedError(
            f"MODEL.META_ARCHITECTURE {cfg.MODEL.META_ARCHITECTURE}: semantic GT "
            "(BUILD_RECORDS.TYPE coco_pano) belongs to the panoptic family, not ported")


def build_train_dataset(cfg):
    """The training set by ``DATASETS.TRAIN_FORMAT``: ``records``, or
    ``auto`` when ``<ROOT>/<TRAIN>.record-*`` shards exist, reads them;
    otherwise the COCO JSON."""
    check_family(cfg)
    pattern = os.path.join(cfg.DATASETS.ROOT_DIR, cfg.DATASETS.TRAIN + ".record-*")
    fmt = cfg.DATASETS.TRAIN_FORMAT
    if fmt == "records" or (fmt == "auto" and glob.glob(pattern)):
        logging.info("training from records: %s", pattern)
        return TFRecordDataset(pattern, load_masks=cfg.MODEL.MASK_ON)
    return CocoDataset(os.path.join(cfg.DATASETS.ROOT_DIR, cfg.DATASETS.TRAIN + ".json"),
                       os.path.join(cfg.DATASETS.ROOT_DIR, cfg.DATASETS.TRAIN),
                       load_masks=cfg.MODEL.MASK_ON)


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

    dataset = build_train_dataset(cfg)
    seed = max(cfg.SEED, 0)
    model = build_model(cfg, device=args.device, training=True, init="jax",
                        generator=torch.Generator().manual_seed(seed))
    if cfg.DATALOADER.NATIVE_TRAIN_IO:
        logging.info("DATALOADER.NATIVE_TRAIN_IO: the native train loader is not ported; "
                     "build_dataloader serves")
    data_iter = build_dataloader(cfg, dataset, training=True,
                                 batch_size=cfg.SOLVER.IMS_PER_BATCH, seed=seed)

    eval_fn = None
    if cfg.TEST.EVAL_PERIOD > 0:
        val_ds = CocoDataset(os.path.join(cfg.DATASETS.ROOT_DIR, cfg.DATASETS.VAL + ".json"),
                             os.path.join(cfg.DATASETS.ROOT_DIR, cfg.DATASETS.VAL),
                             load_masks=cfg.MODEL.MASK_ON)

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
