"""Evaluate a trained detector on a COCO-format dataset or its TFRecords.

    python -m detectron2_tensorflow_tpu_torch.tools.eval --config_file CFG [--checkpoint PATH]
        [--max_images N] [--dump_results FILE] [--watch SECONDS] [--device cpu] [KEY VALUE ...]

The port's counterpart of the repo's ``eval.py``. The weights come from
``--checkpoint`` (a checkpoint directory, whose newest step is taken, or
one checkpoint file), by default the training directory
``<LOGS.ROOT_DIR or OUTPUT_DIR>/<LOGS.TRAIN>``; without one, from
``PRETRAINS``; else the model's random weights, with a warning. The
``DATASETS.VAL`` split is read by ``DATASETS.TRAIN_FORMAT``
(``tools.train.build_eval_dataset``; the COCO JSON with
``PROPOSAL_FILES_TEST[0]`` attached under ``MODEL.LOAD_PROPOSALS``; the
COCO-panoptic layout when ``EVAL.METRICS`` names the semantic or panoptic
metrics) and evaluated by the evaluators ``EVAL.METRICS`` selects (COCO
bbox, segm and keypoints; proposal recall ``box_proposals/AR@100`` and
``AR@1000`` for a ``ProposalNetwork``; ``sem_seg/mIoU``, ``mACC``,
``pACC``, ``fwIoU``; ``panoptic/PQ``, ``SQ``, ``RQ`` and their thing and
stuff parts); each metric is printed as ``name: value``. With ``TEST.PRECISE_BN.ENABLED`` the
BN statistics are first re-estimated over ``TEST.PRECISE_BN.NUM_ITER``
evaluation batches (``engine.tta.precise_bn``; a model without BN is left
as it is).
``TEST.EXPECTED_RESULTS`` is then checked and a failure exits with the
failing lines. ``--dump_results`` writes the detections as a COCO results
JSON. ``--watch N`` polls the checkpoint directory every N seconds,
evaluates each new step (appending to ``eval_metrics.jsonl``) and stops
after ``--watch_timeout`` idle seconds. It runs on the card unless
``--device cpu``.

Not ported: the native eval loader (``DATALOADER.NATIVE_EVAL_IO``: one line
says so and ``build_dataloader`` serves).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

from ..config import finalize, get_cfg
from ..data import build_dataloader
from ..engine import check_expected_results, run_evaluation
from ..engine.checkpoint import latest_checkpoint, latest_step, load_pretrained, restore_variables
from ..engine.tta import precise_bn
from ..evaluation.coco_results import CocoResultsWriter
from ..models import build_model
from .train import build_eval_dataset, checkpoint_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config_file", required=True)
    p.add_argument("--checkpoint", default=None, help="checkpoint directory or file")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--dump_results", default=None,
                   help="write detections as a COCO results JSON")
    p.add_argument("--watch", type=int, default=0,
                   help="poll interval (s) for continuous evaluation of new checkpoints")
    p.add_argument("--watch_timeout", type=int, default=3600,
                   help="stop watching after this many seconds without a new checkpoint")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    return p.parse_args(argv)


def load_variables(cfg, model, checkpoint) -> str:
    """Load ``model``'s weights; returns where they came from."""
    path = checkpoint
    if checkpoint and os.path.isdir(checkpoint):
        path = latest_checkpoint(checkpoint)
    if path and os.path.isfile(path):
        logging.info("restoring %s", path)
        restore_variables(path, model)
        return path
    if load_pretrained(cfg, model):
        return "PRETRAINS"
    logging.warning("no checkpoint found — evaluating random weights")
    return "random weights"


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    finalize(cfg, training=False, device=args.device)

    dataset = build_eval_dataset(cfg)
    model = build_model(cfg, device=args.device)
    if cfg.DATALOADER.NATIVE_EVAL_IO:
        logging.info("DATALOADER.NATIVE_EVAL_IO: the native eval loader is not ported; "
                     "build_dataloader serves")
    ckpt = args.checkpoint or checkpoint_dir(cfg)

    def eval_once():
        load_variables(cfg, model, ckpt)
        if cfg.TEST.PRECISE_BN.ENABLED:
            n = cfg.TEST.PRECISE_BN.NUM_ITER
            used = precise_bn(model, build_dataloader(cfg, dataset, training=False), n)
            logging.info("precise BN: statistics from %d batches", used)
        writer = None
        if args.dump_results:
            writer = CocoResultsWriter(getattr(dataset, "contiguous_to_cat_id", None))
        metrics = run_evaluation(cfg, model, dataset,
                                 lambda: build_dataloader(cfg, dataset, training=False),
                                 args.max_images, results_writer=writer)
        if writer is not None:
            n = writer.save(args.dump_results)
            logging.info("wrote %d records to %s", n, args.dump_results)
        for k, v in sorted(metrics.items()):
            print(f"{k}: {v:.3f}", flush=True)
        return metrics

    if args.watch <= 0:
        metrics = eval_once()
        failures = check_expected_results(cfg, metrics)
        if failures:
            raise SystemExit("EXPECTED_RESULTS failed:\n" + "\n".join(failures))
        return metrics

    last_seen = None
    idle_since = time.time()
    while True:
        step = latest_step(ckpt)
        if step is not None and step != last_seen:
            logging.info("evaluating checkpoint step %d", step)
            metrics = eval_once()
            last_seen = step
            idle_since = time.time()
            out_dir = cfg.LOGS.ROOT_DIR or cfg.OUTPUT_DIR
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(out_dir, "eval_metrics.jsonl"), "a") as f:
                    f.write(json.dumps({"step": step, **metrics}) + "\n")
        if time.time() - idle_since > args.watch_timeout:
            logging.info("no new checkpoint for %ds — stopping", args.watch_timeout)
            return None
        time.sleep(args.watch)


if __name__ == "__main__":
    main()
