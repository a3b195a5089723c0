"""Learning check: overfit a small detector on 8 synthetic images and report AP.

    python -m detectron2_tensorflow_tpu_torch.tools.overfit_check [STEPS] [--arch rcnn|c4]
        [--device cpu] [KEY VALUE ...]

The port's counterpart of the repo's ``tools/overfit_check.py`` for its
``rcnn`` (Mask R-CNN R50-FPN's YAML) and ``c4`` (Mask R-CNN R50-C4's YAML)
families, with that tool's recipe (``overfit_cfg``): the tiny inputs of
``config.small_cfg()``, anchors scaled to 10-30 px boxes, ResNet-18 with GN
trained from the JAX package's initializers (``FREEZE_AT 0``), 3 classes, 64
ROIs per image, 8 images per step, LR 0.01 after 100 warm-up steps. It
trains STEPS (default 600) steps on ``data.SyntheticDataset(n=8,
num_classes=3)``, evaluates COCO bbox (and segm) AP on the same images and
lists the GT instances no detection finds (IoU >= 0.5, same class, score
above 0.5) on stderr. ``KEY VALUE`` overrides apply last (for example
narrower widths). It runs on the card unless ``--device cpu``. The last line
of stdout is one JSON object: ``arch``, ``steps``, ``train_seconds``,
``final_loss``, ``bbox_ap``, ``bbox_ap50`` and, with masks, ``segm_ap``,
``segm_ap50``. It gates nothing itself: a caller reads the APs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import get_cfg, small_cfg
from ..data import SyntheticDataset, build_dataloader
from ..data.transforms import resize_image
from ..engine import build_train_step, create_train_state, to_device
from ..engine.evaluator import evaluate
from ..models import build_model

REPO_CONFIGS = {
    "rcnn": "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml",
    "c4": "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml",
}


def get_cfg_for(arch: str):
    """The family's YAML (relative to the repo root) in the full default tree."""
    from .workflow_check import REPO

    if arch not in REPO_CONFIGS:
        raise SystemExit(f"unknown --arch {arch} (ported: {sorted(REPO_CONFIGS)})")
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / REPO_CONFIGS[arch]))
    return cfg


def overfit_cfg(arch: str):
    """The JAX tool's recipe on ``arch``'s YAML."""
    cfg = get_cfg_for(arch)
    tiny = small_cfg()
    cfg.TRANSFORM = tiny.TRANSFORM
    cfg.INPUT = tiny.INPUT
    cfg.TRANSFORM.RESIZE.MINI_MASK_SIZE = 28
    if arch == "rcnn":  # anchors for 10-30 px boxes, one size per FPN level
        cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[8], [16], [32], [64], [128]]
    else:  # one feature level: one set of sizes
        cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[8, 16, 32, 64, 128]]
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.RESNETS.NORM = "GN"
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 400
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 400
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 200
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 100
    cfg.SOLVER.STEPS = (100000,)  # constant LR after warmup
    cfg.SOLVER.AUTO_SCALE_LR_SCHEDULE = False
    return cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("steps", nargs="?", type=int, default=600)
    p.add_argument("--arch", default="rcnn", help="rcnn (the default) or c4")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args, opts = p.parse_known_args(argv)
    if any(o.startswith("--") for o in opts):
        p.error(f"unknown options {opts}")
    args.opts = opts  # KEY VALUE overrides
    return args


def find_instances(cfg, model, ds, device, arch: str):
    """(found, missed) GT instances: a same-class detection above the report
    threshold with IoU >= 0.5, on each image resized and padded as the
    evaluation loader does; each miss is listed on stderr."""
    r = cfg.TRANSFORM.RESIZE
    found = missed = 0
    for i in range(len(ds)):
        s = ds[i]
        h, w = s["image"].shape[:2]
        scale = r.MIN_SIZE_TEST / min(h, w)
        if max(h, w) * scale > r.MAX_SIZE_TEST:
            scale = r.MAX_SIZE_TEST / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        bh, bw = cfg.INPUT.PAD_BUCKETS[0] if nh <= nw else cfg.INPUT.PAD_BUCKETS[1]
        img = np.zeros((1, bh, bw, 3), np.float32)
        img[0, :nh, :nw] = resize_image(s["image"].astype(np.float32), nh, nw)
        det = model.predict(to_device({"image": img, "image_size": np.array([[nh, nw]], np.int32)},
                                      device))
        boxes = det.boxes[0].float().cpu().numpy() / np.array([nw / w, nh / h] * 2)
        cls = det.pred_classes[0].cpu().numpy()
        ok = det.is_valid[0].cpu().numpy() & (det.scores[0].float().cpu().numpy() > 0.5)
        for g, gbox in enumerate(s["boxes"]):
            best = 0.0
            for b in boxes[ok & (cls == s["classes"][g])]:
                ix = max(0.0, min(gbox[2], b[2]) - max(gbox[0], b[0]))
                iy = max(0.0, min(gbox[3], b[3]) - max(gbox[1], b[1]))
                union = ((gbox[2] - gbox[0]) * (gbox[3] - gbox[1])
                         + (b[2] - b[0]) * (b[3] - b[1]) - ix * iy)
                best = max(best, ix * iy / max(union, 1e-6))
            if best >= 0.5:
                found += 1
            else:
                missed += 1
                print(f"MISS img{i} gt{g} cls={int(s['classes'][g])} "
                      f"box={np.round(gbox, 1).tolist()} best_iou={best:.2f}", file=sys.stderr)
    return found, missed


def main(argv=None):
    args = parse_args(argv)
    cfg = overfit_cfg(args.arch)
    if args.opts:
        cfg.merge_from_list(args.opts)
    device = torch.device(args.device)
    ds = SyntheticDataset(n=8, num_classes=3)
    model = build_model(cfg, device=device, training=True, init="jax",
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, torch.Generator(device=device).manual_seed(0))
    step = build_train_step(cfg, state)
    train_iter = build_dataloader(cfg, ds, training=True, seed=0)

    t0 = time.time()
    last_loss = None
    for i in range(args.steps):
        metrics = step(to_device(next(train_iter), device))
        if i % 100 == 0 or i == args.steps - 1:
            last_loss = float(metrics["total_loss"])
            print(f"step {i}: total_loss={last_loss:.4f}", file=sys.stderr)
    train_s = time.time() - t0
    train_iter.close()

    model.eval()
    results = evaluate(cfg, model, ds, build_dataloader(cfg, ds, training=False, seed=0))
    found, missed = find_instances(cfg, model, ds, device, args.arch)
    print(f"instances found {found} / {found + missed}", file=sys.stderr)
    out = {
        "arch": args.arch,
        "steps": args.steps,
        "train_seconds": round(train_s, 1),
        "final_loss": last_loss,
        "bbox_ap": round(float(results.get("bbox/AP", float("nan"))), 2),
        "bbox_ap50": round(float(results.get("bbox/AP50", float("nan"))), 2),
    }
    if "segm/AP" in results:
        out["segm_ap"] = round(float(results["segm/AP"]), 2)
        out["segm_ap50"] = round(float(results.get("segm/AP50", float("nan"))), 2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
