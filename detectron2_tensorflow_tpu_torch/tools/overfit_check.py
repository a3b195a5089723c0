"""Learning check: overfit a small detector on 8 synthetic images and report AP.

    python -m detectron2_tensorflow_tpu_torch.tools.overfit_check [STEPS]
        [--arch rcnn|c4|cls_agnostic|retinanet|cascade|keypoint|semantic|dconv|solov2]
        [--eval_at N[,N...]]
        [--device cpu] [KEY VALUE ...]

The port's counterpart of the repo's ``tools/overfit_check.py`` for its
``rcnn`` (Mask R-CNN R50-FPN's YAML), ``c4`` (Mask R-CNN R50-C4's YAML),
``cls_agnostic`` (``Misc/mask_rcnn_R_50_FPN_1x_cls_agnostic.yaml``: one
shared box regressor and a one-channel mask head), ``retinanet``
(``retinanet_R_50_FPN_1x.yaml``, 3 classes; the JAX recipe also sets
``MODEL.SINGLE_STAGE_HEAD.SCORE_THRESH_TEST`` 0.3, which its RetinaNet never
reads: it keeps ``MODEL.RETINANET.SCORE_THRESH_TEST`` 0.05, and so does
this one), ``cascade`` (``Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml``) and
``keypoint`` (Mask R-CNN R50-FPN's YAML with ``MASK_ON`` off and
``KEYPOINT_ON``: 4 keypoints, the box corners of
``SyntheticDataset(with_keypoints=True)``, a head of four 128-wide convs,
OKS sigmas 0.05) and ``semantic`` (``semantic_R_50_FPN_1x.yaml``'s
SemanticSegmentor, 4 classes: the background and the 3 box classes of
``SyntheticDataset(with_sem_seg=True)``, on 194x306 images of 30-70 px
boxes resized to the 128x256 / 256x128 buckets, as the JAX tool has it)
and ``dconv`` (``Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml``: deformable
res3-res5) and ``solov2`` (``solo_v2_R_50_FPN_1x.yaml``, 3 classes, grids
24/20/16/12/8, the ``dice+bce`` mask loss, on ``semantic``'s 194x306 images
and buckets; no anchors; the JAX recipe also sets
``MODEL.SINGLE_STAGE_HEAD.SCORE_THRESH_TEST`` 0.2, which SOLOv2 never
reads: it keeps ``MODEL.SOLO.SCORE_THRESH_TEST`` 0.1, and so does this one;
it takes the small configuration's ``TRANSFORM``, whose mini-masks are the
only targets SOLOv2's loss reads) families, with that tool's recipe (``overfit_cfg``): the tiny inputs of
``config.small_cfg()``, anchors scaled to 10-30 px boxes, ResNet-18 with GN trained from the JAX
package's initializers (``FREEZE_AT 0``), 3 classes, 64 ROIs per image, 8
images per step, LR 0.01 after 100 warm-up steps. It trains STEPS (default
600) steps on ``data.SyntheticDataset(n=8, num_classes=3)``, evaluates COCO
bbox (and segm, or keypoint) AP on the same images and lists on stderr the GT instances
no detection finds (IoU >= 0.5, same class, score above the report
threshold) and the detections above it that find none (the JAX tool's
threshold: 0.5 for ``rcnn``, 0.25 for the other archs). The JAX recipe's
ResNet-18 has basic blocks, which the JAX package gives no deformable conv
(its ``dconv`` run trains none: the ``rcnn`` gate again), and which the port
refuses to deform; so ``dconv`` keeps the YAML's ResNet-50 (GN, from
scratch, the recipe's other settings) and also reports its offset convs:
how many there are and how many moved away from their zero start.
``KEY VALUE`` overrides apply last
(for example narrower widths). It runs on the card unless ``--device cpu``.
The last line of stdout is one JSON object: ``arch``, ``steps``,
``train_seconds``, ``final_loss``, ``bbox_ap``, ``bbox_ap50`` and, with
masks, ``segm_ap``, ``segm_ap50``, with keypoints ``keypoints_ap``, with
deformable convs ``conv_offsets`` and ``conv_offsets_moved``; for
``semantic`` ``miou`` and ``macc`` (``evaluate_sem_seg`` on the same
images) in place of the APs.
``--eval_at`` also evaluates after each
of those earlier step counts and prints the same object for it (``steps`` =
N) on a line of its own; training goes on from there unchanged. It gates
nothing itself: a caller reads the APs.
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
from ..engine.evaluator import evaluate, evaluate_sem_seg
from ..models import build_model

REPO_CONFIGS = {
    "rcnn": "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml",
    "c4": "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml",
    "cls_agnostic": "configs/Misc/mask_rcnn_R_50_FPN_1x_cls_agnostic.yaml",
    "retinanet": "configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml",
    "cascade": "configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml",
    "keypoint": "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml",
    "semantic": "configs/COCO-SemanticSegmentation/semantic_R_50_FPN_1x.yaml",
    "dconv": "configs/Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml",
    "solov2": "configs/COCO-InstanceSegmentation/solo_v2_R_50_FPN_1x.yaml",
}
# The archs trained on 194x306 images of 30-70 px boxes in the 128x256 /
# 256x128 buckets (a stride-4 head needs targets of more than a few cells).
LARGE_INPUT_ARCHS = ("semantic", "solov2")


def report_thresh(arch: str) -> float:
    """Score above which find_instances counts a detection: the JAX tool's
    rule, 0.5 for ``rcnn`` and 0.25 for every other arch."""
    return 0.5 if arch == "rcnn" else 0.25


def get_cfg_for(arch: str):
    """The family's YAML (relative to the repo root) in the full default tree."""
    from .workflow_check import REPO

    if arch not in REPO_CONFIGS:
        raise SystemExit(f"unknown --arch {arch} (ported: {sorted(REPO_CONFIGS)})")
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / REPO_CONFIGS[arch]))
    if arch == "retinanet":
        cfg.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES = 3
        cfg.MODEL.SINGLE_STAGE_HEAD.SCORE_THRESH_TEST = 0.3  # read by no model (module doc)
    elif arch == "keypoint":
        cfg.MODEL.MASK_ON = False
        cfg.MODEL.KEYPOINT_ON = True
        cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 4
        cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = (128,) * 4
        cfg.TEST.KEYPOINT_OKS_SIGMAS = [0.05] * 4
    elif arch == "semantic":
        cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 4  # the background and the 3 box classes
    elif arch == "solov2":
        cfg.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES = 3
        cfg.MODEL.SINGLE_STAGE_HEAD.SCORE_THRESH_TEST = 0.2  # read by no model (module doc)
        cfg.MODEL.SOLO.NUM_GRIDS = [24, 20, 16, 12, 8]  # fewer cells at the small input
        cfg.MODEL.SOLO.INS_LOSS_TYPE = "dice+bce"  # pure dice collapses from scratch
    return cfg


def overfit_cfg(arch: str):
    """The JAX tool's recipe on ``arch``'s YAML."""
    cfg = get_cfg_for(arch)
    tiny = small_cfg()
    cfg.TRANSFORM = tiny.TRANSFORM
    cfg.INPUT = tiny.INPUT
    cfg.TRANSFORM.RESIZE.MINI_MASK_SIZE = 28
    if arch == "c4":  # one feature level: one set of sizes
        cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[8, 16, 32, 64, 128]]
    elif arch not in LARGE_INPUT_ARCHS:  # anchors for 10-30 px boxes, one size per FPN level
        cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[8], [16], [32], [64], [128]]
    # The JAX recipe's ResNet-18, but a deformable trunk needs bottleneck blocks.
    cfg.MODEL.RESNETS.DEPTH = 50 if arch == "dconv" else 18
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


def overfit_inputs(cfg, arch: str) -> SyntheticDataset:
    """The 8 training (and evaluation) images of ``arch``'s recipe; for
    ``semantic`` and ``solov2`` (a stride-4 head needs targets of more than a
    few cells) larger images and boxes, resized to the 128x256 / 256x128
    buckets, which ``cfg`` is set to, as the JAX tool's ``main`` does."""
    if arch not in LARGE_INPUT_ARCHS:
        return SyntheticDataset(n=8, num_classes=3, with_keypoints=arch == "keypoint")
    r = cfg.TRANSFORM.RESIZE
    r.MIN_SIZE_TRAIN, r.MAX_SIZE_TRAIN = (128,), 256
    r.MIN_SIZE_TEST, r.MAX_SIZE_TEST = 128, 256
    cfg.INPUT.PAD_BUCKETS = ((128, 256), (256, 128))
    return SyntheticDataset(n=8, h=194, w=306, num_classes=3, box_range=(30, 70),
                            with_sem_seg=arch == "semantic")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("steps", nargs="?", type=int, default=600)
    p.add_argument("--arch", default="rcnn",
                   help=f"rcnn (the default) or one of {sorted(REPO_CONFIGS)}")
    p.add_argument("--eval_at", default="",
                   help="comma-separated step counts below STEPS to evaluate after as well")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args, opts = p.parse_known_args(argv)
    if any(o.startswith("--") for o in opts):
        p.error(f"unknown options {opts}")
    args.eval_at = sorted({int(n) for n in args.eval_at.split(",") if n})
    if any(not 0 < n < args.steps for n in args.eval_at):
        p.error(f"--eval_at {args.eval_at}: each must lie in [1, STEPS)")
    args.opts = opts  # KEY VALUE overrides
    return args


def find_instances(cfg, model, ds, device, arch: str):
    """(found, missed, false) on each image resized and padded as the
    evaluation loader does: GT instances with a same-class detection above
    the report threshold at IoU >= 0.5, those without, and detections above
    the threshold with no same-class GT at IoU >= 0.5 (each of which costs
    AP50 when it outranks a true one). Each miss and false detection is
    listed on stderr."""
    r = cfg.TRANSFORM.RESIZE
    thresh = report_thresh(arch)
    found = missed = false = 0
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
        scores = det.scores[0].float().cpu().numpy()
        ok = det.is_valid[0].cpu().numpy() & (scores > thresh)
        same = cls[:, None] == s["classes"][None, :]  # [detections, GT]
        overlap = np.where(same, box_iou(boxes, s["boxes"]), 0.0)
        for g, gbox in enumerate(s["boxes"]):
            best = overlap[ok, g].max(initial=0.0)
            if best >= 0.5:
                found += 1
            else:
                missed += 1
                print(f"MISS img{i} gt{g} cls={int(s['classes'][g])} "
                      f"box={np.round(gbox, 1).tolist()} best_iou={best:.2f}", file=sys.stderr)
        for k in np.flatnonzero(ok):
            best = overlap[k].max(initial=0.0)
            if best < 0.5:
                false += 1
                print(f"FALSE img{i} cls={int(cls[k])} box={np.round(boxes[k], 1).tolist()} "
                      f"score={scores[k]:.3f} best_iou={best:.2f}", file=sys.stderr)
    return found, missed, false


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[len(a), len(b)] IoU of two sets of (x0, y0, x1, y1) boxes."""
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(hi - lo, 0.0, None), axis=-1)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=-1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-6)


def report(cfg, model, ds, device, arch: str, steps: int, train_s: float, loss: float):
    """Evaluate ``model`` on ``ds`` and print the JSON line of ``steps``."""
    model.eval()
    if arch == "semantic":
        results = evaluate_sem_seg(cfg, model, ds, build_dataloader(cfg, ds, training=False,
                                                                     seed=0))
        out = {"arch": arch, "steps": steps, "train_seconds": round(train_s, 1),
               "final_loss": loss, "miou": round(float(results["sem_seg/mIoU"]), 2),
               "macc": round(float(results["sem_seg/mACC"]), 2)}
        print(json.dumps(out), flush=True)
        return out
    results = evaluate(cfg, model, ds, build_dataloader(cfg, ds, training=False, seed=0))
    found, missed, false = find_instances(cfg, model, ds, device, arch)
    print(f"instances found {found} / {found + missed}, {false} false detections above "
          f"{report_thresh(arch)}", file=sys.stderr)
    out = {
        "arch": arch,
        "steps": steps,
        "train_seconds": round(train_s, 1),
        "final_loss": loss,
        "bbox_ap": round(float(results.get("bbox/AP", float("nan"))), 2),
        "bbox_ap50": round(float(results.get("bbox/AP50", float("nan"))), 2),
    }
    if "segm/AP" in results:
        out["segm_ap"] = round(float(results["segm/AP"]), 2)
        out["segm_ap50"] = round(float(results.get("segm/AP50", float("nan"))), 2)
    if "keypoints/AP" in results:
        out["keypoints_ap"] = round(float(results["keypoints/AP"]), 2)
    offsets = [m.weight for n, m in model.named_modules() if n.endswith(".conv_offset")]
    if offsets:
        out["conv_offsets"] = len(offsets)
        out["conv_offsets_moved"] = sum(bool(w.detach().abs().max() > 0) for w in offsets)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    args = parse_args(argv)
    cfg = overfit_cfg(args.arch)
    ds = overfit_inputs(cfg, args.arch)
    if args.opts:
        cfg.merge_from_list(args.opts)
    device = torch.device(args.device)
    model = build_model(cfg, device=device, training=True, init="jax",
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, torch.Generator(device=device).manual_seed(0))
    step = build_train_step(cfg, state)
    train_iter = build_dataloader(cfg, ds, training=True, seed=0)

    train_s = 0.0
    last_loss = None
    for i in range(args.steps):
        t0 = time.time()
        metrics = step(to_device(next(train_iter), device))
        if i % 100 == 0 or i == args.steps - 1 or i + 1 in args.eval_at:
            last_loss = float(metrics["total_loss"])
            print(f"step {i}: total_loss={last_loss:.4f}", file=sys.stderr)
        train_s += time.time() - t0
        if i + 1 in args.eval_at:
            report(cfg, model, ds, device, args.arch, i + 1, train_s, last_loss)
            model.train()
    train_iter.close()
    return report(cfg, model, ds, device, args.arch, args.steps, train_s, last_loss)


if __name__ == "__main__":
    main()
