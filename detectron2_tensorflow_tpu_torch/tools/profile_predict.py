"""Where the time of one ``predict`` goes on the card.

    python -m detectron2_tensorflow_tpu_torch.tools.profile_predict [--config_file CFG] [batch ...]
        [KEY VALUE ...]

Builds chip_smoke's model (Mask R-CNN R50-FPN, bf16, seeded random weights,
``SCORE_THRESH_TEST = 0``; with ``--config_file``, that YAML's model, for
example ``configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml`` or
``configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml``, in bf16 with the same
threshold, RetinaNet's, SOLOv2's and YOLOv4's too), serves a random batch of each given
size (default 2) at the config's first ``INPUT.PAD_BUCKETS`` entry (800x1344, or
608x608 for ``configs/COCO-Detection/yolov4_D_53_PAN_1x.yaml``; a ``LOAD_PROPOSALS`` model gets ``engine.add_proposal_slots``'s
proposals around ``make_train_batch``'s random boxes), and prints: images/s on the host clock around
synchronized runs; from ``torch.profiler``, the device time per batch, the
device's idle share (1 - device time / wall time), the device time by
category (convs, GEMMs, the hand-written kernels, sorts, the rest), each
hand-written kernel's own device time (``nms_keep``'s mask pass and sweep
apart) and the top kernels by device time; for a model with a semantic
head (``PanopticFPN``, ``SemanticSegmentor``) the head's own device time
(its convs, GN, upsamples and the float32 logits) and the argmax's, on the
served features, and for a ``PanopticFPN`` the device and wall time of
``panoptic_fusion`` on the served output; for SOLOv2 the head's, the
inference's, the dynamic conv's and matrix NMS's device time; for YOLOv4 the
head's and the inference's (decode, top-k, clip and NMS); for Relation Networks
(``configs/Misc/relation_rcnn_R_50_FPN_1x.yaml``) the relation box head's (its
geometry embedding apart) and, with ``DUPLICATE_REMOVAL_ON`` (for example
``MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_ON True`` after the batch
sizes: ``KEY VALUE`` pairs there override the config), the learned
duplicate removal's (candidates, keep logits, top-k). The full profiler table goes to
``profile_predict[_<config>]_b<batch>[_fused].txt`` in ``main``'s output
directory. Set ``D2TPU_ENABLE_FUSED_EPILOGUE=1`` to profile the model with
the fused bottleneck tail (``_fused`` in the file name).
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as profile_ctx

from detectron2_tensorflow_tpu_torch import bench_cfg, build_model, get_cfg
from detectron2_tensorflow_tpu_torch.engine import add_proposal_slots, make_train_batch
from detectron2_tensorflow_tpu_torch.models.roi_heads.relation import (
    RelationROIHeads,
    geometry_embeddings,
)
from detectron2_tensorflow_tpu_torch.ops.fused_residual import fused_epilogue_enabled

CATEGORIES = (
    ("fused_residual kernel", ("fused_epilogue",)),
    ("nms_keep kernel", ("nms_mask_kernel", "nms_sweep_kernel")),
    ("roi_patch_fwd kernel", ("roi_patch_fwd_kernel",)),
    ("roi_patch_bwd kernel", ("roi_patch_bwd_kernel",)),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "nhwc", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "cutlass", "sm90_", "gemv")),
    ("sort / top-k", ("sort", "radix", "topk", "scan")),
    ("gather / index", ("index", "gather", "scatter")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other elementwise / copies"


def yaml_cfg(config_file: str, opts=()):
    """``config_file``'s model, with the ``KEY VALUE`` overrides ``opts``, in
    bf16 (the full default tree under it)."""
    cfg = get_cfg()
    cfg.merge_from_file(config_file)
    cfg.merge_from_list(list(opts))
    cfg.MODEL.DTYPE = "bfloat16"
    return cfg


def serving_cfg(config_file: Optional[str] = None, opts=()):
    """``bench_cfg()``, or ``config_file``'s model in bf16, with
    ``SCORE_THRESH_TEST = 0`` (the ROI heads', RetinaNet's, SOLOv2's, with
    SOLOv2's ``UPDATE_SCORE_THRESH_TEST``, and YOLOv4's) so that every
    detection slot is real."""
    cfg = yaml_cfg(config_file, opts) if config_file else bench_cfg()
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.RETINANET.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.SOLO.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.SOLO.UPDATE_SCORE_THRESH_TEST = 0.0
    cfg.MODEL.YOLOV4.SCORE_THRESH_TEST = 0.0
    return cfg


def serving_shape(cfg):
    """``((H, W), (h, w))``: the first ``INPUT.PAD_BUCKETS`` entry and the
    content of a landscape image the test resize fills it with, capped by
    ``MIN_SIZE_TEST`` and ``MAX_SIZE_TEST`` (800x1333 in 800x1344; 608x608
    for YOLOv4)."""
    bh, bw = (int(v) for v in cfg.INPUT.PAD_BUCKETS[0])
    r = cfg.TRANSFORM.RESIZE
    return (bh, bw), (min(bh, int(r.MIN_SIZE_TEST)), min(bw, int(r.MAX_SIZE_TEST)))


def run(batch: int, out_dir: Path, config_file: Optional[str] = None, opts=()) -> None:
    dev = torch.device("cuda", 0)
    cfg = serving_cfg(config_file, opts)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    (bh, bw), content = serving_shape(cfg)
    image = torch.from_numpy(rng.uniform(0, 255, (batch, bh, bw, 3)).astype(np.float32)).to(dev)
    inputs = {"image": image,
              "image_size": torch.tensor([content] * batch, dtype=torch.int32, device=dev)}
    if cfg.MODEL.LOAD_PROPOSALS:  # proposals around train_cfg's random GT boxes
        gt = make_train_batch(cfg, bh, bw)
        slots = add_proposal_slots(cfg, {k: gt[k][:batch] for k in ("gt_boxes", "gt_valid",
                                                                     "image_size")},
                                   training=False)
        inputs.update({k: torch.from_numpy(v).to(dev) for k, v in slots.items()
                       if k.startswith("proposal_")})
    for _ in range(3):
        model.predict(inputs)
    torch.cuda.synchronize()

    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        model.predict(inputs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    print(f"batch {batch} at {bh}x{bw}: {batch / wall:.2f} img/s, {wall * 1000:.2f} ms/batch "
          "(host clock)")

    profile(lambda: model.predict(inputs), 3, f"batch {batch}",
            out_dir / f"profile_predict{name_of(config_file)}_b{batch}{suffix()}.txt")
    if hasattr(model, "sem_seg_head"):
        profile_semantic(cfg, model, inputs)
    if hasattr(model, "solov2"):
        profile_solov2(model, inputs)
    if hasattr(model, "yolov4"):
        profile_yolov4(model, inputs)
    if isinstance(getattr(model, "roi_heads", None), RelationROIHeads):
        profile_relation(model, inputs)


def relation_times(model, inputs) -> dict:
    """Device ms per call, on the served proposals and features, of the
    relation box head (fc1, relation1, fc2, relation2), of its ``[B, R, R,
    64]`` geometry embedding alone and, when the model has it, of the
    learned duplicate removal (``dup_removal_inference``: candidates, the
    keep logits, the top-k)."""
    heads, rpn = model.roi_heads, model.proposal_generator
    with torch.inference_mode():
        feats = model.features(inputs["image"])
        props = rpn.proposals(*rpn.rpn_head([feats[f] for f in rpn.in_features]),
                              inputs["image_size"])
        boxes, valid = props.proposal_boxes, props.is_valid
        pooled = heads.pool_box_features(boxes, heads.pooling_storage(feats), valid=valid)
        out = {"rois": tuple(boxes.shape[:2]),
               "head_ms": device_time(lambda: heads.box_head(pooled, boxes, valid), 3)[0],
               "geometry_ms": device_time(lambda: geometry_embeddings(
                   boxes, heads.box_head.geometry_dim), 3)[0]}
        if heads.duplicate_removal is not None:
            scores, deltas, app = heads.box_outputs(pooled, boxes, valid)
            out["removal_ms"] = device_time(lambda: heads.dup_removal_inference(
                scores.float(), deltas.float(), props, app, inputs["image_size"]), 3)[0]
    return out


def profile_relation(model, inputs) -> None:
    t = relation_times(model, inputs)
    removal = (f"; duplicate removal (top {4 * model.roi_heads.detections_per_image} "
               f"candidates, keep logits, top-k): device {t['removal_ms']:.3f} ms/call"
               if "removal_ms" in t else "; no duplicate removal (class-aware NMS)")
    print(f"  relation box head ({t['rois'][0]} x {t['rois'][1]} ROIs): device "
          f"{t['head_ms']:.3f} ms/call, of which the geometry embedding {t['geometry_ms']:.3f} "
          f"ms" + removal)


def profile_yolov4(model, inputs) -> None:
    """YOLOv4's head (the three 3x3 convs and predictors) and its inference
    (decode, scores, the top 1000, clip, one class-agnostic NMS), each timed
    on the served features."""
    drv = model.yolov4
    with torch.inference_mode():
        feats = model.features(inputs["image"])
        levels = [feats[f] for f in drv.in_features]
        head = device_time(lambda: model.head(levels), 3)
        maps = model._head_outputs(inputs["image"])
        infer = device_time(lambda: drv.inference(maps, inputs["image_size"]), 3)
    cands = sum(m.shape[2] * m.shape[3] for m in maps) * drv.num_anchors
    print(f"  YOLOv4 head ({len(maps)} levels, {cands} candidates): device {head[0]:.3f} ms/call, "
          f"wall {head[1]:.3f} ms; inference (decode, top-1000, NMS): device {infer[0]:.3f} "
          f"ms/call, wall {infer[1]:.3f} ms, idle share {infer[2]:.3f}")


def profile_solov2(model, inputs) -> None:
    """SOLOv2's head (towers, mask branch), its inference, and inside that
    the dynamic conv (``TOPK_CANDIDATES_TEST`` kernels against the mask
    features, float32, and the sigmoid) and matrix NMS (on those masks
    binarized), each timed on the served features."""
    from detectron2_tensorflow_tpu_torch.ops.nms import matrix_nms

    drv = model.solov2
    with torch.inference_mode():
        feats = model.features(inputs["image"])
        head = device_time(lambda: model.head(feats), 3)
        outputs = model._head_outputs(inputs["image"])
        infer = device_time(lambda: drv.inference(*outputs), 3)
        mask_feat = outputs[2]
        b, e, hm, wm = mask_feat.shape
        kernels = torch.cat([k.reshape(b, -1, e) for k in outputs[1]], 1)[:, :drv.topk]
        flat = mask_feat.reshape(b, e, hm * wm)
        dyn = device_time(lambda: torch.sigmoid(torch.bmm(kernels, flat)), 3)
        binary = torch.sigmoid(torch.bmm(kernels, flat)) > drv.mask_thresh
        labels = torch.zeros(binary.shape[:2], dtype=torch.int64, device=binary.device)
        scores = torch.linspace(1.0, 0.0, binary.shape[1], device=binary.device).expand(b, -1)
        nms = device_time(lambda: matrix_nms(binary, labels, scores, drv.nms_sigma,
                                             drv.nms_kernel), 3)
    print(f"  SOLOv2 head (towers on grids {drv.num_grids}, mask branch to {hm}x{wm}): device "
          f"{head[0]:.3f} ms/call, wall {head[1]:.3f} ms; inference: device {infer[0]:.3f} "
          f"ms/call, wall {infer[1]:.3f} ms")
    print(f"  dynamic conv ([{b}, {kernels.shape[1]}, {e}] x [{e}, {hm * wm}] float32 + sigmoid): "
          f"device {dyn[0]:.3f} ms/call; matrix NMS ([{b}, {binary.shape[1]}, {hm * wm}], one "
          f"class): device {nms[0]:.3f} ms/call")


def profile_semantic(cfg, model, inputs) -> None:
    """The semantic head's and the argmax's device ms on the served features,
    and a PanopticFPN's ``panoptic_fusion`` of its served output."""
    from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import (
        panoptic_fusion,
        semantic_logits,
    )

    with torch.inference_mode():
        feats = model.features(inputs["image"])
        logits = semantic_logits(model, feats)
        head = device_time(lambda: semantic_logits(model, feats), 3)
        arg = device_time(lambda: torch.argmax(logits, dim=1), 3)
    print(f"  sem_seg head (convs, GN, upsamples, float32 logits {tuple(logits.shape)}): "
          f"device {head[0]:.3f} ms/call, wall {head[1]:.3f} ms; argmax: device "
          f"{arg[0]:.3f} ms/call")
    if cfg.MODEL.META_ARCHITECTURE == "PanopticFPN":
        out = model.predict(inputs)
        fusion = device_time(lambda: panoptic_fusion(cfg, out), 3)
        print(f"  panoptic_fusion ({out.boxes.shape[1]} detection slots, "
              f"{cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES} stuff labels): device {fusion[0]:.3f} "
              f"ms/call, wall {fusion[1]:.3f} ms/call, idle share {fusion[2]:.3f}")


def name_of(config_file: Optional[str]) -> str:
    """File-name part naming the config (none for ``bench_cfg()``)."""
    return "_" + Path(config_file).stem if config_file else ""


def suffix() -> str:
    """File-name suffix of a run with the fused bottleneck tail switched on."""
    return "_fused" if fused_epilogue_enabled() else ""


def device_time(fn, runs: int, host_ops: bool = True):
    """``(device ms per call, wall ms per call, idle share, profiler)`` of
    ``runs`` calls of ``fn`` under ``torch.profiler``: the device time is
    the sum of the kernels' times, the idle share 1 - device time / wall
    time. ``host_ops`` False records the device's activity alone: the same
    sums, without the host operators a full table shows, whose
    post-processing takes seconds over a long call."""
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile_ctx(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / runs * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / runs / 1e3
    return device_ms, wall_ms, 1 - device_ms / wall_ms, prof


def profile(fn, runs: int, label: str, out_file: Path) -> None:
    """Profile ``runs`` calls of ``fn`` and print the device time per call,
    the device idle share (1 - device time / wall time under the profiler),
    the device time by category and the top kernels; the full profiler
    table goes to ``out_file``."""
    device_ms, wall_ms, idle, prof = device_time(fn, runs)
    total_us = device_ms * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"{label}: device time {device_ms:.2f} ms/call, wall under the profiler "
          f"{wall_ms:.2f} ms/call, device idle share {idle:.3f}")
    by_cat = defaultdict(float)
    for e in events:
        by_cat[category(e.key)] += e.self_device_time_total / runs
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:28s} {us / 1000:8.3f} ms  {us / total_us:6.1%}")
    print("  hand-written kernels, each:")
    for e in sorted(events, key=lambda e: e.key):
        if category(e.key).endswith(" kernel"):
            print(f"    {e.self_device_time_total / runs / 1000:8.4f} ms  x{e.count // runs:<4d} "
                  f"{e.key[:110]}")
    print("  top kernels:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / runs / 1000:8.3f} ms  x{e.count // runs:<4d} "
              f"{e.key[:110]}")
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80))


def main(argv, run_batch=run, default_batch: int = 2) -> None:
    """``run_batch(batch, out_dir, config_file, opts)`` for each batch size
    in ``argv`` (``--config_file CFG`` anywhere in it names the YAML; the
    ``KEY VALUE`` pairs after the batch sizes, ``opts``, override it)."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    argv = list(argv)
    config_file = None
    if "--config_file" in argv:
        i = argv.index("--config_file")
        config_file = argv[i + 1]
        del argv[i: i + 2]
    print(torch.cuda.get_device_name(0), torch.__version__, config_file or "bench_cfg()",
          f"fused bottleneck tail {'on' if fused_epilogue_enabled() else 'off'}")
    sizes = [a for a in argv if a.isdigit()]
    opts = argv[len(sizes):]
    if argv[:len(sizes)] != sizes or len(opts) % 2 or opts and not config_file:
        raise SystemExit("usage: [--config_file CFG] [batch ...] [KEY VALUE ...] (overrides "
                         "need --config_file)")
    for batch in [int(a) for a in sizes] or [default_batch]:
        run_batch(batch, Path("chiprun_out"), config_file, opts)


if __name__ == "__main__":
    main(sys.argv[1:])
