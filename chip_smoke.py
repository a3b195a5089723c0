"""GPU smoke run of the PyTorch/CUDA port (``detectron2_tensorflow_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX. Phases, in order,
any failure exits non-zero:

  1. device: a CUDA card is required;
  2. build: the hand-written kernels (``csrc/*.cu``: ``nms_keep``, and
     ``roi_patch_fwd`` and ``roi_patch_bwd`` in one library) are compiled
     for sm_90a, one nvcc per source, in parallel;
  3. kernels: each kernel is held against its plain PyTorch version on the
     card at the slices' shapes (inputs from a seeded numpy generator) and
     both are timed with CUDA events after warm-up;
  4. model: Mask R-CNN R50-FPN (``bench_cfg()``'s model, seeded random
     weights, ``SCORE_THRESH_TEST = 0`` so all 100 detection slots are real)
     serves a seeded random 2 x 800 x 1344 bf16 batch through
     ``build_model(cfg)`` + ``model.predict(batch)``; the kernels' launch
     counts are read around that run; outputs are checked, and a narrow
     float32 model is held against the same model run on the CPU (where
     every kernel takes its plain version) on a small input;
  5. train: the same model at ``train_cfg(8)`` (bf16, float32 parameters,
     seeded random weights) takes 2 warm-up and 3 x 3 timed steps on a
     seeded 8 x 800 x 1344 batch through ``create_train_state`` +
     ``build_train_step``; the launch counts are read around the timed
     steps; losses must be finite, the frozen stem and res2 unchanged bit
     for bit, every trainable parameter changed; and a narrow float32 train
     step on 2 x 128 x 160 is held against the same step on the CPU (same
     weights, noise and proposals).

The last lines are the card's name and power limit, a ``{"kernels": [...]}``
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from detectron2_tensorflow_tpu_torch import get_cfg, kernels, train_cfg
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.meta_arch.postprocess import detector_postprocess
from detectron2_tensorflow_tpu_torch.models.poolers import (
    build_storage,
    plan_patch,
    plan_rois,
    roi_patch_backward,
    roi_patch_backward_reference,
    roi_patch_interpolate,
    roi_patch_interpolate_reference,
)
from detectron2_tensorflow_tpu_torch.models.sampling import draw_noise
from detectron2_tensorflow_tpu_torch.ops.nms import greedy_keep, greedy_keep_reference
from detectron2_tensorflow_tpu_torch.solver import trainable_parameters

SEED = 0
NMS_SRC = "detectron2_tensorflow_tpu_torch/csrc/nms_keep.cu"
ROI_SRC = "detectron2_tensorflow_tpu_torch/csrc/roi_patch.cu"
ROOT = Path(__file__).resolve().parent
# ROI tolerances. float32: both sides sum the same products in another
# order, so |err| stays near 1e-6 on O(1) features; 1e-4 leaves margin.
# bfloat16: both round one float32 value once, so they differ by at most
# one bf16 ulp of the output's magnitude, 2^-7 relative to its maximum.
ROI_TOL_F32 = 1e-4
ROI_TOL_BF16_REL = 2.0 ** -7
# ROI backward: both sides sum the same float32 products (g widened exactly)
# in other orders, the kernel's cross-ROI sums in atomic order. A float32 sum
# of n terms errs by at most about n * 2^-24 of the sum of their magnitudes,
# and a plane cell sums 2S products per ROI over the ROIs that cover it
# (up to ~100 with clustered boxes): each cell is held to 1e-5 of the sum of
# the magnitudes of its terms, the same plane made from |g|.
ROI_BWD_TOL = 1e-5
# Narrow float32 train step, card against CPU (TF32 off), same weights,
# proposals and sampler noise: losses to 1e-4 relative; gradients to 1e-4 of
# each tensor's largest magnitude, elementwise and in norm. The same float32
# sums in other orders (cuDNN against oneDNN, the backward kernel's atomics)
# read 3.11e-05 at worst on an H100; tests/test_torch_train.py holds the CPU
# against the JAX package to the same 1e-4.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-4


def tpu_kernel(name: str, line: int) -> str:
    """Repo-relative ``file:line`` of the JAX package's Pallas kernel
    ``ops/pallas/<name>.py`` (the one package with an ``ops/pallas``)."""
    (path,) = ROOT.glob(f"*/ops/pallas/{name}.py")
    return f"{path.relative_to(ROOT).as_posix()}:{line}"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- inputs -----------------------------------------------------------------

def clustered_boxes(rng, b, n, h=800.0, w=1333.0, objects=150):
    """Score-sorted candidate boxes as a detector emits them: jittered copies
    of a few objects (so NMS really suppresses), clipped to the image."""
    ctr = rng.uniform([0, 0], [w, h], (b, objects, 2))
    size = np.exp(rng.uniform(np.log(12), np.log(600), (b, objects, 1)))
    ar = np.exp(rng.uniform(-0.7, 0.7, (b, objects, 1)))
    wh = np.concatenate([size * ar, size / ar], -1)
    pick = rng.integers(0, objects, (b, n))
    c = np.take_along_axis(ctr, pick[..., None], 1) + rng.normal(0, 6, (b, n, 2))
    s = np.take_along_axis(wh, pick[..., None], 1) * rng.uniform(0.85, 1.15, (b, n, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], -1)
    boxes = np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)
    valid = rng.uniform(0, 1, (b, n)) > 0.05
    return boxes, valid


def class_offset(boxes, classes):
    """``ops/nms.class_aware_nms``'s shift, in its float32 order."""
    finite = np.where(np.isfinite(boxes), boxes, 0).max(axis=(1, 2)).astype(np.float32)
    max_coord = finite + np.float32(1.0)
    off = classes.astype(np.float32) * max_coord[:, None]
    return (boxes + off[..., None]).astype(np.float32)


# -- phase 3: kernels -------------------------------------------------------

def check_nms(rng, dev):
    cases = []
    b, v = clustered_boxes(rng, 10, 1000)  # RPN: 2 images x 5 levels
    cases.append(("rpn 2x5 levels N=1000 iou=0.7", b, v, 0.7, None))
    b, v = clustered_boxes(rng, 2, 2000)  # box head: class-offset candidates
    cls = rng.integers(0, 80, (2, 2000))
    cases.append(("box head B=2 N=2000 iou=0.5 max_keep=100", class_offset(b, cls), v, 0.5, 100))
    results = []
    errs = []
    for name, boxes, valid, thr, mk in cases:
        tb = torch.from_numpy(boxes).to(dev)
        tv = torch.from_numpy(valid).to(dev)
        got = greedy_keep(tb, tv, thr, max_keep=mk)
        want = greedy_keep_reference(tb, tv, thr, max_keep=mk)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if mk is None:
            if not np.array_equal(got, want):
                raise AssertionError(f"nms_keep {name}: keep mask differs from the plain version")
        for i in range(got.shape[0]):  # the prefix of max_keep survivors, what consumers read
            g, w = np.flatnonzero(got[i]), np.flatnonzero(want[i])
            k = len(w) if mk is None else min(mk, len(w))
            if not np.array_equal(g[:k], w[:k]):
                raise AssertionError(f"nms_keep {name}: survivors differ (image {i})")
        equal = bool(np.array_equal(got, want))
        errs.append(int(np.abs(got.astype(np.int8) - want.astype(np.int8)).max()))
        ms = cuda_ms(lambda: greedy_keep(tb, tv, thr, max_keep=mk), reps=50)
        plain_ms = cuda_ms(lambda: greedy_keep_reference(tb, tv, thr, max_keep=mk), reps=3, warmup=1)
        log(f"nms_keep   {name}: kept {int(got.sum())}, keep mask equal={equal}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results.append({"case": name, "err": errs[-1], "ms": ms, "plain_ms": plain_ms})
    return results


def roi_inputs(rng, dev, dtype, n, s, valid_frac=0.9, objects=None):
    """A real storage plane (p2-p5 of an 800x1344 image, C=256, with the
    extent-tier aliases) and a plan for ``n`` random boxes per image,
    jittered copies of ``objects`` objects (default ``n // 4``)."""
    b, c = 2, 256
    feats = [torch.from_numpy(rng.standard_normal((b, 800 // st, 1344 // st, c)).astype(np.float32))
             .to(dev, dtype) for st in (4, 8, 16, 32)]
    storage, meta = build_storage(feats, [4, 8, 16, 32], plan_patch(1333, 32))
    boxes, _ = clustered_boxes(rng, b, n, objects=objects or max(n // 4, 8))
    valid = torch.from_numpy(rng.uniform(0, 1, (b, n)) < valid_frac).to(dev)
    starts, wy, wx = plan_rois(meta, torch.from_numpy(boxes).to(dev), s, 0, 224, 4, valid=valid)
    return storage.contiguous(), starts.contiguous(), wy.contiguous(), wx.contiguous(), valid


def check_roi(rng, dev):
    results = []
    for label, n, s in (("box N=1000 S=7", 1000, 7), ("mask N=100 S=14", 100, 14)):
        for dtype in (torch.bfloat16, torch.float32):
            storage, starts, wy, wx, valid = roi_inputs(rng, dev, dtype, n, s)
            got = roi_patch_interpolate(storage, starts, wy, wx)
            want = roi_patch_interpolate_reference(storage, starts, wy, wx)
            torch.cuda.synchronize()
            skipped = ~valid
            if bool((got[skipped] != 0).any()):
                raise AssertionError(f"roi_patch {label}: skip-sentinel slots are not exact zeros")
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            tol = ROI_TOL_F32 if dtype == torch.float32 else ROI_TOL_BF16_REL * max(1.0, scale)
            if not err <= tol:
                raise AssertionError(f"roi_patch {label} {dtype}: max |err| {err} > {tol}")
            ms = cuda_ms(lambda: roi_patch_interpolate(storage, starts, wy, wx), reps=20)
            plain_ms = cuda_ms(lambda: roi_patch_interpolate_reference(storage, starts, wy, wx),
                               reps=3, warmup=1)
            name = f"{label} {str(dtype).replace('torch.', '')}"
            log(f"roi_patch  {name}: max|err| {err:.3g} (tol {tol:.3g}, max|out| {scale:.3g}), "
                f"skipped {int(skipped.sum())}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            results.append({"case": name, "err": err, "ms": ms, "plain_ms": plain_ms})
    return results


def check_roi_bwd(rng, dev):
    """``roi_patch_bwd`` against ``roi_patch_backward_reference`` at the train
    step's box and mask sets, clustered heavily overlapping boxes, 10% of the
    slots skipped, bf16 and float32 cotangents, and box chained into mask
    through ``init``."""
    results = []
    planes = {}
    for label, n, s in (("box B=2 N=512 S=7", 512, 7), ("mask B=2 N=128 S=14", 128, 14)):
        storage, starts, wy, wx, valid = roi_inputs(rng, dev, torch.bfloat16, n, s, objects=12)
        shape = tuple(storage.shape)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.from_numpy(rng.standard_normal((2, n, s, s, 256)).astype(np.float32)).to(dev, dtype)
            got = roi_patch_backward(g, starts, wy, wx, shape)
            want = roi_patch_backward_reference(g, starts, wy, wx, shape)
            bound = roi_patch_backward_reference(g.abs(), starts, wy, wx, shape)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            excess = float(((got - want).abs() - ROI_BWD_TOL * bound).max())
            if not excess <= 0:
                raise AssertionError(f"roi_patch_bwd {label} {dtype}: error exceeds "
                                     f"{ROI_BWD_TOL} x sum|terms| by {excess}")
            only_skipped = torch.where((~valid)[..., None, None, None], g, torch.zeros_like(g))
            if bool(roi_patch_backward(only_skipped, starts, wy, wx, shape).any()):
                raise AssertionError(f"roi_patch_bwd {label}: skipped slots added to the plane")
            acc, acc_ref = torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)
            ms = cuda_ms(lambda: roi_patch_backward(g, starts, wy, wx, shape, init=acc), reps=20)
            plain_ms = cuda_ms(lambda: roi_patch_backward_reference(g, starts, wy, wx, shape,
                                                                    init=acc_ref),
                               reps=3, warmup=1)
            name = f"{label} {str(dtype).replace('torch.', '')}"
            log(f"roi_bwd    {name}: max|err| {err:.3g} (max|want| {float(want.abs().max()):.3g}, "
                f"max sum|terms| {float(bound.max()):.3g}), skipped {int((~valid).sum())}, "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            results.append({"case": name, "err": err, "ms": ms, "plain_ms": plain_ms})
            planes[label, dtype] = (g, starts, wy, wx, shape)
    # Chained: the box set's gradient into a fresh plane, then the mask set's
    # added into it, in the order the fused pool's backward takes them.
    gb, sb, wyb, wxb, shape = planes["box B=2 N=512 S=7", torch.bfloat16]
    gm, sm, wym, wxm, _ = planes["mask B=2 N=128 S=14", torch.bfloat16]
    got = roi_patch_backward(gm, sm, wym, wxm, shape, init=roi_patch_backward(gb, sb, wyb, wxb, shape))
    want = roi_patch_backward_reference(gm, sm, wym, wxm, shape,
                                        init=roi_patch_backward_reference(gb, sb, wyb, wxb, shape))
    bound = roi_patch_backward_reference(gm.abs(), sm, wym, wxm, shape,
                                         init=roi_patch_backward_reference(gb.abs(), sb, wyb, wxb, shape))
    err = float((got - want).abs().max())
    if not float(((got - want).abs() - ROI_BWD_TOL * bound).max()) <= 0:
        raise AssertionError("roi_patch_bwd chained box -> mask: error exceeds the bound")
    log(f"roi_bwd    chained box -> mask through init (bf16): max|err| {err:.3g}")
    results.append({"case": "chained", "err": err})
    return results


# -- phase 4: model ---------------------------------------------------------

NARROW = {"STEM_OUT_CHANNELS": 16, "RES2_OUT_CHANNELS": 32, "WIDTH_PER_GROUP": 8}


def narrow_cfg():
    cfg = get_cfg()
    for k, v in NARROW.items():
        cfg.MODEL.RESNETS[k] = v
    cfg.MODEL.NECK.OUT_CHANNELS = 32
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 32
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.DTYPE = "float32"
    return cfg


def check_small_against_cpu(rng, dev):
    """Narrow float32 model on a 2 x 128 x 160 input: the card's output
    (kernels) against the CPU's (plain versions), same weights."""
    cfg = narrow_cfg()
    cpu_model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    gpu_model = build_model(cfg, device=dev, state_dict=cpu_model.state_dict())
    image = rng.uniform(0, 255, (2, 128, 160, 3)).astype(np.float32)
    sizes = np.array([[128, 160], [112, 150]], np.int32)
    batch = {"image": torch.from_numpy(image), "image_size": torch.from_numpy(sizes)}
    want = cpu_model.predict(batch)
    got = gpu_model.predict({k: v.to(dev) for k, v in batch.items()})
    got = {k: v.cpu() for k, v in got.get_fields().items()}
    if not torch.equal(got["is_valid"], want.is_valid):
        raise AssertionError("small input: valid slots differ between the card and the CPU")
    if not torch.equal(got["pred_classes"], want.pred_classes):
        raise AssertionError("small input: classes differ between the card and the CPU")
    errs = {}
    for k, tol in (("boxes", 1e-3), ("scores", 1e-5), ("pred_masks", 1e-4)):
        errs[k] = float((got[k] - want.get_fields()[k]).abs().max())
        if not errs[k] <= tol:
            raise AssertionError(f"small input: {k} max |err| {errs[k]} > {tol}")
    log(f"model      small f32 input, card vs CPU: valid={int(want.is_valid.sum())} slots equal, "
        f"classes equal, max|err| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def run_model(rng, dev):
    cfg = get_cfg()
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    log(f"model      built Mask R-CNN R50-FPN bf16 in {time.perf_counter() - t0:.2f} s")
    b, h, w = 2, 800, 1344
    image = torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)).to(dev)
    batch = {"image": image,
             "image_size": torch.tensor([[800, 1333]] * b, dtype=torch.int32, device=dev)}
    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
        model.predict(batch)
    torch.cuda.synchronize()

    # Host-bound at batch 2, so one short window is noisy: report the
    # median of three windows of five synchronized runs.
    greedy_keep.launches = 0
    roi_patch_interpolate.launches = 0
    windows, iters = 3, 5
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = model.predict(batch)
        torch.cuda.synchronize()
        rates.append(b * iters / (time.perf_counter() - t0))
    launches = {"nms_keep": greedy_keep.launches, "roi_patch_fwd": roi_patch_interpolate.launches}
    img_s = sorted(rates)[windows // 2]
    log(f"model      predict {windows}x{iters}, batch {b} at {h}x{w}: {img_s:.2f} img/s median "
        f"(windows {', '.join(f'{r:.2f}' for r in rates)}); launches {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")

    f = out.get_fields()
    for k in ("boxes", "scores", "pred_masks"):
        if not bool(torch.isfinite(f[k]).all()):
            raise AssertionError(f"non-finite {k}")
    if tuple(f["boxes"].shape) != (b, 100, 4) or tuple(f["pred_masks"].shape) != (b, 100, 28, 28):
        raise AssertionError(f"unexpected shapes {out}")
    per_image = f["is_valid"].sum(1).tolist()
    if per_image != [100] * b:
        raise AssertionError(f"valid detections per image {per_image}, expected 100")
    m = f["pred_masks"]
    if not (float(m.min()) >= 0.0 and float(m.max()) <= 1.0):
        raise AssertionError("mask probabilities outside [0, 1]")
    bx = f["boxes"]
    if bool((bx[..., 2] > 1333).any()) or bool((bx[..., 3] > 800).any()):
        raise AssertionError("boxes not clipped to the image size")
    pasted = detector_postprocess(cfg, out, batch).pred_masks
    if tuple(pasted.shape) != (b, 100, h, w) or pasted.dtype != torch.uint8:
        raise AssertionError(f"postprocess gave {tuple(pasted.shape)} {pasted.dtype}")
    log(f"model      outputs finite, 100 valid detections per image, scores in "
        f"[{float(f['scores'].min()):.4f}, {float(f['scores'].max()):.4f}], "
        f"{len(set(f['pred_classes'].flatten().tolist()))} classes, pasted masks "
        f"{tuple(pasted.shape)} with {int(pasted.sum())} pixels set")
    return launches, img_s


# -- phase 5: train ---------------------------------------------------------

FROZEN = ("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")


def narrow_train_cfg():
    cfg = train_cfg(2)
    for k, v in NARROW.items():
        cfg.MODEL.RESNETS[k] = v
    cfg.MODEL.NECK.OUT_CHANNELS = 32
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 32
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.DTYPE = "float32"
    cfg.INPUT.MAX_GT_INSTANCES = 5
    return cfg


@contextlib.contextmanager
def given_proposals(model, proposals):
    """Make ``model``'s RPN return ``proposals``: the card's and the CPU's
    convolutions round differently, and proposal scores closer than that
    may trade slots in the top-k, which reorders the sample."""
    model.proposal_generator.proposals = lambda *args, **kwargs: proposals
    try:
        yield
    finally:
        del model.proposal_generator.proposals


def check_train_against_cpu(dev):
    """Narrow float32 train step on a 2 x 128 x 160 batch: losses, gradients
    and updated parameters on the card (kernels) against the CPU (plain
    versions), from the same weights, sampler noise and proposals."""
    cfg = narrow_train_cfg()
    cpu_model = build_model(cfg, generator=torch.Generator().manual_seed(SEED), training=True)
    gpu_model = build_model(cfg, device=dev, state_dict=cpu_model.state_dict(), training=True)
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(cfg, 128, 160).items()}
    gbatch = {k: v.to(dev) for k, v in batch.items()}
    with torch.no_grad():
        feats = cpu_model.features(batch["image"])
        rpn = cpu_model.proposal_generator
        logits, deltas = rpn.rpn_head([feats[f] for f in rpn.in_features])
        proposals = rpn.proposals(logits, deltas, batch["image_size"], training=True)
    n_anchors = sum(l[0].numel() for l in logits)
    gen = torch.Generator().manual_seed(SEED + 1)
    noise = {"rpn": draw_noise(gen, (2, n_anchors), "cpu"),
             "roi": draw_noise(gen, (2, proposals.is_valid.shape[1] + 5), "cpu")}
    gnoise = {k: tuple(t.to(dev) for t in v) for k, v in noise.items()}
    gprops = type(proposals)(**{k: v.to(dev) for k, v in proposals.get_fields().items()})

    def run(model, b, nz, props):
        with given_proposals(model, props):
            losses = model.losses(b, noise=nz)
        sum(losses.values()).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None})

    want_l, want_g = run(cpu_model, batch, noise, proposals)
    got_l, got_g = run(gpu_model, gbatch, gnoise, gprops)
    for k, v in want_l.items():
        if not abs(got_l[k] - v) <= TRAIN_LOSS_RTOL * abs(v):
            raise AssertionError(f"narrow train step: {k} {got_l[k]} on the card, {v} on the CPU")
    if set(got_g) != set(want_g) or set(got_g) != set(trainable_parameters(cpu_model, 2)):
        raise AssertionError("narrow train step: gradients of other parameters on the card")
    worst, worst_norm = (0.0, ""), (0.0, "")
    for n, w in want_g.items():
        diff = got_g[n] - w
        rel = float(diff.abs().max()) / max(float(w.abs().max()), 1e-30)
        rel_norm = float(diff.norm()) / max(float(w.norm()), 1e-30)
        worst, worst_norm = max(worst, (rel, n)), max(worst_norm, (rel_norm, n))
        if rel > TRAIN_GRAD_TOL or rel_norm > TRAIN_GRAD_TOL:
            raise AssertionError(f"narrow train step: gradient of {n} differs by {rel:.3g} of "
                                 f"its largest magnitude, {rel_norm:.3g} in norm "
                                 f"(tolerance {TRAIN_GRAD_TOL})")
    log("train      narrow f32 step, card vs CPU: losses " + ", ".join(
        f"{k} {got_l[k]:.6f}/{v:.6f}" for k, v in want_l.items())
        + f"; {len(want_g)} gradients, worst max|err| / max|grad| {worst[0]:.3g} ({worst[1]}),"
          f" worst |err| / |grad| {worst_norm[0]:.3g} ({worst_norm[1]})")


def run_train(dev):
    cfg = train_cfg(8)
    b, h, w = 8, 800, 1344
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED),
                        training=True)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(SEED))
    step = build_train_step(cfg, state)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(cfg, h, w).items()}
    log(f"train      built Mask R-CNN R50-FPN train state (bf16, float32 params) in "
        f"{time.perf_counter() - t0:.2f} s")
    metrics = [step(batch) for _ in range(2)]  # warm-up: cuDNN algorithms, allocator
    torch.cuda.synchronize()

    greedy_keep.launches = 0
    roi_patch_interpolate.launches = 0
    roi_patch_backward.launches = 0
    windows, iters = 3, 3
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics.append(step(batch))
        torch.cuda.synchronize()
        rates.append(b * iters / (time.perf_counter() - t0))
    launches = {"nms_keep": greedy_keep.launches, "roi_patch_fwd": roi_patch_interpolate.launches,
                "roi_patch_bwd": roi_patch_backward.launches}
    img_s = sorted(rates)[windows // 2]
    log(f"train      {windows}x{iters} steps, batch {b} at {h}x{w}: {img_s:.2f} img/s "
        f"median (windows {', '.join(f'{r:.2f}' for r in rates)}); launches {launches}; "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the train step never launched {name}")

    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"non-finite losses: {values}")
    trainable = trainable_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
    frozen = [n for n, _ in model.named_parameters() if n not in trainable]
    if not frozen or any(not n.startswith(FROZEN) for n in frozen):
        raise AssertionError(f"unexpected frozen parameters {frozen}")
    changed_frozen = [n for n in frozen if not torch.equal(dict(model.named_parameters())[n], start[n])]
    unchanged = [n for n, p in trainable.items() if torch.equal(p.detach(), start[n])]
    if changed_frozen or unchanged:
        raise AssertionError(f"frozen parameters changed: {changed_frozen}; "
                             f"trainable parameters unchanged: {unchanged}")
    log(f"train      losses finite over {len(values)} steps; first "
        + ", ".join(f"{k} {v:.4f}" for k, v in values[0].items())
        + f"; last total_loss {values[-1]['total_loss']:.4f}; {len(frozen)} frozen parameters "
          f"bit-equal, all {len(trainable)} trainable parameters changed")
    return launches, img_s


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device     {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    paths = kernels.build_all()
    log(f"build      {sorted(p.name for p in paths.values())} in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(SEED)
    nms = check_nms(rng, dev)
    roi = check_roi(rng, dev)
    bwd = check_roi_bwd(rng, dev)
    check_small_against_cpu(rng, dev)
    launches, _ = run_model(rng, dev)
    check_train_against_cpu(dev)
    train_launches, _ = run_train(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "nms_keep", "route": "cuda", "source": NMS_SRC, "replaces": tpu_kernel("nms_keep", 161),
         "launches": launches["nms_keep"], "max_abs_err": float(max(r["err"] for r in nms)),
         "ms": nms[0]["ms"], "plain_ms": nms[0]["plain_ms"]},
        {"name": "roi_patch_fwd", "route": "cuda", "source": ROI_SRC, "replaces": tpu_kernel("roi_patch", 667),
         "launches": launches["roi_patch_fwd"],
         "max_abs_err": max(r["err"] for r in roi),
         "ms": roi[0]["ms"], "plain_ms": roi[0]["plain_ms"]},
        {"name": "roi_patch_bwd", "route": "cuda", "source": ROI_SRC, "replaces": tpu_kernel("roi_patch", 440),
         "launches": train_launches["roi_patch_bwd"],
         "max_abs_err": max(r["err"] for r in bwd),
         "ms": bwd[0]["ms"], "plain_ms": bwd[0]["plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
