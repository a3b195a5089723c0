"""GPU smoke run of the PyTorch/CUDA port (``detectron2_tensorflow_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX. Phases, in order,
any failure exits non-zero:

  1. device: a CUDA card is required;
  2. build: the hand-written kernels (``csrc/*.cu``: ``nms_keep``;
     ``roi_patch_fwd`` with its ablation variants and ``roi_patch_bwd`` in
     one library; ``fused_residual``) are compiled for sm_90a, one nvcc per
     source, in parallel;
  3. kernels: each kernel is held against its plain PyTorch version on the
     card at the slices' shapes (inputs from a seeded numpy generator) and
     both are timed with CUDA events after warm-up, beside the least time
     the card could take (bound) and, for the fused bottleneck tail, the
     port's unfused tail as the PyTorch yardstick. The fused tail is held
     at R50's four tail shapes at batch 2 and 8, each on the persistent
     ``wgmma`` path, and its host cost per call is read on that path and on
     the ``mma.sync`` one. ``nms_keep``'s keep masks
     are bit-equal at serving's RPN (10 x 1000, and stacked with p6's 819
     rows padded to 1000), the box head (2 x 2000, ``max_keep`` 100) and
     training's stacked RPN (40 x 2000, ``max_keep`` 1000);
  4. variants: the ROI forward's seven ablations at the ROI tool's shapes
     with 2 images, each held against its plain version (``full`` bit-equal
     to ``roi_patch_interpolate``), then timed through the tool's own
     entry point (``tools/exp_roi_variants.main``);
  5. model: Mask R-CNN R50-FPN (``bench_cfg()``'s model, seeded random
     weights, ``SCORE_THRESH_TEST = 0`` so all 100 detection slots are real)
     is built twice through ``build_model(cfg)`` (on the card by default),
     with ``D2TPU_ENABLE_FUSED_EPILOGUE`` unset and set, and serves a seeded
     random 2 x 800 x 1344 bf16 batch through ``model.predict(batch)`` in
     turns (off, on, on, off, twice); the kernels' launch counts are read
     around that run (16 fused tails per ``predict`` with the switch on,
     all on the ``wgmma`` path, 0 off; 2 ``nms_keep`` launches per
     ``predict``); outputs are checked,
     and a narrow float32 model is held against the same model run on the
     CPU (where every kernel takes its plain version) on a small input,
     switch off and on;
  6. train: the same model at ``train_cfg(8)`` (bf16, float32 parameters,
     seeded random weights), switch off and on, takes 2 warm-up steps each
     and 8 x 3 timed steps in turns on a seeded 8 x 800 x 1344 batch
     through ``create_train_state`` + ``build_train_step``; the launch
     counts are read around the timed steps (16 fused tails per step with
     the switch on, all on the ``wgmma`` path, 1 ``nms_keep`` launch per
     step); losses must be finite,
     the frozen stem and res2 unchanged bit for bit, every trainable
     parameter changed; and a narrow
     float32 train step on 2 x 128 x 160 is held against the same step on
     the CPU (same weights, noise and proposals), switch off and on.

The last lines are the card's name and power limit, a ``{"kernels": [...]}``
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
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
    hat_support,
    plan_patch,
    plan_rois,
    roi_patch_backward,
    roi_patch_backward_reference,
    roi_patch_interpolate,
    roi_patch_interpolate_reference,
    skip_tier_class,
)
from detectron2_tensorflow_tpu_torch.models.sampling import draw_noise
from detectron2_tensorflow_tpu_torch.ops import fused_residual
from detectron2_tensorflow_tpu_torch.ops.fused_residual import (
    fused_conv1x1_bn_add_relu,
    fused_conv1x1_bn_add_relu_reference,
)
from detectron2_tensorflow_tpu_torch.ops.nms import (
    PAD_BOX,
    greedy_keep,
    greedy_keep_reference,
)
from detectron2_tensorflow_tpu_torch.solver import trainable_parameters
from detectron2_tensorflow_tpu_torch.tools import exp_roi_variants
from detectron2_tensorflow_tpu_torch.tools.exp_roi_variants import (
    roi_patch_variant,
    roi_patch_variant_reference,
)

SEED = 0
NMS_SRC = "detectron2_tensorflow_tpu_torch/csrc/nms_keep.cu"
ROI_SRC = "detectron2_tensorflow_tpu_torch/csrc/roi_patch.cu"
FUSED_SRC = "detectron2_tensorflow_tpu_torch/csrc/fused_residual.cu"
ROOT = Path(__file__).resolve().parent
# Least time of a function on an H100 SXM (NVIDIA data sheet, at 700 W):
# the larger of its bytes over the HBM rate and its operations over the
# peak rate for the inputs' type (bf16 tensor cores; float32 outside them,
# as the float32 kernels must not round to TF32).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# About 20 float32 operations per IoU pair: two areas, the intersection
# (min, max, differences, clamps, product), the union and the division, and
# the comparison with the threshold.
NMS_OPS_PER_PAIR = 20
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
# Fused bottleneck tail, kernel against plain version on the card: both sum
# the same float32 products in other orders and round once. float32: 1e-5 of
# the largest value. bf16: one bf16 ulp of each value, plus that float32
# tolerance where the sum cancels near zero (a float32 difference there is
# larger than the ulp of the tiny result): within_tolerance.
FUSED_TOL_F32 = 1e-5
# The bottleneck tails of R50 at 800 x 1344: (stage, K, N, H, W).
R50_TAILS = (("res2", 64, 256, 200, 336), ("res3", 128, 512, 100, 168),
             ("res4", 256, 1024, 50, 84), ("res5", 512, 2048, 25, 42))
FUSED_TAILS = 16  # R50's bottleneck blocks, each with one fused tail
# nms_keep launches: per predict the RPN's five levels in one, the box
# head's class-aware NMS in another; per train step the RPN's alone.
NMS_PER_PREDICT = 2
NMS_PER_STEP = 1


def tpu_kernel(pattern: str, line: int) -> str:
    """Repo-relative ``file:line`` of the TPU kernel in the one file of the
    checkout matching ``pattern`` (a glob from the repo root, for example
    ``*/ops/pallas/nms_keep.py`` or ``tools/exp_roi_variants.py``)."""
    (path,) = ROOT.glob(pattern)
    return f"{path.relative_to(ROOT).as_posix()}:{line}"


def bound(nbytes: float, ops: float, dtype: torch.dtype):
    """``(bound_ms, bound_by)``: the least time for ``nbytes`` of device
    memory traffic and ``ops`` operations on ``dtype`` inputs."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def fused_switch(on: bool):
    """``D2TPU_ENABLE_FUSED_EPILOGUE`` set to 1 (or unset) for the block; the
    port reads it when a model is built."""
    old = os.environ.get(fused_residual.ENV_SWITCH)
    if on:
        os.environ[fused_residual.ENV_SWITCH] = "1"
    else:
        os.environ.pop(fused_residual.ENV_SWITCH, None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(fused_residual.ENV_SWITCH, None)
        else:
            os.environ[fused_residual.ENV_SWITCH] = old


def fused_tails(model) -> int:
    """Convs of ``model`` built to take the fused tail."""
    return sum(bool(getattr(m, "fuse_residual", False)) for m in model.modules())


COUNTERS = {"nms_keep": greedy_keep, "roi_patch_fwd": roi_patch_interpolate,
            "roi_patch_bwd": roi_patch_backward, "fused_residual": fused_conv1x1_bn_add_relu,
            "roi_patch_variants": roi_patch_variant}


def zero_launches() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    fused_conv1x1_bn_add_relu.launches_by_path.update(
        dict.fromkeys(fused_conv1x1_bn_add_relu.launches_by_path, 0))


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


# Cycles per second of torch.cuda._sleep's spin loop: the H100's top SM clock
# (1.98 GHz). A slower clock only makes the hold below longer.
SPIN_CYCLES_PER_S = 1.98e9


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after warm-up.

    A spin kernel holds the stream while the host enqueues the calls, so
    the events time the calls' device work back to back, not the host's
    launch cost between them (which exceeds a small kernel's run time).
    If the hold ended before the last call was enqueued (a call that
    synchronizes, as a plain version may), it is retried longer, and after
    three tries the time is taken as it comes, host gaps included.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold = 2 * (time.perf_counter() - t0) * reps + 1e-3  # an upper bound of the enqueue time
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(4):
        if attempt < 3:
            torch.cuda._sleep(int(hold * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        late = start.query()  # the hold was over before the calls were all enqueued
        torch.cuda.synchronize()
        if not late:
            break
        hold *= 4
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

def stacked_levels(rng, images, n, last=819):
    """The RPN's stacked candidates: per image four levels of ``n`` boxes and
    p6's ``last`` (13 x 21 x 3 at 800x1344) padded to ``n`` with invalid rows
    holding the far-away box, as ``ops.nms.nms_fixed_levels`` pads them."""
    boxes, valid = clustered_boxes(rng, images * 5, n)
    p6 = np.arange(images) * 5 + 4
    boxes[p6, last:] = PAD_BOX
    valid[p6, last:] = False
    return boxes, valid


def nms_pairs(valid, keep, max_keep):
    """IoU pairs of valid boxes the greedy needs per batch row: all of them,
    or with ``max_keep`` those up to the row of the last survivor kept."""
    total = 0.0
    for v, k in zip(valid, keep):
        rows = np.flatnonzero(k)
        end = len(v) if max_keep is None or len(rows) < max_keep else rows[max_keep - 1] + 1
        m = float(v[:end].sum())
        total += m * (m - 1) / 2
    return total


def check_nms(rng, dev):
    """``nms_keep`` bit-equal to its plain version at the main path's shapes:
    serving's RPN (2 images x 5 levels of 1000, unpadded as in PR 5's check
    and stacked with p6 padded), the box head (class-offset candidates,
    ``max_keep`` 100) and training's RPN (8 images x 5 levels of 2000,
    ``max_keep`` 1000); each timed beside its bound and the plain version."""
    cases = []
    b, v = clustered_boxes(rng, 10, 1000)  # RPN: 2 images x 5 levels
    cases.append(("rpn 2x5 levels N=1000 iou=0.7", b, v, 0.7, None))
    b, v = stacked_levels(rng, 2, 1000)
    cases.append(("rpn stacked 2x(4x1000 + 819 padded) iou=0.7", b, v, 0.7, None))
    b, v = clustered_boxes(rng, 2, 2000)  # box head: class-offset candidates
    cls = rng.integers(0, 80, (2, 2000))
    cases.append(("box head B=2 N=2000 iou=0.5 max_keep=100", class_offset(b, cls), v, 0.5, 100))
    b, v = stacked_levels(rng, 8, 2000)
    cases.append(("train rpn stacked 8x(4x2000 + 819 padded) iou=0.7 max_keep=1000",
                  b, v, 0.7, 1000))
    results = []
    for name, boxes, valid, thr, mk in cases:
        tb = torch.from_numpy(boxes).to(dev)
        tv = torch.from_numpy(valid).to(dev)
        got = greedy_keep(tb, tv, thr, max_keep=mk)
        want = greedy_keep_reference(tb, tv, thr, max_keep=mk)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"nms_keep {name}: keep mask differs from the plain version")
        err = int(np.abs(got.astype(np.int8) - want.astype(np.int8)).max())
        ms = cuda_ms(lambda: greedy_keep(tb, tv, thr, max_keep=mk), reps=50)
        plain_ms = cuda_ms(lambda: greedy_keep_reference(tb, tv, thr, max_keep=mk),
                           reps=3, warmup=1)
        # Boxes and valid flags in, the keep mask out; the IoU of every pair
        # of valid boxes the greedy reaches.
        bound_ms, bound_by = bound(boxes.nbytes + 2 * valid.size,
                                   NMS_OPS_PER_PAIR * nms_pairs(valid, want, mk), torch.float32)
        log(f"nms_keep   {name}: kept {int(got.sum())}, keep mask equal, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        results.append({"case": name, "err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by})
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


def covered_cells(starts, wy, wx, htot: int, wm: int) -> int:
    """Plane cells ``(b, row, col)`` in the hat support of some slot that is
    not skipped: what a ROI kernel must read (or, backward, add into)."""
    b, n, _, p = wy.shape
    ar = torch.arange(p, device=starts.device)
    sy, sx = hat_support(wy), hat_support(wx)
    in_y = (ar >= sy[..., :1]) & (ar < sy[..., 1:])  # [B, N, P]
    in_x = (ar >= sx[..., :1]) & (ar < sx[..., 1:])
    rows = starts[..., 0, None].long() + ar
    cols = starts[..., 1, None].long() + ar
    in_y &= (rows >= 0) & (rows < htot)
    in_x &= (cols >= 0) & (cols < wm)
    keep = ((starts[..., 2] < skip_tier_class(p))[..., None, None]
            & in_y[..., :, None] & in_x[..., None, :])
    bidx = torch.arange(b, device=starts.device)[:, None, None, None].expand(b, n, p, p)
    mask = torch.zeros((b, htot, wm), dtype=torch.bool, device=starts.device)
    mask[bidx[keep], rows[..., :, None].expand(b, n, p, p)[keep],
         cols[..., None, :].expand(b, n, p, p)[keep]] = True
    return int(mask.sum())


def support_spans(starts, wy, wx):
    """Row and column spans ``(hy, hx)`` of the hat support of each slot that
    is not skipped (``[active]`` int64 each)."""
    active = starts[..., 2] < skip_tier_class(wy.shape[-1])
    sy, sx = hat_support(wy)[active], hat_support(wx)[active]
    return sy[:, 1] - sy[:, 0], sx[:, 1] - sx[:, 0]


def support_share(starts, wy, wx) -> float:
    """Mean share of the P x P patch inside the hat support, over the slots
    that are not skipped."""
    hy, hx = support_spans(starts, wy, wx)
    return float((hy * hx).double().mean()) / wy.shape[-1] ** 2


def roi_bound(storage_shape, dtype, starts, wy, wx, backward: bool):
    """Bound of one ROI patch pass: the plane cells in the union of the hat
    supports read (forward, in the plane's dtype) or read and written
    (backward, into a float32 plane given as ``init``), the plan, the
    ``[B, N, S, S, C]`` result (or cotangent) once; the two contractions
    over each slot's support (forward ``S*hy*hx + S*S*hx`` products per
    channel, backward ``S*S*hy + S*hy*hx``), at the rate of the plane's (or
    cotangent's) dtype."""
    b, htot, wm, c = storage_shape
    n, s, p = wy.shape[1:]
    esize = torch.empty((), dtype=dtype).element_size()
    cells = covered_cells(starts, wy, wx, htot, wm) * c
    plane_bytes = cells * (8 if backward else esize)
    plan_bytes = b * n * (3 * 4 + 2 * s * p * 4)
    io_bytes = b * n * s * s * c * esize
    hy, hx = (t.double() for t in support_spans(starts, wy, wx))
    per_slot = s * s * hy + s * hy * hx if backward else s * hy * hx + s * s * hx
    ops = 2 * c * float(per_slot.sum())
    return bound(plane_bytes + plan_bytes + io_bytes, ops, dtype)


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
            bound_ms, bound_by = roi_bound(storage.shape, dtype, starts, wy, wx, backward=False)
            name = f"{label} {str(dtype).replace('torch.', '')}"
            log(f"roi_patch  {name}: max|err| {err:.3g} (tol {tol:.3g}, max|out| {scale:.3g}), "
                f"skipped {int(skipped.sum())}, support {support_share(starts, wy, wx):.1%} of "
                f"the patch, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            results.append({"case": name, "err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by})
    return results


def spread_starts(starts, p: int, htot: int, wm: int, seed: int):
    """``starts`` with every slot's origin moved to a uniform random row and
    8-aligned column of the plane: the same supports (the same work), with
    little overlap between ROIs."""
    gen = torch.Generator(device=starts.device).manual_seed(seed)
    b, n = starts.shape[:2]
    spread = starts.clone()
    spread[..., 0] = torch.randint(0, htot - p + 1, (b, n), generator=gen, device=starts.device)
    spread[..., 1] = torch.randint(0, (wm - p) // 8 + 1, (b, n), generator=gen,
                                   device=starts.device) * 8
    return spread


def check_roi_bwd(rng, dev):
    """``roi_patch_bwd`` against ``roi_patch_backward_reference`` at the train
    step's box and mask sets, clustered heavily overlapping boxes, 10% of the
    slots skipped, bf16 and float32 cotangents, and box chained into mask
    through ``init``. The atomics' contention: the bf16 sets timed again
    with their ROIs spread over the plane (the same supports)."""
    results = []
    planes = {}
    for label, n, s in (("box B=2 N=512 S=7", 512, 7), ("mask B=2 N=128 S=14", 128, 14)):
        storage, starts, wy, wx, valid = roi_inputs(rng, dev, torch.bfloat16, n, s, objects=12)
        shape = tuple(storage.shape)
        share = support_share(starts, wy, wx)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.from_numpy(rng.standard_normal((2, n, s, s, 256)).astype(np.float32)).to(dev, dtype)
            got = roi_patch_backward(g, starts, wy, wx, shape)
            want = roi_patch_backward_reference(g, starts, wy, wx, shape)
            terms = roi_patch_backward_reference(g.abs(), starts, wy, wx, shape)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            excess = float(((got - want).abs() - ROI_BWD_TOL * terms).max())
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
            bound_ms, bound_by = roi_bound(shape, dtype, starts, wy, wx, backward=True)
            name = f"{label} {str(dtype).replace('torch.', '')}"
            log(f"roi_bwd    {name}: max|err| {err:.3g} (max|want| {float(want.abs().max()):.3g}, "
                f"max sum|terms| {float(terms.max()):.3g}), skipped {int((~valid).sum())}, "
                f"support {share:.1%} of the patch, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            results.append({"case": name, "err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by})
            planes[label, dtype] = (g, starts, wy, wx, shape)
        g = planes[label, torch.bfloat16][0]
        spread = spread_starts(starts, wy.shape[-1], shape[1], shape[2], SEED + n)
        acc = torch.zeros(shape, device=dev)
        spread_ms = cuda_ms(lambda: roi_patch_backward(g, spread, wy, wx, shape, init=acc), reps=20)
        ms = results[-2]["ms"]
        log(f"roi_bwd    {label} bf16 contention: clustered on 12 objects {ms:.4f} ms, the same "
            f"ROIs spread over the plane {spread_ms:.4f} ms, clustered / spread {ms / spread_ms:.2f}")
    # Chained: the box set's gradient into a fresh plane, then the mask set's
    # added into it, in the order the fused pool's backward takes them.
    gb, sb, wyb, wxb, shape = planes["box B=2 N=512 S=7", torch.bfloat16]
    gm, sm, wym, wxm, _ = planes["mask B=2 N=128 S=14", torch.bfloat16]
    got = roi_patch_backward(gm, sm, wym, wxm, shape, init=roi_patch_backward(gb, sb, wyb, wxb, shape))
    want = roi_patch_backward_reference(gm, sm, wym, wxm, shape,
                                        init=roi_patch_backward_reference(gb, sb, wyb, wxb, shape))
    terms = roi_patch_backward_reference(gm.abs(), sm, wym, wxm, shape,
                                         init=roi_patch_backward_reference(gb.abs(), sb, wyb, wxb, shape))
    err = float((got - want).abs().max())
    if not float(((got - want).abs() - ROI_BWD_TOL * terms).max()) <= 0:
        raise AssertionError("roi_patch_bwd chained box -> mask: error exceeds the bound")
    log(f"roi_bwd    chained box -> mask through init (bf16): max|err| {err:.3g}")
    results.append({"case": "chained", "err": err})
    return results


def tail_inputs(rng, dev, dtype, b, h, w, k, n):
    """A bottleneck tail's operands in the port's layouts: ``x`` ``[B, K, H,
    W]`` and ``shortcut`` channels_last, the weight ``[N, K, 1, 1]``, the
    folded FrozenBN affine float32 ``[N]``."""
    x = torch.from_numpy(np.maximum(rng.standard_normal((b, h, w, k)), 0).astype(np.float32))
    weight = torch.from_numpy((rng.standard_normal((n, k, 1, 1)) / np.sqrt(k)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.1, 0.5, n).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32))
    sc = torch.from_numpy(rng.standard_normal((b, h, w, n)).astype(np.float32))
    return (x.to(dev, dtype).permute(0, 3, 1, 2), weight.to(dev, dtype), scale.to(dev),
            shift.to(dev), sc.to(dev, dtype).permute(0, 3, 1, 2))


def tail_bytes(m: int, k: int, n: int, esize: int) -> int:
    """Bytes a tail must move: x, the weight and the shortcut in, the output
    out, each once, and scale and shift (float32)."""
    return (m * k + n * k + 2 * m * n) * esize + 2 * n * 4


def within_tolerance(got: torch.Tensor, want: torch.Tensor) -> bool:
    """bf16 ``got`` within one ulp of each value plus ``FUSED_TOL_F32`` of the largest."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp + FUSED_TOL_F32 * float(want.abs().max())).all())


def unfused_tail(x, weight, scale, shift, sc):
    """The port's unfused tail (``Conv2d`` with FrozenBN, then add and ReLU):
    cuDNN's 1x1 conv, the affine in the activation dtype, the add, the ReLU."""
    view = (1, -1, 1, 1)
    y = torch.nn.functional.conv2d(x, weight)
    y = y * scale.to(y.dtype).view(view) + shift.to(y.dtype).view(view)
    return torch.relu(y + sc)


def check_fused(rng, dev):
    """``fused_residual`` against its plain version at R50's four tail shapes
    (800 x 1344, bf16) at batch 2 and 8, where each must take the Hopper
    (``wgmma``) path, at a ragged shape (M = 63 rows, K = 8, N = 32) in bf16
    and float32, and at res4's shape in float32; timed beside the plain
    version, the bound and the port's unfused tail. Then the host cost of a
    call on each bf16 path (the Hopper path encodes four TMA maps a call)."""
    cases = [(f"{st} b{b} M={b * h * w} K={k} N={n}", torch.bfloat16, (b, h, w, k, n))
             for b in (2, 8) for st, k, n, h, w in R50_TAILS]
    cases += [("ragged M=63 K=8 N=32", torch.bfloat16, (1, 7, 9, 8, 32)),
              ("ragged M=63 K=8 N=32", torch.float32, (1, 7, 9, 8, 32)),
              ("res4 M=8400 K=256 N=1024", torch.float32, (2, 50, 84, 256, 1024))]
    results = []
    for label, dtype, (b, h, w, k, n) in cases:
        args = tail_inputs(rng, dev, dtype, b, h, w, k, n)
        before = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"]
        got = fused_conv1x1_bn_add_relu(*args)
        if label.startswith("res") and dtype == torch.bfloat16 and (
                fused_conv1x1_bn_add_relu.launches_by_path["wgmma"] != before + 1):
            raise AssertionError(f"fused_residual {label}: did not take the wgmma path")
        want = fused_conv1x1_bn_add_relu_reference(*args)
        torch.cuda.synchronize()
        if got.shape != (b, n, h, w) or not got.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError(f"fused_residual {label}: output {tuple(got.shape)} not "
                                 "channels_last [B, N, H, W]")
        gotf, wantf = got.float(), want.float()
        err = (gotf - wantf).abs()
        if dtype == torch.float32:
            ok = float(err.max()) <= FUSED_TOL_F32 * float(wantf.abs().max())
        else:
            ok = within_tolerance(got, want)
        name = f"{label} {str(dtype).replace('torch.', '')}"
        if not ok:
            raise AssertionError(f"fused_residual {name}: max |err| {float(err.max())} beyond "
                                 "the tolerance")
        ms = cuda_ms(lambda: fused_conv1x1_bn_add_relu(*args), reps=20)
        plain_ms = cuda_ms(lambda: fused_conv1x1_bn_add_relu_reference(*args), reps=3, warmup=1)
        library_ms = cuda_ms(lambda: unfused_tail(*args), reps=20)
        m, esize = b * h * w, got.element_size()
        bound_ms, bound_by = bound(tail_bytes(m, k, n, esize), 2.0 * m * n * k, dtype)
        log(f"fused_res  {name}: max|err| {float(err.max()):.3g} (max|out| "
            f"{float(wantf.abs().max()):.3g}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"unfused tail {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.0%} of bound")
        results.append({"case": name, "err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by})
    log(f"fused_res  host cost per call at res4 b2 (host clock, 200 calls): "
        f"{host_cost_us(rng, dev)}")
    return results


def host_cost_us(rng, dev) -> str:
    """Host microseconds per wrapper call at res4's batch-2 shape on the
    ``wgmma`` path and on the ``mma`` path (x at a 2-byte storage offset):
    the difference is mostly the four TMA maps the Hopper path encodes."""
    _, k, n, h, w = R50_TAILS[2]
    args = tail_inputs(rng, dev, torch.bfloat16, 2, h, w, k, n)
    buf = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = buf[1:].view(2, h, w, k).permute(0, 3, 1, 2)
    shifted.copy_(args[0])
    per_path = {}
    for path, xs in (("wgmma", args[0]), ("mma", shifted)):
        before = fused_conv1x1_bn_add_relu.launches_by_path[path]
        for _ in range(20):
            fused_conv1x1_bn_add_relu(xs, *args[1:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fused_conv1x1_bn_add_relu(xs, *args[1:])
        per_path[path] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        if fused_conv1x1_bn_add_relu.launches_by_path[path] != before + 220:
            raise AssertionError(f"host cost: the {path} case took another path")
    return (f"wgmma {per_path['wgmma']:.1f} us, mma {per_path['mma']:.1f} us, difference x "
            f"{FUSED_TAILS} tails {(per_path['wgmma'] - per_path['mma']) * FUSED_TAILS / 1e3:.3f} "
            "ms per predict")


def check_variants(dev):
    """The ROI forward's seven ablations at the ROI tool's shapes with 2
    images (its seeded inputs), each against its plain version: the ones
    that only move values equal, the others within the ROI tolerances;
    ``full`` bit-equal to the production kernel ``roi_patch_interpolate``."""
    plane, starts, wy, wx = exp_roi_variants.make_inputs(
        2, dev, torch.Generator(device=dev).manual_seed(SEED))
    errs = {}
    for variant in exp_roi_variants.VARIANTS:
        got = roi_patch_variant(plane, starts, wy, wx, variant)
        want = roi_patch_variant_reference(plane, starts, wy, wx, variant)
        torch.cuda.synchronize()
        errs[variant] = float((got.float() - want.float()).abs().max())
        tol = 0.0 if variant in ("nodma", "onedma", "nodot") else (
            ROI_TOL_BF16_REL * max(1.0, float(want.float().abs().max())))
        if not errs[variant] <= tol:
            raise AssertionError(f"roi variant {variant}: max |err| {errs[variant]} > {tol}")
        if variant == "full" and not torch.equal(got, roi_patch_interpolate(plane, starts, wy, wx)):
            raise AssertionError("roi variant full differs from roi_patch_interpolate")
    plain_ms = cuda_ms(lambda: roi_patch_variant_reference(plane, starts, wy, wx, "full"),
                       reps=3, warmup=1)
    bound_ms, bound_by = roi_bound(plane.shape, plane.dtype, starts, wy, wx, backward=False)
    log("variants   2 images x 1000 ROIs, P=32 C=256 S=14 bf16, max|err| against plain: "
        + ", ".join(f"{v} {e:.3g}" for v, e in errs.items())
        + f"; full bit-equal to roi_patch_interpolate; plain full {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"err": max(errs.values()), "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def run_variants_tool():
    """The variants tool's entry point at 2 images (the same seeded inputs
    as ``check_variants``), launch counts read around it."""
    zero_launches()
    times = exp_roi_variants.main(["2"])
    launches = read_launches()
    if launches["roi_patch_variants"] == 0:
        raise AssertionError("the variants tool never launched roi_patch_variants")
    return times, launches["roi_patch_variants"]


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


def check_small_against_cpu(rng, dev, fused: bool):
    """Narrow float32 model on a 2 x 128 x 160 input: the card's output
    (kernels) against the CPU's (plain versions), same weights, with the
    fused tail switched off or on for both."""
    cfg = narrow_cfg()
    with fused_switch(fused):
        cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
        gpu_model = build_model(cfg, device=dev, state_dict=cpu_model.state_dict())
    if fused_tails(gpu_model) != (FUSED_TAILS if fused else 0):
        raise AssertionError(f"narrow model built with {fused_tails(gpu_model)} fused tails")
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
    log(f"model      small f32 input, fused tail {'on' if fused else 'off'}, card vs CPU: "
        f"valid={int(want.is_valid.sum())} slots equal, classes equal, max|err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def check_outputs(cfg, out, batch, b, h, w, label):
    f = out.get_fields()
    for k in ("boxes", "scores", "pred_masks"):
        if not bool(torch.isfinite(f[k]).all()):
            raise AssertionError(f"{label}: non-finite {k}")
    if tuple(f["boxes"].shape) != (b, 100, 4) or tuple(f["pred_masks"].shape) != (b, 100, 28, 28):
        raise AssertionError(f"{label}: unexpected shapes {out}")
    per_image = f["is_valid"].sum(1).tolist()
    if per_image != [100] * b:
        raise AssertionError(f"{label}: valid detections per image {per_image}, expected 100")
    m = f["pred_masks"]
    if not (float(m.min()) >= 0.0 and float(m.max()) <= 1.0):
        raise AssertionError(f"{label}: mask probabilities outside [0, 1]")
    bx = f["boxes"]
    if bool((bx[..., 2] > 1333).any()) or bool((bx[..., 3] > 800).any()):
        raise AssertionError(f"{label}: boxes not clipped to the image size")
    pasted = detector_postprocess(cfg, out, batch).pred_masks
    if tuple(pasted.shape) != (b, 100, h, w) or pasted.dtype != torch.uint8:
        raise AssertionError(f"{label}: postprocess gave {tuple(pasted.shape)} {pasted.dtype}")
    log(f"model      {label}: outputs finite, 100 valid detections per image, scores in "
        f"[{float(f['scores'].min()):.4f}, {float(f['scores'].max()):.4f}], "
        f"{len(set(f['pred_classes'].flatten().tolist()))} classes, pasted masks "
        f"{tuple(pasted.shape)} with {int(pasted.sum())} pixels set")


# Timing turns of the switch: off, on, on, off, twice.
TURNS = (False, True, True, False) * 2


def run_model(rng, dev):
    """Serve with the fused tail off and on, in turns; returns the serving
    run's launch counts and the median img/s of each setting."""
    cfg = get_cfg()
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    models = {}
    for fused in (False, True):
        t0 = time.perf_counter()
        with fused_switch(fused):  # read when the model is built
            models[fused] = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
        if next(models[fused].parameters()).device.type != "cuda":
            raise AssertionError("build_model(cfg) did not build on the card")
        if fused_tails(models[fused]) != (FUSED_TAILS if fused else 0):
            raise AssertionError(f"model built with {fused_tails(models[fused])} fused tails")
        log(f"model      built Mask R-CNN R50-FPN bf16, fused tail {'on' if fused else 'off'}, "
            f"in {time.perf_counter() - t0:.2f} s")
    b, h, w = 2, 800, 1344
    image = torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)).to(dev)
    batch = {"image": image,
             "image_size": torch.tensor([[800, 1333]] * b, dtype=torch.int32, device=dev)}
    for model in models.values():
        for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
            model.predict(batch)
    torch.cuda.synchronize()

    # Host-bound at batch 2, so one short window is noisy: each setting's
    # median over its windows of five synchronized runs, in turns.
    iters = 5
    rates = {False: [], True: []}
    outs = {}
    zero_launches()
    for fused in TURNS:
        before = fused_conv1x1_bn_add_relu.launches
        before_wgmma = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"]
        t0 = time.perf_counter()
        for _ in range(iters):
            outs[fused] = models[fused].predict(batch)
        torch.cuda.synchronize()
        rates[fused].append(b * iters / (time.perf_counter() - t0))
        tails = fused_conv1x1_bn_add_relu.launches - before
        hopper = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"] - before_wgmma
        if tails != (FUSED_TAILS * iters if fused else 0) or hopper != tails:
            raise AssertionError(f"{tails} fused tails ({hopper} on the wgmma path) in "
                                 f"{iters} predicts with the switch {'on' if fused else 'off'}")
    launches = read_launches()
    img_s = {fused: float(np.median(r)) for fused, r in rates.items()}
    log(f"model      predict in turns {''.join('N' if f else 'F' for f in TURNS)} (F off, N on), "
        f"{iters} runs each, batch {b} at {h}x{w}: fused tail off {img_s[False]:.2f} img/s "
        f"median (windows {', '.join(f'{r:.2f}' for r in rates[False])}), on "
        f"{img_s[True]:.2f} img/s (windows {', '.join(f'{r:.2f}' for r in rates[True])}); "
        f"launches {launches}, {FUSED_TAILS} fused tails per predict with the switch on, all "
        f"on the wgmma path ({fused_conv1x1_bn_add_relu.launches_by_path})")
    for name in ("nms_keep", "roi_patch_fwd", "fused_residual"):
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    if launches["nms_keep"] != NMS_PER_PREDICT * len(TURNS) * iters:
        raise AssertionError(f"{launches['nms_keep']} nms_keep launches in {len(TURNS) * iters} "
                             f"predicts, expected {NMS_PER_PREDICT} per predict")
    for fused, out in outs.items():
        check_outputs(cfg, out, batch, b, h, w, f"fused tail {'on' if fused else 'off'}")
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


def check_train_against_cpu(dev, fused: bool):
    """Narrow float32 train step on a 2 x 128 x 160 batch: losses and
    gradients on the card (kernels) against the CPU (plain versions), from
    the same weights, sampler noise and proposals, with the fused tail
    switched off or on for both."""
    cfg = narrow_train_cfg()
    with fused_switch(fused):
        cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED),
                                training=True)
        gpu_model = build_model(cfg, device=dev, state_dict=cpu_model.state_dict(),
                                training=True)
    if fused_tails(gpu_model) != (FUSED_TAILS if fused else 0):
        raise AssertionError(f"narrow train model built with {fused_tails(gpu_model)} fused tails")
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
    log(f"train      narrow f32 step, fused tail {'on' if fused else 'off'}, card vs CPU: "
        "losses " + ", ".join(
        f"{k} {got_l[k]:.6f}/{v:.6f}" for k, v in want_l.items())
        + f"; {len(want_g)} gradients, worst max|err| / max|grad| {worst[0]:.3g} ({worst[1]}),"
          f" worst |err| / |grad| {worst_norm[0]:.3g} ({worst_norm[1]})")


def run_train(dev):
    """Train with the fused tail off and on, in turns; returns the timed
    steps' launch counts and the median img/s of each setting."""
    cfg = train_cfg(8)
    b, h, w = 8, 800, 1344
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(cfg, h, w).items()}
    runs = {}
    for fused in (False, True):
        t0 = time.perf_counter()
        with fused_switch(fused):  # read when the model is built
            model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED),
                                training=True)
        if fused_tails(model) != (FUSED_TAILS if fused else 0):
            raise AssertionError(f"train model built with {fused_tails(model)} fused tails")
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(SEED))
        step = build_train_step(cfg, state)
        log(f"train      built Mask R-CNN R50-FPN train state (bf16, float32 params), fused tail "
            f"{'on' if fused else 'off'}, in {time.perf_counter() - t0:.2f} s")
        metrics = [step(batch) for _ in range(2)]  # warm-up: cuDNN algorithms, allocator
        runs[fused] = (model, start, step, metrics)
    torch.cuda.synchronize()

    iters = 3
    rates = {False: [], True: []}
    zero_launches()
    for fused in TURNS:
        _, _, step, metrics = runs[fused]
        before = fused_conv1x1_bn_add_relu.launches
        before_wgmma = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"]
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics.append(step(batch))
        torch.cuda.synchronize()
        rates[fused].append(b * iters / (time.perf_counter() - t0))
        tails = fused_conv1x1_bn_add_relu.launches - before
        hopper = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"] - before_wgmma
        if tails != (FUSED_TAILS * iters if fused else 0) or hopper != tails:
            raise AssertionError(f"{tails} fused tails ({hopper} on the wgmma path) in "
                                 f"{iters} steps with the switch {'on' if fused else 'off'}")
    launches = read_launches()
    img_s = {fused: float(np.median(r)) for fused, r in rates.items()}
    log(f"train      steps in turns {''.join('N' if f else 'F' for f in TURNS)} (F off, N on), "
        f"{iters} each, batch {b} at {h}x{w}: fused tail off {img_s[False]:.2f} img/s median "
        f"(windows {', '.join(f'{r:.2f}' for r in rates[False])}), on {img_s[True]:.2f} img/s "
        f"(windows {', '.join(f'{r:.2f}' for r in rates[True])}); launches {launches}, "
        f"{FUSED_TAILS} fused tails per step with the switch on, all on the wgmma path "
        f"({fused_conv1x1_bn_add_relu.launches_by_path}); peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    for name in ("nms_keep", "roi_patch_fwd", "roi_patch_bwd", "fused_residual"):
        if launches[name] == 0:
            raise AssertionError(f"the train step never launched {name}")
    if launches["nms_keep"] != NMS_PER_STEP * len(TURNS) * iters:
        raise AssertionError(f"{launches['nms_keep']} nms_keep launches in {len(TURNS) * iters} "
                             f"steps, expected {NMS_PER_STEP} per step")

    for fused, (model, start, _, metrics) in runs.items():
        label = f"fused tail {'on' if fused else 'off'}"
        values = [{k: float(v) for k, v in m.items()} for m in metrics]
        if not all(np.isfinite(v) for m in values for v in m.values()):
            raise AssertionError(f"{label}: non-finite losses: {values}")
        trainable = trainable_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
        frozen = [n for n, _ in model.named_parameters() if n not in trainable]
        if not frozen or any(not n.startswith(FROZEN) for n in frozen):
            raise AssertionError(f"{label}: unexpected frozen parameters {frozen}")
        params = dict(model.named_parameters())
        changed_frozen = [n for n in frozen if not torch.equal(params[n], start[n])]
        unchanged = [n for n, p in trainable.items() if torch.equal(p.detach(), start[n])]
        if changed_frozen or unchanged:
            raise AssertionError(f"{label}: frozen parameters changed: {changed_frozen}; "
                                 f"trainable parameters unchanged: {unchanged}")
        log(f"train      {label}: losses finite over {len(values)} steps; first "
            + ", ".join(f"{k} {v:.4f}" for k, v in values[0].items())
            + f"; last total_loss {values[-1]['total_loss']:.4f}; {len(frozen)} frozen "
              f"parameters bit-equal, all {len(trainable)} trainable parameters changed")
    return launches, img_s


def kernel_line(name, src, replaces, launches, result, err):
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": float(err), "ms": result["ms"],
            "plain_ms": result["plain_ms"], "bound_ms": result["bound_ms"],
            "bound_by": result["bound_by"], "library_ms": result.get("library_ms")}


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
    fused = check_fused(rng, dev)
    variants = check_variants(dev)
    variant_times, variant_launches = run_variants_tool()
    variants["ms"] = variant_times["full"]
    for on in (False, True):
        check_small_against_cpu(rng, dev, on)
    launches, _ = run_model(rng, dev)
    for on in (False, True):
        check_train_against_cpu(dev, on)
    train_launches, _ = run_train(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"kernels": [  # nms_keep at the RPN's stacked levels, the main path's input
        kernel_line("nms_keep", NMS_SRC, tpu_kernel("*/ops/pallas/nms_keep.py", 161),
                    launches["nms_keep"], nms[1], max(r["err"] for r in nms)),
        kernel_line("roi_patch_fwd", ROI_SRC, tpu_kernel("*/ops/pallas/roi_patch.py", 667),
                    launches["roi_patch_fwd"], roi[0], max(r["err"] for r in roi)),
        kernel_line("roi_patch_bwd", ROI_SRC, tpu_kernel("*/ops/pallas/roi_patch.py", 440),
                    train_launches["roi_patch_bwd"], bwd[0], max(r["err"] for r in bwd)),
        kernel_line("fused_residual", FUSED_SRC, tpu_kernel("*/ops/pallas/fused_residual.py", 118),
                    launches["fused_residual"], fused[0], max(r["err"] for r in fused)),
        kernel_line("roi_patch_variants", ROI_SRC, tpu_kernel("tools/exp_roi_variants.py", 27),
                    variant_launches, variants, variants["err"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
