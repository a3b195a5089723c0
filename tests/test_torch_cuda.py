"""Edge cases of the CUDA kernels (NMS keep, ROI patch forward and
backward, the ROI forward's ablation variants, the fused bottleneck tail)
against their plain PyTorch versions, on the card. Marked ``cuda``: they
skip where there is no CUDA device. On a GPU machine (which has no JAX, so
the repo's conftest cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Keep masks must be equal; ROI outputs within the tolerances of
``chip_smoke.py`` (float32 1e-4 absolute on O(1) features, bf16 one ulp of
the output's maximum), skipped slots exact zeros; ROI backward planes within
1e-5 of each cell's sum of term magnitudes (float32 sums in other orders,
atomics across ROIs), skipped slots adding nothing. Ablations that only move
values are equal to their plain versions, the others within the ROI
tolerances. The fused tail: float32 within 1e-5 of the largest value, bf16
within one bf16 ulp of each value plus that (float32 sums in other orders,
one rounding on each side).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from detectron2_tensorflow_tpu_torch import bench_cfg, train_cfg
from detectron2_tensorflow_tpu_torch.models import poolers
from detectron2_tensorflow_tpu_torch.models.rpn import RPN
from detectron2_tensorflow_tpu_torch.ops import fused_residual as fr
from detectron2_tensorflow_tpu_torch.ops.nms import (
    MAX_N,
    PAD_BOX,
    greedy_keep,
    greedy_keep_reference,
    nms_fixed,
    nms_fixed_levels,
)
from detectron2_tensorflow_tpu_torch.tools import exp_roi_variants as tv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _boxes(rng, b, n, size=300.0):
    ctr = rng.uniform(0, size, (b, n, 2))
    wh = rng.uniform(1, 90, (b, n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


# (rows, N): every N at 1, 10 and 40 rows while the plain version's [R, N, N]
# IoU temporaries stay a few GB (4097 up to 10 rows, 16384 at 1).
NMS_SHAPES = [(r, n) for n in (1, 63, 64, 65, 819, 1000, 2000) for r in (1, 10, 40)] + [
    (1, 4097), (10, 4097), (1, 16384)]


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("mk", [None, 5, 64, 100, 1000])
@pytest.mark.parametrize("b,n", NMS_SHAPES)
def test_nms_keep_kernel_equals_plain(dev, b, n, mk, thr):
    rng = np.random.default_rng(n + b)
    boxes = torch.from_numpy(_boxes(rng, b, n)).to(dev)
    valid = torch.from_numpy(rng.uniform(0, 1, (b, n)) > 0.1).to(dev)
    got = greedy_keep(boxes, valid, thr, max_keep=mk)
    want = greedy_keep_reference(boxes, valid, thr, max_keep=mk)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("b,n,mk", [(10, 1000, None), (40, 2000, 1000), (3, 130, 5)])
def test_nms_keep_kernel_rows_with_other_valid_counts(dev, b, n, mk):
    """Rows of one call end their valid boxes at other places, as the RPN's
    stacked levels do (p6's 819 rows padded to N with the far-away box)."""
    rng = np.random.default_rng(b * n)
    boxes = _boxes(rng, b, n)
    valid = rng.uniform(0, 1, (b, n)) > 0.05
    ends = rng.integers(0, n + 1, b)
    ends[0], ends[-1] = n, min(819, n)
    for r, e in enumerate(ends):
        boxes[r, e:] = PAD_BOX
        valid[r, e:] = False
    boxes, valid = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    want = greedy_keep_reference(boxes, valid, 0.7, max_keep=mk)
    assert torch.equal(greedy_keep(boxes, valid, 0.7, max_keep=mk).cpu(), want.cpu())


@pytest.mark.parametrize("n", [1, 64, 65, 130, 1000])
def test_nms_keep_kernel_degenerate_inputs(dev, n):
    """All boxes identical (only the first kept), every row invalid (none),
    zero-area boxes (never overlap: all kept, up to max_keep)."""
    ones = torch.ones(3, n, dtype=torch.bool, device=dev)
    same = torch.tensor([10.0, 10.0, 50.0, 50.0], device=dev).repeat(3, n, 1)
    keep = greedy_keep(same, ones, 0.5)
    assert keep.cpu().tolist() == [[True] + [False] * (n - 1)] * 3
    assert not greedy_keep(same, torch.zeros_like(ones), 0.5).any()
    flat = torch.zeros(3, n, 4, device=dev)
    assert greedy_keep(flat, ones, 0.5).all()
    assert greedy_keep(flat, ones, 0.5, max_keep=5).sum(1).tolist() == [min(5, n)] * 3


def test_nms_keep_kernel_counts_launches_and_checks_inputs(dev):
    boxes = torch.zeros(2, 10, 4, device=dev)
    valid = torch.ones(2, 10, dtype=torch.bool, device=dev)
    before = greedy_keep.launches
    greedy_keep(boxes, valid, 0.5)
    assert greedy_keep.launches == before + 1
    big = MAX_N + 1
    misaligned = torch.zeros(2 * 10 * 4 + 1, device=dev)[1:].view(2, 10, 4)
    bad = [(boxes.double(), valid), (boxes, valid.int()), (misaligned, valid),
           (torch.zeros(1, big, 4, device=dev), torch.ones(1, big, dtype=torch.bool, device=dev))]
    for bad_boxes, bad_valid in bad:  # rejected before any launch, and not counted
        with pytest.raises(ValueError):
            greedy_keep(bad_boxes, bad_valid, 0.5)
        assert greedy_keep.launches == before + 1


def _rpn_inputs(rng, dev, b):
    """Objectness logits and deltas of R50-FPN's RPN head at 800x1344 (p2-p6,
    3 anchors), random."""
    shapes = [(200, 336), (100, 168), (50, 84), (25, 42), (13, 21)]
    logits = [torch.from_numpy(rng.normal(0, 2, (b, h, w, 3)).astype(np.float32)).to(dev)
              for h, w in shapes]
    deltas = [torch.from_numpy(rng.normal(0, 0.3, (b, h, w, 12)).astype(np.float32)).to(dev)
              for h, w in shapes]
    return logits, deltas, torch.tensor([[800, 1333]] * b, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("training", [False, True])
def test_rpn_proposals_launch_nms_keep_once(dev, training):
    """One RPN ``proposals`` call on the card (serving and training budgets)
    launches the keep mask once for its five levels, and the stacked levels'
    NMS equals the per-level loop."""
    cfg = train_cfg(2) if training else bench_cfg()
    rpn = RPN(cfg, [4, 8, 16, 32, 64], 16).to(dev)
    logits, deltas, sizes = _rpn_inputs(np.random.default_rng(int(training)), dev, 2)
    before = greedy_keep.launches
    props = rpn.proposals(logits, deltas, sizes, training=training)
    assert greedy_keep.launches == before + 1
    assert 0 < int(props.is_valid.sum()) <= props.is_valid.numel()
    # The stacked levels against the per-level loop, on the card.
    pre_k, post_k = rpn.pre_nms_topk[training], rpn.post_nms_topk[training]
    levels = []
    for logit in logits:
        k = min(pre_k, logit[0].numel())
        scores = torch.sort(logit.reshape(2, -1), dim=1, descending=True, stable=True)[0][:, :k]
        boxes = torch.from_numpy(_boxes(np.random.default_rng(k), 2, k)).to(dev)
        levels.append((boxes, scores.contiguous(), scores > -1.0))
    stacked = nms_fixed_levels(levels, rpn.nms_thresh, post_k)
    for (boxes, scores, valid), got in zip(levels, stacked):
        want = nms_fixed(boxes, scores, rpn.nms_thresh, min(post_k, boxes.shape[1]),
                         valid=valid, presorted=True)
        for g, w in zip(got, (want[0], want[1], want[3])):
            assert torch.equal(g, w)


def _roi_case(rng, dev, dtype, b, n, s, p, c):
    htot, wm = 3 * p, 2 * p
    plane = torch.from_numpy(rng.standard_normal((b, htot, wm, c)).astype(np.float32)).to(dev, dtype)
    rows = rng.integers(0, htot - p + 1, (b, n))
    tx = rng.integers(0, (wm - p) // 8 + 1, (b, n)) * 8
    cls = np.where(rng.uniform(0, 1, (b, n)) < 0.2, poolers.skip_tier_class(p), 0)
    starts = torch.from_numpy(np.stack([rows, tx, cls], -1).astype(np.int32)).to(dev)
    wy = torch.from_numpy(rng.uniform(0, 0.3, (b, n, s, p)).astype(np.float32)).to(dev)
    wx = torch.from_numpy(rng.uniform(0, 0.3, (b, n, s, p)).astype(np.float32)).to(dev)
    return plane, starts, wy, wx, torch.from_numpy(cls > 0).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,s,p,c", [(1, 1, 7, 32, 256), (2, 13, 7, 16, 40),
                                       (3, 9, 14, 32, 16), (1, 5, 14, 64, 33)])
def test_roi_patch_kernel_equals_plain(dev, dtype, b, n, s, p, c):
    rng = np.random.default_rng(n * s + c)
    plane, starts, wy, wx, skip = _roi_case(rng, dev, dtype, b, n, s, p, c)
    got = poolers.roi_patch_interpolate(plane, starts, wy, wx)
    want = poolers.roi_patch_interpolate_reference(plane, starts, wy, wx)
    assert got.shape == (b, n, s, s, c) and got.dtype == dtype
    assert bool((got[skip] == 0).all())
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2.0 ** -7 * max(1.0, scale)
    assert err <= tol


def test_roi_patch_kernel_counts_launches_and_checks_inputs(dev):
    rng = np.random.default_rng(0)
    plane, starts, wy, wx, _ = _roi_case(rng, dev, torch.float32, 1, 4, 7, 32, 16)
    before = poolers.roi_patch_interpolate.launches
    poolers.roi_patch_interpolate(plane, starts, wy, wx)
    assert poolers.roi_patch_interpolate.launches == before + 1
    with pytest.raises(ValueError):
        poolers.roi_patch_interpolate(plane.half(), starts, wy, wx)
    with pytest.raises(ValueError):
        poolers.roi_patch_interpolate(plane, starts.long(), wy, wx)
    with pytest.raises(ValueError):
        poolers.roi_patch_interpolate(plane, starts, wy[:, :, :5], wx)  # S mismatch
    with pytest.raises(ValueError):
        poolers.roi_patch_interpolate(plane, starts, wy.transpose(2, 3), wx)


def _bwd_case(rng, dev, dtype, b, n, s, p, c):
    plane, starts, wy, wx, skip = _roi_case(rng, dev, torch.float32, b, n, s, p, c)
    g = torch.from_numpy(rng.standard_normal((b, n, s, s, c)).astype(np.float32)).to(dev, dtype)
    return tuple(plane.shape), starts, wy, wx, skip, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,s,p,c", [(1, 1, 7, 32, 256), (2, 13, 7, 16, 40),
                                       (3, 9, 14, 32, 16), (1, 5, 14, 64, 33),
                                       (2, 200, 7, 32, 64)])
def test_roi_patch_backward_kernel_equals_plain(dev, dtype, b, n, s, p, c):
    rng = np.random.default_rng(n * s + c + 1)
    shape, starts, wy, wx, skip, g = _bwd_case(rng, dev, dtype, b, n, s, p, c)
    got = poolers.roi_patch_backward(g, starts, wy, wx, shape)
    want = poolers.roi_patch_backward_reference(g, starts, wy, wx, shape)
    bound = poolers.roi_patch_backward_reference(g.abs(), starts, wy, wx, shape)
    assert got.shape == shape and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-5 * bound).all())
    only_skipped = torch.where(skip[..., None, None, None], g, torch.zeros_like(g))
    assert not bool(poolers.roi_patch_backward(only_skipped, starts, wy, wx, shape).any())


def test_roi_patch_backward_kernel_accumulates_into_init(dev):
    rng = np.random.default_rng(1)
    shape, starts, wy, wx, _, g = _bwd_case(rng, dev, torch.bfloat16, 2, 20, 7, 32, 32)
    init = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    want = poolers.roi_patch_backward_reference(g, starts, wy, wx, shape, init=init.clone())
    got = poolers.roi_patch_backward(g, starts, wy, wx, shape, init=init)
    assert got.data_ptr() == init.data_ptr()  # in place
    bound = init.abs() + poolers.roi_patch_backward_reference(g.abs(), starts, wy, wx, shape)
    assert bool(((got - want).abs() <= 1e-5 * bound + 1e-7).all())


def test_roi_patch_backward_kernel_counts_launches_and_checks_inputs(dev):
    rng = np.random.default_rng(0)
    shape, starts, wy, wx, _, g = _bwd_case(rng, dev, torch.float32, 1, 4, 7, 32, 16)
    before = poolers.roi_patch_backward.launches
    poolers.roi_patch_backward(g, starts, wy, wx, shape)
    assert poolers.roi_patch_backward.launches == before + 1
    with pytest.raises(ValueError):
        poolers.roi_patch_backward(g.half(), starts, wy, wx, shape)
    with pytest.raises(ValueError):
        poolers.roi_patch_backward(g, starts.long(), wy, wx, shape)
    with pytest.raises(ValueError):
        poolers.roi_patch_backward(g[..., :8], starts, wy, wx, shape)  # C mismatch
    with pytest.raises(ValueError):
        poolers.roi_patch_backward(g, starts, wy, wx, shape,
                                   init=torch.zeros(shape, dtype=torch.bfloat16, device=dev))


def test_pool_multi_backward_on_the_card_equals_the_cpu(dev):
    """The fused two-set pool's plane gradient (kernels) against the same
    op on the CPU (plain versions)."""
    rng = np.random.default_rng(3)
    shape, sb, wyb, wxb, _, gb = _bwd_case(rng, dev, torch.float32, 2, 30, 7, 32, 24)
    _, sm, wym, wxm, _, gm = _bwd_case(rng, dev, torch.float32, 2, 10, 14, 32, 24)
    outs = {}
    for where in ("cpu", dev):
        plane = torch.zeros(shape, device=where, requires_grad=True)
        specs = [t.to(where) for t in (sb, wyb, wxb, sm, wym, wxm)]
        box, mask = poolers.RoiPatchPoolMulti.apply(plane, *specs)
        (box * gb.to(where)).sum().add((mask * gm.to(where)).sum()).backward()
        outs[str(where)] = plane.grad.cpu()
    got, want = outs[str(dev)], outs["cpu"]
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


SUPPORT_CASES = ("far_edge", "one_row_col", "zero_area", "dense", "last_rows_cols", "random")
# (B, N, S, P, C): P = 16, 24, 32, 64; C a multiple of the forward's 32-channel
# tile and of the backward's 128 or not (33, 40); S at both sides of 8.
SUPPORT_SHAPES = [(2, 12, 7, 16, 33), (1, 10, 14, 24, 40), (2, 9, 8, 32, 256),
                  (1, 6, 16, 64, 40)]


def _support_case(rng, dev, dtype, b, n, s, p, c, case):
    """A plane ``[b, 3p, 2p, c]`` and a plan whose weights are nonzero only on
    each slot's window ``[y0, y1) x [x0, x1)`` of the patch (tier class 0, 15%
    of the slots skipped): ``far_edge`` windows end at the patch's last row
    and column; ``one_row_col`` are one row by one column; ``zero_area``
    has a third of the slots with all-zero weights, not skipped; ``dense``
    covers the whole patch; ``last_rows_cols`` puts far-edge windows of
    patches at the plane's last rows and columns; ``random`` windows are
    random. Returns the plane, the plan, the skip mask and the all-zero
    mask."""
    htot, wm = 3 * p, 2 * p
    plane = torch.from_numpy(rng.standard_normal((b, htot, wm, c)).astype(np.float32)).to(dev, dtype)
    if case == "last_rows_cols":
        rows, tx = np.full((b, n), htot - p), np.full((b, n), (wm - p) // 8 * 8)
    else:
        rows = rng.integers(0, htot - p + 1, (b, n))
        tx = rng.integers(0, (wm - p) // 8 + 1, (b, n)) * 8
    skip = rng.uniform(0, 1, (b, n)) < 0.15
    cls = np.where(skip, poolers.skip_tier_class(p), 0)
    starts = torch.from_numpy(np.stack([rows, tx, cls], -1).astype(np.int32)).to(dev)
    weights = []
    for _ in range(2):  # wy over rows, wx over columns
        if case == "dense":
            lo, hi = np.zeros((b, n), int), np.full((b, n), p)
        elif case in ("far_edge", "last_rows_cols"):
            lo, hi = rng.integers(1, p, (b, n)), np.full((b, n), p)
        elif case == "one_row_col":
            lo = rng.integers(0, p, (b, n))
            hi = lo + 1
        else:
            ends = np.sort(rng.integers(0, p, (b, n, 2)), -1)
            lo, hi = ends[..., 0], ends[..., 1] + 1
        pos = np.arange(p)
        inside = (pos >= lo[..., None]) & (pos < hi[..., None])
        w = rng.uniform(0.05, 0.3, (b, n, s, p)) * inside[:, :, None, :]
        weights.append(w)
    zero = rng.uniform(0, 1, (b, n)) < (1 / 3 if case == "zero_area" else 0)
    wy, wx = (torch.from_numpy(np.where(zero[..., None, None], 0, w).astype(np.float32)).to(dev)
              for w in weights)
    return plane, starts, wy, wx, torch.from_numpy(skip).to(dev), torch.from_numpy(zero).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,b,n,s,p,c", [
    (case, *shape) for case in SUPPORT_CASES for shape in SUPPORT_SHAPES] + [
    # enough ROIs that a block walks several channel tiles of its ROI (the
    # last one ragged at C = 72), over one or several row and column chunks
    ("random", 2, 1500, 7, 32, 72), ("dense", 2, 1200, 14, 64, 40),
    ("far_edge", 1, 3000, 7, 32, 256)])
def test_roi_patch_kernel_on_hat_supports_equals_plain(dev, dtype, case, b, n, s, p, c):
    """The forward narrows its loops to each slot's support, derived from the
    weights: at the patch's far edge, one row and one column, all-zero
    (exact zeros out), dense under tier class 0, at the plane's last rows and
    columns, for P = 16-64, C off the channel tile, and with several channel
    tiles per block."""
    rng = np.random.default_rng(SUPPORT_CASES.index(case) * 100 + n + p + c)
    plane, starts, wy, wx, skip, zero = _support_case(rng, dev, dtype, b, n, s, p, c, case)
    got = poolers.roi_patch_interpolate(plane, starts, wy, wx)
    want = poolers.roi_patch_interpolate_reference(plane, starts, wy, wx)
    assert got.shape == (b, n, s, s, c) and got.dtype == dtype
    assert bool((got[skip | zero] == 0).all())
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2.0 ** -7 * max(1.0, scale)
    assert err <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,s,p,c", SUPPORT_SHAPES)
@pytest.mark.parametrize("case", SUPPORT_CASES)
def test_roi_patch_backward_kernel_on_hat_supports_equals_plain(dev, dtype, case, b, n, s, p, c):
    """The backward over the same supports: each cell within 1e-5 of its sum
    of term magnitudes; all-zero and skipped slots add nothing."""
    rng = np.random.default_rng(SUPPORT_CASES.index(case) * 100 + p + c + 1)
    plane, starts, wy, wx, skip, zero = _support_case(rng, dev, torch.float32, b, n, s, p, c, case)
    shape = tuple(plane.shape)
    g = torch.from_numpy(rng.standard_normal((b, n, s, s, c)).astype(np.float32)).to(dev, dtype)
    got = poolers.roi_patch_backward(g, starts, wy, wx, shape)
    want = poolers.roi_patch_backward_reference(g, starts, wy, wx, shape)
    terms = poolers.roi_patch_backward_reference(g.abs(), starts, wy, wx, shape)
    assert bool(((got - want).abs() <= 1e-5 * terms).all())
    silent = torch.where((skip | zero)[..., None, None, None], g, torch.zeros_like(g))
    assert not bool(poolers.roi_patch_backward(silent, starts, wy, wx, shape).any())


@pytest.mark.parametrize("layout", ["one_window", "spread"])
def test_roi_patch_backward_kernel_contention_chained(dev, layout):
    """A box set (S=7) then a mask set (S=14) chained through ``init=``, with
    every ROI on one window of the plane (the worst contention for the
    atomics) or spread over it; each cell within 1e-5 of its sum of term
    magnitudes."""
    rng = np.random.default_rng(11 if layout == "spread" else 12)
    c, p = 256, 32
    plane, sb, wyb, wxb, _, _ = _support_case(rng, dev, torch.float32, 2, 300, 7, p, c, "random")
    _, sm, wym, wxm, _, _ = _support_case(rng, dev, torch.float32, 2, 80, 14, p, c, "random")
    shape = tuple(plane.shape)
    if layout == "one_window":
        for st in (sb, sm):
            st[..., 0], st[..., 1] = p, 8
    gb = torch.from_numpy(rng.standard_normal((2, 300, 7, 7, c)).astype(np.float32)).to(dev, torch.bfloat16)
    gm = torch.from_numpy(rng.standard_normal((2, 80, 14, 14, c)).astype(np.float32)).to(dev, torch.bfloat16)
    init = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    got = poolers.roi_patch_backward(gm, sm, wym, wxm, shape,
                                     init=poolers.roi_patch_backward(gb, sb, wyb, wxb, shape,
                                                                     init=init.clone()))
    want = poolers.roi_patch_backward_reference(
        gm, sm, wym, wxm, shape,
        init=poolers.roi_patch_backward_reference(gb, sb, wyb, wxb, shape, init=init.clone()))
    terms = init.abs() + poolers.roi_patch_backward_reference(
        gm.abs(), sm, wym, wxm, shape,
        init=poolers.roi_patch_backward_reference(gb.abs(), sb, wyb, wxb, shape))
    assert bool(((got - want).abs() <= 1e-5 * terms + 1e-7).all())


@pytest.mark.parametrize("n,c", [(10, 40), (1200, 72)])  # 1200: blocks of several tiles
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(tv.VARIANTS))
def test_roi_variant_kernel_equals_plain(dev, variant, dtype, n, c):
    rng = np.random.default_rng(len(variant) + n)
    plane, starts, wy, wx, skip = _roi_case(rng, dev, dtype, 2, n, 14, 32, c)
    got = tv.roi_patch_variant(plane, starts, wy, wx, variant)
    want = tv.roi_patch_variant_reference(plane, starts, wy, wx, variant)
    assert got.shape == want.shape == (2, n, 14, 14, c) and got.dtype == dtype
    assert bool((got[skip] == 0).all())
    if variant in ("nodma", "onedma", "nodot"):
        assert torch.equal(got, want)
    else:
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        assert err <= (1e-4 if dtype == torch.float32 else 2.0 ** -7) * max(1.0, scale)


def test_roi_variant_full_is_the_production_kernel(dev):
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.bfloat16):
        plane, starts, wy, wx, _ = _roi_case(rng, dev, dtype, 2, 9, 7, 32, 64)
        full = tv.roi_patch_variant(plane, starts, wy, wx, "full")
        assert torch.equal(full, poolers.roi_patch_interpolate(plane, starts, wy, wx))
        noswap = tv.roi_patch_variant(plane, starts, wy, wx, "noswap")
        assert torch.equal(noswap, full.transpose(2, 3))


def test_roi_variant_kernel_counts_launches_and_checks_inputs(dev):
    rng = np.random.default_rng(0)
    plane, starts, wy, wx, _ = _roi_case(rng, dev, torch.float32, 1, 4, 7, 32, 16)
    before = tv.roi_patch_variant.launches
    tv.roi_patch_variant(plane, starts, wy, wx, "nodma")
    assert tv.roi_patch_variant.launches == before + 1
    with pytest.raises(ValueError):
        tv.roi_patch_variant(plane, starts, wy, wx, "nothing")
    with pytest.raises(ValueError):
        tv.roi_patch_variant(plane.half(), starts, wy, wx, "full")
    with pytest.raises(ValueError):
        tv.roi_patch_variant(plane, starts.cpu(), wy, wx, "full")


def _tail_case(rng, dev, dtype, b, h, w, k, n):
    x = torch.from_numpy(rng.standard_normal((b, h, w, k)).astype(np.float32))
    weight = torch.from_numpy((rng.standard_normal((n, k, 1, 1)) / np.sqrt(k)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32))
    sc = torch.from_numpy(rng.standard_normal((b, h, w, n)).astype(np.float32))
    return (x.to(dev, dtype).permute(0, 3, 1, 2), weight.to(dev, dtype), scale.to(dev),
            shift.to(dev), sc.to(dev, dtype).permute(0, 3, 1, 2))


def _tail_errors(got, want):
    """|got - want|, 1e-5 of the largest value, and one bf16 ulp of each value."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    return (got - want).abs(), 1e-5 * float(want.abs().max()), torch.exp2(
        torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,k,n", [(2, 5, 7, 8, 32), (1, 3, 3, 64, 256), (2, 9, 11, 128, 512),
                                       (1, 1, 1, 16, 8), (3, 7, 5, 24, 40), (1, 4, 5, 12, 20),
                                       (1, 5, 5, 7, 13), (1, 41, 50, 256, 1024)])
def test_fused_residual_kernel_equals_plain(dev, dtype, b, h, w, k, n):
    rng = np.random.default_rng(k * n + h)
    args = _tail_case(rng, dev, dtype, b, h, w, k, n)
    got = fr.fused_conv1x1_bn_add_relu(*args)
    want = fr.fused_conv1x1_bn_add_relu_reference(*args)
    assert got.shape == (b, n, h, w) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    err, slack, ulp = _tail_errors(got, want)
    if dtype == torch.float32:
        assert float(err.max()) <= slack
    else:
        assert bool((err <= ulp + slack).all())
    assert bool((got >= 0).all())


def test_fused_residual_kernel_counts_launches_and_checks_inputs(dev):
    rng = np.random.default_rng(0)
    x, weight, scale, shift, sc = _tail_case(rng, dev, torch.bfloat16, 2, 4, 6, 16, 32)
    before = fr.fused_conv1x1_bn_add_relu.launches
    fr.fused_conv1x1_bn_add_relu(x, weight, scale, shift, sc)
    assert fr.fused_conv1x1_bn_add_relu.launches == before + 1
    bad = [
        (x.contiguous(), weight, scale, shift, sc),           # NCHW memory, not channels_last
        (x, weight, scale, shift, sc.contiguous()),
        (x.half(), weight.half(), scale, shift, sc.half()),   # dtype the kernel does not take
        (x, weight.float(), scale, shift, sc),                 # weight in another dtype
        (x, weight, scale.bfloat16(), shift, sc),              # scale not float32
        (x, weight, scale.cpu(), shift, sc),                   # another device
        (x, weight[:, :8].contiguous(), scale, shift, sc),     # K mismatch
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fr.fused_conv1x1_bn_add_relu(*args)


# R50's tails at 800 x 1344 by stage: (K, N, H, W).
R50_TAILS = {stage: shape for stage, *shape in chip_smoke.R50_TAILS}


def _hopper_case(dev, b, h, w, k, n, seed):
    """A bf16 tail that ``plan_tail`` sends to the ``wgmma`` kernel, run
    against the plain version; returns the plan and the launches by path."""
    args = _tail_case(np.random.default_rng(seed), dev, torch.bfloat16, b, h, w, k, n)
    plan = fr.plan_tail(b * h * w, k, n, torch.bfloat16, True,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan.path == "wgmma"
    before = dict(fr.fused_conv1x1_bn_add_relu.launches_by_path)
    got = fr.fused_conv1x1_bn_add_relu(*args)
    after = dict(fr.fused_conv1x1_bn_add_relu.launches_by_path)
    want = fr.fused_conv1x1_bn_add_relu_reference(*args)
    assert got.shape == (b, n, h, w) and got.is_contiguous(memory_format=torch.channels_last)
    err, slack, ulp = _tail_errors(got, want)
    assert bool((err <= ulp + slack).all()), float(err.max())
    return plan, {p: after[p] - before[p] for p in after}


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("stage", sorted(R50_TAILS))
def test_fused_residual_hopper_path_at_r50_shapes(dev, stage, batch):
    k, n, h, w = R50_TAILS[stage]
    plan, launched = _hopper_case(dev, batch, h, w, k, n, seed=k + batch)
    assert launched == {"ffma": 0, "mma": 0, "wgmma": 1}
    assert plan.rounds * plan.grid[0] >= plan.tiles


# (b, h, w, k, n): M not a multiple of the tile's 64 rows (221, 63, 2706,
# 2100, 2090, 1, 105, 966); tile counts that 132 does not divide (4, 2, 43,
# 266, 1, 16); K = 8, 16, 24 and 64, each one K stage or less; N = 8, 40
# and 200 ending inside a 64-column box or the 256-column tile.
HOPPER_EDGES = [(1, 13, 17, 8, 256), (1, 7, 9, 16, 512), (2, 33, 41, 64, 256),
                (1, 128, 133, 64, 256), (1, 30, 70, 64, 2048), (1, 19, 110, 512, 2048),
                (1, 1, 1, 16, 8), (3, 7, 5, 24, 40), (2, 21, 23, 128, 200),
                (1, 64, 66, 256, 1024)]


@pytest.mark.parametrize("b,h,w,k,n", HOPPER_EDGES)
def test_fused_residual_hopper_path_edges(dev, b, h, w, k, n):
    plan, launched = _hopper_case(dev, b, h, w, k, n, seed=b * h * w + n)
    assert launched["wgmma"] == 1
    assert plan.tiles == -(-b * h * w // 64) * -(-n // 256)


def test_fused_residual_launches_by_path(dev):
    """Each path counts its own launches; the total stays the sum."""
    rng = np.random.default_rng(3)
    cases = {"wgmma": _tail_case(rng, dev, torch.bfloat16, 1, 4, 6, 64, 256),
             "mma": _tail_case(rng, dev, torch.bfloat16, 1, 4, 6, 7, 256),
             "ffma": _tail_case(rng, dev, torch.float32, 1, 4, 6, 64, 256)}
    # An unaligned pointer: x at a 2-byte storage offset, still channels_last.
    x = cases["wgmma"][0]
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = buf[1:].view(1, 4, 6, 64).permute(0, 3, 1, 2)
    shifted.copy_(x)
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    assert not fr.operands_aligned(shifted)
    cases["unaligned"] = (shifted,) + cases["wgmma"][1:]
    for name, args in cases.items():
        path = "mma" if name == "unaligned" else name
        before = dict(fr.fused_conv1x1_bn_add_relu.launches_by_path)
        total = fr.fused_conv1x1_bn_add_relu.launches
        got = fr.fused_conv1x1_bn_add_relu(*args)
        after = fr.fused_conv1x1_bn_add_relu.launches_by_path
        assert {p: after[p] - before[p] for p in after} == {
            p: int(p == path) for p in after}, name
        assert fr.fused_conv1x1_bn_add_relu.launches == total + 1
        err, slack, ulp = _tail_errors(got, fr.fused_conv1x1_bn_add_relu_reference(*args))
        assert bool((err <= (slack if args[0].dtype == torch.float32 else ulp + slack)).all()), name


def test_fused_residual_gradients_on_the_card_bf16_hopper_path(dev):
    """The backward reads the ``wgmma`` kernel's ``out`` for its ReLU mask:
    the card's gradients (bf16, aligned) against the same hand-written
    backward computed in float32 from that ``out``. dx and dshortcut round
    once to bf16 (one ulp of each value plus 1e-5 of the largest); dW is a
    bf16 rounding of a float32 sum (one ulp plus 1e-3 of the largest, the
    products of bf16 g * scale summed in another order)."""
    rng = np.random.default_rng(4)
    x, weight, scale, shift, sc = _tail_case(rng, dev, torch.bfloat16, 2, 12, 10, 64, 256)
    x, weight, sc = (t.detach().requires_grad_(True) for t in (x, weight, sc))
    before = fr.fused_conv1x1_bn_add_relu.launches_by_path["wgmma"]
    out = fr.fused_conv1x1_bn_add_relu(x, weight, scale, shift, sc)
    assert fr.fused_conv1x1_bn_add_relu.launches_by_path["wgmma"] == before + 1
    dy = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)).to(dev, torch.bfloat16)
    out.backward(dy)
    g = dy.float() * (out.detach() > 0).float()
    gs = (g.to(torch.bfloat16) * scale.to(torch.bfloat16).view(1, -1, 1, 1)).float()
    gs2 = gs.permute(0, 2, 3, 1).reshape(-1, 256)
    want_dx = (gs2 @ weight.detach().reshape(256, 64).float()).reshape(2, 12, 10, 64).permute(0, 3, 1, 2)
    want_dw = (gs2.t() @ x.detach().permute(0, 2, 3, 1).reshape(-1, 64).float()).reshape(256, 64, 1, 1)
    for got, want, rel in ((x.grad, want_dx, 1e-5), (weight.grad, want_dw, 1e-3), (sc.grad, g, 1e-5)):
        assert got.dtype == torch.bfloat16
        err, _, ulp = _tail_errors(got, want)
        assert bool((err <= ulp + rel * float(want.abs().max())).all())
    assert bool((sc.grad == 0).any()) and bool((sc.grad != 0).any())


def test_fused_residual_gradients_on_the_card_equal_the_cpu(dev):
    rng = np.random.default_rng(1)
    args = _tail_case(rng, "cpu", torch.float32, 2, 6, 5, 32, 64)
    grads = {}
    for where in ("cpu", dev):
        x, weight, scale, shift, sc = (t.to(where) for t in args)
        if where != "cpu":
            x, sc = (t.contiguous(memory_format=torch.channels_last) for t in (x, sc))
        x, weight, sc = (t.detach().requires_grad_(True) for t in (x, weight, sc))
        out = fr.fused_conv1x1_bn_add_relu(x, weight, scale, shift, sc)
        (out * torch.cos(out)).sum().backward()
        grads[str(where)] = [t.grad.cpu() for t in (x, weight, sc)]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_nms_keep_kernel_one_level_2x6000_max_keep_2000(dev):
    """``rpn_R_50_C4_1x``'s serving shape: one RPN level of 6000 candidates
    per image for 2 images, keeping at most 2000; bit-equal to the plain
    version, as chip_smoke holds it."""
    rng = np.random.default_rng(11)
    boxes, valid = chip_smoke.clustered_boxes(rng, 2, 6000, objects=600)
    boxes, valid = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    want = chip_smoke.greedy_keep_reference_rows(boxes, valid, 0.7, 2000)
    got = greedy_keep(boxes, valid, 0.7, max_keep=2000)
    assert torch.equal(got.cpu(), want.cpu()) and int(got.sum(1).max()) <= 2000


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batch_norm_on_the_card_equals_the_cpu(dev, dtype, train):
    """The trainable BN layer on a channels_last card tensor against the CPU:
    outputs within one ulp of their dtype plus 1e-5 of the largest value,
    the running statistics it writes in training within 1e-6 relative."""
    from detectron2_tensorflow_tpu_torch.models.layers import BatchNorm2d

    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.standard_normal((4, 64, 17, 23)) * 3 + 1).astype(np.float32))
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, 64).astype(np.float32))
    outs, stats = {}, {}
    for where in ("cpu", dev):
        bn = BatchNorm2d(64)
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
            bn.running_var.fill_(1.5)
        bn.to(where).train(train)
        xin = x.to(where, dtype)
        if str(where) != "cpu":
            xin = xin.contiguous(memory_format=torch.channels_last)
        outs[str(where)] = bn(xin).float().cpu()
        stats[str(where)] = (bn.running_mean.cpu(), bn.running_var.cpu())
    got, want = outs[str(dev)], outs["cpu"]
    ulp = torch.finfo(dtype).eps * torch.maximum(got.abs(), want.abs())
    assert bool(((got - want).abs() <= ulp + 1e-5 * float(want.abs().max())).all())
    for g, w in zip(stats[str(dev)], stats["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_nms_keep_kernel_retinanet_class_offset_2x5000(dev):
    """RetinaNet's serving shape: 5 levels x 1000 candidates per image for 2
    images, shifted by ``class * (max coordinate + 1)`` over 80 classes (up
    to ~1.1e5), IoU 0.5, keeping at most 100; bit-equal to the plain
    version, as chip_smoke holds it."""
    rng = np.random.default_rng(12)
    boxes, valid = chip_smoke.clustered_boxes(rng, 2, 5000, objects=300)
    boxes = chip_smoke.class_offset(boxes, rng.integers(0, 80, (2, 5000)))
    assert boxes.max() > 1e5
    boxes, valid = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    want = chip_smoke.greedy_keep_reference_rows(boxes, valid, 0.5, 100)
    got = greedy_keep(boxes, valid, 0.5, max_keep=100)
    assert torch.equal(got.cpu(), want.cpu()) and int(got.sum(1).min()) == 100


def test_scale_gradient_and_focal_loss_on_the_card_equal_the_cpu(dev):
    """The cascade's ``scale_gradient`` in bf16 bit-equal to the CPU's (its
    value need not be its input's), and the focal loss and its gradient in
    float32 within 1e-6 relative."""
    from detectron2_tensorflow_tpu_torch.models.losses import sigmoid_focal_loss
    from detectron2_tensorflow_tpu_torch.models.roi_heads.cascade import scale_gradient

    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(0, 3, 65536).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(scale_gradient(x.to(dev), 1 / 3).cpu(), scale_gradient(x, 1 / 3))
    logits = torch.from_numpy(rng.normal(0, 3, 4096).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 2, 4096).astype(np.float32))
    out = {}
    for where in ("cpu", dev):
        z = logits.to(where).requires_grad_(True)
        loss = sigmoid_focal_loss(z, t.to(where))
        loss.sum().backward()
        out[str(where)] = (loss.detach().cpu(), z.grad.cpu())
    for g, w in zip(out[str(dev)], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_nms_keep_kernel_keypoint_train_rpn_max_keep_1500(dev):
    """Keypoint R-CNN's training RPN (``POST_NMS_TOPK_TRAIN`` 1500): 8 images
    x 4 levels of 2000 and p6's 819 padded, keeping at most 1500 a row;
    bit-equal to the plain version, as chip_smoke holds it."""
    rng = np.random.default_rng(14)
    boxes, valid = chip_smoke.stacked_levels(rng, 8, 2000)
    boxes, valid = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    want = greedy_keep_reference(boxes, valid, 0.7, 1500)
    got = greedy_keep(boxes, valid, 0.7, max_keep=1500)
    assert torch.equal(got.cpu(), want.cpu()) and int(got.sum(1).max()) <= 1500


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(2, 100), (8, 128)])
def test_roi_kernels_on_the_fixed_ratio_plan_equal_plain(dev, dtype, b, n):
    """The keypoint pooler's plan (sampling ratio 2, S = 14) on p2-p5 of
    800x1344 images: the forward within chip_smoke's ROI tolerances of its
    plain version (skipped slots exact zeros), the backward within 1e-5 of
    each cell's sum of term magnitudes. The kernels narrow each slot's
    window to its hat support; a fixed ratio leaves zero-weight rows
    between samples inside it, which they must still cover."""
    rng = np.random.default_rng(b * n)
    storage, starts, wy, wx, valid = chip_smoke.roi_inputs(rng, dev, dtype, n, 14, b=b, ratio=2)
    got = poolers.roi_patch_interpolate(storage, starts, wy, wx)
    want = poolers.roi_patch_interpolate_reference(storage, starts, wy, wx)
    assert bool((got[~valid] == 0).all())
    scale = float(want.float().abs().max())
    tol = (chip_smoke.ROI_TOL_F32 if dtype == torch.float32
           else chip_smoke.ROI_TOL_BF16_REL * max(1.0, scale))
    assert float((got.float() - want.float()).abs().max()) <= tol
    shape = tuple(storage.shape)
    del storage, got, want
    g = torch.from_numpy(rng.standard_normal((b, n, 14, 14, 256)).astype(np.float32)).to(dev, dtype)
    got = poolers.roi_patch_backward(g, starts, wy, wx, shape)
    want = poolers.roi_patch_backward_reference(g, starts, wy, wx, shape)
    bound = poolers.roi_patch_backward_reference(g.abs(), starts, wy, wx, shape)
    assert bool(((got - want).abs() <= chip_smoke.ROI_BWD_TOL * bound).all())


def test_keypoint_loss_and_inference_on_the_card_equal_the_cpu(dev):
    """``keypoint_loss`` (with its gradient by the logits) and
    ``keypoint_inference`` on card tensors against the CPU: the loss within
    1e-6 relative, its gradient (softmax probabilities, whose exp rounds
    differently on each side) within 1e-5 of its largest value, the
    keypoints' x, y to 1e-4 px and scores to 1e-6 relative."""
    from detectron2_tensorflow_tpu_torch.config import get_cfg
    from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import GeneralizedRCNN
    from detectron2_tensorflow_tpu_torch.models.roi_heads.roi_heads import SampledProposals
    from detectron2_tensorflow_tpu_torch.structures import Instances

    cfg = get_cfg()
    cfg.merge_from_file(str(chip_smoke.ROOT / chip_smoke.KEYPOINT_YAML))
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    with torch.device("meta"):
        heads = GeneralizedRCNN(cfg).roi_heads
    rng = np.random.default_rng(15)
    b, s, m, g = 2, 64, heads.mask_slots, 5
    xy = rng.uniform(0, 100, (b, s, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (b, s, 2))], -1).astype(np.float32)
    fields = dict(boxes=boxes, gt_classes=np.zeros((b, s), np.int64),
                  gt_boxes=boxes, matched_idx=rng.integers(0, g, (b, s)),
                  is_fg=np.arange(s)[None].repeat(b, 0) < 10, valid=np.ones((b, s), bool))
    kp = np.zeros((b, g, 17, 3), np.float32)
    kp[..., :2] = rng.uniform(0, 160, (b, g, 17, 2))
    kp[..., 2] = rng.integers(0, 3, (b, g, 17))
    logits = rng.normal(0, 3, (b * m, 56, 56, 17)).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        sampled = SampledProposals(**{k: torch.from_numpy(v).to(where) for k, v in fields.items()})
        z = torch.from_numpy(logits).to(where).requires_grad_(True)
        loss = heads.keypoint_loss(z, sampled, {"gt_keypoints": torch.from_numpy(kp).to(where)})
        loss.backward()
        det = Instances(boxes=sampled.boxes[:, :m], scores=torch.ones((b, m), device=where),
                        pred_classes=torch.zeros((b, m), dtype=torch.int32, device=where),
                        is_valid=torch.ones((b, m), dtype=torch.bool, device=where))
        pk = heads.keypoint_inference(z.detach(), det).pred_keypoints
        out[str(where)] = (loss.detach().cpu(), z.grad.cpu(), pk.cpu())
    (gl, gg, gk), (wl, wg, wk) = out[str(dev)], out["cpu"]
    torch.testing.assert_close(gl, wl, rtol=1e-6, atol=0)
    assert float((gg - wg).abs().max()) <= 1e-5 * float(wg.abs().max())
    torch.testing.assert_close(gk[..., :2], wk[..., :2], rtol=0, atol=1e-4)
    torch.testing.assert_close(gk[..., 2], wk[..., 2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("overlap,limit,conf", [(0.5, 80, 0.5), (0.3, 200, 0.0), (0.8, 1, 0.6)])
def test_panoptic_fusion_on_the_card_equals_the_cpu(dev, overlap, limit, conf):
    """``combine_semantic_and_instance_outputs`` on card tensors against the
    CPU: the panoptic map and the four segment tables bit-equal, over random
    detections (score ties, invalid slots, carved mask probabilities) and a
    blocky stuff map, with segments of both kinds formed."""
    from detectron2_tensorflow_tpu_torch.models.sem_seg import (
        combine_semantic_and_instance_outputs,
    )
    from detectron2_tensorflow_tpu_torch.structures import Instances

    rng = np.random.default_rng(int(overlap * 10) + limit)
    b, d, h, w = 2, 20, 120, 168
    xy = rng.uniform(0, [w - 20, h - 20], (b, d, 2))
    fields = dict(
        boxes=np.concatenate([xy, xy + rng.uniform(8, 60, (b, d, 2))], -1).astype(np.float32),
        scores=rng.choice([0.3, 0.5, 0.6, 0.7, 0.7, 0.9], (b, d)).astype(np.float32),
        pred_classes=rng.integers(0, 5, (b, d)).astype(np.int64),
        is_valid=rng.uniform(0, 1, (b, d)) > 0.2,
        pred_masks=rng.uniform(0.2, 1.0, (b, d, 28, 28)).astype(np.float32))
    fields["pred_masks"][:, ::3, :6] = 0.0
    sem = np.kron(rng.integers(0, 7, (b, 6, 7)), np.ones((20, 24), np.int64))
    out = {}
    for where in ("cpu", dev):
        det = Instances(**{k: torch.from_numpy(v).to(where) for k, v in fields.items()})
        pan, info = combine_semantic_and_instance_outputs(
            det, torch.from_numpy(sem).to(where), overlap, limit, conf, 7)
        out[str(where)] = (pan.cpu(), {k: v.cpu() for k, v in info.items()})
    (gm, gi), (wm, wi) = out[str(dev)], out["cpu"]
    assert torch.equal(gm, wm)
    for k, v in wi.items():
        assert torch.equal(gi[k], v), k
    assert bool((wi["valid"] & wi["is_thing"]).any()) and bool((wi["valid"] & ~wi["is_thing"]).any())


def test_panoptic_predict_on_the_card_equals_the_cpu(dev):
    """PanopticFPN's narrow float32 ``predict`` on the card against the CPU
    (``chip_smoke.check_small_against_cpu``): the detections and masks at
    the standing tolerances, ``sem_seg`` equal outside logit ties of 1e-5,
    and ``panoptic_fusion`` of the CPU's output bit-equal on both."""
    rng = np.random.default_rng(0)
    chip_smoke.check_small_against_cpu(rng, dev, False,
                                       chip_smoke.two_stage_cfg("panoptic", narrow=True),
                                       label="panoptic")


@pytest.mark.parametrize("stride,modulated,dg", [(1, False, 1), (2, True, 2), (1, True, 1)])
def test_deform_conv_on_the_card_equals_the_cpu(dev, stride, modulated, dg):
    """``DeformConv2d`` float32 on the card against the CPU, real offsets
    (samples between pixels and off the map): the output within 1e-4 of its
    largest magnitude, and the gradients of the input, the kernel and the
    offset conv within 1e-4 of each one's largest."""
    torch.manual_seed(0)
    layer = chip_smoke.DeformConv2d(32, 24, 3, stride=stride, deform_groups=dg,
                                    modulated=modulated)
    with torch.no_grad():
        layer.conv_offset.weight.normal_(0, 0.05)
        layer.conv_offset.bias.uniform_(-3, 3)
    x = torch.randn(2, 32, 23, 29)
    g = torch.randn(2, 24, (23 - 1) // stride + 1, (29 - 1) // stride + 1)
    outs = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        lay = layer.to(d)
        for p in lay.parameters():
            p.grad = None
        xd = x.to(d).detach().requires_grad_(True)
        out = lay(xd)
        (out * g.to(d)).sum().backward()
        outs[name] = [t.detach().cpu() for t in (out, xd.grad, lay.weight.grad,
                                                 lay.conv_offset.weight.grad,
                                                 lay.conv_offset.bias.grad)]
    for got, want in zip(outs["card"], outs["cpu"]):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_tta_predict_on_the_card_equals_the_cpu(dev):
    """The narrow float32 R50-dconv's ``tta_predict`` on the card against the
    CPU (``chip_smoke.check_tta_small``: three scales and flips, the merged
    slots at the standing tolerances)."""
    chip_smoke.check_tta_small(np.random.default_rng(0), dev)


def test_dconv_predict_and_step_on_the_card_equal_the_cpu(dev):
    """The narrow float32 R50-dconv ``predict`` and train step on the card
    against the CPU, as ``chip_smoke`` holds them."""
    rng = np.random.default_rng(0)
    chip_smoke.check_small_against_cpu(rng, dev, False,
                                       chip_smoke.two_stage_cfg("dconv_r50", narrow=True),
                                       label="dconv")
    chip_smoke.check_train_against_cpu(dev, False,
                                       chip_smoke.two_stage_cfg("dconv_r50", narrow=True,
                                                                batch=2), label="dconv")


@pytest.mark.parametrize("deform", [False, True])
def test_solov2_predict_and_step_on_the_card_equal_the_cpu(dev, deform):
    """The narrow float32 SOLOv2 ``predict`` (plain and deformable towers),
    its assignment's ties and its train step on the card against the CPU,
    as ``chip_smoke`` holds them."""
    chip_smoke.check_solo_small_against_cpu(np.random.default_rng(0), dev, deform=deform)
    chip_smoke.check_solo_assignment(dev)
    chip_smoke.check_train_against_cpu(dev, False, chip_smoke.solo_cfg(narrow=True, batch=2),
                                       label=chip_smoke.SOLO, prepare=chip_smoke.tie_free)


@pytest.mark.parametrize("kernel", ["gaussian", "linear"])
def test_matrix_nms_on_the_card_equals_the_cpu(dev, kernel):
    """``matrix_nms`` of 500 random rectangles a frame at SOLOv2's full-width
    mask shape (200 x 336), two images: the decayed scores within 1e-6 (the
    intersections are exact sums of 0/1 products on both sides)."""
    from detectron2_tensorflow_tpu_torch.ops.nms import matrix_nms

    rng = np.random.default_rng(0)
    masks = np.zeros((2, 500, 200, 336), bool)
    for i in range(2):
        for j in range(500):
            y, x = rng.integers(0, 180), rng.integers(0, 300)
            masks[i, j, y:y + rng.integers(4, 60), x:x + rng.integers(4, 90)] = True
    labels = rng.integers(0, 80, (2, 500))
    scores = -np.sort(-rng.uniform(0, 1, (2, 500))).astype(np.float32)
    args = [torch.from_numpy(a) for a in (masks, labels, scores)]
    want = matrix_nms(*args, kernel=kernel)
    got = matrix_nms(*[a.to(dev) for a in args], kernel=kernel).cpu()
    assert float((got - want).abs().max()) <= 1e-6 and bool((want < torch.from_numpy(scores)).any())
