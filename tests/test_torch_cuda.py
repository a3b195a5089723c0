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

from detectron2_tensorflow_tpu_torch.models import poolers
from detectron2_tensorflow_tpu_torch.ops import fused_residual as fr
from detectron2_tensorflow_tpu_torch.ops.nms import greedy_keep, greedy_keep_reference
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


@pytest.mark.parametrize("b,n", [(1, 1), (2, 63), (3, 64), (1, 65), (2, 1000), (1, 4097)])
@pytest.mark.parametrize("thr,mk", [(0.3, None), (0.7, None), (0.5, 5)])
def test_nms_keep_kernel_equals_plain(dev, b, n, thr, mk):
    rng = np.random.default_rng(n)
    boxes = torch.from_numpy(_boxes(rng, b, n)).to(dev)
    valid = torch.from_numpy(rng.uniform(0, 1, (b, n)) > 0.1).to(dev)
    got = greedy_keep(boxes, valid, thr, max_keep=mk)
    want = greedy_keep_reference(boxes, valid, thr, max_keep=mk)
    assert torch.equal(got.cpu(), want.cpu())


def test_nms_keep_kernel_degenerate_inputs(dev):
    same = torch.tensor([[10.0, 10.0, 50.0, 50.0]], device=dev).repeat(1, 130, 1)
    keep = greedy_keep(same, torch.ones(1, 130, dtype=torch.bool, device=dev), 0.5)
    assert keep.cpu().tolist() == [[True] + [False] * 129]
    none = greedy_keep(same, torch.zeros(1, 130, dtype=torch.bool, device=dev), 0.5)
    assert not none.any()
    empty = torch.zeros(1, 70, 4, device=dev)  # zero-area boxes never overlap
    assert greedy_keep(empty, torch.ones(1, 70, dtype=torch.bool, device=dev), 0.5).all()


def test_nms_keep_kernel_counts_launches_and_checks_inputs(dev):
    boxes = torch.zeros(2, 10, 4, device=dev)
    valid = torch.ones(2, 10, dtype=torch.bool, device=dev)
    before = greedy_keep.launches
    greedy_keep(boxes, valid, 0.5)
    assert greedy_keep.launches == before + 1
    with pytest.raises(ValueError):
        greedy_keep(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError):
        greedy_keep(boxes, valid.int(), 0.5)


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
