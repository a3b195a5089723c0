"""Edge cases of the CUDA kernels (NMS keep, ROI patch forward and
backward) against their plain PyTorch versions, on the card. Marked
``cuda``: they skip where there is no CUDA device. On a GPU machine (which
has no JAX, so the repo's conftest cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Keep masks must be equal; ROI outputs within the tolerances of
``chip_smoke.py`` (float32 1e-4 absolute on O(1) features, bf16 one ulp of
the output's maximum), skipped slots exact zeros; ROI backward planes within
1e-5 of each cell's sum of term magnitudes (float32 sums in other orders,
atomics across ROIs), skipped slots adding nothing.
"""

import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu_torch.models import poolers
from detectron2_tensorflow_tpu_torch.ops.nms import greedy_keep, greedy_keep_reference

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
