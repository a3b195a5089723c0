"""Edge cases of the two CUDA kernels against their plain PyTorch versions,
on the card. Marked ``cuda``: they skip where there is no CUDA device, as
here on the CPU. On a GPU machine (which has no JAX, so the repo's
conftest cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Keep masks must be equal; ROI outputs within the tolerances of
``chip_smoke.py`` (float32 1e-4 absolute on O(1) features, bf16 one ulp of
the output's maximum), skipped slots exact zeros.
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
