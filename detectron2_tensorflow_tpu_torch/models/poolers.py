"""Multi-level ROIAlign from one row-concatenated storage plane.

Port of the JAX package's ``models/poolers.py``. Each image's pyramid
levels (plus 2x/4x average-pooled aliases for boxes too large for the
patch) are stacked row-wise into one NHWC plane
``[B, Htot, Wm, C]`` with ``P`` zero rows below. Each ROI then reads one
``[P, P, C]`` patch at ``(row, tx)``, and bilinear sampling with D2's
adaptive ``sampling_ratio=0`` bin average collapses into two contractions
with per-ROI hat-weight matrices: ``out = Wy (S x P) . patch . Wx^T``.

The plan (:func:`plan_rois`) is the JAX package's, operation for operation,
including the 8-aligned ``tx`` and the tier classes of the TPU kernel (a
later refactor may drop both). The contraction is :func:`roi_patch_interpolate`:
the hand-written kernel ``csrc/roi_patch.cu`` for CUDA tensors, which
replaces the TPU kernel ``ops/pallas/roi_patch.py`` ``roi_patch_interpolate``,
and the plain PyTorch :func:`roi_patch_interpolate_reference` for CPU tensors.
Its gradient is :func:`roi_patch_backward`: the kernel ``roi_patch_bwd`` of
the same source for CUDA tensors, which replaces the TPU kernel
``roi_patch_backward``, and :func:`roi_patch_backward_reference` for CPU
tensors. Training pools the box and mask ROI sets through
:func:`pool_multi_from_storage`, whose backward chains both sets through one
float32 accumulator. The 2x2 alias pool ``_avgpool2x`` is differentiated by
autograd, which gives the exact transpose the JAX package writes by hand
(each cotangent cell spread over its window at weight 1/4).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence

import torch

from .. import kernels

TARGET_PATCH = 32
_ALIGN = 8  # the TPU kernel's sublane alignment of tx, kept for parity
_EXTENT_MARGIN = 2 + (_ALIGN - 1)

# Window tiers of the TPU kernel (ops/pallas/roi_patch.py): starts[..., 2]
# carries row_class * n_col_tiers + col_class; one past the last class is
# the skip sentinel of an invalid slot.
ROW_TIERS = (16, 24)
COL_TIERS = (16, 24)

# ROIs per step of the plain versions, bounding their gathered
# [B, chunk, P, P, C] patches and products.
_FWD_CHUNK = 256
_BWD_CHUNK = 32


def tier_combos(p: int):
    tr = [r for r in ROW_TIERS if r < p] + [p]
    tc = [c for c in COL_TIERS if c < p] + [p]
    return [(r, c) for r in tr for c in tc]


def skip_tier_class(p: int) -> int:
    """Tier class marking a slot the kernel skips: no loads, exact zeros."""
    return len(tier_combos(p))


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                           canonical_box_size: int = 224,
                           canonical_level: int = 4) -> torch.Tensor:
    """FPN eqn (1): ``floor(k0 + log2(sqrt(wh) / 224))`` clamped, 0-based."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    sqrt_area = torch.sqrt(w * h)
    lvl = torch.floor(canonical_level + torch.log2(sqrt_area / canonical_box_size + 1e-8))
    lvl = torch.clamp(lvl, min_level, max_level)
    return (lvl - min_level).to(torch.int32)


def _interp_weights(coords, ty, size_l, patch_size, out_size, ratio):
    """Bin-averaged hat weights ``[..., out, P]`` for sample coords ``[..., out*ratio]``.

    D2's border rule: samples outside ``[-1, size]`` weigh zero, the rest
    are clamped to ``[0, size - 1]``.
    """
    in_range = (coords >= -1.0) & (coords <= size_l[..., None])
    clamped = torch.minimum(torch.clamp(coords, min=0.0), size_l[..., None] - 1.0)
    local = clamped - ty[..., None]
    cells = torch.arange(patch_size, dtype=torch.float32, device=coords.device)
    w = torch.clamp(1.0 - torch.abs(local[..., None] - cells), min=0.0)
    w = w * in_range[..., None]
    lead = coords.shape[:-1]
    return w.reshape(lead + (out_size, ratio, patch_size)).mean(dim=-2)


def _sample_coords(origin, extent, out_size, ratio):
    s = out_size * ratio
    steps = (torch.arange(s, dtype=torch.float32, device=origin.device) + 0.5) / s
    return origin[..., None] + steps * extent[..., None]


def _adaptive_weights(origin, extent, ratio_sel, ty, size_l, patch_size,
                      out_size, ratio_max):
    """Hat weights under D2's adaptive rule: ``ratio_sel`` samples per bin."""
    w = None
    for r in range(1, ratio_max + 1):
        w_r = _interp_weights(_sample_coords(origin, extent, out_size, r), ty,
                              size_l, patch_size, out_size, r)
        w = w_r if w is None else torch.where((ratio_sel == r)[..., None, None], w_r, w)
    return w


def _avgpool2x(f: torch.Tensor) -> torch.Tensor:
    """2x2 mean of ``[B, H, W, C]`` (VALID windows), in the input dtype."""
    b, h, w, c = f.shape
    h2, w2 = h // 2, w // 2
    x = f[:, : 2 * h2, : 2 * w2].reshape(b, h2, 2, w2, 2, c)
    s = x[:, :, 0, :, 0] + x[:, :, 1, :, 0] + x[:, :, 0, :, 1] + x[:, :, 1, :, 1]
    return s * 0.25


class StorageMeta:
    """Static description of a built storage plane."""

    def __init__(self, shapes, strides, base_l, patch_size):
        self.shapes = shapes
        self.strides = strides
        self.base_l = base_l
        self.patch_size = patch_size
        self.w_max = max(max(w for _, w in shapes), patch_size)
        offs, off = [], 0
        for h, _ in shapes:
            offs.append(off)
            off += h
        self.row_offsets = offs


def build_storage(features: List[torch.Tensor], strides: Sequence[int],
                  patch_size: int):
    """Stack NHWC levels ``[B, Hl, Wl, C]`` and their extent-tier aliases
    (a 2x-averaged copy of every level, a 4x one of the top level) into
    ``([B, Htot, Wm, C], meta)``."""
    features = list(features)
    strides = list(strides)
    base_l = len(features)
    for i in range(base_l):
        features.append(_avgpool2x(features[i]))
        strides.append(strides[i] * 2)
    features.append(_avgpool2x(features[2 * base_l - 1]))
    strides.append(strides[base_l - 1] * 4)
    b, c = features[0].shape[0], features[0].shape[-1]
    meta = StorageMeta([(f.shape[1], f.shape[2]) for f in features], strides,
                       base_l, patch_size)
    htot = sum(h for h, _ in meta.shapes) + patch_size
    storage = features[0].new_zeros((b, htot, meta.w_max, c))
    for f, off in zip(features, meta.row_offsets):
        storage[:, off: off + f.shape[1], : f.shape[2]] = f
    return storage, meta


def plan_rois(meta: StorageMeta, boxes: torch.Tensor, output_size: int,
              sampling_ratio: int, canonical_box_size: int,
              canonical_level: int, valid: torch.Tensor | None = None):
    """Per-ROI plan ``(starts [..., 3] int32, wy, wx [..., S, P])`` for
    ``[..., 4]`` boxes against a built storage.

    Invalid slots get the skip sentinel class, an origin on the plane's
    trailing zero rows and zero weights.
    """
    strides = meta.strides
    base_l = meta.base_l
    p = meta.patch_size
    w_max = meta.w_max
    dev = boxes.device

    heights = torch.tensor([h for h, _ in meta.shapes], dtype=torch.float32, device=dev)
    widths = torch.tensor([w for _, w in meta.shapes], dtype=torch.float32, device=dev)
    scales = torch.tensor([1.0 / st for st in strides], dtype=torch.float32, device=dev)
    offsets = torch.tensor(meta.row_offsets, dtype=torch.int32, device=dev)

    # Area rule, then extent tiers: own level -> its 2x alias -> top 4x.
    min_level = int(math.log2(strides[0]))
    base = assign_boxes_to_levels(boxes, min_level, min_level + base_l - 1,
                                  canonical_box_size, canonical_level).long()
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    max_side = torch.maximum(bw, bh)
    bound = float(p - _EXTENT_MARGIN)
    base_stride = torch.tensor(strides[:base_l], dtype=torch.float32, device=dev)[base]
    extent = max_side / base_stride
    levels = torch.where(extent > bound, base + base_l, base)
    levels = torch.where(extent > 2 * bound, torch.full_like(levels, 2 * base_l), levels)

    scale = scales[levels]
    h_l = heights[levels]
    w_l = widths[levels]

    scaled = boxes * scale[..., None]
    x0 = scaled[..., 0] - 0.5
    y0 = scaled[..., 1] - 0.5
    roi_w = scaled[..., 2] - scaled[..., 0]
    roi_h = scaled[..., 3] - scaled[..., 1]

    if sampling_ratio > 0:
        raise NotImplementedError("only D2's adaptive sampling_ratio=0 is ported")
    r_max = max(1, -(-(p - _EXTENT_MARGIN) // output_size))
    ry = torch.clamp(torch.ceil(roi_h / output_size), 1, r_max).to(torch.int32)
    rx = torch.clamp(torch.ceil(roi_w / output_size), 1, r_max).to(torch.int32)
    ns_y = (output_size * ry).to(torch.float32)
    ns_x = (output_size * rx).to(torch.float32)
    first_y = y0 + 0.5 * roi_h / ns_y
    first_x = x0 + 0.5 * roi_w / ns_x
    max_y = torch.maximum(first_y, y0 + roi_h - 0.5 * roi_h / ns_y)
    max_x = torch.maximum(first_x, x0 + roi_w - 0.5 * roi_w / ns_x)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ty = torch.minimum(
        torch.maximum(torch.floor(torch.clamp(first_y, min=0.0)), zero),
        torch.clamp(h_l - 1, min=0.0),
    )
    tx = torch.clamp(torch.floor(torch.clamp(first_x, min=0.0)), 0.0, float(w_max - p))
    tx = torch.floor(tx / _ALIGN) * _ALIGN

    wy = _adaptive_weights(y0, roi_h, ry, ty, h_l, p, output_size, r_max)
    wx = _adaptive_weights(x0, roi_w, rx, tx, w_l, p, output_size, r_max)
    ok = ((roi_h > 0.0) & (roi_w > 0.0))[..., None, None]
    wy = wy * ok
    wx = wx * ok

    rows = offsets[levels] + ty.to(torch.int32)

    def tier_class(tiers, span):
        c = torch.full(span.shape, len(tiers), dtype=torch.int32, device=dev)
        for k in reversed(range(len(tiers))):
            c = torch.where(span <= tiers[k], torch.full_like(c, k), c)
        return c

    last_y = torch.minimum(torch.clamp(max_y, min=0.0), torch.clamp(h_l - 1, min=0.0))
    span_y = torch.floor(last_y).to(torch.int32) - ty.to(torch.int32) + 2
    last_x = torch.minimum(torch.clamp(max_x, min=0.0), torch.clamp(w_l - 1, min=0.0))
    span_x = torch.floor(last_x).to(torch.int32) - tx.to(torch.int32) + 2
    n_col = len([c for c in COL_TIERS if c < p]) + 1
    cls = (tier_class([r for r in ROW_TIERS if r < p], span_y) * n_col
           + tier_class([c for c in COL_TIERS if c < p], span_x))

    if valid is not None:
        skip = ~valid
        safe_row = sum(h for h, _ in meta.shapes)
        cls = torch.where(skip, torch.full_like(cls, skip_tier_class(p)), cls)
        rows = torch.where(skip, torch.full_like(rows, safe_row), rows)
        tx = torch.where(skip, torch.zeros_like(tx), tx)
        wy = torch.where(skip[..., None, None], torch.zeros_like(wy), wy)
        wx = torch.where(skip[..., None, None], torch.zeros_like(wx), wx)

    starts = torch.stack([rows, tx.to(torch.int32), cls], dim=-1)
    return starts, wy, wx


def hat_support(w: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` int64 ``[lo, hi)`` per slot of hat weights ``w [..., S, P]``:
    the patch rows (of ``wy``) or columns (of ``wx``) where some of the S
    weights is nonzero, ``[0, 0)`` where none is. The ROI kernels derive the
    same range from the weights and loop over it alone."""
    p = w.shape[-1]
    nz = (w != 0).any(dim=-2)
    pos = torch.arange(p, device=w.device)
    hi = torch.where(nz, pos + 1, 0).amax(dim=-1)
    lo = torch.where(nz, pos, p).amin(dim=-1)
    return torch.stack([torch.where(hi > 0, lo, 0), hi], dim=-1)


def roi_patch_interpolate_reference(storage: torch.Tensor, starts: torch.Tensor,
                                    wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ROI patch contraction ``[B, N, S, S, C]``.

    The same arithmetic as the kernel: ``wy`` rounded to the plane's dtype,
    both contractions in float32, the result rounded once. Skip-sentinel
    slots give exact zeros.
    """
    b, htot, wm, c = storage.shape
    n, s, p = wy.shape[1], wy.shape[2], wy.shape[3]
    dev = storage.device
    ar = torch.arange(p, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    skip = starts[..., 2] >= skip_tier_class(p)
    outs = []
    for lo in range(0, n, _FWD_CHUNK):
        hi = lo + _FWD_CHUNK
        st = starts[:, lo:hi].long()
        rows = torch.clamp(st[..., 0, None] + ar, 0, htot - 1)  # [B, n, P]
        cols = torch.clamp(st[..., 1, None] + ar, 0, wm - 1)
        patches = storage[bidx, rows[..., :, None], cols[..., None, :]].float()  # [B,n,P,P,C]
        wyc = wy[:, lo:hi].to(storage.dtype).float()
        a = torch.einsum("bnop,bnpqc->bnoqc", wyc, patches)
        out = torch.einsum("bnuq,bnoqc->bnouc", wx[:, lo:hi].float(), a)
        outs.append(out)
    out = torch.cat(outs, dim=1)
    out = torch.where(skip[..., None, None, None], torch.zeros_like(out), out)
    return out.to(storage.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_plan(what: str, starts: torch.Tensor, wy: torch.Tensor,
                wx: torch.Tensor, b: int, device: torch.device):
    """Validate a ``[B, N]`` plan for a kernel launch; return ``(n, s, p)``."""
    if wy.dim() != 4 or wy.shape[0] != b:
        raise ValueError(f"{what}: wy must be [B, N, S, P]")
    n, s, p = wy.shape[1:]
    for name, t, shape, dtype in (("starts", starts, (b, n, 3), torch.int32),
                                  ("wy", wy, (b, n, s, p), torch.float32),
                                  ("wx", wx, (b, n, s, p), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dtype} {shape} on the plane's device")
    if s > 16 or p > 64:
        raise ValueError(f"{what}: S={s} > 16 or P={p} > 64 is not supported")
    return n, s, p


def _roi_patch_cuda(storage: torch.Tensor, starts: torch.Tensor,
                    wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    what = "roi_patch_interpolate"
    if storage.dim() != 4 or not storage.is_contiguous():
        raise ValueError(f"{what}: storage must be a contiguous [B, Htot, Wm, C]")
    if storage.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: storage dtype {storage.dtype} is not float32/bfloat16")
    b, htot, wm, c = storage.shape
    n, s, p = _check_plan(what, starts, wy, wx, b, storage.device)
    lib = kernels.load("roi_patch")
    out = torch.empty((b, n, s, s, c), dtype=storage.dtype, device=storage.device)
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    rc = lib.roi_patch_fwd_launch(
        storage.data_ptr(), starts.data_ptr(), wy.data_ptr(), wx.data_ptr(),
        out.data_ptr(), b, n, htot, wm, c, p, s, skip_tier_class(p),
        _DTYPE_CODES[storage.dtype], ctypes.c_void_p(stream),
    )
    roi_patch_interpolate.launches += 1
    kernels.check(rc, "roi_patch_fwd_launch")
    return out


def roi_patch_interpolate(storage: torch.Tensor, starts: torch.Tensor,
                          wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """``[B, N, S, S, C]`` pooled features in the storage's dtype.

    CPU tensors take :func:`roi_patch_interpolate_reference`; CUDA tensors
    the kernel (``roi_patch_interpolate.launches`` counts its launches).
    Anything else raises.
    """
    dev = storage.device.type
    if dev == "cpu":
        return roi_patch_interpolate_reference(storage, starts, wy, wx)
    if dev == "cuda":
        return _roi_patch_cuda(storage, starts, wy, wx)
    raise RuntimeError(f"roi_patch_interpolate: no implementation for device '{dev}'")


roi_patch_interpolate.launches = 0


def roi_patch_backward_reference(g: torch.Tensor, starts: torch.Tensor,
                                 wy: torch.Tensor, wx: torch.Tensor, out_shape,
                                 init: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch ROI patch backward: the float32 plane ``out_shape``
    ``[B, Htot, Wm, C]`` of ``sum`` over ROIs of
    ``gp[p, q, c] = sum_o sum_u wy[o, p] g[o, u, c] wx[u, q]`` placed at
    ``(row + p, tx + q)``.

    ``g [B, N, S, S, C]`` is widened to float32 and ``wy``/``wx`` are used
    unrounded, as the TPU kernel does. Skip-sentinel slots and cells outside
    the plane add nothing. ``init`` (a float32 plane of ``out_shape``) is
    accumulated into in place and returned; otherwise a zero plane is.
    """
    b, htot, wm, c = out_shape
    n, p = wy.shape[1], wy.shape[3]
    dev = g.device
    acc = torch.zeros(out_shape, dtype=torch.float32, device=dev) if init is None else init
    ar = torch.arange(p, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    keep = starts[..., 2] < skip_tier_class(p)
    for lo in range(0, n, _BWD_CHUNK):
        hi = lo + _BWD_CHUNK
        st = starts[:, lo:hi].long()
        rows = st[..., 0, None] + ar  # [B, n, P]
        cols = st[..., 1, None] + ar
        t = torch.einsum("bnop,bnouc->bnpuc", wy[:, lo:hi].float(), g[:, lo:hi].float())
        gp = torch.einsum("bnpuc,bnuq->bnpqc", t, wx[:, lo:hi].float())
        inside = (((rows >= 0) & (rows < htot))[..., :, None]
                  & ((cols >= 0) & (cols < wm))[..., None, :]
                  & keep[:, lo:hi, None, None])
        gp = torch.where(inside[..., None], gp, torch.zeros_like(gp))
        acc.index_put_((bidx, rows.clamp(0, htot - 1)[..., :, None],
                        cols.clamp(0, wm - 1)[..., None, :]), gp, accumulate=True)
    return acc


def _roi_patch_bwd_cuda(g: torch.Tensor, starts: torch.Tensor, wy: torch.Tensor,
                        wx: torch.Tensor, out_shape,
                        init: torch.Tensor | None) -> torch.Tensor:
    what = "roi_patch_backward"
    if g.dim() != 5 or not g.is_contiguous():
        raise ValueError(f"{what}: g must be a contiguous [B, N, S, S, C]")
    if g.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: g dtype {g.dtype} is not float32/bfloat16")
    b, htot, wm, c = out_shape
    n, s, p = _check_plan(what, starts, wy, wx, b, g.device)
    if tuple(g.shape) != (b, n, s, s, c):
        raise ValueError(f"{what}: g is {tuple(g.shape)}, expected {(b, n, s, s, c)}")
    if init is None:
        acc = torch.zeros(tuple(out_shape), dtype=torch.float32, device=g.device)
    else:
        if (tuple(init.shape) != tuple(out_shape) or init.dtype != torch.float32
                or not init.is_contiguous() or init.device != g.device):
            raise ValueError(f"{what}: init must be a contiguous float32 {tuple(out_shape)} "
                             "plane on g's device")
        acc = init
    lib = kernels.load("roi_patch")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = lib.roi_patch_bwd_launch(
        g.data_ptr(), starts.data_ptr(), wy.data_ptr(), wx.data_ptr(),
        acc.data_ptr(), b, n, htot, wm, c, p, s, skip_tier_class(p),
        _DTYPE_CODES[g.dtype], ctypes.c_void_p(stream),
    )
    roi_patch_backward.launches += 1
    kernels.check(rc, "roi_patch_bwd_launch")
    return acc


def roi_patch_backward(g: torch.Tensor, starts: torch.Tensor, wy: torch.Tensor,
                       wx: torch.Tensor, out_shape,
                       init: torch.Tensor | None = None) -> torch.Tensor:
    """Float32 plane gradient of :func:`roi_patch_interpolate` for the
    cotangent ``g``; accumulates into ``init`` in place when given.

    CPU tensors take :func:`roi_patch_backward_reference`; CUDA tensors the
    kernel (``roi_patch_backward.launches`` counts its launches). Anything
    else raises.
    """
    dev = g.device.type
    if dev == "cpu":
        return roi_patch_backward_reference(g, starts, wy, wx, out_shape, init=init)
    if dev == "cuda":
        return _roi_patch_bwd_cuda(g, starts, wy, wx, out_shape, init)
    raise RuntimeError(f"roi_patch_backward: no implementation for device '{dev}'")


roi_patch_backward.launches = 0


class RoiPatchPoolMulti(torch.autograd.Function):
    """Pool several ROI sets ``(starts, wy, wx)`` from one storage plane.

    The forward is one :func:`roi_patch_interpolate` per set. The backward
    chains every set's :func:`roi_patch_backward` through one float32
    accumulator (``init=``) and casts it once to the plane's dtype, as the
    JAX package's ``roi_patch_pool_multi`` does. Gradients go to the plane
    only: the plan is built from boxes that carry none.
    """

    @staticmethod
    def forward(ctx, storage, *flat_specs):
        specs = [flat_specs[i: i + 3] for i in range(0, len(flat_specs), 3)]
        ctx.plane_shape = tuple(storage.shape)
        ctx.plane_dtype = storage.dtype
        ctx.save_for_backward(*flat_specs)
        return tuple(roi_patch_interpolate(storage, st, wy, wx) for st, wy, wx in specs)

    @staticmethod
    def backward(ctx, *grads):
        flat = ctx.saved_tensors
        specs = [flat[i: i + 3] for i in range(0, len(flat), 3)]
        acc = None
        for g, (st, wy, wx) in zip(grads, specs):
            if g is None:
                continue
            acc = roi_patch_backward(g.contiguous(), st, wy, wx, ctx.plane_shape, init=acc)
        grad = None if acc is None else acc.to(ctx.plane_dtype)
        return (grad,) + (None,) * len(flat)


def _plan(meta: StorageMeta, boxes: torch.Tensor, output_size: int,
          sampling_ratio: int, canonical_box_size: int, canonical_level: int,
          valid: torch.Tensor | None):
    starts, wy, wx = plan_rois(meta, boxes.detach().float(), output_size,
                               sampling_ratio, canonical_box_size, canonical_level,
                               valid=valid)
    return starts.contiguous(), wy.contiguous(), wx.contiguous()


def pool_from_storage(storage: torch.Tensor, meta: StorageMeta,
                      boxes: torch.Tensor, output_size: int,
                      sampling_ratio: int, canonical_box_size: int = 224,
                      canonical_level: int = 4,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """ROIAlign ``[B, N, 4]`` boxes from a built ``[B, Htot, Wm, C]`` storage
    -> ``[B, N, S, S, C]``; invalid slots pool exact zeros. Differentiable
    in the storage (:class:`RoiPatchPoolMulti` with one ROI set)."""
    plan = _plan(meta, boxes, output_size, sampling_ratio, canonical_box_size,
                 canonical_level, valid)
    return RoiPatchPoolMulti.apply(storage, *plan)[0]


def pool_multi_from_storage(storage: torch.Tensor, meta: StorageMeta,
                            requests: Sequence[dict]):
    """Pool several ROI sets from one storage plane in one differentiable
    op whose backward chains through one float32 accumulator
    (:class:`RoiPatchPoolMulti`). Each request is ``dict(boxes,
    output_size, sampling_ratio, canonical_box_size, canonical_level,
    valid)``, the arguments of :func:`pool_from_storage` (``valid`` may be
    None). Returns one ``[B, N, S, S, C]`` tensor per request."""
    flat = []
    for r in requests:
        flat.extend(_plan(meta, r["boxes"], r["output_size"], r["sampling_ratio"],
                          r["canonical_box_size"], r["canonical_level"], r["valid"]))
    return RoiPatchPoolMulti.apply(storage, *flat)


def plan_patch(max_image_size: int, top_stride: int, target: int = TARGET_PATCH) -> int:
    """Patch size covering a full-image-wide ROI through the 4x extent tier."""
    need = -(-max_image_size // (4 * top_stride)) + _EXTENT_MARGIN
    return max(-(-need // _ALIGN) * _ALIGN, 16, min(target, 32))


class ROIPooler:
    """Config-bound pooler: level strides, output size and patch layout."""

    def __init__(self, output_size: int, strides: Sequence[int],
                 sampling_ratio: int, pooler_type: str = "ROIAlignV2",
                 canonical_box_size: int = 224, canonical_level: int = 4,
                 max_image_size: int = 0):
        if pooler_type != "ROIAlignV2":
            raise NotImplementedError(f"pooler '{pooler_type}' is not ported")
        if not max_image_size:
            raise ValueError("the pooler needs max_image_size to size its patch")
        self.output_size = output_size
        self.strides = list(strides)
        self.sampling_ratio = sampling_ratio
        self.canonical_box_size = canonical_box_size
        self.canonical_level = canonical_level
        self.patch_size = plan_patch(max_image_size, self.strides[-1])

    def build_storage(self, features: List[torch.Tensor]):
        """``(storage, meta)`` shareable by every pooler with this layout."""
        return build_storage(features, self.strides, self.patch_size)

    def pool(self, storage, meta, boxes: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
        return pool_from_storage(storage, meta, boxes, self.output_size,
                                 self.sampling_ratio, self.canonical_box_size,
                                 self.canonical_level, valid=valid)
