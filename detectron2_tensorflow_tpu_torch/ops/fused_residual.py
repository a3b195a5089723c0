"""Fused 1x1 conv + FrozenBN + residual add + ReLU: the bottleneck tail.

Port of the JAX package's ``ops/pallas/fused_residual.py``. The tail of
every ResNet bottleneck block is ``relu(frozen_bn(conv1x1(x)) + shortcut)``;
with the activations in ``channels_last`` memory the 1x1 conv is the matrix
product of ``x`` ``[M = B*H*W, K]`` with the weight ``[N, K]``, so the whole
tail is one pass: ``relu((x @ W^T) * scale + shift + shortcut)``, products
summed in float32, ``scale``/``shift`` (the folded FrozenBN affine) in
float32, the shortcut widened to float32, one rounding to the input dtype.

:func:`fused_conv1x1_bn_add_relu` dispatches on the device of its input: a
CPU tensor goes to the plain PyTorch version
(:func:`fused_conv1x1_bn_add_relu_reference`), a CUDA tensor to the
hand-written kernel ``csrc/fused_residual.cu``, which replaces the TPU
kernel ``ops/pallas/fused_residual.py`` ``fused_conv1x1_bn_add_relu``.
:func:`plan_tail` picks the kernel and its launch geometry from the shape,
the dtype and the alignment alone: the persistent ``wgmma``/TMA kernel for
bf16 with K and N multiples of 8 on 16-byte-aligned tensors (all of R50's
tails), the ``mma.sync`` kernel for any other bf16, FFMA for float32.

The path is opt-in, as in the JAX package: :func:`fused_epilogue_supported`
is true only when ``D2TPU_ENABLE_FUSED_EPILOGUE`` is set to any non-empty
value (``"0"`` included: the JAX package tests the variable's truthiness).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple, Tuple

import torch

from .. import kernels

ENV_SWITCH = "D2TPU_ENABLE_FUSED_EPILOGUE"

_DTYPES = (torch.float32, torch.bfloat16)

# The C entry's path codes.
PATHS = {"ffma": 0, "mma": 1, "wgmma": 2}
# The Hopper kernel's output tile (rows, columns) and the stages of its
# shared-memory ring, as ``csrc/fused_residual.cu`` is built: with the
# shortcut's two buffers they fill the 227 KB a block may use.
WGMMA_TILE = (64, 256, 4)
# The H100 SXM's streaming multiprocessors: the persistent grid's default.
H100_SMS = 132


class TailPlan(NamedTuple):
    """Which kernel a tail takes and how it is launched: ``path`` (a key of
    :data:`PATHS`), the output tile ``bm`` x ``bn``, the ``stages`` of the
    operand ring, the ``grid`` (``wgmma``: the persistent blocks and 1; the
    others: blocks along N and along M), the output ``tiles`` and the
    ``rounds``, the most tiles one block takes."""
    path: str
    bm: int
    bn: int
    stages: int
    grid: Tuple[int, int]
    tiles: int
    rounds: int


def plan_tail(m: int, k: int, n: int, dtype: torch.dtype, aligned: bool,
              sms: int = H100_SMS) -> TailPlan:
    """The launch of an ``[m, k] x [k, n]`` tail, from the shape, the dtype
    and whether every operand starts on a 16-byte boundary.

    bf16 with ``k`` and ``n`` multiples of 8 on aligned tensors (what TMA
    takes) goes to the persistent ``wgmma`` kernel: at most one block per SM
    (``sms``), each walking 64 x 256 output tiles, N fastest. With 64-row
    tiles the blocks' rounds are, over all of them, at least 99% full at
    every R50 tail at batch 2 and 8 (``tiles / (rounds * grid)``). Any other
    bf16 goes to the ``mma.sync`` kernel, float32 to FFMA, one block a tile.
    The C entry takes the path and, for ``wgmma``, the grid; the tiles and
    stages here mirror the kernels' own constants.
    """
    if dtype == torch.float32:
        return _one_tile_a_block("ffma", 64, 64, 1, m, n)
    if dtype != torch.bfloat16:
        raise ValueError(f"plan_tail: no kernel for {dtype}")
    if not (aligned and k % 8 == 0 and n % 8 == 0):
        return _one_tile_a_block("mma", 128, 128, 2, m, n)
    bm, bn, stages = WGMMA_TILE
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    grid = min(tiles, sms)
    return TailPlan("wgmma", bm, bn, stages, (grid, 1), tiles,
                    math.ceil(tiles / grid) if grid else 0)


def _one_tile_a_block(path, bm, bn, stages, m, n):
    grid = (math.ceil(n / bn), math.ceil(m / bm))
    return TailPlan(path, bm, bn, stages, grid, grid[0] * grid[1], 1)


def operands_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary, as TMA
    needs (a view with a storage offset may not)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_epilogue_enabled() -> bool:
    """Whether the user switched the fused tail on (any non-empty value)."""
    return bool(os.environ.get(ENV_SWITCH))


def epilogue_shape_supported(kernel_size: int, strides: int, groups: int, dilation: int,
                             norm: str, use_bias: bool, padding="SAME") -> bool:
    """Whether a conv with a residual can take the fused tail: 1x1, stride 1,
    no groups or dilation, FrozenBN, no bias, and padding that is a no-op
    ("SAME" or "VALID"; explicit numeric padding grows the output)."""
    return (
        kernel_size == 1
        and strides == 1
        and groups == 1
        and dilation == 1
        and norm == "FrozenBN"
        and not use_bias
        and padding in ("SAME", "VALID")
    )


def fused_epilogue_supported(kernel_size: int, strides: int, groups: int, dilation: int,
                             norm: str, use_bias: bool, padding="SAME") -> bool:
    """:func:`epilogue_shape_supported` behind the user's switch."""
    if not fused_epilogue_enabled():
        return False
    return epilogue_shape_supported(kernel_size, strides, groups, dilation, norm, use_bias,
                                    padding)


def fused_conv1x1_bn_add_relu_reference(x: torch.Tensor, weight: torch.Tensor,
                                        scale: torch.Tensor, shift: torch.Tensor,
                                        shortcut: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fused tail, the kernel's arithmetic: float32 products
    and sums, ``* scale + shift + shortcut`` in float32, ReLU, one rounding
    to ``x``'s dtype.

    ``x`` ``[B, K, H, W]``, ``weight`` ``[N, K, 1, 1]``, ``scale``/``shift``
    ``[N]``, ``shortcut`` ``[B, N, H, W]``; returns ``[B, N, H, W]`` in
    ``channels_last`` memory.
    """
    b, k, h, w = x.shape
    n = weight.shape[0]
    xm = x.permute(0, 2, 3, 1).reshape(-1, k).float()
    acc = xm @ weight.reshape(n, k).float().t()
    sc = shortcut.permute(0, 2, 3, 1).reshape(-1, n).float()
    y = torch.relu(acc * scale.float() + shift.float() + sc)
    return y.to(x.dtype).reshape(b, h, w, n).permute(0, 3, 1, 2)


def _check_cuda_inputs(x, weight, scale, shift, shortcut):
    what = "fused_conv1x1_bn_add_relu"
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{what}: x must be a float32/bfloat16 [B, K, H, W]")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: x must be channels_last-contiguous")
    b, k, h, w = x.shape
    n = weight.shape[0]
    if (tuple(weight.shape) != (n, k, 1, 1) or weight.dtype != x.dtype
            or not weight.is_contiguous() or weight.device != x.device):
        raise ValueError(f"{what}: weight must be a contiguous [N, {k}, 1, 1] {x.dtype} "
                         "on x's device")
    for name, t in (("scale", scale), ("shift", shift)):
        if (tuple(t.shape) != (n,) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{what}: {name} must be a contiguous float32 [{n}] on x's device")
    if (tuple(shortcut.shape) != (b, n, h, w) or shortcut.dtype != x.dtype
            or not shortcut.is_contiguous(memory_format=torch.channels_last)
            or shortcut.device != x.device):
        raise ValueError(f"{what}: shortcut must be a channels_last-contiguous "
                         f"{(b, n, h, w)} {x.dtype} on x's device")
    return b * h * w, k, n


def _fused_cuda(x, weight, scale, shift, shortcut):
    m, k, n = _check_cuda_inputs(x, weight, scale, shift, shortcut)
    out = torch.empty_like(shortcut, memory_format=torch.channels_last)
    plan = plan_tail(m, k, n, x.dtype, operands_aligned(x, weight, shortcut, out),
                     _sm_count(x.device.index))
    lib = kernels.load("fused_residual")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_conv1x1_bn_add_relu_launch(
        x.data_ptr(), weight.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        shortcut.data_ptr(), out.data_ptr(), m, k, n, PATHS[plan.path], plan.grid[0],
        ctypes.c_void_p(stream),
    )
    fused_conv1x1_bn_add_relu.launches += 1
    fused_conv1x1_bn_add_relu.launches_by_path[plan.path] += 1
    kernels.check(rc, "fused_conv1x1_bn_add_relu_launch")
    return out


def _forward(x, weight, scale, shift, shortcut):
    dev = x.device.type
    if dev == "cpu":
        return fused_conv1x1_bn_add_relu_reference(x, weight, scale, shift, shortcut)
    if dev == "cuda":
        return _fused_cuda(x, weight, scale, shift, shortcut)
    raise RuntimeError(f"fused_conv1x1_bn_add_relu: no implementation for device '{dev}'")


class FusedConv1x1BnAddRelu(torch.autograd.Function):
    """The fused tail with the JAX package's hand-written backward (``_bwd``).

    ``g = dy * (out > 0)``; ``gs = g * scale`` in the working dtype;
    ``dx = gs @ W``; ``dW = gs^T @ x`` summed in float32, cast to the
    weight's dtype; ``dshortcut = g``. The two products are PyTorch's
    matrix products, as the JAX package leaves them to XLA outside any
    Pallas kernel. ``scale`` and ``shift`` are FrozenBN buffers here and take
    no gradient, so ``_bwd``'s ``dscale`` (approximate: it rebuilds the conv
    output from the rounded activation) and ``dshift`` are not carried over.
    """

    @staticmethod
    def forward(ctx, x, weight, scale, shift, shortcut):
        out = _forward(x, weight, scale, shift, shortcut)
        ctx.save_for_backward(x, weight, scale, out)
        ctx.shortcut_dtype = shortcut.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, scale, out = ctx.saved_tensors
        b, k, h, w = x.shape
        n = weight.shape[0]
        g = dy * (out > 0).to(dy.dtype)
        gs = (g * scale.to(g.dtype).view(1, -1, 1, 1)).permute(0, 2, 3, 1).reshape(-1, n)
        w2 = weight.reshape(n, k).to(x.dtype)
        dx = (gs.to(x.dtype) @ w2).reshape(b, h, w, k).permute(0, 3, 1, 2)
        xm = x.permute(0, 2, 3, 1).reshape(-1, k)
        dw = _mm_float32(gs.t(), xm).reshape(n, k, 1, 1).to(weight.dtype)
        return dx, dw, None, None, g.to(ctx.shortcut_dtype)


def _mm_float32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed and returned in float32. bf16 operands on the card go
    to the tensor cores with a float32 result (``torch.mm``'s ``out_dtype``)
    instead of being widened into float32 copies for a float32 product."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def fused_conv1x1_bn_add_relu(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor, shortcut: torch.Tensor) -> torch.Tensor:
    """``relu((x conv1x1 weight) * scale + shift + shortcut)``, differentiable
    in ``x``, ``weight`` and ``shortcut``.

    ``x`` ``[B, K, H, W]``, ``weight`` ``[N, K, 1, 1]`` in ``x``'s dtype,
    ``scale``/``shift`` float32 ``[N]``, ``shortcut`` ``[B, N, H, W]`` in
    ``x``'s dtype; returns ``[B, N, H, W]`` (``channels_last``). CPU tensors
    take :func:`fused_conv1x1_bn_add_relu_reference`; CUDA tensors the
    kernel of :func:`plan_tail` (``fused_conv1x1_bn_add_relu.launches``
    counts the launches, ``.launches_by_path`` each path's), which takes
    only ``channels_last``-contiguous ``x`` and ``shortcut`` and raises on
    any other layout, dtype or device.
    """
    return FusedConv1x1BnAddRelu.apply(x, weight, scale, shift, shortcut)


fused_conv1x1_bn_add_relu.launches = 0
fused_conv1x1_bn_add_relu.launches_by_path = dict.fromkeys(PATHS, 0)
