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

The path is opt-in, as in the JAX package: :func:`fused_epilogue_supported`
is true only when ``D2TPU_ENABLE_FUSED_EPILOGUE`` is set to any non-empty
value (``"0"`` included: the JAX package tests the variable's truthiness).
"""

from __future__ import annotations

import ctypes
import os

import torch

from .. import kernels

ENV_SWITCH = "D2TPU_ENABLE_FUSED_EPILOGUE"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
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
    lib = kernels.load("fused_residual")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_conv1x1_bn_add_relu_launch(
        x.data_ptr(), weight.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        shortcut.data_ptr(), out.data_ptr(), m, k, n, _DTYPE_CODES[x.dtype],
        ctypes.c_void_p(stream),
    )
    fused_conv1x1_bn_add_relu.launches += 1
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
    kernel (``fused_conv1x1_bn_add_relu.launches`` counts its launches),
    which takes only ``channels_last``-contiguous ``x`` and ``shortcut`` and
    raises on any other layout, dtype or device.
    """
    return FusedConv1x1BnAddRelu.apply(x, weight, scale, shift, shortcut)


fused_conv1x1_bn_add_relu.launches = 0
