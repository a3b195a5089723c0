"""Deformable convolution v1 and v2 (modulated): a 3x3 conv that samples its
taps at offsets predicted by a regular conv.

Port of the JAX package's ``models/deform_conv.py`` (``DeformConv2D``), the
same computation in the same order:

  * ``conv_offset`` is a 3x3 conv with a bias, zero at the JAX package's
    initialization (the layer starts as a plain conv), run in the input's
    dtype, its sum rounded before the bias is added and again after, as
    Flax's ``nn.Conv`` rounds; so in bf16 the offsets are rounded to bf16
    before the float32 cast;
  * its channels are ``(deform_groups, taps, 2)`` offsets, y first, then
    (v2) ``(deform_groups, taps)`` modulation logits, whose sigmoid scales
    each sampled tap;
  * tap ``t`` of output ``(i, j)`` samples the input at ``(i * stride +
    (t // k - 1) * dilation + dy, j * stride + (t % k - 1) * dilation +
    dx)``, bilinearly from the four corners, each of which contributes only
    when it lies inside the map (zero padding, no clamping of
    coordinates);
  * the corner weights are computed in float32 and cast to the input's
    dtype; the four corner products are summed in that dtype in the JAX
    order;
  * the batch is folded into one flat ``[B*H*W, C]`` row index, and the
    sampled ``[B*oh*ow, taps*C]`` operand (taps-major, then channels) goes
    through one product with the kernel reshaped to ``[taps*C, F]``.

The gathers are plain PyTorch, as they are XLA in the JAX package (no
Pallas kernel); the product is ``torch.matmul``. The kernel is dense over
the input channels: like the JAX ``DeformConv2D``, the layer has no
``groups``. ``weight`` is ``[F, C, k, k]`` (PyTorch's and Detectron2's
layout; the JAX kernel is its ``(k, k, C, F)`` transpose).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, get_norm

# The submodule that predicts the offsets, named as the JAX package's.
OFFSET_CONV = "conv_offset"


def _bilinear_sample(flat: torch.Tensor, h: int, w: int, ys: torch.Tensor, xs: torch.Tensor,
                     row_base: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear samples ``[P, C]`` of ``flat [B*H*W, C]`` at float32
    coordinates ``ys``, ``xs`` ``[P]`` of the images whose first rows are
    ``row_base [P]``. Each corner's index is clipped into the image, so images
    never read each other's rows; an outside corner's weight is zero."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = (ys - y0)[:, None]
    lx = (xs - x0)[:, None]

    def take(yi, xi, wgt):
        inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        v = torch.index_select(flat, 0, yc * w + xc + row_base)
        wgt = torch.where(inside[:, None], wgt, torch.zeros_like(wgt)).to(flat.dtype)
        return v * wgt

    return (take(y0, x0, (1 - ly) * (1 - lx))
            + take(y0, x0 + 1, (1 - ly) * lx)
            + take(y0 + 1, x0, ly * (1 - lx))
            + take(y0 + 1, x0 + 1, ly * lx))


def deform_conv(x: torch.Tensor, offset_field: torch.Tensor, weight: torch.Tensor,
                stride: int = 1, dilation: int = 1, deform_groups: int = 1,
                modulated: bool = False) -> torch.Tensor:
    """The deformable conv of ``x [B, C, H, W]`` with ``weight [F, C, k, k]``
    at the offsets (and, ``modulated``, the modulation logits) of
    ``offset_field [B, (2 or 3) * dg * k * k, oh, ow]``; returns ``[B, F, oh,
    ow]`` in ``x``'s dtype, NHWC in memory."""
    b, c, h, w = x.shape
    f, _, k, _ = weight.shape
    taps = k * k
    dg = deform_groups
    if c % dg:
        raise ValueError(f"{c} channels do not split into {dg} deformable groups")
    oh, ow = offset_field.shape[2:]
    field = offset_field.permute(0, 2, 3, 1)  # [B, oh, ow, channels]
    off32 = field[..., :2 * taps * dg].reshape(b, oh, ow, dg, taps, 2).float()
    mod = (torch.sigmoid(field[..., 2 * taps * dg:]).reshape(b, oh, ow, dg, taps)
           if modulated else None)

    dev = x.device
    base_y = torch.arange(oh, dtype=torch.float32, device=dev) * stride
    base_x = torch.arange(ow, dtype=torch.float32, device=dev) * stride
    tap = torch.arange(k, dtype=torch.float32, device=dev) - (k - 1) / 2.0
    tap_y = torch.repeat_interleave(tap, k) * dilation  # [taps]
    tap_x = tap.repeat(k) * dilation
    grid_y = base_y[:, None, None] + tap_y[None, None, :]  # [oh, 1, taps]
    grid_x = base_x[None, :, None] + tap_x[None, None, :]  # [1, ow, taps]
    row_base = torch.repeat_interleave(
        torch.arange(b, dtype=torch.int64, device=dev) * (h * w), oh * ow * taps)

    group_c = c // dg
    rows = x.permute(0, 2, 3, 1)  # [B, H, W, C]: a view of channels_last memory
    outs = []
    for g in range(dg):
        flat = rows[..., g * group_c:(g + 1) * group_c].reshape(-1, group_c)
        ys = grid_y[None] + off32[:, :, :, g, :, 0]  # [B, oh, ow, taps]
        xs = grid_x[None] + off32[:, :, :, g, :, 1]
        sampled = _bilinear_sample(flat, h, w, ys.reshape(-1), xs.reshape(-1), row_base)
        if mod is not None:
            sampled = sampled * mod[:, :, :, g, :].reshape(-1, 1).to(sampled.dtype)
        outs.append(sampled)
    sampled = outs[0] if dg == 1 else torch.cat(outs, dim=-1)  # [B*oh*ow*taps, C]
    wmat = weight.permute(2, 3, 1, 0).reshape(taps * c, f).to(x.dtype)
    out = torch.matmul(sampled.reshape(b * oh * ow, taps * c), wmat)
    return out.reshape(b, oh, ow, f).permute(0, 3, 1, 2)


class DeformConv2d(nn.Module):
    """A ``k`` x ``k`` deformable conv (v2 with ``modulated``) with its offset
    conv (``conv_offset``) and an optional norm after it (``norm``, named as
    a :class:`~.layers.Conv2d`'s, where Detectron2 keeps a deformable conv's
    norm too). ``forward(x)`` -> ``norm(deform_conv(x))``; no bias (the JAX
    callers, the trunk and SOLOv2's tower, use none), no activation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, deform_groups: int = 1,
                 modulated: bool = False, norm: str = ""):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.deform_groups = deform_groups
        self.modulated = modulated
        taps = kernel_size * kernel_size
        offset_channels = (3 if modulated else 2) * taps * deform_groups
        self.conv_offset = Conv2d(in_channels, offset_channels, kernel_size, stride=stride,
                                  dilation=dilation, bias=True)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.norm = get_norm(norm, out_channels)
        with torch.no_grad():
            nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def offset_field(self, x: torch.Tensor) -> torch.Tensor:
        """``conv_offset(x)`` in ``x``'s dtype, the bias added after the sum is
        rounded (module docstring)."""
        c = self.conv_offset
        field = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding, c.dilation)
        return field + c.bias.to(x.dtype).view(1, -1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = deform_conv(x, self.offset_field(x), self.weight, self.stride, self.dilation,
                          self.deform_groups, self.modulated)
        if self.norm is not None:
            out = self.norm(out)
        return out
