"""Shared building blocks: conv with norm and activation, FrozenBN, BN, GN, deconv.

Port of the JAX package's ``models/layers.py``. The
JAX package runs NHWC convs with HWIO kernels; here convs are PyTorch's
NCHW modules and the model keeps activations in ``channels_last`` memory, so
the tensor a layer produces is NHWC in memory either way. ``convert.py``
turns the JAX kernels into OIHW weights.

What carries over exactly:
  * D2's symmetric padding for stride-2 convs (``(k - 1) // 2 * dilation``
    on every side, where XLA's "SAME" would pad bottom/right-heavy);
  * FrozenBN folded to ``x * scale + shift``, the fold computed in float32
    and cast to the activation dtype, as the JAX module does;
  * GN (the JAX ``GroupNorm(32, eps=1e-5)``): statistics and the affine in
    float32 whatever the input dtype, the result cast to the input's dtype.
    Flax takes the variance as ``E[x^2] - E[x]^2``, ``F.group_norm`` as a
    two-pass (Welford) sum; in float32 they agree to ~1e-7 relative;
  * trainable BN (the JAX package's ``BatchNorm``; SyncBN is the same
    layer, as under its data mesh) with its semantics, not
    ``torch.nn.BatchNorm2d``'s: float32 batch moments with
    the biased variance ``max(E[x^2] - E[x]^2, 0)``, running statistics
    updated as ``0.9 * running + 0.1 * batch`` (``F.batch_norm`` would
    write the unbiased variance), eps 1e-5, the float32 result cast to the
    input's dtype;
  * a conv runs in its input's dtype (its weight and bias are cast, so
    float32 training parameters compute in bf16), as the JAX package's
    convs do.
The fused bottleneck tail is ported as the JAX package has it: a
``Conv2d`` built with ``fuse_residual=True`` (the caller read the user's
switch, ``ops.fused_residual.fused_epilogue_enabled``) whose shape passes
``epilogue_shape_supported`` computes ``forward(x, residual=sc)`` as one
:func:`~..ops.fused_residual.fused_conv1x1_bn_add_relu` with the folded
float32 FrozenBN affine. That rounds once in float32 where the unfused path
rounds after the conv, the affine and the add. The module, its parameters
and buffers are the same either way, so a state dict loads into both. Not
ported: the JAX package's ``D2TPU_DOT_TAIL`` branch, a TPU dead end.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_residual


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics and affine (never trained).

    The four tensors are buffers, named as in Detectron2's checkpoints.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def folded_affine(self):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return scale, shift

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.folded_affine()
        shape = (1, -1, 1, 1)
        return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class GroupNorm(nn.GroupNorm):
    """Group normalization over 32 groups, computed in float32 (see the
    module docstring); ``weight`` and ``bias`` are trained."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def batch_moments(x: torch.Tensor):
    """Per-channel float32 mean and biased variance of ``[N, C, H, W]``,
    as the JAX package's BN takes them (the fast variance)."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    return mean, var


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    _RECOMPUTE.depth = getattr(_RECOMPUTE, "depth", 0) + 1
    try:
        yield
    finally:
        _RECOMPUTE.depth -= 1


def recomputing() -> bool:
    """True inside a ``torch.utils.checkpoint`` recomputation that runs under
    :func:`recompute_context` (on this thread)."""
    return getattr(_RECOMPUTE, "depth", 0) > 0


def recompute_context():
    """``context_fn`` of a non-reentrant ``torch.utils.checkpoint``: nothing in
    the forward pass, :func:`recomputing` true in the recomputation, where a
    trainable BN normalizes with the same batch moments but leaves its running
    statistics alone (they were updated once, in the forward pass)."""
    return contextlib.nullcontext(), _recomputing()


class BatchNorm2d(nn.Module):
    """Trainable BN with the JAX package's semantics (module docstring): batch
    moments in training, running statistics otherwise. ``weight`` and
    ``bias`` are trained; ``running_mean`` and ``running_var`` are float32
    buffers, Detectron2's names."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = batch_moments(x)
            if not recomputing():
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x.float() - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``softplus``: ``logaddexp(x, 0)``, in ``x``'s dtype."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x * tanh(softplus(x))`` in ``x``'s dtype (the JAX package's lambda)."""
    return x * torch.tanh(softplus(x))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``0.1 * x`` (the JAX package's ``leaky_relu``,
    slope 0.1)."""
    return F.leaky_relu(x, 0.1)


# The activations a Conv2d applies after its norm, by the config's name.
ACTIVATIONS = {"relu": F.relu, "mish": mish, "leaky_relu": leaky_relu}


def get_norm(norm: str, channels: int) -> Optional[nn.Module]:
    """The norm layer the config names: none, FrozenBN, BN (SyncBN is BN on
    one card) or GN."""
    if norm == "":
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm2d(channels)
    if norm in ("BN", "SyncBN"):
        return BatchNorm2d(channels)
    if norm == "GN":
        return GroupNorm(channels)
    raise NotImplementedError(f"norm '{norm}' is not ported")


class Conv2d(nn.Conv2d):
    """Conv + optional norm + optional activation (:data:`ACTIVATIONS`), with
    D2's padding rule.

    ``bias`` defaults to "no norm => bias", the D2 convention. Padding is
    ``(k - 1) // 2 * dilation`` on every side: the same as "SAME" at stride
    1 for odd kernels, and D2's symmetric rule at stride 2.
    ``fuse_residual``: take the fused tail for ``forward(x, residual=...)``
    when the conv's shape allows it (see the module docstring).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 norm: str = "", activation: str = "", bias: Optional[bool] = None,
                 fuse_residual: bool = False):
        if bias is None:
            bias = norm == ""
        super().__init__(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=(kernel_size - 1) // 2 * dilation, dilation=dilation,
            groups=groups, bias=bias,
        )
        self.norm = get_norm(norm, out_channels)
        if activation not in ("",) + tuple(ACTIVATIONS):
            raise NotImplementedError(f"activation '{activation}' is not ported "
                                      f"(ported: {sorted(ACTIVATIONS)})")
        self.activation = activation
        self.fuse_residual = fuse_residual and fused_residual.epilogue_shape_supported(
            kernel_size, stride, groups, dilation, norm, bias)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``residual`` given: ``relu(norm(conv(x)) + residual)``."""
        if residual is not None and self.fuse_residual:
            scale, shift = self.norm.folded_affine()
            return fused_residual.fused_conv1x1_bn_add_relu(
                x, self.weight.to(x.dtype), scale, shift, residual)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                     self.dilation, self.groups)
        if self.norm is not None:
            x = self.norm(x)
        if residual is not None:
            return F.relu(x + residual)
        if self.activation:
            x = ACTIVATIONS[self.activation](x)
        return x


class ConvTranspose2d(nn.ConvTranspose2d):
    """Transposed conv (the mask head's 2x deconv), run in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    """Linear layer run in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max pool with D2's symmetric ``(window - 1) // 2`` padding."""
    return F.max_pool2d(x, window, stride, padding=(window - 1) // 2)
