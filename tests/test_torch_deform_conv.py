"""The port's deformable convolution (``models/deform_conv.py``) against the
JAX package's ``DeformConv2D`` on the CPU.

The cases of ``tests/test_deform_conv.py`` on the port (zero offsets equal a
conv, v2 at zero offsets is half a conv, the strided shape, a batch equals
its images one by one with samples pushed off the map, the bf16 drift), then
the port against JAX on the same seeded inputs and weights, with real
offsets (a random ``conv_offset`` whose bias pushes samples between pixels
and off the map), over v1 and v2, deform groups 1 and 2, stride 1 and 2,
dilation 1 and 2: the float32 output and the gradients of ``x``, the
kernel and ``conv_offset`` within 1e-5 of each tensor's largest magnitude;
in bf16 (inputs, weights and arithmetic) the output within BF16_TOL of its
largest magnitude, four bf16 ulps (4 x 2^-8; the repo's bf16 parity of a
whole trunk, ``tests/test_torch_gn.py``, allows 10%): v1 comes out
bit-equal, v2 within 0.8% (measured), as XLA's logistic and torch's
sigmoid may round a modulation a bf16 ulp apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detectron2_tensorflow_tpu.models.deform_conv import DeformConv2D
from detectron2_tensorflow_tpu_torch.models.deform_conv import DeformConv2d, deform_conv
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = 1e-5
BF16_TOL = 4 * 2.0 ** -8


def nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).to(dtype)


def port_layer(params, c, f, stride=1, dilation=1, deform_groups=1, modulated=False):
    """A port ``DeformConv2d`` holding the JAX layer's ``params``."""
    layer = DeformConv2d(c, f, 3, stride=stride, dilation=dilation,
                         deform_groups=deform_groups, modulated=modulated)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(params["kernel"]).transpose(3, 2, 0, 1)))
        layer.conv_offset.weight.copy_(torch.from_numpy(
            np.asarray(params["conv_offset"]["kernel"]).transpose(3, 2, 0, 1)))
        layer.conv_offset.bias.copy_(torch.from_numpy(np.asarray(params["conv_offset"]["bias"])))
    return layer


def real_offsets(params, rng, kernel_std=0.5, bias=4.0):
    """``params`` with a random ``conv_offset``: a kernel of ``kernel_std`` and a
    bias uniform in ``[-bias, bias]``, which pushes samples between pixels and
    off the map."""
    p = jax.tree_util.tree_map(np.asarray, params)
    p = jax.tree_util.tree_map(np.array, p)
    ok = p["conv_offset"]["kernel"]
    p["conv_offset"]["kernel"] = (rng.standard_normal(ok.shape) * kernel_std).astype(np.float32)
    p["conv_offset"]["bias"] = rng.uniform(-bias, bias, p["conv_offset"]["bias"].shape).astype(
        np.float32)
    return p


# -- the JAX tests' cases on the port ---------------------------------------------------

@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_zero_offset_equals_plain_conv(stride, dilation):
    """At zero offsets (the JAX initialization) the layer is a plain 3x3 conv
    with padding ``dilation``, strided or dilated."""
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    x = nchw(rng.standard_normal((1, 9, 11, 6)).astype(np.float32))
    layer = DeformConv2d(6, 4, 3, stride=stride, dilation=dilation)
    want = F.conv2d(x, layer.weight, None, stride, dilation, dilation)
    np.testing.assert_allclose(layer(x).detach().numpy(), want.detach().numpy(), atol=1e-5)


def test_modulated_zero_offset_is_half_conv():
    rng = np.random.default_rng(1)
    torch.manual_seed(1)
    x = nchw(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    layer = DeformConv2d(4, 3, 3, modulated=True)
    want = 0.5 * F.conv2d(x, layer.weight, None, 1, 1)
    np.testing.assert_allclose(layer(x).detach().numpy(), want.detach().numpy(), atol=1e-5)


def test_strided_deform_shape():
    layer = DeformConv2d(8, 8, 3, stride=2, deform_groups=2)
    assert layer.conv_offset.weight.shape == (2 * 9 * 2, 8, 3, 3)
    assert tuple(layer(torch.zeros(2, 8, 16, 16)).shape) == (2, 8, 8, 8)


def test_batched_equals_per_image_with_real_offsets():
    """The folded batch keeps images apart: a batch of 2 equals its images one
    by one, with samples pushed off the map; gradients reach the offsets and
    the kernel."""
    rng = np.random.default_rng(2)
    torch.manual_seed(2)
    x = nchw(rng.standard_normal((2, 10, 12, 6)).astype(np.float32))
    layer = DeformConv2d(6, 5, 3, modulated=True)
    with torch.no_grad():
        layer.conv_offset.weight.copy_(torch.randn(layer.conv_offset.weight.shape) * 0.5)
        layer.conv_offset.bias.uniform_(-4, 4)
    full = layer(x)
    for i in range(2):
        np.testing.assert_allclose(full[i].detach().numpy(), layer(x[i:i + 1])[0].detach().numpy(),
                                   atol=1e-5)
    assert torch.isfinite(full).all()
    (full ** 2).sum().backward()
    assert float(layer.conv_offset.weight.grad.abs().sum()) > 0
    assert float(layer.weight.grad.abs().sum()) > 0


def test_bf16_drift_vs_f32_is_bounded():
    """The JAX test's case on the port, its weights and input included (the
    JAX layer's init from ``PRNGKey(0)``, then its seeded offset conv): bf16
    against float32 within the JAX test's bounds."""
    rng = np.random.default_rng(3)
    x32 = rng.standard_normal((2, 12, 14, 8)).astype(np.float32)
    params = DeformConv2D(features=8, kernel_size=3, modulated=True).init(
        jax.random.PRNGKey(0), jnp.asarray(x32))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    ok = params["conv_offset"]["kernel"]
    params["conv_offset"]["kernel"] = (rng.standard_normal(ok.shape) * 0.3).astype(np.float32)
    params["conv_offset"]["bias"] = rng.uniform(
        -2, 2, params["conv_offset"]["bias"].shape).astype(np.float32)
    layer = port_layer(params, 8, 8, modulated=True)
    x = nchw(x32)
    out32 = layer(x).detach().numpy()
    out16 = layer(x.to(torch.bfloat16)).float().detach().numpy()
    err = np.abs(out16 - out32)
    scale = np.abs(out32).mean() + 1e-6
    assert err.max() / scale < 0.35, (err.max(), scale)
    assert err.mean() / scale < 0.02, (err.mean(), scale)


# -- the port against JAX ---------------------------------------------------------------

CASES = {
    "v1": dict(modulated=False, deform_groups=1, strides=1, dilation=1),
    "v2": dict(modulated=True, deform_groups=1, strides=1, dilation=1),
    "v1_groups2": dict(modulated=False, deform_groups=2, strides=1, dilation=1),
    "v2_groups2_stride2": dict(modulated=True, deform_groups=2, strides=2, dilation=1),
    "v1_stride2": dict(modulated=False, deform_groups=1, strides=2, dilation=1),
    "v2_dilation2": dict(modulated=True, deform_groups=1, strides=1, dilation=2),
    "v1_groups2_dilation2": dict(modulated=False, deform_groups=2, strides=1, dilation=2),
}


def jax_case(name, seed, dtype=jnp.float32):
    """The JAX layer of case ``name`` (6 -> 5 channels, or 8 -> 6 with 2
    groups), its real-offset params and an input ``[2, 11, 13, C]``."""
    kw = CASES[name]
    c, f = (8, 6) if kw["deform_groups"] > 1 else (6, 5)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 11, 13, c)).astype(np.float32)
    m = DeformConv2D(features=f, kernel_size=3, dtype=dtype, **kw)
    params = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return m, real_offsets(params, rng), x, c, f, kw


def port_of(params, c, f, kw):
    return port_layer(params, c, f, stride=kw["strides"], dilation=kw["dilation"],
                      deform_groups=kw["deform_groups"], modulated=kw["modulated"])


def close(got, want, tol, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())
    assert err <= tol * scale, f"{name}: max |err| {err} > {tol} of {scale}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    m, params, x, c, f, kw = jax_case(name, seed=10)
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    layer = port_of(params, c, f, kw)
    got = layer(nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    close(got, want, F32_TOL, name)
    # samples really fell between pixels and off the map
    off = layer.offset_field(nchw(x)).detach()
    assert float((off - off.round()).abs().max()) > 0.1 and float(off.abs().max()) > 2


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    """The gradients of ``x``, the kernel and ``conv_offset`` (kernel and bias)
    of ``sum(out * g)`` for a seeded ``g``."""
    m, params, x, c, f, kw = jax_case(name, seed=20)
    out_shape = m.apply({"params": params}, jnp.asarray(x)).shape
    g = np.random.default_rng(21).standard_normal(out_shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(m.apply({"params": p}, xx) * g)

    jp, jx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    layer = port_of(params, c, f, kw)
    tx = nchw(x).requires_grad_(True)
    (layer(tx) * nchw(g)).sum().backward()
    close(tx.grad.permute(0, 2, 3, 1).numpy(), jx, F32_TOL, "x")
    close(layer.weight.grad.numpy(), np.asarray(jp["kernel"]).transpose(3, 2, 0, 1), F32_TOL,
          "kernel")
    close(layer.conv_offset.weight.grad.numpy(),
          np.asarray(jp["conv_offset"]["kernel"]).transpose(3, 2, 0, 1), F32_TOL,
          "conv_offset kernel")
    close(layer.conv_offset.bias.grad.numpy(), jp["conv_offset"]["bias"], F32_TOL,
          "conv_offset bias")


@pytest.mark.parametrize("name", ["v1", "v2_groups2_stride2", "v2_dilation2"])
def test_bf16_forward_matches_jax(name):
    """bf16 inputs and weights, bf16 arithmetic in both (the offsets rounded to
    bf16 before the float32 cast, the corner sums in bf16, the product
    accumulated in float32): the outputs within BF16_TOL of their largest."""
    m, params, x, c, f, kw = jax_case(name, seed=30, dtype=jnp.bfloat16)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(m.apply({"params": params}, jnp.asarray(xb, jnp.bfloat16)), np.float32)
    layer = port_of(params, c, f, kw)
    got = layer(nchw(xb, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    close(got.float().permute(0, 2, 3, 1).detach().numpy(), want, BF16_TOL, name)


def test_functional_takes_an_offset_field():
    """``deform_conv`` of a given offset field: a whole-pixel offset of (+1, 0)
    on every tap shifts a plain conv's output up by one row, the last row
    reading the zero padding."""
    rng = np.random.default_rng(4)
    x = nchw(rng.standard_normal((1, 7, 9, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
    field = torch.zeros(1, 18, 7, 9)
    field[:, 0::2] = 1.0  # dy = +1 for every tap
    got = deform_conv(x, field, w)
    plain = F.conv2d(F.pad(x, (0, 0, 0, 1)), w, None, 1, 1)[:, :, 1:]
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)


def test_deform_groups_must_divide_the_channels():
    with pytest.raises(ValueError, match="deformable groups"):
        deform_conv(torch.zeros(1, 6, 5, 5), torch.zeros(1, 4 * 18, 5, 5),
                    torch.zeros(4, 6, 3, 3), deform_groups=4)
