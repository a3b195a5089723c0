"""The port's ROI-kernel ablations (``tools/exp_roi_variants.py``) against
the JAX package's ``tools/exp_roi_variants.py`` on the CPU.

Each variant's plain version is held against the JAX tool's kernel body
(``make_kernel``) run through ``pl.pallas_call(..., interpret=True)``, with
this file's own copy of the tool's grid spec (its ``run`` is jitted for the
TPU and takes no ``interpret``). Small size: b=1, n=8, P=16, C=32 (one
32-channel tile, where the port's per-tile "first element" is the JAX
tool's channel 0), S=7. Variants that move values without arithmetic
(``nodma``, ``onedma``, ``nodot``) must be equal; the others sum float32
products in other orders and round once: float32 to 1e-5 of the largest
value, bfloat16 to one bf16 ulp of each value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from detectron2_tensorflow_tpu_torch.models.poolers import (
    roi_patch_interpolate,
    skip_tier_class,
)
from detectron2_tensorflow_tpu_torch.tools import exp_roi_variants as tv
from tools.exp_roi_variants import GROUP, make_kernel

B, N, P, C, S, HTOT, WM = 1, 8, 16, 32, 7, 40, 40
EXACT = ("nodma", "onedma", "nodot")


@functools.partial(jax.jit, static_argnames=("variant",))
def jax_variant(stacked, starts, wy, wx, variant):
    """The JAX tool's ``run`` (tools/exp_roi_variants.py:112-138) in
    interpret mode."""
    bsz, n, s, p = wy.shape
    c = stacked.shape[-1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(bsz, n // GROUP),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((1, GROUP, s, p), lambda b, j, *_: (b, j, 0, 0)),
            pl.BlockSpec((1, GROUP, s, p), lambda b, j, *_: (b, j, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, GROUP, s, s, c), lambda b, j, *_: (b, j, 0, 0, 0)),
        scratch_shapes=[
            pltpu.VMEM((2, GROUP, p, p, c), stacked.dtype),
            pltpu.SemaphoreType.DMA((2, GROUP)),
        ],
    )
    return pl.pallas_call(
        make_kernel(variant, s, p, c),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((bsz, n, s, s, c), stacked.dtype),
        interpret=True,
    )(jnp.moveaxis(starts, 2, 0), stacked, wy, wx)


def _inputs(seed, b=B, n=N, c=C):
    """The tool's input rule at a small size: normal plane, rows in
    [0, Htot - P), tx multiples of 8, tier class 0, uniform weights."""
    rng = np.random.default_rng(seed)
    plane = rng.standard_normal((b, HTOT, WM, c)).astype(np.float32)
    rows = rng.integers(0, HTOT - P, (b, n))
    tx = rng.integers(0, (WM - P) // 8 + 1, (b, n)) * 8
    starts = np.stack([rows, tx, np.zeros_like(rows)], -1).astype(np.int32)
    wy = rng.uniform(0, 1, (b, n, S, P)).astype(np.float32)
    wx = rng.uniform(0, 1, (b, n, S, P)).astype(np.float32)
    return plane, starts, wy, wx


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(tv.VARIANTS))
def test_variant_matches_jax_tool_interpret(variant, dtype):
    plane, starts, wy, wx = _inputs(3)
    jplane = jnp.asarray(plane, jnp.dtype(dtype))
    want = np.asarray(jax_variant(jplane, jnp.asarray(starts), jnp.asarray(wy), jnp.asarray(wx),
                                  variant).astype(jnp.float32))
    tplane = torch.from_numpy(np.array(jplane.astype(jnp.float32))).to(getattr(torch, dtype))
    out = tv.roi_patch_variant(tplane, torch.from_numpy(starts), torch.from_numpy(wy),
                               torch.from_numpy(wx), variant)
    assert out.shape == (B, N, S, S, C) and out.dtype == tplane.dtype
    got = out.float().numpy()
    if variant in EXACT:
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        assert (np.abs(got - want) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()


def test_full_variant_is_the_production_plain_version():
    plane, starts, wy, wx = (torch.from_numpy(a) for a in _inputs(4, b=2, n=12, c=40))
    starts[1, 3, 2] = skip_tier_class(P)  # a skipped slot writes zeros in every variant
    want = roi_patch_interpolate(plane, starts, wy, wx)
    assert torch.equal(tv.roi_patch_variant(plane, starts, wy, wx, "full"), want)
    assert torch.equal(tv.roi_patch_variant(plane, starts, wy, wx, "noswap"), want.transpose(2, 3))
    for variant in tv.VARIANTS:
        assert not tv.roi_patch_variant(plane, starts, wy, wx, variant)[1, 3].any(), variant


def test_first_element_variants_are_per_channel_tile():
    """With C = 40 the second 32-channel tile (channels 32-39) takes its own
    first channel, 32: the GPU block's "first element"."""
    plane, starts, wy, wx = (torch.from_numpy(a) for a in _inputs(5, b=1, n=8, c=40))
    full = roi_patch_interpolate(plane, starts, wy, wx)
    nowrite = tv.roi_patch_variant(plane, starts, wy, wx, "nowrite")
    onedma = tv.roi_patch_variant(plane, starts, wy, wx, "onedma")
    for c0, chans in ((0, slice(0, 32)), (32, slice(32, 40))):
        assert torch.equal(nowrite[..., chans], full[:, :, :1, :1, c0, None].expand_as(
            nowrite[..., chans]))
        for i in range(8):
            g = i // tv.GROUP * tv.GROUP
            row, tx = starts[0, g, 0], starts[0, g, 1]
            assert bool((onedma[0, i, ..., chans] == plane[0, row, tx, c0]).all())


def test_unknown_variant_raises():
    plane, starts, wy, wx = (torch.from_numpy(a) for a in _inputs(6))
    with pytest.raises(ValueError):
        tv.roi_patch_variant(plane, starts, wy, wx, "nothing")
    with pytest.raises(RuntimeError):
        tv.roi_patch_variant(plane.to("meta"), starts, wy, wx, "full")
