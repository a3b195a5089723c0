"""Ablations of the ROI forward kernel's body, timed on the card.

    python -m detectron2_tensorflow_tpu_torch.tools.exp_roi_variants [batch]

Port of the JAX package's ``tools/exp_roi_variants.py``: the same shapes
(``batch`` images, default 32, of 1000 ROIs each, P=32, C=256, S=14, a bf16
plane of 402 x 344, random rows, ``tx`` multiples of 8, uniform hat
weights), every variant timed with CUDA events after warm-up and printed as
ms per batch and ns per ROI, beside the card's name and power limit. Each
variant is a compile-time instantiation of the production kernel
``roi_patch_fwd_kernel`` in ``csrc/roi_patch.cu`` (``full`` is the
production kernel itself), launched through :func:`roi_patch_variant`; the
source's header says what each one skips. The inputs are drawn on the card
from a seeded generator.

:func:`roi_patch_variant` dispatches on the device of its input: a CPU
tensor goes to the plain version :func:`roi_patch_variant_reference`, a CUDA
tensor to the kernel (``roi_patch_variant.launches`` counts its launches).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from .. import kernels
from ..models.poolers import (
    _DTYPE_CODES,
    _check_plan,
    roi_patch_interpolate_reference,
    skip_tier_class,
)

# Variant name -> the `variant` code of roi_patch_variant_launch.
VARIANTS = {"nodma": 1, "onedma": 2, "nodot": 3, "m1only": 4, "noswap": 5, "nowrite": 6,
            "full": 0}
GROUP = 4  # ROIs per group of the TPU tool's grid step (onedma reads one patch per group)
TILE = 32  # channels per tile of csrc/roi_patch.cu's forward: "first element" is per tile


def _patches(plane: torch.Tensor, starts: torch.Tensor, p: int) -> torch.Tensor:
    """``[B, N, P, P, C]`` patches at ``starts``, in the plane's dtype."""
    b, htot, wm, _ = plane.shape
    ar = torch.arange(p, device=plane.device)
    bidx = torch.arange(b, device=plane.device)[:, None, None, None]
    st = starts.long()
    rows = torch.clamp(st[..., 0, None] + ar, 0, htot - 1)
    cols = torch.clamp(st[..., 1, None] + ar, 0, wm - 1)
    return plane[bidx, rows[..., :, None], cols[..., None, :]]


def roi_patch_variant_reference(plane: torch.Tensor, starts: torch.Tensor, wy: torch.Tensor,
                                wx: torch.Tensor, variant: str) -> torch.Tensor:
    """Plain PyTorch version of each ablation ``[B, N, S, S, C]``, in the
    plane's dtype; skip-sentinel slots are exact zeros, as in the kernel.

    ``c0(c)`` is the first channel of channel ``c``'s 32-channel tile.
    ``full``: :func:`roi_patch_interpolate_reference`; ``noswap``: the same
    values at ``[u, o, c]``; ``nowrite``: ``full[o=0, u=0, c0(c)]`` everywhere;
    ``m1only``: ``a[:, :S]`` of ``a = Wy . patch`` (float32, one rounding);
    ``nodot``: ``patch[:S, :S]``; ``onedma``: ``plane[row, tx, c0(c)]`` of the
    first ROI of the slot's group of 4; ``nodma``: ones.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant '{variant}' (one of {sorted(VARIANTS)})")
    b, _, _, c = plane.shape
    n, s, p = wy.shape[1:]
    dev = plane.device
    c0 = torch.arange(c, device=dev) // TILE * TILE
    if variant in ("full", "noswap", "nowrite"):
        out = roi_patch_interpolate_reference(plane, starts, wy, wx)
        if variant == "noswap":
            out = out.transpose(2, 3)
        elif variant == "nowrite":
            out = out[:, :, :1, :1, c0].expand(b, n, s, s, c)
    elif variant == "nodma":
        out = torch.ones((b, n, s, s, c), dtype=plane.dtype, device=dev)
    elif variant == "onedma":
        first = starts[:, torch.arange(n, device=dev) // GROUP * GROUP]
        out = _patches(plane, first, 1)[:, :, :, :, c0].expand(b, n, s, s, c)
    elif variant == "nodot":
        out = _patches(plane, starts, p)[:, :, :s, :s]
    else:  # m1only
        a = torch.einsum("bnop,bnpqc->bnoqc", wy.to(plane.dtype).float(),
                         _patches(plane, starts, p).float())
        out = a[:, :, :, :s].to(plane.dtype)
    skip = starts[..., 2] >= skip_tier_class(p)
    out = torch.where(skip[..., None, None, None], torch.zeros_like(out), out)
    return out.contiguous()


def _variant_cuda(plane, starts, wy, wx, variant):
    what = "roi_patch_variant"
    if plane.dim() != 4 or not plane.is_contiguous() or plane.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: plane must be a contiguous float32/bfloat16 [B, Htot, Wm, C]")
    b, htot, wm, c = plane.shape
    n, s, p = _check_plan(what, starts, wy, wx, b, plane.device)
    lib = kernels.load("roi_patch")
    out = torch.empty((b, n, s, s, c), dtype=plane.dtype, device=plane.device)
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    rc = lib.roi_patch_variant_launch(
        plane.data_ptr(), starts.data_ptr(), wy.data_ptr(), wx.data_ptr(), out.data_ptr(),
        b, n, htot, wm, c, p, s, skip_tier_class(p), _DTYPE_CODES[plane.dtype],
        VARIANTS[variant], ctypes.c_void_p(stream),
    )
    roi_patch_variant.launches += 1
    kernels.check(rc, "roi_patch_variant_launch")
    return out


def roi_patch_variant(plane: torch.Tensor, starts: torch.Tensor, wy: torch.Tensor,
                      wx: torch.Tensor, variant: str) -> torch.Tensor:
    """The ablation ``variant`` of the ROI forward kernel on the plan
    ``(starts, wy, wx)``, as :func:`~..models.poolers.roi_patch_interpolate`
    takes it. CPU tensors take :func:`roi_patch_variant_reference`; CUDA
    tensors the kernel. Anything else raises."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant '{variant}' (one of {sorted(VARIANTS)})")
    dev = plane.device.type
    if dev == "cpu":
        return roi_patch_variant_reference(plane, starts, wy, wx, variant)
    if dev == "cuda":
        return _variant_cuda(plane, starts, wy, wx, variant)
    raise RuntimeError(f"roi_patch_variant: no implementation for device '{dev}'")


roi_patch_variant.launches = 0


def make_inputs(b: int, device, generator: torch.Generator, n: int = 1000, p: int = 32,
                c: int = 256, s: int = 14, htot: int = 402, wm: int = 344):
    """The JAX tool's inputs: a bf16 normal plane ``[b, htot, wm, c]``, rows
    uniform in ``[0, htot - p)``, ``tx`` multiples of 8 in ``[0, wm - p]``,
    tier class 0, uniform ``wy``/``wx`` ``[b, n, s, p]``."""
    kw = dict(device=device, generator=generator)
    plane = torch.randn((b, htot, wm, c), dtype=torch.bfloat16, **kw)
    rows = torch.randint(0, htot - p, (b, n), **kw)
    txs = torch.randint(0, (wm - p) // 8 + 1, (b, n), **kw) * 8
    starts = torch.stack([rows, txs, torch.zeros_like(rows)], -1).to(torch.int32).contiguous()
    wy = torch.rand((b, n, s, p), **kw)
    wx = torch.rand((b, n, s, p), **kw)
    return plane, starts, wy, wx


def time_variants(plane, starts, wy, wx, iters: int = 20, warmup: int = 3):
    """``{variant: ms per call}`` of every variant, CUDA events after warm-up."""
    times = {}
    for variant in VARIANTS:
        for _ in range(warmup):
            roi_patch_variant(plane, starts, wy, wx, variant)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            roi_patch_variant(plane, starts, wy, wx, variant)
        end.record()
        torch.cuda.synchronize()
        times[variant] = start.elapsed_time(end) / iters
    return times


def main(argv) -> dict:
    """Time every variant at ``argv[0]`` images (default 32); returns
    ``{variant: ms per batch}``."""
    if not torch.cuda.is_available():
        raise SystemExit("exp_roi_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    b = int(argv[0]) if argv else 32
    plane, starts, wy, wx = make_inputs(b, dev, torch.Generator(device=dev).manual_seed(0))
    n = starts.shape[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}; b={b} n={n} P={wy.shape[3]} C={plane.shape[3]} "
          f"S={wy.shape[2]} plane {tuple(plane.shape)} bf16")
    times = time_variants(plane, starts, wy, wx)
    for variant, ms in times.items():
        print(f"{variant:8s} {ms:8.3f} ms/batch  {ms * 1e6 / (b * n):7.1f} ns/ROI")
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
