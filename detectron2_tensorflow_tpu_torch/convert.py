"""Carry the JAX package's weights, or a Detectron2 checkpoint, into the
port's ``state_dict``.

:func:`convert_d2_weights` reads a Detectron2 state dict (``.pkl`` model-zoo
files or ``.pth`` files, through :func:`load_state_dict`). The port's
modules carry Detectron2's names and PyTorch's layouts (a C4 model's
3-stage trunk ``backbone.res{2,3,4}`` and its head ``roi_heads.res5.{b}``,
RetinaNet's ``head.*`` and ``backbone.top_block.*`` and a cascade's
``roi_heads.box_head.{k}.*`` included), so only the box head's ``fc1`` (each
cascade stage's) changes: Detectron2 flattens the pooled features in (c, h,
w) order, the port in (h, w, c), so its columns are permuted.

:func:`convert_variables` reads the JAX model's ``variables``, nested dicts
of numpy (or array-like) values with a ``params`` and a ``frozen``
collection, and a ``batch_stats`` one when the model has BN. Output: a dict of float32 tensors named as the port's modules
(Detectron2's names), ready for ``build_model(cfg, state_dict=...)``. The
JAX trunk (``backbone``) is the port's ``backbone.bottom_up`` under an FPN
and ``backbone`` without a neck (C4, DC5); the C4 ROI head's module-level
``res5`` is ``roi_heads.res5``; RetinaNet's ``neck/top_block_p{6,7}`` are
``backbone.top_block.p{6,7}`` and its ``head/{cls,bbox}_subnet_{i}`` the
towers' ``head.{cls,bbox}_subnet.{2i}``; a cascade's ``box_heads_{k}`` and
``box_predictors_{k}`` are ``roi_heads.box_head.{k}`` and
``roi_heads.box_predictor.{k}``. A single-stage model's ``loss_normalizer``
is the JAX ``initial_state``'s 100, as for a Detectron2 checkpoint.

Layout changes:
  * conv kernels HWIO -> OIHW;
  * FC kernels ``[in, out]`` -> ``[out, in]``. The box head's ``fc1``
    needs no row reordering: the port flattens the pooled ``[S, S, C]``
    features in (h, w, c) order, as the JAX package does. (A Detectron2
    checkpoint flattens (c, h, w); loading one needs that permutation.)
  * the mask head's and the keypoint head's deconvs (``deconv``,
    ``score_lowres``): the JAX package's ``ConvTranspose2D`` applies
    the kernel as stored, PyTorch's ``ConvTranspose2d`` applies it
    spatially flipped with in/out swapped, so the kernel is flipped in H and
    W and laid out ``[in, out, kh, kw]``;
  * the ``frozen`` FrozenBN collection (scale, bias, mean, var) becomes the
    ``norm`` buffers (weight, bias, running_mean, running_var);
  * a GN layer's ``GroupNorm_0/GroupNorm_0/{scale,bias}`` (the JAX
    wrapper module and the GroupNorm module inside it) becomes the conv's
    ``norm.weight`` / ``norm.bias``, and so does a BN layer's
    ``BatchNorm_0/BatchNorm_0/{scale,bias}``; the ``batch_stats``
    collection (BN's ``mean``, ``var``) becomes ``norm.running_mean`` /
    ``norm.running_var``. Basic blocks (R18/R34) keep their JAX
    names (``conv1``, ``conv2``, ``shortcut``), which are the port's.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from .models.meta_arch.single_stage import INITIAL_LOSS_NORMALIZER

_PREFIX = {
    "neck": "backbone",
    "res5": "roi_heads.res5",
    "rpn_head": "proposal_generator.rpn_head",
    "box_heads_0": "roi_heads.box_head",
    "box_predictors_0": "roi_heads.box_predictor",
    "mask_head": "roi_heads.mask_head",
    "keypoint_head": "roi_heads.keypoint_head",
}
_FROZEN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_AFFINE = {"scale": "weight", "bias": "bias"}
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}
_NORM_WRAPPERS = (["GroupNorm_0", "GroupNorm_0"], ["BatchNorm_0", "BatchNorm_0"])
# Model state that no Detectron2 checkpoint holds, at its initial value.
_MODEL_STATE = {"loss_normalizer": INITIAL_LOSS_NORMALIZER}


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if hasattr(v, "items"):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v, dtype=np.float32)


_TOWER = re.compile(r"^(cls|bbox)_subnet_(\d+)$")


def _module_name(path: Tuple[str, ...], prefix: Dict[str, str]) -> str:
    top, *rest = path
    if top not in prefix:
        raise KeyError(f"no port counterpart for JAX parameter {'/'.join(path)}")
    if top == "neck" and rest and rest[0].startswith("top_block_"):
        rest = ["top_block", rest[0][len("top_block_"):]] + rest[1:]
    tower = _TOWER.match(rest[0]) if top == "head" and rest else None
    if tower:  # a Sequential of (conv, ReLU) pairs
        rest = [f"{tower.group(1)}_subnet", str(2 * int(tower.group(2)))] + rest[1:]
    return ".".join([prefix[top]] + rest)


def _kernel(arr: np.ndarray, deconv: bool) -> np.ndarray:
    if arr.ndim == 2:  # Dense [in, out]
        return arr.T
    if deconv:  # JAX ConvTranspose [kh, kw, in, out] -> [in, out, kh, kw], flipped
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW


def convert_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX ``variables`` -> the port's float32 ``state_dict``. The model has an FPN when ``params`` holds a ``neck``
    (the identity neck has no parameters), is a cascade when it holds
    ``box_heads_1`` and a single-stage model when it holds a ``head``."""
    params = variables["params"]
    neck = "neck" in params
    prefix = {**_PREFIX, "backbone": "backbone.bottom_up" if neck else "backbone",
              "head": "head"}
    if "box_heads_1" in params:
        for k in range(sum(name.startswith("box_heads_") for name in params)):
            prefix[f"box_heads_{k}"] = f"roi_heads.box_head.{k}"
            prefix[f"box_predictors_{k}"] = f"roi_heads.box_predictor.{k}"
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables["params"]):
        *mod, leaf = path
        if len(mod) > 2 and mod[-2:] in _NORM_WRAPPERS:
            name = _module_name(tuple(mod[:-2]), prefix)
            out[f"{name}.norm.{_AFFINE[leaf]}"] = torch.from_numpy(arr.copy())
            continue
        deconv = mod[-1] == "deconv"
        if mod[-1] in ("conv", "deconv") and len(mod) > 2:
            mod = mod[:-1]  # the inner conv module of a Conv2D / ConvTranspose2D
        name = _module_name(tuple(mod), prefix)
        if leaf == "kernel":
            out[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(_kernel(arr, deconv)))
        elif leaf == "bias":
            out[f"{name}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"unexpected JAX parameter {'/'.join(path)}")
    for path, arr in _flatten(variables.get("frozen", {})):
        *mod, bn, leaf = path
        if not bn.startswith("FrozenBatchNorm"):
            raise KeyError(f"unexpected frozen variable {'/'.join(path)}")
        name = _module_name(tuple(mod), prefix)
        out[f"{name}.norm.{_FROZEN[leaf]}"] = torch.from_numpy(arr.copy())
    for path, arr in _flatten(variables.get("batch_stats", {})):
        *mod, leaf = path
        if len(mod) < 3 or mod[-2:] != ["BatchNorm_0", "BatchNorm_0"]:
            raise KeyError(f"unexpected batch_stats variable {'/'.join(path)}")
        name = _module_name(tuple(mod[:-2]), prefix)
        out[f"{name}.norm.{_BATCH_STATS[leaf]}"] = torch.from_numpy(arr.copy())
    if "head" in params:
        out["loss_normalizer"] = torch.tensor(INITIAL_LOSS_NORMALIZER, dtype=torch.float32)
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A Detectron2 ``.pkl`` (``{"model": {name: array}}``) or a PyTorch
    checkpoint (``model``/``state_dict`` or a bare state dict) ->
    ``{name: np.ndarray}``, without ``num_batches_tracked``."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        sd = data.get("model", data)
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
        sd = data.get("model", data.get("state_dict", data))
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _port_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every tensor of the port's model for ``cfg``, built
    on the meta device (no memory, no weights)."""
    from .models.meta_arch.rcnn import meta_architecture

    with torch.device("meta"):
        model = meta_architecture(cfg)(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def convert_d2_weights(sd: Dict[str, np.ndarray], cfg) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A Detectron2 state dict -> (the port's float32 ``state_dict``, the
    checkpoint's names that the model has no place for). Raises
    ``KeyError`` when the checkpoint lacks a tensor the model has."""
    shapes = _port_shapes(cfg)
    model_state = [k for k in _MODEL_STATE if shapes.pop(k, None) is not None]
    missing = sorted(set(shapes) - set(sd))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors of the model: {missing[:8]}")
    out: Dict[str, torch.Tensor] = {}
    for name in shapes:
        arr = np.asarray(sd[name], np.float32)
        if re.fullmatch(r"roi_heads\.box_head\.(\d+\.)?fc1\.weight", name):
            s = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
            arr = arr.reshape(arr.shape[0], -1, s, s).transpose(0, 2, 3, 1).reshape(arr.shape[0], -1)
        if arr.shape != shapes[name]:
            raise ValueError(f"{name}: checkpoint {arr.shape}, model {shapes[name]}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    for name in model_state:  # not a Detectron2 tensor: the model's initial value
        out[name] = torch.tensor(_MODEL_STATE[name])
    leftovers = [k for k in sd if k not in shapes and "cell_anchors" not in k
                 and "anchor_generator" not in k and "pixel_" not in k]
    return out, leftovers
