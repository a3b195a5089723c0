"""Carry the JAX package's weights, or a Detectron2 checkpoint, into the
port's ``state_dict``.

:func:`convert_d2_weights` reads a Detectron2 state dict (``.pkl`` model-zoo
files or ``.pth`` files, through :func:`load_state_dict`). The port's
modules carry Detectron2's names and PyTorch's layouts (a C4 model's
3-stage trunk ``backbone.res{2,3,4}`` and its head ``roi_heads.res5.{b}``,
RetinaNet's ``head.*`` and ``backbone.top_block.*`` and a cascade's
``roi_heads.box_head.{k}.*`` included), so only the box head's ``fc1`` (each
cascade stage's) changes: Detectron2 flattens the pooled features in (c, h,
w) order, the port in (h, w, c), so its columns are permuted. A deformable
block's offset conv, Detectron2's ``conv2_offset``, is the port's
``conv2.conv_offset``; its ``conv2.weight`` and ``conv2.norm.*`` keep their
names. The port's deformable kernel is dense over the channels, as the JAX
package's: a grouped Detectron2 kernel (a ResNeXt's, ``[F, C / groups, 3,
3]``) does not fit it and raises, naming the tensor, rather than being
reshaped.

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
``roi_heads.box_predictor.{k}``; the semantic head's ``sem_seg_head/p{l}_{i}``
(conv ``i`` of level ``p{l}``, with its GN wrapper) is
``sem_seg_head.p{l}.{2i}`` (Detectron2's ``nn.Sequential`` holds an
upsample after each conv) and its ``predictor`` ``sem_seg_head.predictor``.
A RetinaNet's ``loss_normalizer`` is the JAX ``initial_state``'s 100, as
for a Detectron2 checkpoint. SOLOv2's ``head/{cate,kernel}_tower_{i}``,
``cate_pred``, ``kernel_pred``, ``mask_{f}_{i}`` and ``mask_pred`` keep
their names (``head.cate_tower_0`` ...); a deformable tower's
``conv/{kernel, conv_offset}`` (``MODEL.SOLO.USE_DEFORM_CONV``) becomes the
tower's ``weight`` and ``conv_offset``, its norm beside it the tower's
``norm``. :func:`convert_solo_weights` reads an mmdet SOLOv2 checkpoint,
:func:`convert_caffe2_backbone` an MSRA/caffe2 ImageNet trunk (a pickle
read by :func:`load_caffe2_pickle`), :func:`convert_torchvision_backbone`
a torchvision (or mmdet ``backbone.``) ResNet state dict, and
:func:`convert_darknet_weights` a darknet ``.weights`` blob through its
JSON manifest (:func:`emit_manifest` writes the skeleton of one;
:func:`write_darknet_weights` writes a model's tensors the other way). A YOLOv4's
DarkNet trunk, neck and head keep the JAX module names (``backbone/res1/
block_1/conv1`` is ``backbone.bottom_up.res1.block_1.conv1``,
``neck/spp_conv1`` ``backbone.spp_conv1``, ``head/pred1`` ``head.pred1``).

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
    names (``conv1``, ``conv2``, ``shortcut``), which are the port's;
  * a deformable block's ``conv2/kernel`` and ``conv2/conv_offset/{kernel,
    bias}`` become ``conv2.weight`` and ``conv2.conv_offset.{weight,bias}``,
    and the norm the JAX block keeps beside it, ``conv2_norm`` (its frozen
    leaves, or its ``GroupNorm_0`` / ``BatchNorm_0``), the deformable conv's
    ``conv2.norm``.
"""

from __future__ import annotations

import json
import math
import pickle
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from .models.deform_conv import OFFSET_CONV
from .models.meta_arch.single_stage import INITIAL_LOSS_NORMALIZER

_PREFIX = {
    "neck": "backbone",
    "res5": "roi_heads.res5",
    "rpn_head": "proposal_generator.rpn_head",
    "box_heads_0": "roi_heads.box_head",
    "box_predictors_0": "roi_heads.box_predictor",
    "mask_head": "roi_heads.mask_head",
    "keypoint_head": "roi_heads.keypoint_head",
    "duplicate_removal": "roi_heads.duplicate_removal",
    "sem_seg_head": "sem_seg_head",
}
_FROZEN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_AFFINE = {"scale": "weight", "bias": "bias"}
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}
_NORM_WRAPPERS = (["GroupNorm_0", "GroupNorm_0"], ["BatchNorm_0", "BatchNorm_0"])
# The norm a JAX deformable block keeps beside its conv2, and its wrapped modules.
_DEFORM_NORM = "conv2_norm"
_DEFORM_NORM_INNER = ("GroupNorm_0", "BatchNorm_0")
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
_SEM_SEG_CONV = re.compile(r"^(p\d+)_(\d+)$")


def _deform_norm(mod: List[str]):
    """The port's ``conv2`` path of a JAX ``conv2_norm`` module path (with its
    ``GroupNorm_0`` / ``BatchNorm_0`` or without), else None."""
    if mod and mod[-1] == _DEFORM_NORM:
        return mod[:-1] + ["conv2"]
    if len(mod) > 1 and mod[-2] == _DEFORM_NORM and mod[-1] in _DEFORM_NORM_INNER:
        return mod[:-2] + ["conv2"]
    return None


def _module_name(path: Tuple[str, ...], prefix: Dict[str, str]) -> str:
    top, *rest = path
    if top not in prefix:
        raise KeyError(f"no port counterpart for JAX parameter {'/'.join(path)}")
    if top == "neck" and rest and rest[0].startswith("top_block_"):
        rest = ["top_block", rest[0][len("top_block_"):]] + rest[1:]
    tower = _TOWER.match(rest[0]) if top == "head" and rest else None
    if tower:  # a Sequential of (conv, ReLU) pairs
        rest = [f"{tower.group(1)}_subnet", str(2 * int(tower.group(2)))] + rest[1:]
    level = _SEM_SEG_CONV.match(rest[0]) if top == "sem_seg_head" and rest else None
    if level:  # a Sequential of (conv, 2x upsample) pairs
        rest = [level.group(1), str(2 * int(level.group(2)))] + rest[1:]
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
        deform = _deform_norm(mod)
        if deform is not None:
            out[f"{_module_name(tuple(deform), prefix)}.norm.{_AFFINE[leaf]}"] = \
                torch.from_numpy(arr.copy())
            continue
        if len(mod) > 2 and mod[-2:] in _NORM_WRAPPERS:
            name = _module_name(tuple(mod[:-2]), prefix)
            out[f"{name}.norm.{_AFFINE[leaf]}"] = torch.from_numpy(arr.copy())
            continue
        deconv = mod[-1] == "deconv"
        if mod[-2:] == ["conv", OFFSET_CONV] and len(mod) > 3:  # a SOLOv2 deformable tower's
            mod = mod[:-2] + [OFFSET_CONV]
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
        if bn == _DEFORM_NORM:
            mod, bn = mod + ["conv2"], "FrozenBatchNorm_0"
        if not bn.startswith("FrozenBatchNorm"):
            raise KeyError(f"unexpected frozen variable {'/'.join(path)}")
        name = _module_name(tuple(mod), prefix)
        out[f"{name}.norm.{_FROZEN[leaf]}"] = torch.from_numpy(arr.copy())
    for path, arr in _flatten(variables.get("batch_stats", {})):
        *mod, leaf = path
        deform = _deform_norm(mod)
        if deform is not None:
            out[f"{_module_name(tuple(deform), prefix)}.norm.{_BATCH_STATS[leaf]}"] = \
                torch.from_numpy(arr.copy())
            continue
        if len(mod) < 3 or mod[-2:] != ["BatchNorm_0", "BatchNorm_0"]:
            raise KeyError(f"unexpected batch_stats variable {'/'.join(path)}")
        name = _module_name(tuple(mod[:-2]), prefix)
        out[f"{name}.norm.{_BATCH_STATS[leaf]}"] = torch.from_numpy(arr.copy())
    if "cls_score" in params.get("head", {}):  # RetinaNet
        out["loss_normalizer"] = torch.tensor(INITIAL_LOSS_NORMALIZER, dtype=torch.float32)
    return out


# A torchvision BN's leaves (the port's FrozenBN buffers), and a GN's.
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_GN_LEAVES = ("weight", "bias")


def convert_solo_weights(sd: Dict[str, np.ndarray], cfg) -> Tuple[Dict[str, torch.Tensor],
                                                                    List[str]]:
    """An mmdetection SOLOv2 checkpoint -> (the port's float32 ``state_dict``
    entries it holds, the checkpoint's names that the model has no place for).

    Port of the JAX package's ``convert/solo.py``, writing the port's names:
    the torchvision trunk under ``backbone.`` by
    :func:`convert_torchvision_backbone` into ``backbone.bottom_up``, the
    FPN's ``neck.lateral_convs.{l}`` / ``neck.fpn_convs.{l}`` ->
    ``backbone.fpn_lateral{l+2}`` /
    ``backbone.fpn_output{l+2}``, the towers' ``bbox_head.{cate,kernel}_convs.{i}.{conv,gn}``
    -> ``head.{cate,kernel}_tower_{i}`` and its ``norm``, ``bbox_head.solo_cate`` /
    ``solo_kernel`` -> ``head.cate_pred`` / ``kernel_pred``, the mask
    branch's ``mask_feat_head.convs_all_levels.{i}.conv{k}`` -> ``head.mask_{f}_{k}``
    and ``conv_pred.0`` -> ``head.mask_pred``. Kernels are PyTorch's OIHW on
    both sides; the classifier's ``fc.*`` is dropped."""
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    out, rest = convert_torchvision_backbone(sd, "backbone.", "backbone.bottom_up")
    used = set()

    def put(src: str, dst: str):
        used.add(src)
        out[dst] = torch.from_numpy(np.ascontiguousarray(sd[src]))

    def conv(src: str, dst: str):
        put(f"{src}.weight", f"{dst}.weight")
        if f"{src}.bias" in sd:
            put(f"{src}.bias", f"{dst}.bias")

    def norm(src: str, dst: str, leaves):
        for leaf in leaves:
            put(f"{src}.{leaf}", f"{dst}.norm.{leaf}")

    for lvl in range(2, 6):
        conv(f"neck.lateral_convs.{lvl - 2}.conv", f"backbone.fpn_lateral{lvl}")
        conv(f"neck.fpn_convs.{lvl - 2}.conv", f"backbone.fpn_output{lvl}")
    s = cfg.MODEL.SOLO
    for i in range(s.MASK_KERNEL_NUM_CONVS):
        for tower in ("cate", "kernel"):
            conv(f"bbox_head.{tower}_convs.{i}.conv", f"head.{tower}_tower_{i}")
            norm(f"bbox_head.{tower}_convs.{i}.gn", f"head.{tower}_tower_{i}", _GN_LEAVES)
    conv("bbox_head.solo_cate", "head.cate_pred")
    conv("bbox_head.solo_kernel", "head.kernel_pred")
    common = int(math.log2(s.MASK_FEATURE_COMMON_STRIDE))
    for i, f in enumerate(s.MASK_FEATURE_IN_FEATURES):
        for k in range(max(1, i + 2 - common)):
            src = f"mask_feat_head.convs_all_levels.{i}.conv{k}"
            conv(f"{src}.conv", f"head.mask_{f}_{k}")
            norm(f"{src}.gn", f"head.mask_{f}_{k}", _GN_LEAVES)
    conv("mask_feat_head.conv_pred.0.conv", "head.mask_pred")
    norm("mask_feat_head.conv_pred.0.gn", "head.mask_pred", _GN_LEAVES)
    return out, [k for k in rest if k not in used]


def load_caffe2_pickle(path: str) -> Dict[str, np.ndarray]:
    """An MSRA/caffe2 pickle (``{"blobs": {name: array}}`` or the bare dict)
    -> ``{name: np.ndarray}``, without the ``_momentum`` blobs."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    blobs = data.get("blobs", data)
    return {k: np.asarray(v) for k, v in blobs.items() if not k.endswith("_momentum")}


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.float32)))


_CAFFE2_BLOCK = re.compile(r"^res(\d)_(\d+)_(branch\w+)_w$")
_CAFFE2_BRANCH = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3",
                  "branch1": "shortcut"}


def convert_caffe2_backbone(blobs: Dict[str, np.ndarray], trunk: str = "backbone"
                            ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """An MSRA/caffe2 ResNet's blobs -> (the port's float32 trunk tensors under
    ``trunk``, the blobs left unconverted).

    Port of the JAX package's ``convert/backbone.py``: ``conv1_w`` and
    ``res_conv1_bn_{s,b}`` are the stem's ``stem.conv1``;
    ``res{s}_{b}_branch{2a,2b,2c,1}_{w,bn_s,bn_b}`` are block ``b`` of stage
    ``res{s}``'s ``conv1``, ``conv2``, ``conv3`` and ``shortcut``. Kernels are
    OIHW on both sides. caffe2 folded each BN's statistics into ``_bn_s`` /
    ``_bn_b``, so the FrozenBN gets them as its weight and bias with mean 0
    and variance ``1 - 1e-5``: with the layer's eps of 1e-5 its scale is
    ``_bn_s`` itself. The classifier's ``fc1000`` and ``pred`` blobs are
    dropped without being listed."""
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def take(name):
        used.add(name)
        return blobs.get(name)

    def put(dst, w, bn_s, bn_b):
        if w is not None:
            out[f"{dst}.weight"] = _tensor(w)
        if bn_s is not None:
            out[f"{dst}.norm.weight"] = _tensor(bn_s)
            out[f"{dst}.norm.bias"] = _tensor(bn_b)
            out[f"{dst}.norm.running_mean"] = _tensor(np.zeros_like(bn_s))
            out[f"{dst}.norm.running_var"] = _tensor(np.ones_like(bn_s) - 1e-5)

    put(f"{trunk}.stem.conv1", take("conv1_w"), take("res_conv1_bn_s"), take("res_conv1_bn_b"))
    for name in list(blobs):
        m = _CAFFE2_BLOCK.match(name)
        if not m:
            continue
        stage, block, branch = m.groups()
        base = f"res{stage}_{block}_{branch}"
        put(f"{trunk}.res{stage}.{block}.{_CAFFE2_BRANCH[branch]}",
            take(base + "_w"), take(base + "_bn_s"), take(base + "_bn_b"))
    leftovers = [k for k in blobs if k not in used and not k.startswith(("fc1000", "pred"))]
    return out, leftovers


def convert_torchvision_backbone(sd: Dict[str, np.ndarray], prefix: str = "",
                                 trunk: str = "backbone"
                                 ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A torchvision ResNet state dict (or an mmdet checkpoint's, with
    ``prefix`` ``"backbone."``) -> (the port's float32 trunk tensors under
    ``trunk``, the names left unconverted).

    Port of the JAX package's ``convert/torchvision.py``: ``conv1`` /
    ``bn1`` are ``stem.conv1``, ``layer{L}.{b}.conv{i}`` / ``bn{i}`` are
    ``res{L+1}.{b}.conv{i}`` (a basic block has no ``conv3``) and
    ``downsample.{0,1}`` the block's ``shortcut``; each BN becomes a FrozenBN
    with its running statistics. ``fc.*`` and ``num_batches_tracked`` are
    dropped without being listed. torchvision's ResNets stride in the 3x3 and
    read RGB with ImageNet's mean and std: use them with
    ``MODEL.RESNETS.STRIDE_IN_1X1 False``, ``MODEL.INPUT_FORMAT RGB`` and
    ``MODEL.PIXEL_STD [58.395, 57.120, 57.375]``."""
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def has(name):
        return prefix + name in sd

    def get(name):
        used.add(prefix + name)
        return sd[prefix + name]

    def conv_bn(conv, bn, dst):
        out[f"{dst}.weight"] = _tensor(get(f"{conv}.weight"))
        for leaf in _BN_LEAVES:
            out[f"{dst}.norm.{leaf}"] = _tensor(get(f"{bn}.{leaf}"))

    conv_bn("conv1", "bn1", f"{trunk}.stem.conv1")
    for layer in range(1, 5):
        b = 0
        while has(f"layer{layer}.{b}.conv1.weight"):
            src, dst = f"layer{layer}.{b}", f"{trunk}.res{layer + 1}.{b}"
            for i in (1, 2, 3):
                if has(f"{src}.conv{i}.weight"):
                    conv_bn(f"{src}.conv{i}", f"{src}.bn{i}", f"{dst}.conv{i}")
            if has(f"{src}.downsample.0.weight"):
                conv_bn(f"{src}.downsample.0", f"{src}.downsample.1", f"{dst}.shortcut")
            b += 1
    leftovers = [k for k in sd if k not in used and not k.endswith("num_batches_tracked")
                 and not k.startswith(("fc.", prefix + "fc."))]
    return out, leftovers


# Darknet ``.weights`` files: the header's int32 words (major, minor, revision)
# and the int64 ``seen`` counter, 5 float32 slots skipped.
DARKNET_HEADER_INTS = 5
DARKNET_NORMS = ("bn", "frozen")


def read_darknet_blob(path: str, skip_header: bool = True) -> np.ndarray:
    """A darknet ``.weights`` file as float32, its 5-word header skipped."""
    data = np.fromfile(path, dtype=np.float32)
    return data[DARKNET_HEADER_INTS:] if skip_header else data


def _node_prefix(manifest: Dict) -> Dict[str, str]:
    """``_module_name``'s prefixes for a manifest's JAX paths: the trunk is
    ``backbone.bottom_up`` when a ``neck/`` node is there, as
    :func:`convert_variables` maps it."""
    neck = any(n["name"].split("/")[0] == "neck" for n in manifest["nodes"])
    return {**_PREFIX, "backbone": "backbone.bottom_up" if neck else "backbone", "head": "head"}


def convert_darknet_weights(blob: np.ndarray, manifest: Dict) -> Tuple[Dict[str, torch.Tensor],
                                                                         int]:
    """A darknet blob read through its JSON manifest -> (the port's float32
    ``state_dict`` entries, the floats consumed).

    Port of the JAX package's ``convert/darknet.py``. The manifest (the JAX
    package's format, so one ``<weights>.json`` serves both packages) lists
    the conv nodes in file order by their JAX paths (``backbone/stem``,
    ``neck/spp_conv1``, ``head/pred1``), with a ``norm`` map of ``"bn"``
    (trainable BN) or ``"frozen"`` (FrozenBN) per normed node. Each node
    reads, in darknet's layout: ``out`` biases (the norm's beta when it has
    one), then for either norm its gamma, running mean and running variance,
    then the ``[out, in, k, k]`` weights, which the port keeps as they are
    (OIHW). Both norms land on the conv's ``norm.{bias, weight,
    running_mean, running_var}``; a node without one gets ``bias``. Raises
    ``ValueError`` when the blob runs out or a norm is unknown."""
    prefix = _node_prefix(manifest)
    norms = manifest.get("norm", {})
    out: Dict[str, torch.Tensor] = {}
    start = 0

    def take(n: int, shape=None) -> torch.Tensor:
        nonlocal start
        v = blob[start:start + n]
        if len(v) != n:
            raise ValueError(f"darknet blob exhausted at {start} (+{n} of {len(blob)})")
        start += n
        v = np.asarray(v, np.float32)
        return torch.from_numpy(v.reshape(shape) if shape else v.copy())

    for node in manifest["nodes"]:
        name = _module_name(tuple(node["name"].split("/")), prefix)
        cin, cout, k = node["in_channels"], node["out_channels"], node["size"]
        norm = norms.get(node["name"])
        if norm and norm not in DARKNET_NORMS:
            raise ValueError(f"unknown manifest norm '{norm}' at {node['name']}")
        bias = take(cout)
        if norm:
            out[f"{name}.norm.bias"] = bias
            for leaf in ("weight", "running_mean", "running_var"):
                out[f"{name}.norm.{leaf}"] = take(cout)
        else:
            out[f"{name}.bias"] = bias
        out[f"{name}.weight"] = take(cin * cout * k * k, (cout, cin, k, k)).clone()
    return out, start


def darknet_floats(state_dict: Dict[str, torch.Tensor], manifest: Dict) -> np.ndarray:
    """The tensors of ``state_dict`` in darknet's layout for ``manifest``, as
    float32: the inverse of :func:`convert_darknet_weights`."""
    prefix = _node_prefix(manifest)
    parts = []
    for node in manifest["nodes"]:
        name = _module_name(tuple(node["name"].split("/")), prefix)
        if node["name"] in manifest.get("norm", {}):
            leaves = [f"{name}.norm.{leaf}"
                      for leaf in ("bias", "weight", "running_mean", "running_var")]
        else:
            leaves = [f"{name}.bias"]
        parts += [state_dict[k].detach().float().cpu().reshape(-1).numpy()
                  for k in leaves + [f"{name}.weight"]]
    return np.concatenate(parts)


def write_darknet_weights(path: str, state_dict: Dict[str, torch.Tensor], manifest: Dict,
                          seen: int = 0) -> None:
    """A darknet ``.weights`` file of ``state_dict`` for ``manifest`` (the
    header's major 0, minor 2, revision 5 and the int64 ``seen``, then
    :func:`darknet_floats`) and its manifest beside it, ``<path>.json``."""
    with open(path, "wb") as f:
        np.asarray([0, 2, 5], np.int32).tofile(f)
        np.asarray([seen], np.int64).tofile(f)
        darknet_floats(state_dict, manifest).tofile(f)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def _jax_path(name: str, neck: bool) -> str:
    """The JAX module path of the port's module ``name`` (the inverse of
    ``_module_name`` for a model whose modules keep the JAX names)."""
    for port, jax_top in (("backbone.bottom_up.", "backbone/"),
                          ("backbone.", "neck/" if neck else "backbone/"), ("head.", "head/")):
        if name.startswith(port):
            return jax_top + name[len(port):].replace(".", "/")
    raise KeyError(f"no darknet node for module {name}")


def emit_manifest(model: torch.nn.Module) -> Dict:
    """The darknet manifest skeleton of a built model, as the JAX package's
    ``emit_manifest`` gives it for the same model's variables: every conv
    node by its JAX path (``in_channels``, ``out_channels``, ``size``),
    in the order of the paths' components (the JAX walk of a tree with
    sorted keys), and the ``norm`` map: ``"bn"`` for a trainable BN,
    ``"frozen"`` for a FrozenBN (no entry for a GN, as there). Reorder the
    nodes to the ``.weights`` file's order before use."""
    from .models.layers import BatchNorm2d, FrozenBatchNorm2d

    neck = hasattr(getattr(model, "backbone", None), "bottom_up")
    nodes, norm = [], {}
    for name, mod in model.named_modules():
        if not isinstance(mod, torch.nn.Conv2d):
            continue
        path = _jax_path(name, neck)
        out_ch, in_ch, k, _ = mod.weight.shape
        nodes.append({"name": path, "in_channels": int(in_ch),
                      "out_channels": int(out_ch), "size": int(k)})
        kind = {BatchNorm2d: "bn", FrozenBatchNorm2d: "frozen"}.get(type(getattr(mod, "norm", None)))
        if kind:
            norm[path] = kind
    nodes.sort(key=lambda n: n["name"].split("/"))
    return {"nodes": nodes, "norm": {n["name"]: norm[n["name"]] for n in nodes
                                     if n["name"] in norm}}


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


def _d2_name(name: str) -> str:
    """Detectron2's name of the port's tensor ``name``: a deformable block's
    ``conv2.conv_offset`` is Detectron2's ``conv2_offset``."""
    return name.replace(".conv2.conv_offset.", ".conv2_offset.")


def convert_d2_weights(sd: Dict[str, np.ndarray], cfg) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A Detectron2 state dict -> (the port's float32 ``state_dict``, the
    checkpoint's names that the model has no place for). Raises
    ``KeyError`` when the checkpoint lacks a tensor the model has."""
    shapes = _port_shapes(cfg)
    model_state = [k for k in _MODEL_STATE if shapes.pop(k, None) is not None]
    d2_name = {k: _d2_name(k) for k in shapes}
    missing = sorted(d2_name[k] for k in shapes if d2_name[k] not in sd)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors of the model: {missing[:8]}")
    deform_kernels = {k[:-len("conv_offset.weight")] + "weight" for k in shapes
                      if k.endswith(".conv2.conv_offset.weight")}
    out: Dict[str, torch.Tensor] = {}
    for name in shapes:
        arr = np.asarray(sd[d2_name[name]], np.float32)
        if re.fullmatch(r"roi_heads\.box_head\.(\d+\.)?fc1\.weight", name):
            s = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
            arr = arr.reshape(arr.shape[0], -1, s, s).transpose(0, 2, 3, 1).reshape(arr.shape[0], -1)
        if name in deform_kernels and arr.shape != shapes[name]:
            raise ValueError(
                f"{name}: the checkpoint's deformable kernel {arr.shape} does not fit the "
                f"port's dense {shapes[name]}: a grouped Detectron2 kernel "
                f"(MODEL.RESNETS.NUM_GROUPS > 1) has no place in the port's deformable conv, "
                f"which, as the JAX package's, convolves every channel; it is not reshaped")
        if arr.shape != shapes[name]:
            raise ValueError(f"{name}: checkpoint {arr.shape}, model {shapes[name]}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    for name in model_state:  # not a Detectron2 tensor: the model's initial value
        out[name] = torch.tensor(_MODEL_STATE[name])
    used = set(d2_name.values())
    leftovers = [k for k in sd if k not in used and "cell_anchors" not in k
                 and "anchor_generator" not in k and "pixel_" not in k]
    return out, leftovers
