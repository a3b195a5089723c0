"""The yacs-style config node: attribute access, type-checked merges.

Port of the JAX package's ``config/config.py`` with its semantics:

* ``merge_from_file`` reads YAML with ``_BASE_`` inheritance (through
  :mod:`.yaml_subset`, a standard-library reader, in place of PyYAML) and
  rewrites upstream-Detectron2 key spellings onto this schema first;
* ``merge_from_list`` takes ``[KEY1, VAL1, ...]`` overrides (``--opts``);
* merges are type-checked and reject keys the tree does not have;
* ``freeze``/``defrost``; a frozen tree still takes new ``COMPUTED_`` keys,
  once each;
* ``clone`` and ``dump``.
"""

from __future__ import annotations

import copy
import json
import math
import os
from ast import literal_eval
from typing import Any, Dict, List

from . import yaml_subset

BASE_KEY = "_BASE_"
COMPUTED_PREFIX = "COMPUTED_"

# Types allowed as config leaf values.
_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """A nested, attribute-accessible configuration node."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict | None = None):
        init_dict = {} if init_dict is None else init_dict
        init_dict = self._create_config_tree_from_dict(init_dict)
        super().__init__(init_dict)
        self.__dict__[CfgNode.IMMUTABLE] = False

    @classmethod
    def _create_config_tree_from_dict(cls, dic: Dict) -> Dict:
        dic = copy.deepcopy(dic)
        for k, v in dic.items():
            if isinstance(v, dict):
                dic[k] = cls(v)
            else:
                _assert_valid_type(v, f"Key {k} with value {type(v)}")
        return dic

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            if name.startswith(COMPUTED_PREFIX):
                if name in self:
                    raise KeyError(f"Computed key '{name}' already set")
                self[name] = value
                return
            raise AttributeError(f"Attempted to set '{name}' but CfgNode is immutable")
        _assert_valid_type(value, f"Key {name}", allow_cfg_node=True)
        self[name] = value

    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, is_immutable: bool) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = is_immutable
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(is_immutable)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_file(self, cfg_filename: str) -> None:
        """Merge a YAML file, resolving ``_BASE_`` inheritance recursively."""
        loaded = _load_yaml_with_base(cfg_filename)
        _apply_upstream_aliases(loaded)
        self.merge_from_other_cfg(type(self)(loaded))

    def merge_from_other_cfg(self, cfg_other: "CfgNode") -> None:
        _merge_a_into_b(cfg_other, self, [])

    def merge_from_list(self, cfg_list: List[str]) -> None:
        """Merge ``[KEY1, VAL1, KEY2, VAL2, ...]`` (the ``--opts`` override)."""
        if len(cfg_list) % 2 != 0:
            raise ValueError(f"Override list has odd length: {cfg_list}")
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            key_parts = full_key.split(".")
            d = self
            for sub in key_parts[:-1]:
                if sub not in d:
                    raise KeyError(f"Non-existent key: {full_key}")
                d = d[sub]
            sub = key_parts[-1]
            if sub not in d:
                raise KeyError(f"Non-existent key: {full_key}")
            value = _decode_cfg_value(v)
            value = _check_and_coerce_cfg_value_type(value, d[sub], full_key)
            if d.is_frozen():
                raise AttributeError(f"Attempted to set '{full_key}' but CfgNode is immutable")
            d[sub] = value

    def flatten(self, prefix: str = ""):
        """Yield ``("MODEL.RPN.NMS_THRESH", value)`` pairs for every leaf."""
        for k, v in self.items():
            if isinstance(v, CfgNode):
                yield from v.flatten(f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    def dump(self) -> str:
        """The tree as YAML (keys sorted, tuples as lists), which
        ``merge_from_file`` reads back."""
        lines: List[str] = []
        _dump_node(self, 0, lines)
        return "".join(lines)

    def __str__(self) -> str:
        def _indent(s, n=2):
            pad = " " * n
            return "\n".join(pad + line for line in s.split("\n"))

        lines = []
        for k, v in sorted(self.items()):
            if isinstance(v, CfgNode):
                lines.append(f"{k}:\n{_indent(str(v))}")
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({super().__repr__()})"


def _assert_valid_type(value: Any, msg: str, allow_cfg_node: bool = False) -> None:
    valid = _VALID_TYPES + ((CfgNode, dict) if allow_cfg_node else ())
    if not isinstance(value, valid):
        raise ValueError(f"{msg} is not a valid config leaf type")


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text:  # YAML 1.1 floats need a dot and a signed exponent
            mant, exp = text.split("e")
            mant = mant if "." in mant else mant + ".0"
            exp = exp if exp[0] in "+-" else "+" + exp
            text = f"{mant}e{exp}"
        return text if "." in text else text + ".0"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    return json.dumps(str(v))


def _dump_node(node: Dict, indent: int, lines: List[str]) -> None:
    for k in sorted(node):
        v = node[k]
        if isinstance(v, dict):
            lines.append(f"{' ' * indent}{k}:\n")
            _dump_node(v, indent + 2, lines)
        else:
            lines.append(f"{' ' * indent}{k}: {_dump_scalar(v)}\n")


def _load_yaml_with_base(filename: str) -> Dict:
    cfg = yaml_subset.load_file(filename)
    if cfg is None:
        cfg = {}
    if BASE_KEY in cfg:
        base_filename = cfg.pop(BASE_KEY)
        if not os.path.isabs(base_filename):
            base_filename = os.path.join(os.path.dirname(filename), base_filename)
        base_cfg = _load_yaml_with_base(base_filename)
        _merge_dict_a_into_b(cfg, base_cfg)
        return base_cfg
    return cfg


def _apply_upstream_aliases(loaded: Dict) -> None:
    """Rewrite upstream-Detectron2 config keys onto this schema, in place.

    * MODEL.WEIGHTS -> PRETRAINS.DETECTRON2 (a full-model D2 file) or
      PRETRAINS.BACKBONE (``ImageNetPretrained`` files); ``detectron2://``
      URIs keep their path, so that PRETRAINS.ROOT can point at a mirror;
    * INPUT.{MIN,MAX}_SIZE_{TRAIN,TEST} -> TRANSFORM.RESIZE.*;
    * DATASETS.TRAIN/TEST tuples -> DATASETS.TRAIN/VAL strings (first entry);
    * DATALOADER.NUM_WORKERS -> DATALOADER.NUM_READERS;
    * SOLVER.CHECKPOINT_PERIOD also sets SOLVER.SHORT_TERM_SAVE_STEPS.
    """
    model = loaded.get("MODEL")
    if isinstance(model, dict) and "WEIGHTS" in model:
        weights = model.pop("WEIGHTS") or ""
        if weights:
            path = weights.split("://", 1)[-1]
            pre = loaded.setdefault("PRETRAINS", {})
            if "ImageNetPretrained" in weights:
                pre.setdefault("BACKBONE", path)
            else:
                pre.setdefault("DETECTRON2", path)

    inp = loaded.get("INPUT")
    if isinstance(inp, dict):
        moved = {}
        for k in ("MIN_SIZE_TRAIN", "MAX_SIZE_TRAIN", "MIN_SIZE_TEST", "MAX_SIZE_TEST"):
            if k in inp:
                moved[k] = inp.pop(k)
        if moved:
            loaded.setdefault("TRANSFORM", {}).setdefault("RESIZE", {}).update(moved)

    ds = loaded.get("DATASETS")
    if isinstance(ds, dict):
        for src, dst in (("TRAIN", "TRAIN"), ("TEST", "VAL")):
            v = _decode_cfg_value(ds.get(src))  # YAML tuples arrive as strings
            if isinstance(v, (list, tuple)):
                ds.pop(src)
                if v:
                    ds[dst] = str(v[0])

    dl = loaded.get("DATALOADER")
    if isinstance(dl, dict) and "NUM_WORKERS" in dl:
        dl["NUM_READERS"] = dl.pop("NUM_WORKERS")

    sol = loaded.get("SOLVER")
    if isinstance(sol, dict) and "CHECKPOINT_PERIOD" in sol:
        sol.setdefault("SHORT_TERM_SAVE_STEPS", sol["CHECKPOINT_PERIOD"])


def _merge_dict_a_into_b(a: Dict, b: Dict) -> None:
    for k, v in a.items():
        if isinstance(v, dict) and k in b and isinstance(b[k], dict):
            _merge_dict_a_into_b(v, b[k])
        else:
            b[k] = v


def _merge_a_into_b(a: CfgNode, b: CfgNode, key_list: List[str]) -> None:
    for k, v_ in a.items():
        full_key = ".".join(key_list + [k])
        if k not in b:
            raise KeyError(f"Non-existent config key: {full_key}")
        v = _decode_cfg_value(copy.deepcopy(v_))
        v = _check_and_coerce_cfg_value_type(v, b[k], full_key)
        if isinstance(v, dict):
            if not isinstance(b[k], CfgNode):
                raise ValueError(f"Cannot merge dict into non-dict at {full_key}")
            _merge_a_into_b(v if isinstance(v, CfgNode) else CfgNode(v), b[k], key_list + [k])
        else:
            b[k] = v


def _decode_cfg_value(value: Any) -> Any:
    if isinstance(value, dict):
        return value if isinstance(value, CfgNode) else CfgNode(value)
    if not isinstance(value, str):
        return value
    try:
        value = literal_eval(value)
    except (ValueError, SyntaxError):
        pass  # a plain string
    return value


def _check_and_coerce_cfg_value_type(replacement: Any, original: Any, full_key: str) -> Any:
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type or original is None:
        return replacement
    for src, dst in ((tuple, list), (list, tuple), (int, float)):
        if replacement_type == src and original_type == dst:
            return dst(replacement)
    if isinstance(original, dict) and isinstance(replacement, dict):
        return replacement
    raise ValueError(
        f"Type mismatch ({original_type} vs {replacement_type}) for config key "
        f"{full_key}: {original} vs {replacement}"
    )


def get_cfg() -> CfgNode:
    """A fresh copy of the full default tree (``defaults.py``)."""
    from .defaults import _C

    return _C.clone()
