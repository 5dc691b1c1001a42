"""A small yacs-compatible config node (the port's own copy of
``centermask2_tpu/config/node.py``).

Reimplements the subset of yacs the reference relies on
(reference: centermask2/centermask/config/config.py:4-13 and
deploy_utils.py:46-57): attribute access, yaml loading with ``_BASE_``
inheritance, CLI ``opts`` key-value overrides, freezing, and cloning.

PyYAML is imported only by the functions that read or write yaml, so a
config built in Python needs no yaml package.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List

_BASE_KEY = "_BASE_"
_VALID_TYPES = (int, float, bool, str, list, tuple, type(None))


class CfgNode(dict):
    """Dict with attribute access, freeze support, and yaml merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        super().__setitem__(name, value)

    # -- freezing ----------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_a_into_b(other, self)

    def merge_from_file(self, filename: str, allow_unsafe: bool = False) -> None:
        loaded = _load_yaml_with_base(filename)
        _merge_a_into_b(loaded, self)

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            d: CfgNode = self
            for sub in keys[:-1]:
                assert sub in d, f"Non-existent key: {full_key}"
                d = d[sub]
            last = keys[-1]
            assert last in d, f"Non-existent key: {full_key}"
            d[last] = _decode_value(v, d[last], full_key)

    # -- io ------------------------------------------------------------------
    def dump(self) -> str:
        import yaml

        def to_plain(node):
            if isinstance(node, CfgNode):
                return {k: to_plain(v) for k, v in node.items()}
            return node

        return yaml.safe_dump(to_plain(self), default_flow_style=None)

    def __repr__(self) -> str:  # pragma: no cover
        return f"CfgNode({super().__repr__()})"


def _decode_value(v: Any, old: Any, full_key: str) -> Any:
    # a blank string becomes None, as yaml.safe_load reads it in the JAX
    # package's copy (detectron2 itself keeps "")
    if isinstance(v, str) and not v.strip():
        v = None
    elif isinstance(v, str):
        import ast

        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            import yaml

            try:
                v = yaml.safe_load(v)
            except yaml.YAMLError:
                pass
    if old is None or v is None:
        return v
    if isinstance(old, tuple) and isinstance(v, list):
        return tuple(v)
    if isinstance(old, list) and isinstance(v, tuple):
        return list(v)
    if isinstance(old, float) and isinstance(v, int):
        return float(v)
    if type(v) is not type(old) and not (
        isinstance(v, bool) and isinstance(old, bool)
    ):
        raise ValueError(
            f"Type mismatch ({type(old)} vs {type(v)}) for key {full_key}"
        )
    return v


def _merge_a_into_b(a: Dict[str, Any], b: CfgNode) -> None:
    for k, v_ in a.items():
        if isinstance(v_, dict) and not isinstance(v_, CfgNode):
            v_ = CfgNode(v_)
        if isinstance(v_, CfgNode):
            if k in b and isinstance(b[k], CfgNode):
                _merge_a_into_b(v_, b[k])
            else:
                b[k] = v_.clone()
        else:
            if k in b:
                b[k] = _decode_value(v_, b[k], k)
            else:
                b[k] = copy.deepcopy(v_)


def _load_yaml_with_base(filename: str) -> Dict[str, Any]:
    """Load a yaml file, recursively resolving ``_BASE_`` inheritance.

    Mirrors detectron2/yacs semantics used by the reference configs
    (configs/centermask/zy_model_config.yaml:1 uses _BASE_).
    """
    import yaml

    with open(filename, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}
    if _BASE_KEY in cfg:
        base_filename = cfg.pop(_BASE_KEY)
        if not os.path.isabs(base_filename):
            base_filename = os.path.join(os.path.dirname(filename), base_filename)
        base = _load_yaml_with_base(base_filename)
        _deep_update(base, cfg)
        return base
    return cfg


def _deep_update(base: Dict[str, Any], new: Dict[str, Any]) -> None:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
