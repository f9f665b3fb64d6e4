"""A small, dependency-free yacs/fvcore-compatible config node.

Copy of ``asf_tpu/config/cfg_node.py`` (the port imports nothing of the JAX
package). The upstream framework keys everything off an fvcore ``CfgNode``
with the precedence: code defaults -> ``merge_from_file(yaml)`` -> CLI
``opts`` via ``merge_from_list``. This module re-implements that surface
without fvcore.

Semantics preserved:
  * attribute-style access (``cfg.TRAIN.BATCH_SIZE``)
  * strict key checking on merge (typo in a YAML raises ``KeyError``)
  * type coercion on merge mirroring yacs ``_check_and_coerce_cfg_value_type``
    (list<->tuple are interchangeable; str values from CLI are literal-eval'd)
  * ``clone()`` deep-copies; ``dump()`` serialises to YAML text,
    ``to_json()`` to JSON text (what ``train`` logs and checkpoints store)

PyYAML is not installed everywhere the port runs, so YAML goes through the
port's own reader and writer, ``yaml_lite``, on every machine; a ``.json``
file goes through ``json``.
"""

from __future__ import annotations

import ast
import copy
import json
from typing import Any, Dict, List

from . import yaml_lite

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """Dict with attribute access and yacs-style merge semantics."""

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            self[k] = v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    # -- lifecycle ---------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        new = CfgNode()
        for k, v in self.items():
            new[k] = copy.deepcopy(v, memo)
        return new

    # -- serialisation -----------------------------------------------------
    def _to_plain(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v._to_plain() if isinstance(v, CfgNode) else v
        return out

    def to_json(self) -> str:
        """The tree as JSON text (tuples become lists); needs no ``yaml``."""
        return json.dumps(self._to_plain(), indent=1, sort_keys=True)

    def dump(self) -> str:
        """The tree as YAML text (block mappings, flow lists) that
        ``merge_from_file`` reads back."""
        return yaml_lite.dump(self._to_plain())

    # -- merging -----------------------------------------------------------
    def merge_from_file(self, cfg_filename: str) -> None:
        """Merges a ``.json`` file (``json``) or a YAML file (``yaml_lite``,
        which raises on YAML outside the subset the repo's configs use)."""
        with open(cfg_filename, "r", encoding="utf-8") as f:
            text = f.read()
        loaded = json.loads(text) if cfg_filename.endswith(".json") else yaml_lite.load(text)
        if loaded is None:
            return
        self._merge_dict(CfgNode(loaded), [])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other, [])

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            node: Any = self
            for sub in keys[:-1]:
                if sub not in node:
                    raise KeyError(f"Non-existent key: {full_key}")
                node = node[sub]
            leaf = keys[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent key: {full_key}")
            value = self._decode_value(v)
            node[leaf] = _coerce(value, node[leaf], full_key)

    def _merge_dict(self, other: "CfgNode", key_path: List[str]) -> None:
        for k, v in other.items():
            full_key = ".".join(key_path + [k])
            if k not in self:
                raise KeyError(f"Non-existent config key: {full_key}")
            if isinstance(self[k], CfgNode):
                if not isinstance(v, (dict, CfgNode)):
                    raise ValueError(f"Cannot merge non-dict into group {full_key}")
                self[k]._merge_dict(CfgNode(v) if not isinstance(v, CfgNode) else v, key_path + [k])
            else:
                self[k] = _coerce(v, self[k], full_key)

    @staticmethod
    def _decode_value(value: Any) -> Any:
        if not isinstance(value, str):
            return value
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value


def _coerce(new: Any, old: Any, full_key: str) -> Any:
    """yacs-style type coercion: allow list<->tuple, int->float; else types
    must match (None values accept anything)."""
    if old is None or new is None:
        return new
    if isinstance(new, str) and not isinstance(old, str):
        # YAML 1.1 parses e.g. `1e-4` as a string; re-interpret literals the
        # way yacs/fvcore do on merge.
        decoded = CfgNode._decode_value(new)
        if not isinstance(decoded, str):
            new = decoded
    if type(new) is type(old):
        return new
    # tuple <-> list
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    # int -> float promotion
    if isinstance(old, float) and isinstance(new, int) and not isinstance(new, bool):
        return float(new)
    raise ValueError(
        f"Type mismatch ({type(old).__name__} vs {type(new).__name__}) for key {full_key}: {new!r}"
    )
