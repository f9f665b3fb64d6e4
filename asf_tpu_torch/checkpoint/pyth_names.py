"""Reference ``.pyth`` state dicts into the port's models.

``torch_state_to_flax`` and ``merge_partial`` are copies of
``asf_tpu/checkpoint/pyth_converter.py:36-88, 138-171`` (numpy only): the
reference's parameter names to the JAX package's variable tree, with
name-pattern clearing, and a shape-matched merge that reports every leaf it
could not take. ``load_into`` composes them with ``convert.py``'s
``flax_variables_to_torch_state``: the leaves of a reference checkpoint
whose names and shapes match the port's model are loaded, the others are
skipped, each with a warning (the reference's ``strict=False`` load with
shape filtering, ``utils/checkpoint.py:128-203``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
from torch import nn

from ..utils.logging import get_logger
from .convert import GRU_PARAM, flax_variables_to_torch_state

logger = get_logger(__name__)


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def torch_state_to_flax(state_dict: Dict[str, Any], clear_name_patterns=()) -> Dict[str, Dict]:
    """A reference ``model_state`` -> ``{"params": ..., "batch_stats": ...}``
    (conv OIHW -> HWIO, linear (O, I) -> (I, O), BN weight -> scale, running
    statistics -> mean/var); keys it cannot place go to ``_skipped_keys``."""
    params: Dict = {}
    batch_stats: Dict = {}
    skipped = []
    for key, tensor in state_dict.items():
        for pattern in clear_name_patterns:
            key = key.replace(pattern, "")
        arr = np.asarray(tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else tensor)
        tokens = key.split(".")
        leaf, prefix = tokens[-1], tuple(tokens[:-1])
        if leaf == "num_batches_tracked":
            continue
        if GRU_PARAM.match(leaf):
            _set(params, prefix + (leaf,), arr.astype(np.float32))
        elif leaf == "running_mean":
            _set(batch_stats, prefix + ("mean",), arr.astype(np.float32))
        elif leaf == "running_var":
            _set(batch_stats, prefix + ("var",), arr.astype(np.float32))
        elif leaf == "weight" and arr.ndim == 4:
            _set(params, prefix + ("kernel",), np.transpose(arr, (2, 3, 1, 0)).astype(np.float32))
        elif leaf == "weight" and arr.ndim == 2:
            _set(params, prefix + ("kernel",), np.transpose(arr, (1, 0)).astype(np.float32))
        elif leaf == "weight" and arr.ndim == 1:
            _set(params, prefix + ("scale",), arr.astype(np.float32))
        elif leaf == "bias":
            _set(params, prefix + ("bias",), arr.astype(np.float32))
        else:
            skipped.append(key)
    out = {"params": params, "batch_stats": batch_stats}
    if skipped:
        out["_skipped_keys"] = skipped
    return out


def merge_partial(target: Dict, source: Dict, path="") -> Tuple[Dict, list]:
    """``target`` with each leaf replaced by ``source``'s where the key exists
    and the shape matches; returns it and the list of leaves not taken."""
    mismatched = []

    def rec(dst, src, p):
        out = {}
        for k, v in dst.items():
            sp = f"{p}.{k}" if p else k
            if k not in src:
                mismatched.append((sp, "missing", None))
                out[k] = v
            elif isinstance(v, dict) and isinstance(src[k], dict):
                out[k] = rec(v, src[k], sp)
            elif not isinstance(v, dict) and not isinstance(src[k], dict):
                if tuple(np.shape(v)) == tuple(np.shape(src[k])):
                    out[k] = np.asarray(src[k], dtype=np.asarray(v).dtype)
                else:
                    mismatched.append((sp, tuple(np.shape(src[k])), tuple(np.shape(v))))
                    out[k] = v
            else:
                mismatched.append((sp, "tree-mismatch", None))
                out[k] = v
        return out

    return rec(target, source, path), mismatched


def load_into(model: nn.Module, state_dict: Dict[str, Any], clear_name_patterns=()) -> list:
    """Loads the leaves of a reference ``model_state`` that match ``model`` by
    name and shape; logs and returns the ones skipped."""
    target = torch_state_to_flax(model.state_dict())
    source = torch_state_to_flax(state_dict, clear_name_patterns)
    params, miss_p = merge_partial(target["params"], source["params"])
    stats, miss_s = merge_partial(target["batch_stats"], source["batch_stats"])
    skipped = miss_p + miss_s + [(k, "no counterpart", None)
                                 for k in source.get("_skipped_keys", [])]
    for name, got, want in skipped:
        logger.warning("pyth load: skipped %s (checkpoint %s, model %s)", name, got, want)
    model.load_state_dict(flax_variables_to_torch_state(
        {"params": params, "batch_stats": stats}), strict=True)
    return skipped
