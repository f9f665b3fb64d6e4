"""JAX (Flax) variables -> PyTorch state dict of the port's models.

The JAX package names its modules after the upstream torch state dict, so
the conversion is a per-leaf layout change:

* conv kernels HWIO -> OIHW; dense kernels (I, O) -> (O, I);
* BN ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``, plus ``num_batches_tracked`` = 0;
* the GRU's leaves (``weight_ih_l{k}[_reverse]``, ``weight_hh_...``,
  ``bias_ih_...``, ``bias_hh_...``) as they are: the JAX package stores them
  in ``nn.GRU``'s layout (``asf_tpu/models/gru.py:15-17``).

The result loads with ``model.load_state_dict(state, strict=True)``.
"""

from __future__ import annotations

from collections.abc import Mapping

import re

import numpy as np
import torch

GRU_PARAM = re.compile(r"^(weight|bias)_(ih|hh)_l\d+(_reverse)?$")


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield ".".join(path), k, np.asarray(v, dtype=np.float32)


def flax_variables_to_torch_state(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of numpy arrays -> torch state dict."""
    state: dict[str, np.ndarray] = {}
    for prefix, leaf, arr in _leaves(variables.get("params", {})):
        if leaf == "kernel" and arr.ndim == 4:
            state[f"{prefix}.weight"] = arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and arr.ndim == 2:
            state[f"{prefix}.weight"] = arr.T
        elif leaf == "scale":
            state[f"{prefix}.weight"] = arr
        elif leaf == "bias":
            state[f"{prefix}.bias"] = arr
        elif GRU_PARAM.match(leaf):
            state[f"{prefix}.{leaf}"] = arr
        else:
            raise ValueError(f"no torch counterpart for parameter {prefix}.{leaf}")
    out = {k: torch.tensor(v) for k, v in state.items()}  # copies, contiguous
    for prefix, leaf, arr in _leaves(variables.get("batch_stats", {})):
        if leaf == "mean":
            out[f"{prefix}.running_mean"] = torch.tensor(arr)
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "var":
            out[f"{prefix}.running_var"] = torch.tensor(arr)
        else:
            raise ValueError(f"no torch counterpart for statistic {prefix}.{leaf}")
    return out
