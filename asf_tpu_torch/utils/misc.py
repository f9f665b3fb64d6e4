"""Model info, memory gauges, class names and ``discretize``.

Counterpart of ``asf_tpu/utils/misc.py``: ``params_count``,
``log_model_info``, ``get_class_names`` and ``discretize``, with the card's
memory from ``torch.cuda`` where the JAX package reads the TPU's. The JAX
package's XLA flop count (``flops_of``) has no counterpart here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

from .logging import get_logger
from .torch_setup import resolve_device

logger = get_logger(__name__)


def params_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def buffers_count(model: nn.Module) -> int:
    """Elements of the floating-point buffers (BN running statistics)."""
    return sum(b.numel() for b in model.buffers() if b.is_floating_point())


def gpu_mem_gb() -> float | None:
    """Peak device memory this process allocated, in GB (None before CUDA is used)."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / 1024**3


def host_mem_gb() -> tuple[float, float]:
    """(resident set of this process, physical memory) in GB."""
    page = os.sysconf("SC_PAGE_SIZE")
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * page
    return rss / 1024**3, os.sysconf("SC_PHYS_PAGES") * page / 1024**3


def log_model_info(model: nn.Module) -> None:
    logger.info("Model:\n%s", model)
    logger.info("Params: {:,}".format(params_count(model)))
    logger.info("BN buffers: {:,}".format(buffers_count(model)))
    mem = gpu_mem_gb()
    if mem is not None:
        logger.info("Peak device memory: %.3f GB", mem)


def get_class_names(path: str, parent_path: str = "", subset_path: str = ""):
    """(class names by id, parent -> child ids, subset ids) from a JSON map
    of class name to id, a JSON map of parent to child names, and a subset
    file of one class name a line (the TensorBoard plots' class names)."""
    with open(path) as f:
        class2idx = json.load(f)
    class_names = [None] * (max(class2idx.values()) + 1)
    for name, idx in class2idx.items():
        class_names[idx] = name

    class_parent = None
    if parent_path:
        with open(parent_path) as f:
            d_parent = json.load(f)
        class_parent = {parent: [class2idx[c] for c in children if class2idx.get(c) is not None]
                        for parent, children in d_parent.items()}

    subset_ids = None
    if subset_path:
        with open(subset_path) as f:
            subset = f.read().split("\n")
        subset_ids = [class2idx[name] for name in subset if class2idx.get(name) is not None]

    return class_names, class_parent, subset_ids


# JAX with 64-bit types off, as asf_tpu runs, holds a 64-bit input as 32-bit.
_AS_32_BIT = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.uint64: torch.uint32}


def _as_compared(x: torch.Tensor, t):
    """``x`` and threshold ``t`` as ``asf_tpu``'s ``x < t`` compares them
    (JAX's promotion of a Python scalar): in a floating input's own dtype;
    for an integer or bool input, in float32 against a Python float and in
    its own dtype against a Python int (bool as int32). ``t`` is rounded, or
    wrapped, into that dtype; integers then compare as int64, which holds
    every 32-bit value."""
    if x.dtype.is_floating_point:
        dtype = x.dtype
    elif isinstance(t, int) and not isinstance(t, bool):
        dtype = torch.int32 if x.dtype == torch.bool else x.dtype
    else:
        dtype = torch.float32
    x, t = x.to(dtype), torch.tensor(t).to(dtype).item()
    return (x, t) if dtype.is_floating_point else (x.to(torch.int64), t)


def discretize(x, low_t: float = -0.5, high_t: float = 0.5,
               low: float = -1.0, high: float = 1.0, device=None) -> torch.Tensor:
    """Values below ``low_t`` -> ``low``, above ``high_t`` -> ``high``, the
    rest (the thresholds themselves and NaN) -> 0, as float32 whatever the
    input's dtype: ``asf_tpu/utils/misc.py:discretize``, compared as it
    compares (``_as_compared``). A tensor stays on its own device; anything
    else goes to ``resolve_device(device)``: the card unless ``device="cpu"``.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    x = x.to(_AS_32_BIT.get(x.dtype, x.dtype))
    x_lo, lo_t = _as_compared(x, low_t)
    x_hi, hi_t = _as_compared(x, high_t)
    f32 = dict(dtype=torch.float32, device=x.device)
    return torch.where(x_lo < lo_t, torch.tensor(low, **f32),
                       torch.where(x_hi > hi_t, torch.tensor(high, **f32),
                                   torch.zeros((), **f32)))
