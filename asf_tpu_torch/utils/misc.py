"""Model info and memory gauges.

Counterpart of ``asf_tpu/utils/misc.py``: ``params_count`` and
``log_model_info``, with the card's memory from ``torch.cuda`` where the
JAX package reads the TPU's. The JAX package's XLA flop count
(``flops_of``) has no counterpart here.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from .logging import get_logger

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
