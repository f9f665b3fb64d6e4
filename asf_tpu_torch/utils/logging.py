"""Logging setup and structured JSON stats.

Copy of ``asf_tpu/utils/logging.py`` under the ``asf_tpu_torch`` logger:
stdlib logging configured once, non-primary processes silenced, and
``log_json_stats`` writing one ``json_stats: {...}`` line per meter event,
the schema of the JAX package and of the upstream framework.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Dict

_FORMAT = "[%(asctime)s][%(levelname)s] %(name)s: %(lineno)4d: %(message)s"


def setup_logging(output_dir: str | None = None, is_primary: bool = True) -> None:
    root = logging.getLogger("asf_tpu_torch")
    root.setLevel(logging.INFO if is_primary else logging.ERROR)
    root.propagate = False
    if root.handlers:
        return
    formatter = logging.Formatter(_FORMAT, datefmt="%m/%d %H:%M:%S")
    if is_primary:
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(formatter)
        root.addHandler(sh)
    if output_dir and is_primary:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "stdout.log"))
        fh.setFormatter(formatter)
        root.addHandler(fh)


def get_logger(name: str) -> logging.Logger:
    """A logger under ``asf_tpu_torch`` (module names are taken as they are)."""
    return logging.getLogger(name if name.startswith("asf_tpu_torch") else f"asf_tpu_torch.{name}")


def log_json_stats(stats: Dict[str, Any]) -> None:
    """One-line JSON stats record, floats rounded to 5 decimals."""
    stats = {k: float(f"{v:.5f}") if isinstance(v, float) else v for k, v in stats.items()}
    get_logger(__name__).info("json_stats: {:s}".format(json.dumps(stats, sort_keys=True)))
