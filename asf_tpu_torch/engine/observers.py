"""Scalar observability sinks: TensorBoard and Weights & Biases.

Counterpart of ``asf_tpu/engine/observers.py``: one ``ScalarLogger`` fans
scalars out to TensorBoard (``visualization/tensorboard_vis.py``) and W&B,
W&B histograms are rebuilt from the 64 counts and the range that
``engine/steps.py:watch_summary`` computes on the card, and alerts go to
W&B and always to the log as a warning. Each sink is imported when the
logger is made: without its package (or with a failing ``wandb.init``) the
logger warns and goes on without it. ``WANDB.RUN_ID`` resumes that run
(``resume="must"``). ``train(cfg)`` makes one on rank 0.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..utils.logging import get_logger

logger = get_logger(__name__)


class ScalarLogger:
    """Fan-out scalar sink; the live sinks follow cfg.TENSORBOARD and cfg.WANDB."""

    def __init__(self, cfg):
        self.tb = None
        self.wandb_run = None

        if cfg.TENSORBOARD.ENABLE:
            try:
                from ..visualization.tensorboard_vis import TensorboardWriter

                self.tb = TensorboardWriter(cfg)
            except Exception as e:
                logger.warning("TensorBoard disabled: %s", e)

        if cfg.WANDB.ENABLE:
            try:
                import wandb

                kwargs = dict(project="audio-slowfast-tpu", config=_cfg_to_dict(cfg),
                              dir=cfg.OUTPUT_DIR)
                if cfg.WANDB.RUN_ID:
                    kwargs.update(id=cfg.WANDB.RUN_ID, resume="must")
                self.wandb_run = wandb.init(**kwargs)
            except Exception as e:
                logger.warning("wandb disabled: %s", e)

    def log(self, scalars: Dict[str, float], global_step: Optional[int] = None):
        if self.tb is not None:
            self.tb.add_scalars(scalars, global_step=global_step)
        if self.wandb_run is not None:
            self.wandb_run.log(scalars, step=global_step)

    def log_histograms(self, hists, global_step: Optional[int] = None):
        """Per-leaf parameter and gradient histograms to W&B: ``hists`` maps
        a name to ``{"counts": (64,), "lo": float, "hi": float}``, the bin
        edges ``linspace(lo, hi, 65)``."""
        if self.wandb_run is None:
            return
        try:
            import wandb

            payload = {}
            for name, h in hists.items():
                counts = np.asarray(h["counts"], np.int64)
                lo, hi = float(h["lo"]), float(h["hi"])
                edges = np.linspace(lo, max(hi, lo + 1e-12), counts.size + 1)
                payload[name] = wandb.Histogram(np_histogram=(counts, edges))
            self.wandb_run.log(payload, step=global_step)
        except Exception as e:
            logger.warning("wandb histogram log failed: %s", e)

    def alert(self, title: str, text: str):
        """A W&B alert at warning level where a run is live; always a warning in the log."""
        if self.wandb_run is not None:
            try:
                import wandb

                self.wandb_run.alert(title=title, text=text, level=wandb.AlertLevel.WARN)
            except Exception as e:
                logger.warning("wandb alert failed: %s", e)
        logger.warning("%s: %s", title, text)

    def close(self):
        if self.tb is not None:
            self.tb.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()


def _cfg_to_dict(node):
    return {k: _cfg_to_dict(v) if hasattr(v, "items") else v for k, v in node.items()}
