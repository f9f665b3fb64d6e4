"""TensorBoard writer: scalar dicts, confusion matrices and top-k histograms.

Counterpart of ``asf_tpu/visualization/tensorboard_vis.py``, through
``torch.utils.tensorboard`` (which needs the ``tensorboard`` package,
imported when a writer is made) and the figures of ``plots.py``
(matplotlib).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..utils.logging import get_logger

logger = get_logger(__name__)


class TensorboardWriter:
    def __init__(self, cfg):
        from torch.utils.tensorboard import SummaryWriter

        if cfg.TENSORBOARD.LOG_DIR == "":
            log_dir = os.path.join(cfg.OUTPUT_DIR, f"runs-{cfg.TRAIN.DATASET}")
        else:
            log_dir = os.path.join(cfg.OUTPUT_DIR, cfg.TENSORBOARD.LOG_DIR)
        self.writer = SummaryWriter(log_dir=log_dir)
        self.cfg = cfg
        logger.info("TensorBoard events will be saved to %s", log_dir)

    def add_scalars(self, data_dict: Dict[str, float], global_step: Optional[int] = None):
        for key, item in data_dict.items():
            if isinstance(item, (int, float)):
                self.writer.add_scalar(key, item, global_step)

    def add_confusion_matrix(self, preds, labels, tag="Confusion Matrix", num_classes=None,
                             global_step=None, class_names=None):
        from .plots import plot_confusion_matrix

        cm = confusion_matrix_counts(preds, labels, num_classes)
        fig = plot_confusion_matrix(cm, class_names=class_names)
        self.writer.add_figure(tag=tag, figure=fig, global_step=global_step)

    def add_topk_histograms(self, preds, labels, k=10, global_step=None, class_names=None):
        """A figure per class present in ``labels``: the ``k`` highest of
        the mean scores of its rows."""
        from .plots import plot_topk_histogram

        preds, labels = np.asarray(preds), np.asarray(labels)
        for cls in np.unique(labels):
            mean_scores = preds[labels == cls].mean(axis=0)
            tag = (f"Val/topk_hist/{class_names[int(cls)]}" if class_names
                   else f"Val/topk_hist/class_{int(cls)}")
            fig = plot_topk_histogram(tag, np.sort(mean_scores)[::-1][:k], k=k,
                                      class_names=None)
            self.writer.add_figure(tag=tag, figure=fig, global_step=global_step)

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.flush()
        self.writer.close()


def confusion_matrix_counts(preds, labels, num_classes=None) -> np.ndarray:
    """(n, n) counts, true class by row and predicted by column; ``preds``
    are class ids or (N, n) scores (their argmax)."""
    preds = np.asarray(preds)
    if preds.ndim == 2:
        preds = preds.argmax(axis=1)
    labels = np.asarray(labels)
    n = num_classes or int(max(preds.max(), labels.max())) + 1
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (labels.astype(np.int64), preds.astype(np.int64)), 1)
    return cm
