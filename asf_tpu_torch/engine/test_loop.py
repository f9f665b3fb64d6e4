"""Testing: ``test(cfg)`` scores every view of every test clip and ensembles them.

Counterpart of ``asf_tpu/engine/test_loop.py`` (``perform_test`` :40,
``_save_scores`` :142, ``test`` :171) for the single-task VGG-Sound branch:
load the test checkpoint (``checkpoint/manager.py:load_test_checkpoint``),
serve every batch of the test loader through ``steps.make_eval_step`` (the
front end's kernel on the card), ensemble each clip's
``TEST.NUM_ENSEMBLE_VIEWS`` views in a ``TestMeter``, pickle ``{output,
labels}`` to ``OUTPUT_DIR/scores/TEST.SAVE_RESULTS_PATH`` and log the
top-k accuracies and ``vggsound_stats``.

The loop does not wait for the card a batch: each batch's probabilities,
labels and clip ids are queued as one copy into pinned host memory with an
event, and the meter takes them once that event has completed. The ragged
last batch runs with its real rows. The JAX package's padding to a static
batch (``pad_batch_to``), its K-step ``multi_eval`` and its device store
(``resolve_offsets``) exist for XLA and the TPU's host link and are not
ported; the verb/noun and sliding-window meters come with the EPIC slice.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..checkpoint import manager as cu
from ..data.loader import construct_loader
from ..data.prefetch import prefetch
from ..models import build_model
from ..utils.logging import get_logger, setup_logging
from ..utils.torch_setup import disable_tf32, resolve_device
from . import metrics
from .meters import TestMeter
from .steps import is_multitask, make_eval_step

logger = get_logger(__name__)


@torch.inference_mode()
def perform_test(test_loader, model, eval_step, test_meter, device):
    """Scores every batch of ``test_loader``; returns the meter's
    ``finalize_metrics()``: (ensembled scores, labels)."""
    cuda = torch.device(device).type == "cuda"
    fetches = []  # (iteration, host times, (probs, labels, clip ids) on the host, event)

    def apply_ready(block: bool):
        while fetches and (block or fetches[0][3] is None or fetches[0][3].query()):
            it, times, (probs, labels, clip_ids), event = fetches.pop(0)
            if event is not None:
                event.synchronize()
            test_meter.update_stats(probs.numpy(), labels.numpy(), clip_ids.numpy())
            test_meter.log_iter_stats(it, times)

    src = prefetch(test_loader, device)
    try:
        test_meter.iter_tic()
        for cur_iter, batch in enumerate(src):
            test_meter.data_toc()
            probs = eval_step(model, batch)
            host = tuple(t.to("cpu", non_blocking=True)
                         for t in (probs, batch["labels"]["class_id"], batch["index"]))
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            test_meter.iter_toc()
            fetches.append((cur_iter, test_meter.iter_times(), host, event))
            apply_ready(block=False)
            test_meter.iter_tic()
        apply_ready(block=True)
    finally:
        src.close()
    return test_meter.finalize_metrics()


def _save_scores(cfg, results) -> str:
    """Pickles ``{output, labels}`` (the schema ``scripts/score_parity.py``
    reads) to ``OUTPUT_DIR/scores/``; returns its path."""
    scores_dir = os.path.join(cfg.OUTPUT_DIR, "scores")
    os.makedirs(scores_dir, exist_ok=True)
    path = os.path.join(scores_dir, cfg.TEST.SAVE_RESULTS_PATH or "test_scores.pkl")
    preds, labels = results
    with open(path, "wb") as f:
        pickle.dump({"output": preds, "labels": labels}, f)
    logger.info("Saved test scores to %s", path)
    return path


def test(cfg, device=None):
    """Tests the model of ``cfg`` on ``TEST.DATASET``; returns (ensembled
    scores (clips, classes) float64, labels (clips,)).

    Runs on the current CUDA device unless ``device="cpu"``; raises when
    CUDA is absent and no device was given. Raises ``NotImplementedError``
    for a verb/noun config, ``TEST.SLIDE.ENABLE`` and ``NUM_SHARDS > 1``,
    which come with later slices.
    """
    if is_multitask(cfg):
        raise NotImplementedError("the verb/noun test meter comes with the EPIC slice")
    if cfg.TEST.SLIDE.ENABLE or cfg.TEST.DATASET.lower().endswith("slide"):
        raise NotImplementedError("sliding-window testing comes with the EPIC slice")
    if cfg.NUM_SHARDS > 1:
        raise NotImplementedError(f"NUM_SHARDS = {cfg.NUM_SHARDS}: test(cfg) runs on one device")
    device = resolve_device(device)
    disable_tf32()
    setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)
    logger.info("Test with config:\n%s", cfg.to_json())

    model = build_model(cfg, device, torch.Generator().manual_seed(cfg.RNG_SEED))
    path = cu.load_test_checkpoint(cfg, model)
    logger.info("Test weights: %s", path or "random initialization")
    eval_step = make_eval_step(cfg, device)
    test_loader = construct_loader(cfg, "test")
    try:
        dataset = test_loader.dataset
        num_clips = dataset._num_clips
        meter = TestMeter(
            num_audios=len(dataset) // num_clips,
            num_clips=num_clips,
            num_cls=cfg.MODEL.NUM_CLASSES[0],
            overall_iters=len(test_loader),
            ensemble_method=cfg.DATA.ENSEMBLE_METHOD,
            log_period=cfg.LOG_PERIOD,
        )
        results = perform_test(test_loader, model, eval_step, meter, device)
    finally:
        test_loader.close()
    _save_scores(cfg, results)
    if not cfg.DATA.MULTI_LABEL and cfg.TEST.DATASET.lower() == "vggsound":
        logger.info("VGG-Sound stats: %s", metrics.vggsound_stats(*results))
    return results
