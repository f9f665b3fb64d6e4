"""Testing: ``test(cfg)`` scores every view of every test clip and ensembles them.

Counterpart of ``asf_tpu/engine/test_loop.py`` (``perform_test`` :40,
``_save_scores`` :142, ``test`` :171) for the single-task and the
verb/noun heads: load the test checkpoint
(``checkpoint/manager.py:load_test_checkpoint``), serve every batch of the
test loader through ``steps.make_eval_step`` (the front end's kernel on the
card), ensemble each clip's ``TEST.NUM_ENSEMBLE_VIEWS`` views in a
``TestMeter`` (verb/noun: an ``EPICTestMeter``, which keeps each clip's
``narration_id``), pickle ``{output, labels}`` (verb/noun:
``{verb_output, noun_output, labels: {verb, noun}, narration_id}``) to
``OUTPUT_DIR/scores/TEST.SAVE_RESULTS_PATH`` and log the top-k accuracies
(and, for VGG-Sound, ``vggsound_stats``). A model with the state head is
tested on its verb and noun scores; its state output is left aside, as in
the JAX package (``:51-60``). Sliding-window testing (``TEST.SLIDE.ENABLE``
or a ``*Slide`` test dataset; ``:228-234``) scores each window of
``EpicKitchensSlide`` once in an ``EPICTestMeterSlide``, whose labels are
(windows, 4) or (windows,) tables, and pickles the windows it scored in the
verb/noun schema.

The loop does not wait for the card a batch: each batch's probabilities,
labels and clip ids are queued as one copy into pinned host memory with an
event, and the meter takes them once that event has completed. The loop's
spans (``utils/spans.py``) are the meter's ``loop.data_wait`` and
``loop.step`` (the eval step and the gather across ranks) and
``loop.meter`` (the copy, its event and the meter's update). The ragged
last batch runs with its real rows. The JAX package's padding to a static
batch (``pad_batch_to``) and its K-step ``multi_eval`` exist for XLA and
are not ported. The test split's segments are kept on the card under
``GPU.TEST_DEVICE_CACHE_MB`` (``data/device_store.py``; the JAX package's
``:191-206``): every view of a record gathers from one stored segment, the
loader starts no worker, and ``perform_test`` takes the prefetched gathered
batch as it takes a streamed one. Each rank builds its own store.

Across ranks (``tools/run_net.py``) every host scores the whole test set,
as the JAX package's host-local mesh does (``:176-186``): the loader does
not split it over hosts, each of a host's ``NUM_GPUS`` data ranks scores
its rows of each batch (the last batch padded, as ``pad_batch_to`` pads
it), the scores, labels, clip ids and metadata are gathered to the host's
local rank 0 in a per-host group, which keeps the batch's real rows and
feeds the meter, and only global rank 0 writes the pickle (``:145``). On a
data x model grid (``GPU.MODEL_PARALLEL``; the JAX package's ``:209-214``)
the loaded model is sharded (``parallel/tensor.py:shard_model``), every
rank of a model group computes its data rank's scores, and only the ranks
of model rank 0 gather them and feed a meter.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..checkpoint import manager as cu
from ..data.device_store import DeviceSegmentStore
from ..data.loader import construct_loader
from ..data.prefetch import prefetch
from ..models import build_model
from ..parallel import dist, tensor
from ..utils.logging import get_logger, setup_logging
from ..utils.spans import span
from ..utils.torch_setup import disable_tf32, resolve_device
from . import metrics
from .meters import EPICTestMeter, EPICTestMeterSlide, TestMeter
from .steps import is_multitask, make_eval_step

logger = get_logger(__name__)


def _gather_host(out: list, metadata, host_rows: int, group):
    """``out`` (tensors) and ``metadata`` (lists) of every rank of ``group``
    (this host's data ranks of one model rank), concatenated in rank order
    and cut to the batch's ``host_rows`` real rows."""
    out = [dist.all_gather(t, group).flatten(0, 1)[:host_rows] for t in out]
    if metadata:
        parts = dist.all_gather_object(metadata, group)
        metadata = {k: [v for m in parts for v in m[k]][:host_rows] for k in metadata}
    return out, metadata


@torch.inference_mode()
def perform_test(test_loader, model, eval_step, test_meter, device, host_group=None,
                 scores: bool = True):
    """Scores every batch of ``test_loader``; returns the meter's
    ``finalize_metrics()``: (ensembled scores, labels), and for verb/noun
    the (verb, noun) pairs of both and the narration ids. When the loader's
    host batches are shared by more than one data rank (``local_size``),
    they are gathered over ``host_group`` and the host's local rank 0
    returns them, the others None. A rank with ``scores`` off (model rank 1
    and above of a grid) runs the model alone and returns None."""
    cuda = torch.device(device).type == "cuda"
    multitask = isinstance(test_meter, (EPICTestMeter, EPICTestMeterSlide))
    shared = test_loader.local_size > 1
    lead = test_loader.local_rank == 0 and scores
    # (iteration, host times, (probs..., labels..., clip ids) on the host, metadata, event)
    fetches = []

    def apply_ready(block: bool):
        while fetches and (block or fetches[0][4] is None or fetches[0][4].query()):
            it, times, host, metadata, event = fetches.pop(0)
            if event is not None:
                event.synchronize()
            host = [t.numpy() for t in host]
            if multitask:
                test_meter.update_stats(host[0:2], host[2:4], metadata, host[4])
            else:
                test_meter.update_stats(*host)
            test_meter.log_iter_stats(it, times)

    src = prefetch(test_loader, device)
    try:
        test_meter.iter_tic()
        for cur_iter, batch in enumerate(src):
            test_meter.data_toc()
            probs = eval_step(model, batch)
            labels = batch["labels"]
            out = ([*probs[:2], labels["verb"], labels["noun"]] if multitask
                   else [probs, labels["class_id"]]) + [batch["index"]]
            metadata = batch.get("metadata")
            if shared and scores:
                out, metadata = _gather_host(out, metadata, batch["host_rows"], host_group)
            test_meter.iter_toc()
            if not lead:
                test_meter.iter_tic()
                continue
            with span("loop.meter"):
                host = [t.to("cpu", non_blocking=True) for t in out]
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record()
                fetches.append((cur_iter, test_meter.iter_times(), host, metadata, event))
                apply_ready(block=False)
            test_meter.iter_tic()
        test_meter.iter_toc()
        apply_ready(block=True)
    finally:
        test_meter.iter_toc()
        src.close()
    return test_meter.finalize_metrics() if lead else None


def _save_scores(cfg, results, multitask: bool) -> str:
    """Pickles ``{output, labels}`` (the schema ``scripts/score_parity.py``
    reads), or for verb/noun ``{verb_output, noun_output, labels: {verb,
    noun}, narration_id}``, to ``OUTPUT_DIR/scores/``; returns its path."""
    scores_dir = os.path.join(cfg.OUTPUT_DIR, "scores")
    os.makedirs(scores_dir, exist_ok=True)
    path = os.path.join(scores_dir, cfg.TEST.SAVE_RESULTS_PATH or "test_scores.pkl")
    if multitask:
        (verb_p, noun_p), (verb_l, noun_l), narration_ids = results
        payload = {"verb_output": verb_p, "noun_output": noun_p,
                   "labels": {"verb": verb_l, "noun": noun_l}, "narration_id": narration_ids}
    else:
        preds, labels = results
        payload = {"output": preds, "labels": labels}
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    logger.info("Saved test scores to %s", path)
    return path


def test(cfg, device=None):
    """Tests the model of ``cfg`` on ``TEST.DATASET``; returns (ensembled
    scores (clips, classes) float64, labels (clips,)), and for verb/noun
    ((verb, noun) scores, (verb, noun) labels, narration ids (clips,)).

    Runs on the current CUDA device unless ``device="cpu"``; raises when
    CUDA is absent and no device was given. Sliding-window testing returns
    the windows scored: ((verb, noun) scores, (verb, noun) labels, narration
    ids). With ``NUM_SHARDS > 1``, ``NUM_GPUS > 1`` or ``GPU.MODEL_PARALLEL
    > 1`` it is one rank of a process group that ``run_net`` started, and
    raises without one; each host's local rank 0 returns the results, the
    other ranks None.
    """
    dist.check_world(cfg, "test")
    device = resolve_device(device)
    disable_tf32()
    setup_logging(cfg.OUTPUT_DIR, is_primary=dist.is_primary())
    dist.check_batch_divisibility(cfg, int(cfg.TEST.BATCH_SIZE), "TEST")
    np.random.seed(cfg.RNG_SEED)
    logger.info("Test with config:\n%s", cfg.to_json())
    multitask = is_multitask(cfg)

    model = build_model(cfg, device, torch.Generator().manual_seed(cfg.RNG_SEED))
    path = cu.load_test_checkpoint(cfg, model)
    logger.info("Test weights: %s", path or "random initialization")
    tensor.shard_model(model, cfg)
    eval_step = make_eval_step(cfg, device)
    test_loader = construct_loader(cfg, "test")
    store = DeviceSegmentStore.try_build(test_loader.dataset,
                                         int(cfg.GPU.TEST_DEVICE_CACHE_MB) << 20, device)
    if store is not None:
        test_loader.attach_store(store)
    try:
        dataset = test_loader.dataset
        num_clips = dataset._num_clips
        if cfg.TEST.SLIDE.ENABLE or cfg.TEST.DATASET.lower().endswith("slide"):
            meter = EPICTestMeterSlide(
                num_windows=len(dataset),
                num_cls=cfg.MODEL.NUM_CLASSES,
                per_action_instance=cfg.TEST.SLIDE.PER_ACTION_INSTANCE,
                log_period=cfg.LOG_PERIOD,
            )
        else:
            meter = (EPICTestMeter if multitask else TestMeter)(
                num_audios=len(dataset) // num_clips,
                num_clips=num_clips,
                num_cls=cfg.MODEL.NUM_CLASSES if multitask else cfg.MODEL.NUM_CLASSES[0],
                overall_iters=len(test_loader),
                ensemble_method=cfg.DATA.ENSEMBLE_METHOD,
                log_period=cfg.LOG_PERIOD,
            )
        group = dist.host_group(cfg) if test_loader.local_size > 1 else None
        results = perform_test(test_loader, model, eval_step, meter, device, group,
                               scores=dist.model_rank(cfg) == 0)
    finally:
        test_loader.close()
    if results is None:
        return None
    if dist.is_primary():
        _save_scores(cfg, results, multitask)
    if not multitask and not cfg.DATA.MULTI_LABEL and cfg.TEST.DATASET.lower() == "vggsound":
        logger.info("VGG-Sound stats: %s", metrics.vggsound_stats(*results))
    return results
