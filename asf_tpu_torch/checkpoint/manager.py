"""Checkpoint save and load, auto-resume, and the load precedence.

Counterpart of ``asf_tpu/checkpoint/manager.py``. A checkpoint is the
reference's ``.pyth`` dict written with ``torch.save``: ``{epoch, step,
model_state, optimizer_state, cfg}`` (``cfg`` as JSON), plus
``generator_state``, SpecAugment's ``torch.Generator`` state. The JAX step
folds its augmentation key by the step count; the port draws from a
generator, so a resumed run restores it to go on with the same stream.
Files are ``checkpoint_epoch_{N:05d}.pyth`` (N = epoch + 1) and
``checkpoint_best.pyth`` under ``OUTPUT_DIR/checkpoints``.

Auto-resume and the test-time load take the port's own ``.pyth`` (one
that holds ``generator_state``) strictly. ``TRAIN.CHECKPOINT_FILE_PATH``
loads any ``.pyth`` by name and shape through ``pyth_names.load_into``, as
the JAX package loads every ``.pyth`` (``asf_tpu/checkpoint/manager.py:170-175``):
a VGG-Sound checkpoint seeds the trunk of a verb/noun model, and each leaf
it cannot give (the heads) keeps its initial value with a warning.

In a process group only global rank 0 writes a checkpoint (the model's own
``state_dict``, never its ``DistributedDataParallel`` wrapper's, so no name
takes a ``module.`` prefix), and every rank then waits at a barrier, so
that an auto-resume on any rank reads the same file. Every rank loads. On
a data x model grid (``GPU.MODEL_PARALLEL``) the ranks of rank 0's model
group first gather each sharded leaf and its optimizer state whole
(``parallel/tensor.py:full_state_dicts``), so the file is the one a single
process writes; every rank loads whole tensors into the whole model, which
``train(cfg)`` and ``test(cfg)`` shard after the load.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..parallel import dist, tensor
from ..utils.logging import get_logger
from .pyth_names import load_into

logger = get_logger(__name__)

CHECKPOINT_DIR = "checkpoints"


def _ckpt_root(path_to_job: str) -> str:
    return os.path.abspath(os.path.join(path_to_job, CHECKPOINT_DIR))


def get_path_to_checkpoint(path_to_job: str, epoch: int) -> str:
    return os.path.join(_ckpt_root(path_to_job), f"checkpoint_epoch_{epoch:05d}.pyth")


def get_last_checkpoint(path_to_job: str) -> Optional[str]:
    d = _ckpt_root(path_to_job)
    if not os.path.isdir(d):
        return None
    names = [n for n in os.listdir(d) if n.startswith("checkpoint_epoch_") and n.endswith(".pyth")]
    return os.path.join(d, sorted(names)[-1]) if names else None


def has_checkpoint(path_to_job: str) -> bool:
    return get_last_checkpoint(path_to_job) is not None


def is_checkpoint_epoch(cfg, cur_epoch: int) -> bool:
    """Every ``CHECKPOINT_PERIOD`` epochs and at the last epoch."""
    return (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0 or (
        cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH
    )


def save_checkpoint(path_to_job: str, state, epoch: int, cfg, name: Optional[str] = None) -> str:
    """Writes ``state`` (a ``steps.TrainState``) after ``epoch``; returns the path.

    The file is written beside its final name and renamed, so that a run cut
    while saving leaves no partial checkpoint for auto-resume to find. In a
    process group rank 0 writes and every rank returns after the barrier
    that follows."""
    path = (os.path.join(_ckpt_root(path_to_job), f"{name}.pyth") if name
            else get_path_to_checkpoint(path_to_job, epoch + 1))
    if dist.data_rank(cfg) == 0:  # rank 0's model group (rank 0 alone at GPU.MODEL_PARALLEL 1)
        model_state, optimizer_state = tensor.full_state_dicts(
            state.model, state.optimizer, tensor.model_shard(cfg))
        if dist.is_primary():
            _write(path, state, epoch, cfg, model_state, optimizer_state)
    dist.barrier()
    return path


def _write(path: str, state, epoch: int, cfg, model_state: dict, optimizer_state: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "epoch": epoch,
        "step": int(state.step),
        "model_state": model_state,
        "optimizer_state": optimizer_state,
        "cfg": cfg.to_json(),
        "generator_state": state.generator.get_state(),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A ``.pyth`` dict on the CPU. Reference files carry a pickled config
    object, so this unpickles fully: load only checkpoints you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _is_port_checkpoint(ckpt) -> bool:
    return isinstance(ckpt, dict) and "generator_state" in ckpt


def _load_model(model, ckpt) -> None:
    """A port checkpoint strictly, a reference one by name and shape."""
    if _is_port_checkpoint(ckpt):
        model.load_state_dict(ckpt["model_state"], strict=True)
    else:
        load_into(model, ckpt.get("model_state", ckpt))


def _restore(state, ckpt) -> None:
    """The optimizer, step count and generator of a port checkpoint."""
    state.optimizer.load_state_dict(ckpt["optimizer_state"])
    state.step = int(ckpt["step"])
    state.generator.set_state(ckpt["generator_state"])


def load_train_checkpoint(cfg, state) -> int:
    """Loads into ``state`` in place, by the JAX package's precedence; returns
    the epoch to start from.

    1. ``TRAIN.AUTO_RESUME`` and a checkpoint in ``OUTPUT_DIR``: the last one,
       whole (model, optimizer, step, generator).
    2. ``TRAIN.CHECKPOINT_FILE_PATH``: any ``.pyth``, by name and shape after
       the ``CHECKPOINT_CLEAR_NAME_PATTERN`` strings are cut from its names.
       A port checkpoint whose every leaf was taken also restores its
       optimizer, step and generator, unless ``TRAIN.CHECKPOINT_EPOCH_RESET``,
       which starts at epoch 0 and step 0.
    3. Neither: epoch 0, ``state`` as it is.
    """
    if cfg.TRAIN.AUTO_RESUME and has_checkpoint(cfg.OUTPUT_DIR):
        last = get_last_checkpoint(cfg.OUTPUT_DIR)
        logger.info("Auto-resume from %s", last)
        ckpt = load_checkpoint(last)
        _load_model(state.model, ckpt)
        _restore(state, ckpt)
        return int(ckpt["epoch"]) + 1

    path = cfg.TRAIN.CHECKPOINT_FILE_PATH
    if not path:
        return 0
    logger.info("Load initial weights from %s", path)
    ckpt = load_checkpoint(path)
    skipped = load_into(state.model, ckpt.get("model_state", ckpt),
                        tuple(cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN))
    if cfg.TRAIN.CHECKPOINT_EPOCH_RESET:
        state.step = 0
        return 0
    if _is_port_checkpoint(ckpt) and not skipped:
        _restore(state, ckpt)
    else:
        state.step = 0
    return int(ckpt.get("epoch", 0)) + 1


def load_test_checkpoint(cfg, model) -> Optional[str]:
    """Loads the test-time weights into ``model``: ``TEST.CHECKPOINT_FILE_PATH``,
    else the last checkpoint in ``OUTPUT_DIR``, else
    ``TRAIN.CHECKPOINT_FILE_PATH``, else none (random weights, for
    debugging). Returns the path loaded."""
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        path = cfg.TEST.CHECKPOINT_FILE_PATH
    elif has_checkpoint(cfg.OUTPUT_DIR):
        path = get_last_checkpoint(cfg.OUTPUT_DIR)
    elif cfg.TRAIN.CHECKPOINT_FILE_PATH:
        path = cfg.TRAIN.CHECKPOINT_FILE_PATH
    else:
        logger.info("Testing with random initialization. Only for debugging.")
        return None
    _load_model(model, load_checkpoint(path))
    return path
