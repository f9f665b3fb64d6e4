"""Clip sampling on the host: copy of ``asf_tpu/data/sampling.py``.

Train and val (``clip_idx == -1``) draw a uniform start in [0, delta];
test takes ``linspace(0, delta, num_clips)[clip_idx]``. ``end = start +
clip_size - 1`` and slices are ``[start, end)``, so a clip carries
``clip_size - 1`` samples. Starts are bit-identical to the JAX package's for
the same ``(seed, epoch, index)``. ``get_start_end_idx_batch`` is the same
placement for a batch of items at once (``fast_rng`` replays the draws of
``item_rng``); ``item_rng`` stays the definition it is tested against.
"""

from __future__ import annotations

import numpy as np

from .fast_rng import bulk_first_uniform


def item_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """The item's own Generator, keyed on (RNG_SEED, epoch, index): the
    loader's workers share no Generator, so a run does not depend on their
    scheduling, and each epoch draws anew."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(epoch), int(index)]))


def get_start_end_idx(
    audio_size: int,
    clip_size: int,
    clip_idx: int,
    num_clips: int,
    start_sample: int = 0,
    rng: np.random.Generator | None = None,
):
    delta = max(audio_size - clip_size, 0)
    if clip_idx == -1:
        rng = rng or np.random.default_rng()
        start_idx = rng.uniform(0, delta)
    else:
        start_idx = np.linspace(0, delta, num=num_clips)[clip_idx]
    end_idx = start_idx + clip_size - 1
    return start_sample + start_idx, start_sample + end_idx


def get_start_end_idx_batch(
    audio_sizes: np.ndarray,
    clip_size: int,
    clip_idx: np.ndarray,
    num_clips: int,
    seed: int,
    epoch: int,
    indices: np.ndarray,
):
    """``get_start_end_idx`` of every item of a batch, bit for bit: item i
    has ``audio_sizes[i]`` samples, view ``clip_idx[i]`` (-1: a uniform draw
    from ``item_rng(seed, epoch, indices[i])``) of ``num_clips``. Returns
    (starts, ends) as float64 arrays. Raises ``ValueError`` for a seed,
    epoch or index outside uint32, which the vectorised draw does not take."""
    delta = np.maximum(np.asarray(audio_sizes, np.int64) - clip_size, 0).astype(np.float64)
    clip_idx = np.asarray(clip_idx, np.int64)
    drawn = clip_idx == -1
    start = np.zeros_like(delta)
    if drawn.any():
        start[drawn] = bulk_first_uniform(seed, epoch, np.asarray(indices)[drawn], delta[drawn])
    if (~drawn).any():
        # np.linspace(0, delta, num)[i]: i * (delta / (num - 1)), the last
        # view exactly delta; one view starts at 0.
        if num_clips > 1:
            views, d = clip_idx[~drawn], delta[~drawn]
            start[~drawn] = np.where(views == num_clips - 1, d, views * (d / (num_clips - 1)))
    return start, start + (clip_size - 1)
