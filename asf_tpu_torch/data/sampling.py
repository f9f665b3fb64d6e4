"""Clip sampling on the host: copy of ``asf_tpu/data/sampling.py``.

Train and val (``clip_idx == -1``) draw a uniform start in [0, delta];
test takes ``linspace(0, delta, num_clips)[clip_idx]``. ``end = start +
clip_size - 1`` and slices are ``[start, end)``, so a clip carries
``clip_size - 1`` samples. Starts are bit-identical to the JAX package's for
the same ``(seed, epoch, index)``.
"""

from __future__ import annotations

import numpy as np


def item_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """The item's own Generator, keyed on (RNG_SEED, epoch, index): the
    loader's threads share no Generator, so a run does not depend on their
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
