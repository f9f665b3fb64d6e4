"""The reference's own reading of the generated split: which rows a batch
holds, where each clip lies, and its samples, worked out from the split's
rows and audio with numpy alone.

* Train order: epoch ``e`` visits the rows in ``numpy.random.default_rng(
  RNG_SEED + e).shuffle(arange(rows))`` order, batches of B, the last partial
  batch dropped (the JAX package's loader, which the port keeps).
* A train clip: an action at least a clip long (``clip_size`` = round(sr *
  CLIP_SECS) samples) gives ``clip_size - 1`` samples from ``int(start +
  u)``, u = ``default_rng(SeedSequence([RNG_SEED, e, index])).uniform(0,
  num - clip_size)``; a shorter one gives its whole segment; the rest of the
  clip is zeros and ``n_valid`` counts the real samples.
* A test view ``v`` of ``V``: the same with ``u = linspace(0, num -
  clip_size, V)[v]``.
* A chain: ``ceil(max((num / sr - overlap) / (CLIP_SECS - overlap), 1))``
  windows, at most ``MAX_NB``; window ``i`` starts ``i * sr`` samples after
  the action (a short action gives its whole segment to every window); a
  window's ``n_valid`` counts its samples inside the video, at least 1. A
  batch pads its chains to the power of two at or above its longest chain,
  at most ``MAX_NB``, with zero windows of ``n_valid`` 1.
"""

from __future__ import annotations

import numpy as np

from .frontend import bucket, num_windows


def train_rows(n_rows: int, batch: int, rng_seed: int, epoch: int, step: int) -> np.ndarray:
    order = np.arange(n_rows)
    np.random.default_rng(int(rng_seed) + int(epoch)).shuffle(order)
    return order[step * batch:(step + 1) * batch]


def _read(audio: np.ndarray, start: int, n: int, width: int) -> np.ndarray:
    out = np.zeros(width, np.int16)
    a, b = max(0, start), min(len(audio), start + n)
    if b > a:
        out[a - start:b - start] = audio[a:b]
    return out


def clips(split, rows: np.ndarray, clip_size: int, offsets) -> tuple[np.ndarray, np.ndarray]:
    """(B, clip_size - 1) int16 and (B,) n_valid of ``rows``; ``offsets(i,
    row, delta)`` gives the clip's start inside its action."""
    width = clip_size - 1
    wave = np.zeros((len(rows), width), np.int16)
    n_valid = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        start, num = int(split.start[r]), int(split.num[r])
        if num < clip_size:
            first, n = start, max(0, num)
        else:
            first, n = int(start + offsets(i, r, num - clip_size)), width
        wave[i] = _read(split.audio[split.video[r]], first, n, width)
        n_valid[i] = n
    return wave, n_valid


def train_clips(split, rows, clip_size: int, rng_seed: int, epoch: int):
    def drawn(_i, r, delta):
        g = np.random.default_rng(np.random.SeedSequence([int(rng_seed), int(epoch), int(r)]))
        return g.uniform(0, delta)

    return clips(split, rows, clip_size, drawn)


def test_views(split, items: np.ndarray, views: int, clip_size: int):
    """Test items ``items`` (row * views + view)."""
    rows, view = items // views, items % views

    def spaced(i, _r, delta):
        return np.linspace(0, delta, num=views)[view[i]]

    return clips(split, rows, clip_size, spaced)


def chains(split, rows: np.ndarray, m: dict):
    """(B, Nb, S) int16 waveforms, (B, Nb) n_valid and the chains' lengths."""
    sr = int(m["sampling_rate"])
    clip_size = int(round(sr * m["clip_s"]))
    width = clip_size - 1
    lengths = [num_windows(int(split.num[r]) / sr, m["clip_s"], m["overlap_s"],
                           m["max_windows"]) for r in rows]
    nb = bucket(max(lengths), m["max_windows"])
    wave = np.zeros((len(rows), nb, width), np.int16)
    n_valid = np.ones((len(rows), nb), np.int32)
    for i, r in enumerate(rows):
        audio = split.audio[split.video[r]]
        start, num = int(split.start[r]), int(split.num[r])
        for w in range(lengths[i]):
            first, n = (start, max(0, num)) if num < clip_size else (start + w * sr, width)
            wave[i, w] = _read(audio, first, n, width)
            n_valid[i, w] = max(1, min(n, max(0, min(first + n, len(audio)) - first)))
    return wave, n_valid, lengths

