"""Slow/Fast pathway indices.

Counterpart of ``asf_tpu/dsp/pathways.py:19-43``. The Fast pathway is the
full (T, F) spectrogram; the Slow pathway takes T//ALPHA frames at
``torch.linspace(0, T-1, T//ALPHA).long()`` on the CPU, the upstream
``pack_pathway_output``.
"""

from __future__ import annotations

import numpy as np


def slow_indices(num_frames: int, alpha: int) -> np.ndarray:
    """``torch.linspace(0, T-1, T//alpha).long()`` on the CPU, bit-exact.

    The CPU linspace fills SYMMETRICALLY: the first half as
    ``start + i*step``, the second as ``end - (steps-1-i)*step``, with a
    float32 step and FMA contraction (the product is not rounded to float32
    before the add). Emulated with a float32 step and float64 products,
    which are exact at these magnitudes and so round once, like the FMA.
    Computed in numpy so that the index set does not depend on the device
    the spectrogram lives on.
    """
    n = num_frames // alpha
    if n <= 1:
        return np.zeros(max(n, 0), np.int64)
    step = np.float64(np.float32(np.float32(num_frames - 1) / np.float32(n - 1)))
    i = np.arange(n, dtype=np.float64)
    half = n // 2
    vals = np.empty(n, np.float32)
    vals[:half] = (i[:half] * step).astype(np.float32)
    vals[half:] = (
        np.float64(num_frames - 1) - (n - 1 - i[half:]) * step
    ).astype(np.float32)
    return vals.astype(np.int64)
