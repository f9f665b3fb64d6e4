"""Operations and bytes the work needs, from the reference's shapes.

* ``model_flops(m, rows, chains, lengths)``: floating-point operations of one
  forward of the plain model (``reference/slowfast.py``) by kind: ``conv``
  and ``linear`` (multiply-adds counted as 2), ``gru`` (the gate products of
  every real window, both directions, every layer), traced on PyTorch's meta
  device at those shapes, so nothing is computed. For chains the trunk is
  counted over the real windows only (the sum of ``lengths``): a window of
  padding is work the batch wastes, not the model's, so packing chains
  raises the share of the peak. A training step is 3 forwards of these
  (forward, input and weight gradients); nothing recomputed is counted.
* ``logmel_work(m, rows)``: the log-mel kernel's least work, as
  ``chip_smoke.py``'s kernel table counts it: the DFT over the window's nonzero
  taps for the frequencies that feed a mel bin, and their mel product
  (operations); each input byte read once, the float32 output written once
  (bytes). Inputs: the waveform in the kernel's type, the DFT's cosine and
  sine rows over those taps and frequencies, and the mel weights.
* ``ideal_s(flops, peaks, dtype)``: the least time of each kind at the card's
  dense peak for the type it runs in (the trunk's convolutions and the linear
  layers in the compute type, the GRU in float32 on cuDNN).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .reference import frontend, slowfast


@functools.lru_cache(maxsize=256)
def _model_flops(m_key: tuple, rows: int, chains, lengths) -> dict:
    m = dict(m_key)
    counts = {"conv": 0, "linear": 0, "gru": 0}

    def count(kind, n):
        counts[kind] += int(n)

    shapes = slowfast.param_shapes(m)
    p = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    ctx = slowfast.Ctx(p, train=False, count=count)
    t, f = m["num_frames"], m["n_mels"]

    def paths(n):
        return [torch.empty(n, 1, t // m["alpha"], f, device="meta"),
                torch.empty(n, 1, t, f, device="meta")]

    if chains is None:
        slowfast.forward(ctx, paths(rows), m)
    else:
        x = slowfast.pooled(ctx, slowfast.trunk(ctx, paths(sum(lengths)), m), m)
        slowfast.gru_head(ctx, torch.empty(rows, *x.shape[1:], device="meta"), chains,
                          list(lengths), m)
    return counts


def model_flops(m: dict, rows: int, chains=None, lengths=None) -> dict:
    key = tuple(sorted((k, _freeze(v)) for k, v in m.items()))
    return _model_flops(key, int(rows), tuple(chains) if chains else None,
                        tuple(int(x) for x in lengths) if lengths else None)


def _freeze(v):
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


def logmel_work(m: dict, rows: int) -> tuple[float, float]:
    """(operations, bytes) of one log-mel launch over ``rows`` clips."""
    win, hop = frontend.stft_geometry(m)
    sr = m["sampling_rate"]
    samples = int(round(sr * m["clip_s"])) - 1
    frames = rows * (1 + samples // hop)
    taps = int(np.count_nonzero(frontend.hann_window(win, m["n_fft"])))
    mel = frontend.mel_filterbank(sr, m["n_fft"], m["n_mels"])
    freqs = int(np.count_nonzero(mel.sum(axis=0) > 0))
    ops = frames * (2 * 2 * taps * freqs + 2 * freqs * m["n_mels"])
    item = 2 if m["dsp_bf16"] else 4
    nbytes = (rows * samples * item + 2 * taps * freqs * item + freqs * m["n_mels"] * item
              + frames * m["n_mels"] * 4)
    return float(ops), float(nbytes)


def logmel_bound_s(m: dict, rows: int, peaks) -> float:
    f32, bf16, mem = peaks
    ops, nbytes = logmel_work(m, rows)
    return max(ops / (bf16 if m["dsp_bf16"] else f32), nbytes / mem)


def ideal_s(flops: dict, peaks, m: dict, passes: int = 1) -> float:
    """Least seconds of ``flops`` (a ``model_flops`` dict) at the card's peaks,
    ``passes`` times (3 for a training step)."""
    f32, bf16, _ = peaks
    trunk_peak = bf16 if m["compute_dtype"] == "bfloat16" else f32
    return passes * ((flops["conv"] + flops["linear"]) / trunk_peak + flops["gru"] / f32)
